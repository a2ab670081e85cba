"""Model configurations of the port: the LM architectures and their
lookups (``registry``)."""
