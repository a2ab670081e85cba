"""Model configurations of the port: the LM, GNN and DIN architectures,
their input shapes and their lookups (``registry``)."""
