"""Models of the port: the dense GQA language model (``transformer``)."""
