"""Models of the port: the language models (``transformer``), the four GNN
architectures (``gnn``) and DIN (``recsys``)."""
