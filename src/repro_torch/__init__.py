"""PyTorch/CUDA port of the DeltaGraph snapshot-retrieval system.

A second package beside the JAX one: the host planner and storage are
copied module for module, the device retrieval path and the dense LM
serving path run on PyTorch tensors, and every TPU kernel of the
reference is a hand-written CUDA kernel for Hopper
(``repro_torch.kernels``).  Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``.
"""
