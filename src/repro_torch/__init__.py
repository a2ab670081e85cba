"""PyTorch/CUDA port of the DeltaGraph snapshot-retrieval system.

A second package beside the JAX one: the host planner and storage are
copied module for module, the device retrieval path runs on PyTorch
tensors, and every TPU kernel on that path is a hand-written CUDA kernel
for Hopper (``repro_torch.kernels``).  Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``.
"""
