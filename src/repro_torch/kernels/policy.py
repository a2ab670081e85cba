"""Kernel dispatch policy: by tensor device, and nothing else.

* every tensor on the CPU  -> the kernel's plain PyTorch version;
* every tensor on CUDA     -> the hand-written CUDA kernel, or an exception
  (a build or launch failure is raised, never answered by the plain
  version);
* anything else (mixed devices, ``meta``, ``mps``) -> ``ValueError``.

There is no environment variable or flag that sends CUDA tensors to the
plain version.  Entry points pick the device with :func:`resolve_device`:
``"cuda"`` unless the caller passes ``device="cpu"``, and a missing card
is an error rather than a silent CPU run.
"""
from __future__ import annotations

import torch


def use_kernel(*tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU inputs; ``None``
    entries (optional inputs) are ignored."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for
    (the default) and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
