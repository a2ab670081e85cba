"""Kernel dispatch policy: by tensor device, and nothing else.

* every tensor on the CPU  -> the kernel's plain PyTorch version;
* every tensor on CUDA     -> the hand-written CUDA kernel, or an exception
  (a build or launch failure is raised, never answered by the plain
  version);
* anything else (mixed devices, ``meta``, ``mps``) -> ``ValueError``.

Before that choice, a wrapper that has a shape-only route asks
:func:`on_meta`: every tensor on the ``meta`` device -> the route, which
returns empty outputs of the kernel's shapes and dtypes and reports the
kernel's work to an active accounting mode (:func:`report_meta_work`;
the dry run, ``repro_torch.launch.op_analysis``).  ``on_meta`` is False
for CPU and CUDA tensors and raises for a mix, so neither ever reaches
that route.

There is no environment variable or flag that sends CUDA tensors to the
plain version or to the shape-only route.  Entry points pick the device
with :func:`resolve_device`: ``"cuda"`` unless the caller passes
``device="cpu"``, and a missing card is an error rather than a silent CPU
run.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def use_kernel(*tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU inputs; ``None``
    entries (optional inputs) are ignored."""
    given = [t for t in tensors if t is not None]
    if given and all(t.is_cuda for t in given):
        return True
    if given and all(t.is_cpu for t in given):
        return False
    kinds = {t.device.type for t in given}
    raise ValueError(f"kernel inputs must all lie on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


def on_meta(*tensors) -> bool:
    """True for all-``meta`` inputs (a shape-only trace), False when none
    is on ``meta``; ``None`` entries are ignored, a mix raises."""
    given = [t for t in tensors if t is not None]
    meta = [t.is_meta for t in given]
    if given and all(meta):
        return True
    if any(meta):
        kinds = {t.device.type for t in given}
        raise ValueError(f"kernel inputs must all lie on one device, got "
                         f"{sorted(kinds)}")
    return False


def report_meta_work(route: str, *, flops: float, nbytes: float,
                     dtype: torch.dtype, inputs=(), outputs=()) -> None:
    """Hand one shape-only kernel call (its route, the operations it does,
    the bytes it must move, and its input and output tensors) to every
    active dispatch mode that accounts kernels (a ``record_kernel``
    method); nothing happens outside one."""
    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "record_kernel", None)
        if record is not None:
            record(route, flops=flops, nbytes=nbytes, dtype=dtype,
                   inputs=inputs, outputs=outputs)


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
