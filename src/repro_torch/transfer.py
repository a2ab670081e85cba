"""Host <-> device copies of the retrieval path, each counted where it is
made.

:func:`to_device` is the one host-to-device copy of a point retrieval
(planes, weights, the segment ids that ``segment_sum`` buckets on the
card, or bucket arrays built on the host): a pageable ``.to()``, inside a
``stage`` span, its bytes added to ``h2d_bytes``.  A copy to the
CPU is no copy: the host tensor comes back as it is, with no span and no
count.  :func:`to_host` brings a tensor back as a numpy array inside a
``readback`` span (the copy and the host's wait for the device before
it), its bytes added to ``d2h_bytes`` when it came from a CUDA device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import obs


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor sharing its memory; packed ``uint32`` words
    become their ``int32`` view (torch's uint32 lacks ``~`` and ``>>``)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device`` (words as ``int32``)."""
    t = host_tensor(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    nbytes = t.nbytes
    with obs.span("stage", bytes=nbytes):
        obs.count("h2d_bytes", nbytes)
        return t.to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host."""
    nbytes = t.nbytes
    with obs.span("readback", bytes=nbytes):
        if t.is_cuda:
            obs.count("d2h_bytes", nbytes)
        return t.detach().cpu().numpy()
