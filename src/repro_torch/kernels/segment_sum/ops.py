"""Public segment-sum wrapper + edge bucketing (on the host, or on the
device of the caller's data).

:func:`segment_sum_bucketed` dispatches by device
(:mod:`repro_torch.kernels.policy`): CPU tensors go to the plain version in
``ref.py``, CUDA tensors to ``csrc/segment_sum.cu``.  Each launch adds
one to the ``launch.segment_sum_bucketed`` counter (:mod:`repro_torch.obs`),
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import obs
from ...transfer import to_device
from .. import _build
from ..policy import use_kernel
from .ref import segment_sum_bucketed_ref

KERNELS = ("segment_sum_bucketed",)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"segment_sum_bucketed_launch": [_P, _P, _P, _I, _I, _I, _I, _P]}
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _build.load("segment_sum", _SIGNATURES)
    return _lib


def bucket_edges(seg_ids: np.ndarray, num_segments: int, block_n: int,
                 device=None) -> tuple:
    """Sort edges by segment, bucket into node blocks of ``block_n``
    destinations, pad each bucket's edge list to the max.

    Returns (order, local_ids, max_edges): gather ``data[order]`` then
    reshape to [NB, ME, D]; ``local_ids`` is [NB, ME] with -1 padding.
    Inside a bucket the valid entries come first, sorted by destination and
    in input order within a destination (the stable sort) — the layout the
    kernel's in-order row sums rely on.

    ``device`` is where the caller's data lies.  On a CUDA device the
    buckets are built there (:func:`bucket_edges_tensor`) from ``seg_ids``
    staged once, and come back as tensors on it; otherwise on the host
    (vectorised: the same output as the JAX package's per-bucket loop) as
    numpy arrays.  Both routes give the same entries.
    """
    seg_ids = np.asarray(seg_ids)
    NB = -(-num_segments // block_n)
    on_card = device is not None and torch.device(device).type == "cuda"
    with obs.span("bucket", edges=seg_ids.size, NB=NB) as sp:
        if on_card:
            out_order, local, ME = bucket_edges_tensor(
                to_device(seg_ids, device), num_segments, block_n)
        else:
            out_order, local, ME = _bucket_edges_host(seg_ids, NB, block_n)
        sp.note(ME=ME)
    obs.count("bucket_entries", NB * ME)
    return out_order, local, ME


def _bucket_edges_host(seg_ids: np.ndarray, NB: int, block_n: int
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    order = np.argsort(seg_ids, kind="stable")
    sorted_ids = seg_ids[order]
    bucket_of = sorted_ids // block_n
    counts = np.bincount(bucket_of, minlength=NB)
    ME = max(int(counts.max(initial=0)), 1)
    starts = np.zeros(NB + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(sorted_ids.size, dtype=np.int64) - starts[bucket_of]
    out_order = np.zeros((NB, ME), np.int64)
    local = np.full((NB, ME), -1, np.int32)
    out_order[bucket_of, pos] = order
    local[bucket_of, pos] = sorted_ids - bucket_of * block_n
    return out_order, local, ME


def bucket_edges_tensor(seg_ids: torch.Tensor, num_segments: int,
                        block_n: int) -> tuple[torch.Tensor, torch.Tensor,
                                               int]:
    """The host route's layout built by tensor ops on the device of
    ``seg_ids``: the same ``order`` (int64) and ``local_ids`` (int32) entry
    for entry, as tensors there.  The stable sort as on the host; each
    bucket's first entry by a binary search of the sorted ids for the
    buckets' bounds (what the host's ``bincount`` and ``cumsum`` give); each
    entry's slot is its sorted index shifted by its bucket's; one scatter
    into each padded array.  One readback of three scalars (the largest
    bucket, which sizes the arrays, and the ids' range); nothing staged."""
    NB = -(-num_segments // block_n)
    dev = seg_ids.device
    E = seg_ids.numel()
    if NB == 0:
        if E:
            raise IndexError(f"{E} segment ids for no segment")
        return (torch.zeros((0, 1), dtype=torch.int64, device=dev),
                torch.full((0, 1), -1, dtype=torch.int32, device=dev), 1)
    sorted_ids, order = torch.sort(seg_ids, stable=True)
    bounds = torch.arange(0, (NB + 1) * block_n, block_n,
                          dtype=sorted_ids.dtype, device=dev)
    starts = torch.searchsorted(sorted_ids, bounds)       # [NB + 1]
    counts = starts.diff()
    below, inside, most = torch.stack(
        (starts[0], starts[-1], counts.max())).tolist()
    if below:
        raise ValueError(f"{below} negative segment ids")
    if inside < E:
        raise IndexError(f"{E - inside} segment ids lie past {NB} buckets "
                         f"of {block_n}")
    ME = max(most, 1)
    bucket_of = torch.div(sorted_ids, block_n, rounding_mode="floor")
    shift = torch.arange(0, NB * ME, ME, device=dev) - starts[:-1]
    slot = shift[bucket_of] + torch.arange(E, device=dev)
    out_order = torch.zeros(NB * ME, dtype=torch.int64, device=dev)
    local = torch.full((NB * ME,), -1, dtype=torch.int32, device=dev)
    out_order.scatter_(0, slot, order)
    local.scatter_(0, slot, torch.remainder(sorted_ids, block_n).int())
    return out_order.view(NB, ME), local.view(NB, ME), ME


def segment_sum_bucketed(data: torch.Tensor, local_ids: torch.Tensor, *,
                         block_n: int) -> torch.Tensor:
    """``data [NB, ME, D]`` f32 padded per-bucket edge features,
    ``local_ids [NB, ME]`` int32 destination offsets within the bucket
    (-1 = padding; laid out as :func:`bucket_edges` emits them) ->
    ``[NB, block_n, D]`` per-bucket sums."""
    with obs.span("launch.segment_sum", shape=tuple(data.shape)):
        if not use_kernel(data, local_ids):
            return segment_sum_bucketed_ref(data, local_ids, block_n=block_n)
        return _segment_sum_kernel(data, local_ids, block_n)


def _segment_sum_kernel(data: torch.Tensor, local_ids: torch.Tensor,
                        block_n: int) -> torch.Tensor:
    if data.dtype != torch.float32 or local_ids.dtype != torch.int32:
        raise TypeError("segment_sum_bucketed takes f32 data, int32 ids")
    if not (data.is_contiguous() and local_ids.is_contiguous()):
        raise ValueError("segment_sum_bucketed inputs must be contiguous")
    if data.dim() != 3 or local_ids.shape != data.shape[:2]:
        raise ValueError(f"local_ids {tuple(local_ids.shape)} does not match "
                         f"data {tuple(data.shape)}")
    if data.get_device() != local_ids.get_device():
        raise ValueError("data and local_ids must lie on one device")
    NB, ME, D = data.shape
    out = torch.empty((NB, block_n, D), dtype=torch.float32,
                      device=data.device)
    if NB:
        _build.launch(_load(), "segment_sum_bucketed_launch", data,
                      data.data_ptr(), local_ids.data_ptr(), out.data_ptr(),
                      NB, ME, D, block_n)
        obs.count("launch.segment_sum_bucketed")
    return out


def segment_sum(data: torch.Tensor, seg_ids, num_segments: int, *,
                block_n: int = 128,
                buckets: tuple | None = None) -> torch.Tensor:
    """Segment sum of ``data [E, D]`` by ``seg_ids [E]`` (host array) into
    ``[num_segments, D]``, through the bucketed kernel on the device of
    ``data``; the buckets are built on that device (:func:`bucket_edges`)
    unless ``buckets`` carries precomputed ones (static graphs), as numpy
    arrays or tensors: only what is still on the host is staged."""
    if data.shape[0] == 0:
        return torch.zeros((num_segments, data.shape[-1]), dtype=data.dtype,
                           device=data.device)
    dev = data.device
    if buckets is None:
        buckets = bucket_edges(np.asarray(seg_ids), num_segments, block_n,
                               dev)
    out_order, local, ME = buckets
    NB = local.shape[0]
    order = _on(out_order.reshape(-1), dev)
    gathered = data[order].reshape(NB, ME, data.shape[-1])
    out = segment_sum_bucketed(gathered, _on(local, dev), block_n=block_n)
    return out.reshape(NB * block_n, data.shape[-1])[:num_segments]


def _on(a, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: a device tensor moved there, a host array or
    tensor staged through :func:`to_device`."""
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(device)
    return to_device(np.asarray(a), device)
