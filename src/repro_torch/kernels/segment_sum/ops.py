"""Public segment-sum wrapper + host-side edge bucketing.

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


def bucket_edges(seg_ids: np.ndarray, num_segments: int, block_n: int
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """Host preprocessing: sort edges by segment, bucket into node blocks of
    ``block_n`` destinations, pad each bucket's edge list to the max.

    Returns (order, local_ids, max_edges): gather ``data[order]`` then
    reshape to [NB, ME, D]; ``local_ids`` is [NB, ME] with -1 padding.
    Inside a bucket the valid entries come first, sorted by destination and
    in input order within a destination (the stable sort) — the layout the
    kernel's in-order row sums rely on.  Vectorised: the same output as
    the JAX package's per-bucket loop.
    """
    seg_ids = np.asarray(seg_ids)
    NB = -(-num_segments // block_n)
    with obs.span("bucket", edges=seg_ids.size, NB=NB) as sp:
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
        sp.note(ME=ME)
    obs.count("bucket_entries", NB * ME)
    return out_order, local, ME


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
    ``data``; ``buckets`` may carry precomputed :func:`bucket_edges` output
    (static graphs)."""
    if data.shape[0] == 0:
        return torch.zeros((num_segments, data.shape[-1]), dtype=data.dtype,
                           device=data.device)
    if buckets is None:
        buckets = bucket_edges(np.asarray(seg_ids), num_segments, block_n)
    out_order, local, ME = buckets
    NB = local.shape[0]
    dev = data.device
    order = to_device(out_order.reshape(-1), dev)
    gathered = data[order].reshape(NB, ME, data.shape[-1])
    out = segment_sum_bucketed(gathered, to_device(local, dev),
                               block_n=block_n)
    return out.reshape(NB * block_n, data.shape[-1])[:num_segments]
