"""EmbeddingBag and the hash-trick lookup, in torch: the port of
``repro/models/recsys/embedding.py``, built from gathers and segment
reductions as the reference builds them (``jnp.take`` + ``segment_sum``),
so each mode, padding id and empty bag gives the reference's value.
"""
from __future__ import annotations

import torch

from ..common import seg_sum

_MASK32 = 0xFFFFFFFF


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor | None = None,
                  per_sample_weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """torch.nn.EmbeddingBag semantics, as the reference computes them.

    * ``indices [M]`` flat indices; ``offsets [B]`` bag starts (first
      element must be 0) — or ``indices [B, L]`` with no offsets (fixed-
      size bags, padding id < 0 skipped).

    An empty bag gives 0 under ``sum`` and ``mean`` and ``-inf`` under
    ``max``; ``mean`` divides by the bag's count taken in f32 (at least 1).
    """
    if offsets is None:
        idx = indices
        valid = idx >= 0
        emb = table[torch.where(valid, idx, 0)]
        emb = emb * valid[..., None]
        if per_sample_weights is not None:
            emb = emb * per_sample_weights[..., None]
        s = emb.sum(dim=-2)
        if mode == "sum":
            return s
        if mode == "mean":
            return s / torch.clamp(valid.sum(-1, keepdim=True), min=1)
        if mode == "max":
            return torch.where(valid[..., None], emb, -torch.inf).amax(-2)
        raise ValueError(mode)
    # ragged bags: segment ids from offsets (a bag start at M, an empty
    # last bag, adds nothing, as the reference's scatter drops it)
    M = indices.shape[0]
    B = offsets.shape[0]
    starts = offsets[1:]
    starts = starts[starts < M]
    seg = torch.cumsum(torch.zeros(M, dtype=torch.int32,
                                   device=indices.device).index_add(
        0, starts, torch.ones_like(starts, dtype=torch.int32)), 0)
    emb = table[indices]
    if per_sample_weights is not None:
        emb = emb * per_sample_weights[:, None]
    if mode == "sum":
        return seg_sum(emb, seg, B)
    if mode == "mean":
        s = seg_sum(emb, seg, B)
        cnt = seg_sum(torch.ones(M, dtype=torch.float32,
                                 device=indices.device), seg, B)
        return s / torch.clamp(cnt, min=1)[:, None]
    if mode == "max":
        out = torch.full((B,) + tuple(emb.shape[1:]), -torch.inf,
                         dtype=emb.dtype, device=emb.device)
        return out.scatter_reduce(0, seg[:, None].expand_as(emb), emb,
                                  "amax", include_self=True)
    raise ValueError(mode)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2^32 for ``x`` in [0, 2^32) held in int64: ``c``
    in 16-bit halves, so no product passes 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_embedding_lookup(table: torch.Tensor, ids: torch.Tensor
                          ) -> torch.Tensor:
    """Hash-trick lookup for open vocabularies: id → row via splitmix on
    the id's 32 low bits (the reference's uint32 arithmetic, carried in
    int64: torch has no ``>>`` on uint32)."""
    x = ids.to(torch.int64) & _MASK32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return table[x % table.shape[0]]
