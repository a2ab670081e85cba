"""Public wrappers for delta-chain application + fused analytics.

Each wrapper dispatches by the device of its tensors
(:mod:`repro_torch.kernels.policy`): CPU tensors go to the plain versions
in ``ref.py``, CUDA tensors to the kernels in ``csrc/delta_apply.cu``
(built at first use).  Words are ``int32`` views of the packed ``uint32``
words.  :data:`launches` counts kernel launches per kernel, incremented
where the kernel is launched and nowhere else.

Unlike the JAX wrappers, nothing is padded to shape buckets: that bucketing
only kept JAX's compile cache small.  The fused kernel masks the ragged
edge itself; its ``pop`` partials come out over ``ceil(W / block_w)``
groups, as they do over the reference's padded width.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..policy import use_kernel
from .ref import delta_apply_chain_ref, delta_apply_fused_ref, pad_weights

launches = {"delta_apply_chain": 0, "delta_apply_fused": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "delta_apply_chain_launch": [_P, _P, _P, _P, _I, _I, _L, _P],
    "delta_apply_fused_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _L, _I, _P],
}
_MAX_BLOCK_W = 8192          # the fused kernel keeps a group's words in smem


def _lib() -> ctypes.CDLL:
    return _build.load("delta_apply", _SIGNATURES)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_words(base, adds, dels) -> tuple[int, int, int]:
    """Validate ``bases [B, W]``, ``adds/dels [B, K, W]`` int32, contiguous,
    on one device; returns ``(B, K, W)``."""
    for name, t in (("base", base), ("adds", adds), ("dels", dels)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 words, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if base.dim() != 2 or adds.dim() != 3 or adds.shape != dels.shape:
        raise ValueError(f"bad shapes base {tuple(base.shape)}, adds "
                         f"{tuple(adds.shape)}, dels {tuple(dels.shape)}")
    B, K, W = adds.shape
    if tuple(base.shape) != (B, W):
        raise ValueError(f"base {tuple(base.shape)} does not match "
                         f"adds {tuple(adds.shape)}")
    if len({base.device, adds.device, dels.device}) != 1:
        raise ValueError("base, adds and dels must lie on one device")
    return B, K, W


def _chain_kernel(bases, adds, dels) -> torch.Tensor:
    B, K, W = _check_words(bases, adds, dels)
    out = torch.empty_like(bases)
    lib = _lib()
    with torch.cuda.device(bases.device):
        err = lib.delta_apply_chain_launch(
            bases.data_ptr(), adds.data_ptr(), dels.data_ptr(),
            out.data_ptr(), B, K, W, _stream(bases))
    _build.check(lib, "delta_apply_chain", err)
    launches["delta_apply_chain"] += 1
    return out


def delta_apply_chain(base: torch.Tensor, adds: torch.Tensor,
                      dels: torch.Tensor) -> torch.Tensor:
    """Land a K-delta chain: ``base [W]``, ``adds/dels [K, W]`` -> ``[W]``."""
    if not use_kernel(base, adds, dels):
        return delta_apply_chain_ref(base, adds, dels)
    return _chain_kernel(base[None], adds[None], dels[None])[0]


def delta_apply_chain_batched(bases: torch.Tensor, adds: torch.Tensor,
                              dels: torch.Tensor) -> torch.Tensor:
    """Batched multi-snapshot apply: ``B`` sibling chains in one launch.

    ``bases [B, W]``, ``adds/dels [B, K, W]`` (chains zero-padded to a
    common ``K``; an all-zero ``(adds, dels)`` row is the identity step).
    Sibling branches after a plan Fork execute as one batched pass — one
    kernel launch and one sweep over the stacked bit-planes instead of
    ``B`` sequential chain calls.
    """
    if not use_kernel(bases, adds, dels):
        return delta_apply_chain_ref(bases, adds, dels)
    return _chain_kernel(bases, adds, dels)


# ---------------------------------------------------------------------------
# fused chain + analytics
# ---------------------------------------------------------------------------


class FusedOut(NamedTuple):
    """Result of one fused delta-apply + analytics pass.

    ``mask [.., W] int32`` is the landed chain state; ``pop [.., G] int32``
    per-group popcount partials; ``accw [.., W] f32`` per-word weighted
    partials; ``live [.., W*32] f32`` the unpacked membership indicator
    (``None`` unless requested — it is the segment_sum degree feed).
    Partials are identical across the kernel and the plain version (fixed
    per-word/per-group reduction groups), so the totals below are too.
    """
    mask: torch.Tensor
    pop: torch.Tensor
    accw: torch.Tensor
    live: torch.Tensor | None

    def live_count(self):
        """Total live elements (int; summed over the trailing axis)."""
        return self.pop.to(torch.int64).sum(-1).cpu().numpy()

    def weighted_total(self):
        """Σ weights over live slots, f32 (PageRank push mass), summed on
        the host in the reference's order."""
        return self.accw.cpu().numpy().sum(axis=-1, dtype=np.float32)


def _fused_kernel(bases, adds, dels, weights, block_w, emit_live):
    B, K, W = _check_words(bases, adds, dels)
    if not 1 <= block_w <= _MAX_BLOCK_W:
        raise ValueError(f"block_w must be in [1, {_MAX_BLOCK_W}]")
    G = -(-W // block_w)
    dev = bases.device
    w_ptr = None
    if weights is not None:
        weights = pad_weights(weights.to(dev), W)
        if weights.data_ptr() % 16:          # the kernel loads float4s
            weights = weights.clone()
        w_ptr = weights.data_ptr()
    mask = torch.empty_like(bases)
    pop = torch.empty((B, G), dtype=torch.int32, device=dev)
    accw = torch.empty((B, W), dtype=torch.float32, device=dev)
    live = (torch.empty((B, W * 32), dtype=torch.float32, device=dev)
            if emit_live else None)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.delta_apply_fused_launch(
            bases.data_ptr(), adds.data_ptr(), dels.data_ptr(), w_ptr,
            mask.data_ptr(), pop.data_ptr(), accw.data_ptr(),
            None if live is None else live.data_ptr(),
            B, K, W, block_w, _stream(bases))
    _build.check(lib, "delta_apply_fused", err)
    launches["delta_apply_fused"] += 1
    return mask, pop, accw, live


def delta_apply_fused(base: torch.Tensor, adds: torch.Tensor,
                      dels: torch.Tensor,
                      weights: torch.Tensor | None = None, *,
                      block_w: int = 1024, emit_live: bool = True) -> FusedOut:
    """Fused retrieval + analytics: land the K-delta chain over ``base``
    and, in the same pass over each bitmap group, emit per-group popcount
    partials, per-word weighted partials (``weights``, at most ``W*32``
    f32, e.g. per-slot PageRank contributions) and the unpacked live
    indicator that feeds the segment_sum kernel's per-node degree
    reduction.  ``pop`` covers ``ceil(W / block_w)`` groups; ``mask``,
    ``accw`` and ``live`` cover ``W`` words."""
    if not use_kernel(base, adds, dels, weights):
        return FusedOut(*delta_apply_fused_ref(
            base, adds, dels, weights, block_w=block_w, emit_live=emit_live))
    mask, pop, accw, live = _fused_kernel(base[None], adds[None], dels[None],
                                          weights, block_w, emit_live)
    return FusedOut(mask[0], pop[0], accw[0],
                    None if live is None else live[0])


def delta_apply_fused_batched(bases: torch.Tensor, adds: torch.Tensor,
                              dels: torch.Tensor,
                              weights: torch.Tensor | None = None, *,
                              block_w: int = 1024,
                              emit_live: bool = True) -> FusedOut:
    """Batched fused apply+analytics: ``bases [B, W]``, ``adds/dels
    [B, K, W]``, one shared ``weights`` — B chains land and emit their
    analytics partials in a single launch (B is the grid's second axis)."""
    if not use_kernel(bases, adds, dels, weights):
        return FusedOut(*delta_apply_fused_ref(
            bases, adds, dels, weights, block_w=block_w, emit_live=emit_live))
    return FusedOut(*_fused_kernel(bases, adds, dels, weights, block_w,
                                   emit_live))
