"""Public wrappers for delta-chain application + fused analytics, and for
building a chain's packed planes from its slot index lists.

Each wrapper dispatches by the device of its tensors
(:mod:`repro_torch.kernels.policy`): CPU tensors go to the plain versions
in ``ref.py``, CUDA tensors to the kernels in ``csrc/delta_apply.cu``
(built at first use).  Words are ``int32`` views of the packed ``uint32``
words.  Each launch adds one to its kernel's ``launch.<kernel>`` counter
(:mod:`repro_torch.obs`), where the kernel is launched and nowhere else.

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

from ... import obs
from ...transfer import to_host
from .. import _build
from ..policy import use_kernel
from .ref import (delta_apply_chain_ref, delta_apply_fused_ref, pad_weights,
                  plane_rows, planes_from_indices_ref)

KERNELS = ("delta_apply_chain", "delta_apply_fused", "planes_from_indices")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "delta_apply_chain_launch": [_P, _P, _P, _P, _I, _I, _L, _P],
    "delta_apply_fused_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _L, _I, _P],
    "delta_apply_fused_pair_launch": [*[_P] * 8, _L, *[_P] * 8, _L,
                                      _I, _I, _I, _P],
    "planes_from_indices_launch": [_P, _L, _P, _I, _P, _P, _P, _P, _L, _L,
                                   _P],
}
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _build.load("delta_apply", _SIGNATURES)
    return _lib


def _check_words(base, adds, dels) -> tuple[int, int, int]:
    """Validate ``base [B, W]`` and ``adds/dels [B, K, W]`` (or ``[W]`` and
    ``[K, W]``, B = 1) int32, contiguous, on one device; returns
    ``(B, K, W)``."""
    if not base.dtype == adds.dtype == dels.dtype == torch.int32:
        raise TypeError(f"words must be int32, got base {base.dtype}, adds "
                        f"{adds.dtype}, dels {dels.dtype}")
    if not (base.is_contiguous() and adds.is_contiguous()
            and dels.is_contiguous()):
        raise ValueError("base, adds and dels must be contiguous")
    if (adds.dim() not in (2, 3) or adds.shape != dels.shape
            or base.shape != adds.shape[:-2] + adds.shape[-1:]):
        raise ValueError(f"bad shapes base {tuple(base.shape)}, adds "
                         f"{tuple(adds.shape)}, dels {tuple(dels.shape)}")
    if not base.get_device() == adds.get_device() == dels.get_device():
        raise ValueError("base, adds and dels must lie on one device")
    K, W = adds.shape[-2:]
    return (adds.shape[0] if adds.dim() == 3 else 1), K, W


def _chain_kernel(bases, adds, dels) -> torch.Tensor:
    B, K, W = _check_words(bases, adds, dels)
    out = torch.empty_like(bases)
    if B and W:
        _build.launch(_load(), "delta_apply_chain_launch", bases,
                      bases.data_ptr(), adds.data_ptr(), dels.data_ptr(),
                      out.data_ptr(), B, K, W)
        obs.count("launch.delta_apply_chain")
    return out


def delta_apply_chain(base: torch.Tensor, adds: torch.Tensor,
                      dels: torch.Tensor) -> torch.Tensor:
    """Land a K-delta chain: ``base [W]``, ``adds/dels [K, W]`` -> ``[W]``."""
    if not use_kernel(base, adds, dels):
        return delta_apply_chain_ref(base, adds, dels)
    return _chain_kernel(base, adds, dels)


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


def delta_apply_chain_prefix(base: torch.Tensor, adds: torch.Tensor,
                             dels: torch.Tensor) -> torch.Tensor:
    """All K intermediate chain states ``[K, W]`` (``out[i]`` = state after
    delta ``i``) of ``base [W]``, ``adds/dels [K, W]``."""
    return delta_apply_chain_prefix_batched(base[None], adds[None],
                                            dels[None])[0]


def delta_apply_chain_prefix_batched(bases: torch.Tensor, adds: torch.Tensor,
                                     dels: torch.Tensor) -> torch.Tensor:
    """Prefix chains of B intervals: ``bases [B, W]``, ``adds/dels
    [B, K, W]`` -> ``[B, K, W]``, every prefix one timepoint's bitmap.

    The reference computes this with an XLA scan and no Pallas kernel
    (each word is written once per step either way, so there is nothing to
    fuse); here it is the same fold in plain PyTorch ops on the words'
    device, three elementwise launches per step, writing each state
    straight into its output row.  Bit-identical to the reference."""
    _check_words(bases, adds, dels)
    out = torch.empty_like(adds)
    state = bases
    for i in range(adds.shape[1]):
        state = torch.bitwise_or(state & ~dels[:, i], adds[:, i],
                                 out=out[:, i])
    return out


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
        return to_host(self.pop.to(torch.int64).sum(-1))

    def weighted_total(self):
        """Σ weights over live slots, f32 (PageRank push mass), summed on
        the host in the reference's order."""
        return to_host(self.accw).sum(axis=-1, dtype=np.float32)


def _fused_plane(bases, adds, dels, weights, block_w, emit_live):
    """Checked inputs and new outputs of one plane for the fused kernel:
    ``(B, K, W, outputs, pointers, weights)``, the pointers in the launch
    functions' order (base, adds, dels, weights, mask, pop, accw, live).
    The caller holds the padded ``weights`` until the launch is enqueued,
    so that the allocator cannot hand its memory out before."""
    B, K, W = _check_words(bases, adds, dels)
    if block_w < 1:
        raise ValueError(f"block_w must be positive, got {block_w}")
    w_ptr = None
    if weights is not None:
        if not (weights.dtype == torch.float32 and weights.dim() == 1
                and weights.shape[0] == 32 * W and weights.is_contiguous()
                and weights.get_device() == bases.get_device()):
            weights = pad_weights(weights.to(bases.device), W)
        if weights.data_ptr() % 16:          # the kernel loads float4s
            weights = weights.clone()
        w_ptr = weights.data_ptr()
    lead = bases.shape[:-1]
    mask = torch.empty_like(bases)
    pop = bases.new_empty((*lead, -(-W // block_w)))
    accw = torch.empty_like(bases, dtype=torch.float32)
    live = (accw.new_empty((*lead, W * 32)) if emit_live else None)
    ptrs = (bases.data_ptr(), adds.data_ptr(), dels.data_ptr(), w_ptr,
            mask.data_ptr(), pop.data_ptr(), accw.data_ptr(),
            None if live is None else live.data_ptr())
    return B, K, W, (mask, pop, accw, live), ptrs, weights


def _fused_kernel(bases, adds, dels, weights, block_w, emit_live):
    B, K, W, outs, ptrs, weights = _fused_plane(bases, adds, dels, weights,
                                                block_w, emit_live)
    if B and W:
        _build.launch(_load(), "delta_apply_fused_launch", bases, *ptrs,
                      B, K, W, block_w)
        obs.count("launch.delta_apply_fused")
    return outs


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
    return FusedOut(*_fused_kernel(base, adds, dels, weights, block_w,
                                   emit_live))


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


def delta_apply_fused_pair(base_n: torch.Tensor, adds_n: torch.Tensor,
                           dels_n: torch.Tensor, base_e: torch.Tensor,
                           adds_e: torch.Tensor, dels_e: torch.Tensor,
                           weights_n: torch.Tensor | None = None,
                           weights_e: torch.Tensor | None = None, *,
                           block_w: int = 1024, emit_live: bool = True
                           ) -> tuple[FusedOut, FusedOut]:
    """Both planes of a singlepoint retrieval in one launch: the node plane
    ``base_n [W_n]``, ``adds_n/dels_n [K, W_n]`` with optional per-slot
    ``weights_n``, and the edge plane over ``W_e`` words (same ``K``) ->
    ``(node, edge)`` :class:`FusedOut`, the same as two
    :func:`delta_apply_fused` calls."""
    with obs.span("launch.delta_apply_fused", K=adds_n.shape[-2],
                  W_n=base_n.shape[-1], W_e=base_e.shape[-1],
                  weights_n=0 if weights_n is None else weights_n.numel(),
                  weights_e=0 if weights_e is None else weights_e.numel(),
                  live=emit_live):
        return _fused_pair(base_n, adds_n, dels_n, base_e, adds_e, dels_e,
                           weights_n, weights_e, block_w, emit_live)


def _fused_pair(base_n, adds_n, dels_n, base_e, adds_e, dels_e, weights_n,
                weights_e, block_w, emit_live) -> tuple[FusedOut, FusedOut]:
    if not use_kernel(base_n, adds_n, dels_n, weights_n, base_e, adds_e,
                      dels_e, weights_e):
        return tuple(FusedOut(*delta_apply_fused_ref(
            b, a, d, w, block_w=block_w, emit_live=emit_live))
            for b, a, d, w in ((base_n, adds_n, dels_n, weights_n),
                               (base_e, adds_e, dels_e, weights_e)))
    if base_n.dim() != 1 or base_e.dim() != 1:
        raise ValueError("delta_apply_fused_pair takes unbatched planes")
    _, K, W_n, outs_n, ptrs_n, weights_n = _fused_plane(
        base_n, adds_n, dels_n, weights_n, block_w, emit_live)
    _, K_e, W_e, outs_e, ptrs_e, weights_e = _fused_plane(
        base_e, adds_e, dels_e, weights_e, block_w, emit_live)
    if K_e != K:
        raise ValueError(f"node plane has K={K}, edge plane K={K_e}")
    if base_n.get_device() != base_e.get_device():
        raise ValueError("node and edge planes must lie on one device")
    if W_n or W_e:
        _build.launch(_load(), "delta_apply_fused_pair_launch", base_n,
                      *ptrs_n, W_n, *ptrs_e, W_e, 1, K, block_w)
        obs.count("launch.delta_apply_fused")
    return FusedOut(*outs_n), FusedOut(*outs_e)


# ---------------------------------------------------------------------------
# index lists -> packed planes
# ---------------------------------------------------------------------------


def planes_from_indices(indices: torch.Tensor, offsets: torch.Tensor,
                        rows: int, W_n: int, W_e: int
                        ) -> tuple[torch.Tensor, ...]:
    """A chain's four stacks of packed planes from its slot index lists:
    ``indices`` concatenates 4·K lists, row ``r`` being
    ``indices[offsets[r]:offsets[r + 1]]`` (``offsets``: 4K + 1 entries),
    and row ``r = p·K + k`` sets its bits in row ``k`` of plane ``p``.
    Returns ``(node adds, node dels, edge adds, edge dels)``, int32 words
    ``[rows, W_n]`` twice and ``[rows, W_e]`` twice, zero wherever no index
    sets a bit (every row past K), as ``core.bitmaps.np_from_indices``
    packs each list.

    CPU tensors (int32 or int64) run the plain version, which refuses an
    index outside ``[0, 32·W)`` with ``IndexError``; CUDA tensors (int32)
    one launch of ``planes_from_indices_kernel`` over one zeroed buffer
    that the four stacks view (none when there is no index), which drops
    such an index: check the lists before they are staged, as
    ``runtime.torch_exec`` does on the host."""
    K = plane_rows(offsets)
    with obs.span("launch.planes_from_indices", K=K, rows=rows, W_n=W_n,
                  W_e=W_e, indices=indices.numel()):
        if not use_kernel(indices, offsets):
            return planes_from_indices_ref(indices, offsets, rows, W_n, W_e)
        return _planes_kernel(indices, offsets, K, rows, W_n, W_e)


def _planes_kernel(indices, offsets, K, rows, W_n, W_e):
    if not indices.dtype == offsets.dtype == torch.int32:
        raise TypeError(f"the kernel takes int32 indices and offsets, got "
                        f"{indices.dtype} and {offsets.dtype}")
    if indices.dim() != 1 or not (indices.is_contiguous()
                                  and offsets.is_contiguous()):
        raise ValueError("indices and offsets must be contiguous vectors")
    if indices.get_device() != offsets.get_device():
        raise ValueError("indices and offsets must lie on one device")
    if rows < K:
        raise ValueError(f"{rows} rows cannot hold {K} chain steps")
    words = torch.zeros(2 * rows * (W_n + W_e), dtype=torch.int32,
                        device=indices.device)
    n_words, e_words = rows * W_n, rows * W_e
    planes = (words[:n_words].view(rows, W_n),
              words[n_words:2 * n_words].view(rows, W_n),
              words[2 * n_words:2 * n_words + e_words].view(rows, W_e),
              words[2 * n_words + e_words:].view(rows, W_e))
    n = indices.numel()
    if n and K:
        _build.launch(_load(), "planes_from_indices_launch", indices,
                      indices.data_ptr(), n, offsets.data_ptr(), K,
                      *(p.data_ptr() for p in planes), W_n, W_e)
        obs.count("launch.planes_from_indices")
    return planes
