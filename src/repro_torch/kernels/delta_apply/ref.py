"""Plain PyTorch versions of the delta-apply kernels.

Semantics (DeltaGraph path application, §4.3): starting from the packed
base membership bitmap, apply K (add, del) bitmap pairs in order::

    m_0 = base
    m_i = (m_{i-1} & ~del_i) | add_i
    out = m_K

Words are ``int32`` views of the packed ``uint32`` words; ``adds``/``dels``
are stacked ``[..., K, W]`` over ``base [..., W]`` (a leading batch axis is
allowed).  These run on CPU tensors (the wrappers in ``ops.py`` send CPU
inputs here) and are what the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.bitmaps import popcount_words


def delta_apply_chain_ref(base: torch.Tensor, adds: torch.Tensor,
                          dels: torch.Tensor) -> torch.Tensor:
    m = base.clone()
    for i in range(adds.shape[-2]):
        m = (m & ~dels[..., i, :]) | adds[..., i, :]
    return m


def pad_weights(weights: torch.Tensor, W: int) -> torch.Tensor:
    """Per-slot weights zero-padded (or cut) to ``32 * W`` floats, f32 and
    contiguous — as the reference pads them with the words."""
    weights = weights.reshape(-1).to(torch.float32)
    n = 32 * W
    if weights.numel() >= n:
        return weights[:n].contiguous()
    return F.pad(weights, (0, n - weights.numel()))


def delta_apply_fused_ref(base: torch.Tensor, adds: torch.Tensor,
                          dels: torch.Tensor,
                          weights: torch.Tensor | None = None, *,
                          block_w: int = 1024, emit_live: bool = True):
    """Plain version of the fused chain + analytics kernel.

    ``base [..., W]``, ``adds/dels [..., K, W]`` int32 words, optional
    per-slot ``weights`` (at most ``32 * W`` floats, shared by the batch).
    ``W`` is padded to a ``block_w`` multiple exactly as the JAX package's
    ``ops.py::_fused_pad`` does, so the per-group partials line up.
    Returns

    * ``mask [..., W] int32``    — the landed chain state,
    * ``pop  [..., G] int32``    — per-``block_w``-group popcounts,
      ``G = ceil(W / block_w)``,
    * ``accw [..., W] f32``      — per-word weighted partials: bit ``j``
      times weight ``32w + j``, summed one term at a time for ``j = 0..31``
      (the reference's order, so the f32 partials are bit-identical); the
      plain per-word popcount when there are no weights,
    * ``live [..., 32W] f32``    — the unpacked membership indicator, or
      ``None`` unless ``emit_live``.
    """
    m = delta_apply_chain_ref(base, adds, dels)
    W = m.shape[-1]
    Wp = -(-W // block_w) * block_w
    mp = F.pad(m, (0, Wp - W))
    lead = mp.shape[:-1]
    pop = (popcount_words(mp).reshape(*lead, Wp // block_w, block_w)
           .sum(-1).to(torch.int32))
    shifts = torch.arange(32, dtype=torch.int32, device=m.device)
    bits = ((m[..., None] >> shifts) & 1).to(torch.float32)    # [..., W, 32]
    if weights is not None:
        w = pad_weights(weights, W).reshape(W, 32)
        accw = torch.zeros(m.shape, dtype=torch.float32, device=m.device)
        for j in range(32):
            accw = accw + bits[..., j] * w[:, j]
    else:
        accw = bits.sum(-1)          # integer-valued: exact in any order
    live = bits.reshape(*lead, W * 32) if emit_live else None
    return m, pop, accw, live


def plane_rows(offsets: torch.Tensor) -> int:
    """K, the chain steps of an offsets array over the 4·K rows of
    :func:`planes_from_indices_ref` (``4K + 1`` entries)."""
    n = offsets.numel()
    if offsets.dim() != 1 or n % 4 != 1:
        raise ValueError(f"offsets must hold 4K + 1 entries, got shape "
                         f"{tuple(offsets.shape)}")
    return (n - 1) // 4


def planes_from_indices_ref(indices: torch.Tensor, offsets: torch.Tensor,
                            rows: int, W_n: int, W_e: int):
    """Plain version of the index-lists-to-planes kernel.

    ``indices`` (int32 or int64) is the concatenation of 4·K slot index
    lists, row ``r`` being ``indices[offsets[r]:offsets[r + 1]]``; row
    ``r = p·K + k`` sets its bits in row ``k`` of plane ``p``: node adds,
    node dels (``[rows, W_n]``), edge adds, edge dels (``[rows, W_e]``),
    all int32 words, zero elsewhere (rows past K too).  The same words
    as ``core.bitmaps.np_from_indices`` of each list; duplicates and any
    order are allowed.  An index outside ``[0, 32·W)`` raises
    ``IndexError``."""
    K = plane_rows(offsets)
    if rows < K:
        raise ValueError(f"{rows} rows cannot hold {K} chain steps")
    dev = indices.device
    offs = offsets.to(torch.int64)
    idx = indices.to(torch.int64)
    row = torch.repeat_interleave(torch.arange(4 * K, device=dev),
                                  offs[1:] - offs[:-1])
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    out = []
    for p, W in enumerate((W_n, W_n, W_e, W_e)):
        sel = (row >= p * K) & (row < (p + 1) * K)
        ix, step = idx[sel], row[sel] - p * K
        if ix.numel() and not (0 <= int(ix.min()) and int(ix.max()) < 32 * W):
            raise IndexError(f"slot index outside [0, {32 * W}) in plane {p}")
        bits = torch.zeros(rows * W * 32, dtype=torch.bool, device=dev)
        bits[step * (32 * W) + ix] = True
        octets = (bits.view(-1, 8).to(torch.uint8) << shifts).sum(
            -1, dtype=torch.uint8)
        out.append(octets.view(rows, 4 * W).view(torch.int32))
    return tuple(out)
