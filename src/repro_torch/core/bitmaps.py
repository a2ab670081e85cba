"""Packed-bitmap primitives (the paper's per-element ``BM`` strings, §6).

Membership sets over a dense slot universe are stored as packed 32-bit
words, little-endian bit order: element ``i`` lives at bit ``i & 31`` of word
``i >> 5``.  Construction-time code paths use the numpy variants (``uint32``
words); query-time code uses the torch variants and, for the hot path, the
CUDA kernels in ``repro_torch.kernels.delta_apply``.

Torch words are ``int32`` views of the ``uint32`` words
(``ndarray.view(np.int32)`` <-> ``torch.from_numpy``): torch's ``uint32`` has
no ``~``, ``>>`` or ``index_put``.  ``&``, ``|`` and ``~`` on the views are
bit-identical; an arithmetic ``>>`` followed by ``& 1`` still extracts bit
``j``; popcounts and packing go through ``int64``.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def num_words(universe_size: int) -> int:
    return (int(universe_size) + WORD_BITS - 1) // WORD_BITS


# ---------------------------------------------------------------------------
# numpy variants (construction / host-side)
# ---------------------------------------------------------------------------

def np_pack(mask: np.ndarray) -> np.ndarray:
    """bool[U] -> uint32[W]."""
    mask = np.asarray(mask, dtype=bool)
    u8 = np.packbits(mask, bitorder="little")
    pad = (-u8.size) % 4
    if pad:
        u8 = np.concatenate([u8, np.zeros(pad, np.uint8)])
    return u8.view(np.uint32)


def np_unpack(words: np.ndarray, universe_size: int) -> np.ndarray:
    """uint32[W] -> bool[U]."""
    u8 = np.asarray(words, dtype=np.uint32).view(np.uint8)
    bits = np.unpackbits(u8, bitorder="little")
    return bits[:universe_size].astype(bool)


def np_from_indices(idx: np.ndarray, universe_size: int) -> np.ndarray:
    """Sorted-or-not unique indices -> packed uint32[W]."""
    words = np.zeros(num_words(universe_size), np.uint32)
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size:
        np.bitwise_or.at(words, idx >> 5, (np.uint32(1) << (idx & 31).astype(np.uint32)))
    return words


def np_to_indices(words: np.ndarray, universe_size: int) -> np.ndarray:
    return np.nonzero(np_unpack(words, universe_size))[0].astype(np.int32)


def np_popcount(words: np.ndarray) -> int:
    return int(np.bitwise_count(np.asarray(words, np.uint32)).sum())


def np_fit_words(words: np.ndarray, W: int) -> np.ndarray:
    """Pad/trim packed words to width ``W`` (live updates grow slot
    universes past older states/planes, §6 — one shared invariant for the
    pool, the device executors, and anything else holding packed rows)."""
    words = np.asarray(words, np.uint32)
    if words.size < W:
        return np.concatenate([words, np.zeros(W - words.size, np.uint32)])
    return words[:W]


# ---------------------------------------------------------------------------
# torch -> numpy word view (numpy -> torch: ``runtime.staging.host_tensor``)
# ---------------------------------------------------------------------------

def to_numpy_words(words: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 words (same bits), on the host."""
    return words.detach().cpu().numpy().view(np.uint32)


def _words_from_int64(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> their int32 two's-complement view."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


# ---------------------------------------------------------------------------
# torch variants (query time)
# ---------------------------------------------------------------------------

def from_indices(idx: torch.Tensor, universe_size: int) -> torch.Tensor:
    """Unique element indices -> packed int32 words.  Valid because every
    (word, bit) pair is distinct, so scatter-add == scatter-or.  Negative
    indices (used as padding) are dropped."""
    W = num_words(universe_size)
    idx = idx.to(torch.int64)
    idx = idx[idx >= 0]
    words = torch.zeros(W, dtype=torch.int64, device=idx.device)
    words.index_add_(0, idx >> 5, torch.ones_like(idx) << (idx & 31))
    return _words_from_int64(words)


def unpack(words: torch.Tensor, universe_size: int) -> torch.Tensor:
    W = words.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts[None, :]) & 1
    return bits.reshape(W * 32)[:universe_size].to(torch.bool)


def pack(mask: torch.Tensor) -> torch.Tensor:
    U = mask.shape[0]
    W = num_words(U)
    padded = torch.zeros(W * 32, dtype=torch.int64, device=mask.device)
    padded[:U] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return _words_from_int64((padded.reshape(W, 32) << shifts[None, :]).sum(1))


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount (SWAR in int64), same shape as ``words``."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(words: torch.Tensor) -> torch.Tensor:
    return popcount_words(words).sum()


def apply_delta(base: torch.Tensor, adds: torch.Tensor,
                dels: torch.Tensor) -> torch.Tensor:
    """One delta step: (base & ~dels) | adds, all packed words."""
    return (base & ~dels) | adds


def apply_delta_chain(base: torch.Tensor, adds: torch.Tensor,
                      dels: torch.Tensor) -> torch.Tensor:
    """Sequentially apply K deltas stacked as [K, W] (plain reference for
    the delta-apply kernels)."""
    m = base
    for a, d in zip(adds, dels):
        m = (m & ~d) | a
    return m
