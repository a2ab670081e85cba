"""The yardstick for kernel rooflines: the card's published peaks and the
least work a kernel's problem needs, counted from what the caller hands
the kernel, whatever implements it.

Each input is read once and each output written once; the least time is
the larger of bytes over the memory rate and operations over their peak.
This reproduces the kernel table's bound for the fused kernel at K 16,
W 2^21 with a weight a slot and the live indicator: 0.2479 ms.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM data sheet, 80 GB HBM3
INT32_OPS_PER_S = 67e12     # the same sheet's 32-bit rate outside tensor cores
WORD_BYTES = 4
BLOCK_W = 1024              # words of one popcount group (the wrapper's default)


def least_s(nbytes: float, ops: float) -> float:
    """Seconds the card needs at least for ``nbytes`` moved and ``ops``
    done."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def fused_plane_work(K: int, W: int, weights: int, live: bool
                     ) -> tuple[float, float]:
    """One plane of ``delta_apply_fused``: the base and 2K planes of W
    words and ``weights`` f32 weights read; the landed words, one popcount
    a group of ``BLOCK_W`` words, a weighted partial a word and (``live``)
    the unpacked f32 indicator of its 32·W slots written.  Operations: an
    and-not and an or a word a step with the step's load, and a multiply
    and an add a weighted slot."""
    nbytes = ((2 * K + 1) * W + W + -(-W // BLOCK_W) + W + weights) * WORD_BYTES
    if live:
        nbytes += 32 * W * WORD_BYTES
    return nbytes, 3.0 * K * W + 2.0 * weights
