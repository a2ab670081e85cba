"""Public attention wrapper.

:func:`attention` keeps the JAX package's signature
(``repro/kernels/flash_attention/ops.py::attention``) without ``impl``:
it dispatches by the device of its tensors
(:mod:`repro_torch.kernels.policy`).  CPU tensors go to the plain version
in ``ref.py``.  CUDA tensors go to one of three hand-written kernels,
built at first use, by a rule on the call's shape and dtype
(:func:`route`; never as a fallback when one fails): calls with few query
rows per KV head (:func:`decode_shape`: decode) to the split-K kernel of
``csrc/flash_decode.cu``; other bf16 calls, at any head dim up to 256, to
the wgmma/TMA kernel of ``csrc/flash_prefill.cu``; other f32 calls to the
TF32 tensor-core kernel of ``csrc/flash_prefill_f32.cu``; bf16 calls with
a head dim past 256 (MLA's absorbed decode, D = 576, Dv = 512) to the
wgmma/TMA kernel of ``csrc/flash_mla_wgmma.cu``, whose key splits merge in
a thread block cluster.  Both prefill kernels are instantiated
at a few head dims and run the smallest that holds the call's
(:func:`prefill_dims`); TMA zero-fills the columns past the real dims, so
nothing is padded on the host.  ``csrc/flash_attention.cu`` and
``csrc/flash_mla.cu``, the first designs, are no route of
:func:`attention`: :func:`_attention_mma`, :func:`_attention_simt` and
:func:`_mla_mma` keep their kernels callable as yardsticks.
Launches are counted where they are made and nowhere else, each in the
``launch.<kernel>`` counter of :mod:`repro_torch.obs` (:data:`KERNELS`):
``flash_attention`` every kernel call of :func:`attention`,
``flash_attention_prefill``, ``flash_attention_prefill_f32``,
``flash_attention_decode`` and ``flash_attention_mla`` those that took
each kernel, and ``flash_attention_prefill_stats`` /
``flash_attention_prefill_f32_stats`` those of the prefill kernels that
also wrote the rows' statistics.

``meta`` tensors (a shape-only trace: the dry run,
``repro_torch.launch.op_analysis``) take neither: :func:`_attention_meta`
checks the call as :func:`kernel_args` does, picks the kernel
:func:`route` would launch on the card (the prefill kernel of the dtype
for :func:`attention_stats`), returns empty outputs of its shapes and
dtypes and reports its work (:func:`~repro_torch.kernels.policy.
report_meta_work`: 2·(D + Dv) operations per unmasked (query, key) pair;
q, the outputs and the visible K and V, MLA's K alone, once).  No plan
that needs a card is made, and no launch is counted.

Training: when autograd records, :func:`attention` goes through
:class:`FlashAttention`, the port of the reference's ``custom_vjp``: its
forward :func:`attention_stats` (a prefill launch with the statistics
output on CUDA tensors), its backward :func:`attention_bwd` (the
reference's chunked recompute, torch ops on either device; the reference
has no backward kernel).

GQA is not broadcast here: the kernel reads KV head ``h // (Hq / Hkv)``
itself.  Inputs may be strided views (a transposed projection, a slice of
a cache): :func:`kernel_args` says which are passed as they are.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ... import obs
from .. import _build
from ..policy import on_meta, report_meta_work, use_kernel
from .ref import attention_ref, attention_ref_stats

KERNELS = ("flash_attention", "flash_attention_prefill",
           "flash_attention_prefill_f32", "flash_attention_decode",
           "flash_attention_mla", "flash_attention_prefill_stats",
           "flash_attention_prefill_f32_stats")

# The backward's key chunk: the reference's ``block_k``
# (``repro/kernels/flash_attention/ops.py::_chunked_gqa_attention``).
BWD_BLOCK_K = 512

MAX_HEAD_DIM = 256          # the kernel keeps a row's Dv outputs in registers
# The MLA kernels, bf16 only, blocks of 64 query rows (heads x Sq) of one KV
# head.  Their head dims: D = kv_lora + qk_rope = 576 at most, Dv = 512.
# f32 calls past 256 have no kernel: deepseek-v3's f32 weights would not
# fit one card at any depth that runs its MoE layers.
MLA_MAX_D, MLA_MAX_DV = 576, 512
MLA_ROWS = 64
# The route's kernel (csrc/flash_mla_wgmma.cu): 64-key K tiles when v is
# k's first Dv columns (V read from the K tile), 32-key K and V tiles when
# v is a tensor of its own (kBN); the key splits of a row block form one
# thread block cluster, at most MLA_MAX_CLUSTER blocks (the portable
# size), each at least DECODE_MIN_TILES tiles.
MLA_BLOCK_N, MLA_BLOCK_N_V = 64, 32
MLA_MAX_CLUSTER = 8
_MAX_GRID_Y = 65535         # B·Hq blocks on the grid's second axis
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The split-K decode kernel (csrc/flash_decode.cu).  A lane holds 8 elements
# of q and of the f32 accumulator for each of the block's G·Sq rows in
# registers, beside 32 partial scores: ptxas gives 216 registers a thread at
# 8 rows (128 at 4), and 16 rows would take 256 for q and acc alone, past
# the 255 a thread has.  So DECODE_MAX_ROWS = 8.
DECODE_MAX_ROWS = 8
DECODE_TILE = 32            # keys per tile (kTile)
DECODE_MIN_TILES = 2        # a split reads at least this many tiles
DECODE_BLOCKS_PER_SM = 2    # 96 KB of bf16 K/V ring each at D = Dv = 256

# The bf16 prefill kernel (csrc/flash_prefill.cu): blocks of 128 query rows,
# two consumer warpgroups of 64 rows each, over 64-key tiles.  Its (D, Dv)
# instantiations, cheapest first; a call runs the first that holds its dims
# (:func:`prefill_dims`).
PREFILL_WG_ROWS = 64        # kWgRows
PREFILL_BLOCK_N = 64        # kBN
PREFILL_DIMS = ((64, 64), (128, 128), (192, 128), (192, 192), (256, 256))
# The f32 prefill kernel (csrc/flash_prefill_f32.cu): blocks of eight
# consumer warps of 16 query rows each, over 32-key tiles; its
# instantiations.
PREFILL_F32_WARP_ROWS = 16  # kWarpRows
PREFILL_F32_BLOCK_N = 32    # kBN
PREFILL_F32_DIMS = ((64, 64), (128, 128), (256, 256))

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {"flash_attention_launch": [_P, _P, _P, _P, *[_L] * 12,
                                          *[_I] * 10, _F, _I, _P]}
# the two prefill kernels, by dtype: source, launch counter, instantiations
# (both launch functions take the same arguments)
_PREFILL = {torch.bfloat16: ("flash_prefill", "flash_attention_prefill",
                             PREFILL_DIMS),
            torch.float32: ("flash_prefill_f32", "flash_attention_prefill_f32",
                            PREFILL_F32_DIMS)}
_PREFILL_ARGS = [_P, _P, _P, _P, *[_L] * 12, *[_I] * 12, _F, _P, _P, _P]
_DECODE_SIGNATURES = {"flash_decode_launch": [*[_P] * 6, *[_L] * 12,
                                              *[_I] * 10, _F, *[_I] * 5, _P]}
_MLA_SIGNATURES = {"flash_mla_launch": [*[_P] * 6, *[_L] * 12, *[_I] * 10,
                                        _F, *[_I] * 5, _P]}
_MLA_WGMMA_SIGNATURES = {
    "flash_mla_wgmma_launch": [*[_P] * 4, *[_L] * 12, *[_I] * 10, _F,
                               *[_I] * 5, _P],
    "flash_mla_wgmma_max_clusters": [_I, _I, ctypes.POINTER(ctypes.c_int)]}
_max_clusters: dict[tuple[int, int, bool], int] = {}   # (device, n, v_in_k)


class SplitPlan(NamedTuple):
    """The visible keys ``[lo, hi)`` of a call cut into ``n_splits``
    chunks of at most ``tiles`` key tiles of ``block_n`` keys (the
    kernel's tile: :data:`DECODE_TILE`, or :func:`mla_block_n` for
    ``flash_mla_wgmma.cu``), inner boundaries on tile multiples."""
    lo: int
    hi: int
    tiles: int
    n_splits: int
    block_n: int = DECODE_TILE

    def bounds(self) -> list[tuple[int, int]]:
        """``(begin, end)`` of each split, as the kernel computes them."""
        n, t0 = self.block_n, self.lo // self.block_n
        return [(max(self.lo, (t0 + s * self.tiles) * n),
                 min(self.hi, (t0 + (s + 1) * self.tiles) * n))
                for s in range(self.n_splits)]


def decode_shape(Sq: int, Hq: int, Hkv: int, D: int, Dv: int) -> bool:
    """True for calls the split-K decode kernel takes: at most
    :data:`DECODE_MAX_ROWS` query rows per KV head (``Sq · Hq / Hkv``) and
    head dims up to :data:`MAX_HEAD_DIM`."""
    return (Hkv > 0 and Hq % Hkv == 0 and 1 <= Sq * (Hq // Hkv) <=
            DECODE_MAX_ROWS and D <= MAX_HEAD_DIM and Dv <= MAX_HEAD_DIM)


def route(Sq: int, Hq: int, Hkv: int, D: int, Dv: int,
          dtype: torch.dtype) -> str:
    """The source whose kernel :func:`attention` launches for a call:
    ``flash_mla`` for bf16 calls with a head dim past
    :data:`MAX_HEAD_DIM` (D up to :data:`MLA_MAX_D`, Dv up to
    :data:`MLA_MAX_DV`, any Sq); otherwise ``flash_decode`` for
    :func:`decode_shape`, else the prefill kernel of the dtype
    (``flash_prefill`` in bf16, ``flash_prefill_f32`` in f32) at any head
    dims from 1 to :data:`MAX_HEAD_DIM`; raises ``ValueError`` for any
    other call (f32 past 256 included)."""
    if (dtype == torch.bfloat16 and max(D, Dv) > MAX_HEAD_DIM and
            0 < D <= MLA_MAX_D and 0 < Dv <= MLA_MAX_DV):
        return "flash_mla"
    if not (dtype in _PREFILL and 0 < D <= MAX_HEAD_DIM and
            0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"no attention kernel takes {dtype} at D={D}, "
                         f"Dv={Dv}")
    return ("flash_decode" if decode_shape(Sq, Hq, Hkv, D, Dv) else
            _PREFILL[dtype][0])


def prefill_dims(D: int, Dv: int, dims=PREFILL_DIMS) -> tuple[int, int]:
    """The instantiation a ``(D, Dv)`` call runs: the first of ``dims``
    (:data:`PREFILL_DIMS`, or :data:`PREFILL_F32_DIMS` for the f32 kernel)
    that holds both.  The kernel reads the real dims and finds zeros past
    them (TMA's fill), which change no score and add nothing to p·v."""
    return next(d for d in dims if d[0] >= D and d[1] >= Dv)


class PrefillTiles(NamedTuple):
    """The key tiles ``[first, end)`` that a query tile's real rows see, and
    for each of them whether the kernel masks it (``masked[i]`` for tile
    ``first + i``)."""
    first: int
    end: int
    masked: tuple[bool, ...]


def prefill_tile_plan(Sq: int, Sk: int, *, causal: bool, window: int | None,
                      q_offset: int, block_m: int = PREFILL_WG_ROWS,
                      block_n: int = PREFILL_BLOCK_N) -> list[PrefillTiles]:
    """What ``flash_prefill.cu`` visits (``key_tiles``, ``tile_masked``),
    for each tile of ``block_m`` query rows: keys ``[begin, end)`` that its
    rows (``qpos`` in ``[qlo, qhi]``) can see, cut into tiles of
    ``block_n`` keys; a tile is masked when it runs past Sk, past the
    first row's causal diagonal or past the last row's window, and
    interior otherwise.  Tiles outside ``[first, end)`` are not visited."""
    plans = []
    for r0 in range(0, Sq, block_m):
        qlo, qhi = r0 + q_offset, min(r0 + block_m, Sq) - 1 + q_offset
        begin = 0 if window is None else max(0, qlo - window + 1)
        end = min(Sk, qhi + 1) if causal else Sk
        if end <= begin:
            plans.append(PrefillTiles(0, 0, ()))
            continue
        first, stop = begin // block_n, -(-end // block_n)
        plans.append(PrefillTiles(first, stop, tuple(
            (t + 1) * block_n > Sk or (causal and (t + 1) * block_n - 1 > qlo)
            or (window is not None and qhi - t * block_n >= window)
            for t in range(first, stop))))
    return plans


def visible_pairs(Sq: int, Sk: int, *, causal: bool, window: int | None,
                  q_offset: int) -> tuple[int, int, int]:
    """``(pairs, lo, hi)``: the unmasked (query, key) pairs of the Sq rows
    from ``q_offset``, and ``[lo, hi)``, the first and one-past-last key
    that any of them sees (``(0, 0, 0)`` when none sees a key).

    Row ``q`` sees keys ``[a(q), b(q))``, ``a = max(0, q - window + 1)``
    (0 without a window) and ``b = min(Sk, q + 1)`` (Sk without causal).
    Both grow with q, so the rows that see a key are one run ``[s, e)``
    and ``lo, hi = a(s), b(e - 1)``; the pairs are sums of clamped ramps,
    in closed form."""
    s, e = q_offset, q_offset + Sq
    if causal:
        s = max(s, 0)
    if window is not None:
        e = min(e, Sk + window - 1)
    if Sk <= 0 or e <= s:
        return 0, 0, 0

    def ramp(c: int) -> int:
        """The sum of ``min(Sk, max(0, q + c))`` over q in ``[s, e)``."""
        def below(t: int) -> int:         # the sum over x in [0, t)
            t = max(t, 0)
            m = min(t, Sk)
            return m * (m - 1) // 2 + (t - m) * Sk
        return below(e + c) - below(s + c)

    b = ramp(1) if causal else Sk * (e - s)
    a = 0 if window is None else ramp(1 - window)
    lo = 0 if window is None else max(0, s - window + 1)
    return b - a, lo, min(Sk, e) if causal else Sk


def plan_splits(Sq: int, Sk: int, *, causal: bool, window: int | None,
                q_offset: int, blocks: int, n_sm: int) -> SplitPlan:
    """Cut the call's visible keys so that ``blocks · n_splits`` (blocks =
    B · Hkv) gives each of ``n_sm`` SMs about :data:`DECODE_BLOCKS_PER_SM`
    blocks, each split reading at least :data:`DECODE_MIN_TILES` tiles.  A
    call that sees no key gets one empty split."""
    want = max(1, -(-DECODE_BLOCKS_PER_SM * n_sm // max(blocks, 1)))
    return _cut_keys(Sq, Sk, causal, window, q_offset, want)


def plan_mla_splits(Sq: int, Sk: int, *, causal: bool, window: int | None,
                    q_offset: int, blocks: int, n_sm: int) -> SplitPlan:
    """The split plan of ``flash_mla.cu``: one block fills an SM (its
    shared memory), so ``blocks · n_splits`` (blocks = B · Hkv · row
    blocks of :data:`MLA_ROWS`) stays within one wave of ``n_sm`` blocks
    where it can: ``n_sm // blocks`` splits, each at least
    :data:`DECODE_MIN_TILES` tiles of :data:`DECODE_TILE` keys."""
    return _cut_keys(Sq, Sk, causal, window, q_offset,
                     max(1, n_sm // max(blocks, 1)))


def mla_block_n(v_in_k: bool) -> int:
    """Keys a tile of ``flash_mla_wgmma.cu``'s instantiation for the call:
    64 when v is k's first columns, 32 with a V ring of its own."""
    return MLA_BLOCK_N if v_in_k else MLA_BLOCK_N_V


def mla_smem_bytes(v_in_k: bool) -> int:
    """Shared memory of a ``flash_mla_wgmma.cu`` block (``Smem::kBytes``):
    Q's 64 x 576 bf16 tile, a 2-stage ring of K tiles (and of V tiles of
    512 columns when v is a tensor of its own), P_hi (and P_lo, which
    otherwise lives in the K tile's RoPE chunk) as 64 x 64 bf16, the row
    statistics (m and the rescale factor, 2 x 2 x 64 f32), 4 mbarriers
    and 1,024 bytes to align the base to the swizzle atom."""
    n = mla_block_n(v_in_k)
    k = n * MLA_MAX_D
    v = 0 if v_in_k else n * MLA_MAX_DV
    p = MLA_ROWS * 64 * (1 if v_in_k else 2)
    stats, bars = 2 * 2 * MLA_ROWS * 4, 4 * 8
    return 1024 + 2 * (MLA_ROWS * MLA_MAX_D + 2 * (k + v) + p) + stats + bars


def plan_mla_wgmma_splits(Sq: int, Sk: int, *, causal: bool,
                          window: int | None, q_offset: int, blocks: int,
                          block_n: int, max_clusters) -> SplitPlan:
    """The split plan of ``flash_mla_wgmma.cu``.  One block fills an SM (its
    shared memory) and a row block's splits form one cluster, so the
    cluster size is the largest ``n <= MLA_MAX_CLUSTER`` at which all
    ``blocks`` clusters (blocks = B · Hkv · row blocks of
    :data:`MLA_ROWS`) are resident at once, ``max_clusters(n) >= blocks``
    (``max_clusters`` is what ``cudaOccupancyMaxActiveClusters`` reports
    for the card), and 1 when none is; the visible keys are cut into that
    many runs of whole ``block_n``-key tiles, each at least
    :data:`DECODE_MIN_TILES` tiles."""
    want = next((n for n in range(MLA_MAX_CLUSTER, 1, -1)
                 if max_clusters(n) >= blocks), 1)
    return _cut_keys(Sq, Sk, causal, window, q_offset, want, block_n)


def _cut_keys(Sq: int, Sk: int, causal: bool, window: int | None,
              q_offset: int, want: int, tile: int = DECODE_TILE
              ) -> SplitPlan:
    """The call's visible keys cut into about ``want`` splits of whole
    ``tile``-key tiles, each at least :data:`DECODE_MIN_TILES` tiles.  A
    call that sees no key gets one empty split."""
    _, lo, hi = visible_pairs(Sq, Sk, causal=causal, window=window,
                              q_offset=q_offset)
    if hi == lo:
        return SplitPlan(lo, hi, 1, 1, tile)
    n_tiles = -(-hi // tile) - lo // tile
    tiles = max(DECODE_MIN_TILES, -(-n_tiles // want))
    return SplitPlan(lo, hi, tiles, -(-n_tiles // tiles), tile)


def _aligned(t: torch.Tensor, unit: int) -> bool:
    """Every stride a multiple of ``unit`` elements and the first element
    on a 16-byte boundary: the kernels copy 16-byte chunks."""
    *outer, last = t.stride()
    if last != 1 or t.data_ptr() % 16:
        return False
    for s in outer:                   # a loop: this runs on every decode call
        if s % unit:
            return False
    return True


def check_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int | None) -> tuple[int, ...]:
    """The checks of :func:`kernel_args`, on shapes and dtypes alone:
    ``(B, Hq, Hkv, Sq, Sk, D, Dv)`` at the call's real head dims, or
    ``TypeError`` / ``ValueError`` for a call no kernel takes."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention takes q [B,Hq,Sq,D], k [B,Hkv,Sk,D], "
                         "v [B,Hkv,Sk,Dv]")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    Dv = v.shape[-1]
    if (k.shape[0] != B or tuple(v.shape[:3]) != (B, Hkv, Sk) or Dk != D
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"attention shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bf16 = q.dtype == torch.bfloat16
    max_d, max_dv = ((MLA_MAX_D, MLA_MAX_DV) if bf16 else
                     (MAX_HEAD_DIM, MAX_HEAD_DIM))
    if not (0 < D <= max_d and 0 < Dv <= max_dv):
        raise ValueError(f"attention kernels take head dims from 1 up to "
                         f"{MAX_HEAD_DIM} in f32, and D up to {MLA_MAX_D}, "
                         f"Dv up to {MLA_MAX_DV} in bf16; got {q.dtype} "
                         f"D={D}, Dv={Dv}")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"attention kernel takes B·Hq <= {_MAX_GRID_Y}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    return B, Hq, Hkv, Sq, Sk, D, Dv


def padded_dims(D: int, Dv: int, dtype: torch.dtype) -> tuple[int, int]:
    """The head dims a kernel is given: D and Dv zero-padded to multiples
    of 16 and 8 in bf16 (the tensor cores' tile, 16 bytes) and of 4 in
    f32 (16 bytes)."""
    bf16 = dtype == torch.bfloat16
    unit = 8 if bf16 else 4               # elements in 16 bytes
    d_unit = 16 if bf16 else 4            # bf16 D: the k16 tensor-core tile
    return -(-D // d_unit) * d_unit, -(-Dv // unit) * unit


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int | None, q_offset: int,
                scale: float | None) -> tuple:
    """Check what the kernel takes (:func:`check_call`) and return ``(q,
    k, v, sizes, flags)`` as it takes them.

    Every kernel copies 16-byte chunks (TMA, or 16-byte loads): views are
    passed by their strides when the last dimension is contiguous, the
    data 16-byte aligned and every other stride a multiple of 16 bytes (8
    bf16, 4 f32 elements); others are copied.  D and Dv are zero-padded
    (:func:`padded_dims`; zeros change no score and the extra output
    columns are dropped): ``sizes`` then holds the padded dims."""
    B, Hq, Hkv, Sq, Sk, D, Dv = check_call(q, k, v, window=window)
    scale = float(scale if scale is not None else D ** -0.5)
    unit = 8 if q.dtype == torch.bfloat16 else 4    # elements in 16 bytes
    Dp, Dvp = padded_dims(D, Dv, q.dtype)
    if Dp != D:
        q, k = (F.pad(t, (0, Dp - D)) for t in (q, k))
    if Dvp != Dv:
        v = F.pad(v, (0, Dvp - Dv))
    D, Dv = Dp, Dvp
    q, k, v = (t if _aligned(t, unit) else t.contiguous() for t in (q, k, v))
    win = 0 if window is None else min(int(window), 2 ** 31 - 1)
    sizes = (B, Hq, Hkv, Sq, Sk, D, Dv)
    flags = (int(bool(causal)), win, int(q_offset), scale)
    return q, k, v, sizes, flags


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] (Hq % Hkv
    == 0) -> [B, Hq, Sq, Dv] in ``q.dtype``.  ``q_offset`` is the absolute
    position of ``q[:, :, 0]`` (decode: the cache length); ``window``
    masks keys with ``qpos - kpos >= window``; ``scale`` defaults to
    ``D ** -0.5``.

    When autograd records (grad enabled and q, k or v requiring grad) the
    call goes through :class:`FlashAttention`: the forward with the rows'
    statistics (:func:`attention_stats`), the backward
    :func:`attention_bwd`.  Otherwise the routes below, unchanged."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset, scale)
    if on_meta(q, k, v):
        return _attention_meta(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if not use_kernel(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    dv = v.shape[-1]
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    source = route(Sq, Hq, Hkv, D, Dv, q.dtype)
    launch = {"flash_decode": _decode, "flash_mla": _mla}.get(source,
                                                              _prefill)
    out = launch(q, k, v, sizes, flags)
    obs.count("launch.flash_attention")
    return out if out.shape[-1] == dv else out[..., :dv]


def _attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int | None, q_offset: int,
                    stats: bool = False):
    """The shape-only route for ``meta`` tensors: the checks of
    :func:`kernel_args`, the source :func:`route` picks on the card (with
    ``stats``, the prefill kernel of the dtype, as :func:`attention_stats`
    launches it), and the call's work reported
    (:func:`~repro_torch.kernels.policy.report_meta_work`): 2·(D + Dv)
    operations per unmasked pair; q, the output (and ``m``, ``l``) and
    the visible keys' K and V (MLA, v inside k: K alone) once, at the real
    head dims, as ``PERF.md`` §6 row 4 bounds a launch.  Returns empty
    ``[B, Hq, Sq, Dv]`` (and f32 ``[B, Hq, Sq]`` ``m``, ``l``)."""
    B, Hq, Hkv, Sq, Sk, D, Dv = check_call(q, k, v, window=window)
    Dp, Dvp = padded_dims(D, Dv, q.dtype)
    if stats:
        if max(Dp, Dvp) > MAX_HEAD_DIM:
            raise ValueError(f"no prefill kernel with statistics past a "
                             f"head dim of {MAX_HEAD_DIM}: got D={D}, "
                             f"Dv={Dv}")
        source = _PREFILL[q.dtype][0]
    else:
        source = route(Sq, Hq, Hkv, Dp, Dvp, q.dtype)
    pairs, lo, hi = visible_pairs(Sq, Sk, causal=causal, window=window,
                                  q_offset=q_offset)
    kv = D if _v_in_k(k, v) else D + Dv
    nbytes = q.element_size() * (B * Hq * Sq * (D + Dv) +
                                 B * Hkv * (hi - lo) * kv)
    if stats:
        nbytes += 2 * 4 * B * Hq * Sq
    outs = (torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device),)
    if stats:
        m = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        outs += (m, torch.empty_like(m))
    report_meta_work(source, flops=2.0 * B * Hq * pairs * (D + Dv),
                     nbytes=float(nbytes), dtype=q.dtype, inputs=(q, k, v),
                     outputs=outs)
    return outs if stats else outs[0]


def _attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int | None = None,
                   q_offset: int = 0, scale: float | None = None
                   ) -> torch.Tensor:
    """CUDA tensors through ``flash_attention.cu`` at any shape
    (``attention_mma_kernel`` in bf16, ``attention_simt_kernel`` in f32):
    the first designs, kept as the yardsticks that ``chip_smoke.py`` and
    the card tests time beside the kernels that replaced them.  Counts no
    launch; no route of :func:`attention` calls it."""
    dv = v.shape[-1]
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale)
    out = _mma(q, k, v, sizes, flags)
    return out if out.shape[-1] == dv else out[..., :dv]


def _attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **kw) -> torch.Tensor:
    """f32 CUDA tensors through ``attention_simt_kernel`` (CUDA cores, the
    f32 design before ``flash_prefill_f32.cu``): :func:`_attention_mma`
    for f32 inputs, a yardstick that counts no launch."""
    if q.dtype != torch.float32:
        raise TypeError(f"attention_simt_kernel takes f32, got {q.dtype}")
    return _attention_mma(q, k, v, **kw)


def _strides(*tensors: torch.Tensor) -> list[int]:
    """Batch, head and sequence strides of each tensor, in order: what the
    launch functions take (the last dimension is contiguous)."""
    return [s for t in tensors for s in t.stride()[:3]]


def _mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sizes: tuple,
         flags: tuple) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on :func:`kernel_args`' output."""
    lib = _build.load("flash_attention", _SIGNATURES)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q, k, v, out), *sizes,
            *flags, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", err)
    return out


def _prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sizes: tuple,
             flags: tuple, stats: bool = False):
    """Launch the prefill kernel of ``q``'s dtype (``csrc/flash_prefill.cu``
    in bf16, ``csrc/flash_prefill_f32.cu`` in f32) on :func:`kernel_args`'
    output, at the instantiation :func:`prefill_dims` picks; the kernel
    reads the real head dims and writes a ``[B, Hq, Sq, Dv]`` output.
    With ``stats`` it also writes the rows' ``m`` and ``l`` (f32 ``[B, Hq,
    Sq]``) and returns ``(out, m, l)``; such a launch counts under the
    kernel's counter and its ``_stats`` counter."""
    source, counter, dims = _PREFILL[q.dtype]
    fn = f"{source}_launch"
    lib = _build.load(source, {fn: _PREFILL_ARGS})
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q, k, v, out), *sizes, *prefill_dims(D, Dv, dims),
            *flags, m.data_ptr() if stats else None,
            l.data_ptr() if stats else None,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, fn, err)
    obs.count(f"launch.{counter}")
    if not stats:
        return out
    obs.count(f"launch.{counter}_stats")
    return out, m, l


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sizes: tuple,
            flags: tuple) -> torch.Tensor:
    """Launch the split-K kernel and its combine (``csrc/flash_decode.cu``)
    on the arguments :func:`kernel_args` gave; returns the output."""
    lib = _build.load("flash_decode", _DECODE_SIGNATURES)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    causal, win, off, _ = flags
    dev = q.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_splits(Sq, Sk, causal=bool(causal), window=win or None,
                       q_offset=off, blocks=B * Hkv, n_sm=n_sm)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=dev)
    rows = B * Hq * Sq * plan.n_splits
    ws = torch.empty(rows * (Dv + 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr(), ws[rows * Dv:].data_ptr(),
            *_strides(q, k, v, out), *sizes,
            *flags, plan.lo, plan.hi, plan.tiles, plan.n_splits,
            _DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_decode", err)
    obs.count("launch.flash_attention_decode")
    return out


def _v_in_k(k: torch.Tensor, v: torch.Tensor) -> bool:
    """True when ``v`` is a view of ``k``'s first columns (MLA's absorbed
    decode passes ``k_cat[..., :kv_lora]``): the MLA kernels then read V
    from K's tile in shared memory and load no V tile.  By storage and
    offset, not data pointer: ``meta`` tensors' pointers are all 0."""
    return (v.untyped_storage()._cdata == k.untyped_storage()._cdata and
            v.storage_offset() == k.storage_offset() and
            v.shape[-1] <= k.shape[-1] and v.stride()[:3] == k.stride()[:3])


def mla_cluster_slots(dev, n: int, v_in_k: bool = True) -> int:
    """``cudaOccupancyMaxActiveClusters`` on ``dev`` for clusters of ``n``
    blocks of ``flash_mla_wgmma.cu``'s instantiation for ``v_in_k``: how
    many the card holds at once, which :func:`_mla` plans by.  Asked once
    per device; builds the kernel if needed."""
    dev = torch.device(dev)
    key = (dev.index, n, v_in_k)
    if key not in _max_clusters:
        lib = _build.load("flash_mla_wgmma", _MLA_WGMMA_SIGNATURES)
        count = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.flash_mla_wgmma_max_clusters(n, int(v_in_k),
                                                   ctypes.byref(count))
        _build.check(lib, "flash_mla_wgmma_max_clusters", err)
        _max_clusters[key] = count.value
    return _max_clusters[key]


def _mla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sizes: tuple,
         flags: tuple) -> torch.Tensor:
    """Launch ``csrc/flash_mla_wgmma.cu`` on the arguments
    :func:`kernel_args` gave: one launch, the key splits of each row block
    merged in its cluster (:func:`plan_mla_wgmma_splits`)."""
    lib = _build.load("flash_mla_wgmma", _MLA_WGMMA_SIGNATURES)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    causal, win, off, _ = flags
    dev = q.device
    v_in_k = _v_in_k(k, v)
    row_blocks = -(-(Hq // Hkv) * Sq // MLA_ROWS)
    plan = plan_mla_wgmma_splits(
        Sq, Sk, causal=bool(causal), window=win or None, q_offset=off,
        blocks=B * Hkv * row_blocks, block_n=mla_block_n(v_in_k),
        max_clusters=lambda n: mla_cluster_slots(dev, n, v_in_k))
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_mla_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q, k, v, out), *sizes, *flags, plan.lo, plan.hi,
            plan.tiles, plan.n_splits, int(v_in_k),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_mla_wgmma", err)
    obs.count("launch.flash_attention_mla")
    return out


def _mla_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: int | None = None,
             q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """CUDA tensors through ``csrc/flash_mla.cu``, the first MLA design
    (``mma.sync`` on 32-key tiles, an f32 workspace and a combine launch),
    at the calls the route ``flash_mla`` takes: the yardstick that
    ``chip_smoke.py`` and the card tests time beside
    ``flash_mla_wgmma.cu``.  Counts no launch; no route of
    :func:`attention` calls it."""
    dv = v.shape[-1]
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    if route(Sq, Hq, Hkv, D, Dv, q.dtype) != "flash_mla":
        raise ValueError(f"flash_mla.cu takes bf16 past a head dim of "
                         f"{MAX_HEAD_DIM}, got {q.dtype} D={D}, Dv={Dv}")
    lib = _build.load("flash_mla", _MLA_SIGNATURES)
    causal, win, off, _ = flags
    dev = q.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    row_blocks = -(-(Hq // Hkv) * Sq // MLA_ROWS)
    plan = plan_mla_splits(Sq, Sk, causal=bool(causal), window=win or None,
                           q_offset=off, blocks=B * Hkv * row_blocks,
                           n_sm=n_sm)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=dev)
    rows = B * Hq * Sq * plan.n_splits
    ws = torch.empty(rows * (Dv + 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_mla_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr(), ws[rows * Dv:].data_ptr(),
            *_strides(q, k, v, out), *sizes,
            *flags, plan.lo, plan.hi, plan.tiles, plan.n_splits,
            int(_v_in_k(k, v)),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_mla", err)
    return out if out.shape[-1] == dv else out[..., :dv]


# ---------------------------------------------------------------------------
# training: the forward with row statistics, the chunked backward
# ---------------------------------------------------------------------------

def attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, scale: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`attention` and its rows' statistics ``(out, m, l)``, the
    reference's ``_flash_fwd_impl``: ``m`` the max of the visible scores
    ``s·scale`` (``-1e30`` for a row that sees no key), ``l`` the softmax
    denominator over the visible keys (0 there), both f32 ``[B, Hq, Sq]``.

    CPU tensors run :func:`~.ref.attention_ref_stats`.  CUDA tensors run
    the prefill kernel of their dtype at any Sq (decode-shaped calls
    included: ``flash_decode.cu`` writes no statistics) with its
    statistics output: ``out`` is what the same launch without it gives,
    bit for bit.  bf16 past a head dim of 256 (MLA's absorbed decode,
    which training does not run) raises ``ValueError``."""
    if on_meta(q, k, v):
        return _attention_meta(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, stats=True)
    if not use_kernel(q, k, v):
        return attention_ref_stats(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    dv = v.shape[-1]
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    if max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"no prefill kernel with statistics past a head "
                         f"dim of {MAX_HEAD_DIM}: got D={D}, Dv={Dv}")
    out, m, l = _prefill(q, k, v, sizes, flags, stats=True)
    obs.count("launch.flash_attention")
    return (out if out.shape[-1] == dv else out[..., :dv]), m, l


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  dout: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, q_offset: int = 0,
                  scale: float | None = None, block_k: int = BWD_BLOCK_K
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`attention` from its saved ``(q, k, v,
    out, m, l)``: the reference's chunked recompute ``_flash_bwd``
    (``repro/kernels/flash_attention/ops.py:98-135``), in torch ops on
    either device.  Keys are padded to whole ``block_k`` chunks; for each
    chunk the scores are recomputed in f32, ``p = exp(s - m) / max(l,
    1e-30)`` masked to the visible keys, and ``dv += pᵀ·dout``, ``ds = p ·
    (dout·vᵀ - Δ) · scale`` with ``Δ = Σ dout·out``, ``dq += ds·k``, ``dk
    += dsᵀ·q``, every product in f32; GQA groups sum into their KV head.
    ``dk`` and ``dv`` are cast to k's and v's dtype chunk by chunk and
    ``dq`` once, as the reference does.  The reference has no backward
    Pallas kernel, so there is no hand-written kernel here either."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = float(scale if scale is not None else D ** -0.5)
    bk = min(block_k, Sk)
    nk = -(-Sk // bk)
    if nk * bk != Sk:
        k = F.pad(k, (0, 0, 0, nk * bk - Sk))
        v = F.pad(v, (0, 0, 0, nk * bk - Sk))
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    dof = dout.float().reshape(B, Hkv, G, Sq, Dv)
    delta = (dof * out.float().reshape(B, Hkv, G, Sq, Dv)).sum(-1)
    m = m.reshape(B, Hkv, G, Sq, 1)
    linv = 1.0 / torch.clamp(l.reshape(B, Hkv, G, Sq, 1), min=1e-30)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    dq = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for j in range(nk):
        kb = k[:, :, j * bk:(j + 1) * bk].float()
        vb = v[:, :, j * bk:(j + 1) * bk].float()
        kpos = torch.arange(j * bk, (j + 1) * bk, device=q.device)[None, :]
        msk = kpos < Sk
        if causal:
            msk = msk & (qpos >= kpos)
        if window is not None:
            msk = msk & ((qpos - kpos) < window)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        p = torch.where(msk, torch.exp(s - m) * linv, 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dof).to(v.dtype))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qf).to(k.dtype))
    dk = torch.cat(dks, dim=2)[:, :, :Sk]
    dv = torch.cat(dvs, dim=2)[:, :, :Sk]
    return dq.reshape(B, Hq, Sq, D).to(q.dtype), dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`attention` with a gradient, the port of the reference's
    ``_flash`` ``custom_vjp``: the forward is :func:`attention_stats` (on
    CUDA tensors one prefill launch with the statistics output) and saves
    ``(q, k, v, out, m, l)``; the backward is :func:`attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        out, m, l = attention_stats(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.mask = (causal, window, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, window, q_offset, scale = ctx.mask
        dq, dk, dv = attention_bwd(q, k, v, out, m, l, dout, causal=causal,
                                   window=window, q_offset=q_offset,
                                   scale=scale)
        return dq, dk, dv, None, None, None, None
