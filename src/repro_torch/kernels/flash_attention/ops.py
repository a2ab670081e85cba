"""Public attention wrapper.

:func:`attention` keeps the JAX package's signature
(``repro/kernels/flash_attention/ops.py::attention``) without ``impl``:
it dispatches by the device of its tensors
(:mod:`repro_torch.kernels.policy`).  CPU tensors go to the plain version
in ``ref.py``.  CUDA tensors go to one of three hand-written kernels,
built at first use, by a rule on the call's shape (never as a fallback
when one fails): calls with few query rows per KV head
(:func:`decode_shape`: decode) to the split-K kernel of
``csrc/flash_decode.cu``; other bf16 calls with head dims that are
multiples of 64 (:func:`prefill_shape`) to the wgmma/TMA kernel of
``csrc/flash_prefill.cu``; every other call (f32, D = 160, narrow test
widths) to ``csrc/flash_attention.cu``.  :data:`launches` counts launches
where they are made and nowhere else: ``flash_attention`` every kernel
call of :func:`attention`, ``flash_attention_prefill`` and
``flash_attention_decode`` those that took the prefill or split-K kernel.

GQA is not broadcast here: the kernel reads KV head ``h // (Hq / Hkv)``
itself.  Inputs may be strided views (a transposed projection, a slice of
a cache): :func:`kernel_args` says which are passed as they are.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from ..policy import use_kernel
from .ref import attention_ref

launches = {"flash_attention": 0, "flash_attention_prefill": 0,
            "flash_attention_decode": 0}

MAX_HEAD_DIM = 256          # the kernel keeps a row's Dv outputs in registers
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

# The prefill kernel (csrc/flash_prefill.cu): blocks of 128 query rows, two
# consumer warpgroups of 64 rows each, over 64-key tiles.  Its (D, Dv)
# instantiations; other multiples of 64 are zero-padded to one of them
# (:func:`prefill_dims`).
PREFILL_WG_ROWS = 64        # kWgRows
PREFILL_BLOCK_N = 64        # kBN
PREFILL_DIMS = ((64, 64), (128, 128), (192, 128), (256, 256))

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {"flash_attention_launch": [_P, _P, _P, _P, *[_L] * 12,
                                          *[_I] * 10, _F, _I, _P]}
_PREFILL_SIGNATURES = {"flash_prefill_launch": [_P, _P, _P, _P, *[_L] * 12,
                                               *[_I] * 10, _F, _P]}
_DECODE_SIGNATURES = {"flash_decode_launch": [*[_P] * 6, *[_L] * 12,
                                              *[_I] * 10, _F, *[_I] * 5, _P]}


class SplitPlan(NamedTuple):
    """The visible keys ``[lo, hi)`` of a call cut into ``n_splits``
    chunks of at most ``tiles`` key tiles (:data:`DECODE_TILE` keys),
    inner boundaries on tile multiples."""
    lo: int
    hi: int
    tiles: int
    n_splits: int

    def bounds(self) -> list[tuple[int, int]]:
        """``(begin, end)`` of each split, as the kernel computes them."""
        t0 = self.lo // DECODE_TILE
        return [(max(self.lo, (t0 + s * self.tiles) * DECODE_TILE),
                 min(self.hi, (t0 + (s + 1) * self.tiles) * DECODE_TILE))
                for s in range(self.n_splits)]


def decode_shape(Sq: int, Hq: int, Hkv: int, D: int, Dv: int) -> bool:
    """True for calls the split-K decode kernel takes: at most
    :data:`DECODE_MAX_ROWS` query rows per KV head (``Sq · Hq / Hkv``) and
    head dims up to :data:`MAX_HEAD_DIM`."""
    return (Hkv > 0 and Hq % Hkv == 0 and 1 <= Sq * (Hq // Hkv) <=
            DECODE_MAX_ROWS and D <= MAX_HEAD_DIM and Dv <= MAX_HEAD_DIM)


def prefill_shape(Sq: int, Hq: int, Hkv: int, D: int, Dv: int,
                  dtype: torch.dtype) -> bool:
    """True for calls the wgmma/TMA prefill kernel takes: bf16, not
    :func:`decode_shape`, D and Dv multiples of 64 up to
    :data:`MAX_HEAD_DIM`."""
    return (dtype == torch.bfloat16 and
            not decode_shape(Sq, Hq, Hkv, D, Dv) and
            D % 64 == 0 and Dv % 64 == 0 and 0 < D <= MAX_HEAD_DIM and
            0 < Dv <= MAX_HEAD_DIM)


def prefill_dims(D: int, Dv: int) -> tuple[int, int]:
    """The instantiation of the prefill kernel a ``(D, Dv)`` call runs:
    itself when it is one of :data:`PREFILL_DIMS`, else both padded to the
    smallest of 64, 128, 256 that holds them (zeros change no score, and
    the extra output columns are dropped)."""
    if (D, Dv) in PREFILL_DIMS:
        return D, Dv
    d = next(n for n in (64, 128, 256) if n >= max(D, Dv))
    return d, d


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


def visible_range(Sq: int, Sk: int, *, causal: bool, window: int | None,
                  q_offset: int) -> tuple[int, int]:
    """``[lo, hi)``: the first and one-past-last key that any of the Sq
    rows from ``q_offset`` sees (``lo == hi`` when none sees a key)."""
    lo, hi = Sk, 0
    for i in range(Sq):
        qpos = i + q_offset
        a = 0 if window is None else max(0, qpos - window + 1)
        b = min(Sk, qpos + 1) if causal else Sk
        if b > a:
            lo, hi = min(lo, a), max(hi, b)
    return (lo, hi) if hi > lo else (0, 0)


def plan_splits(Sq: int, Sk: int, *, causal: bool, window: int | None,
                q_offset: int, blocks: int, n_sm: int) -> SplitPlan:
    """Cut the call's visible keys so that ``blocks · n_splits`` (blocks =
    B · Hkv) gives each of ``n_sm`` SMs about :data:`DECODE_BLOCKS_PER_SM`
    blocks, each split reading at least :data:`DECODE_MIN_TILES` tiles.  A
    call that sees no key gets one empty split."""
    lo, hi = visible_range(Sq, Sk, causal=causal, window=window,
                           q_offset=q_offset)
    if hi == lo:
        return SplitPlan(lo, hi, 1, 1)
    n_tiles = -(-hi // DECODE_TILE) - lo // DECODE_TILE
    want = max(1, -(-DECODE_BLOCKS_PER_SM * n_sm // max(blocks, 1)))
    tiles = max(DECODE_MIN_TILES, -(-n_tiles // want))
    return SplitPlan(lo, hi, tiles, -(-n_tiles // tiles))


def _aligned(t: torch.Tensor, unit: int) -> bool:
    """Every stride a multiple of ``unit`` elements and the first element
    on a 16-byte boundary: the bf16 kernel copies 16-byte chunks."""
    *outer, last = t.stride()
    if last != 1 or t.data_ptr() % 16:
        return False
    for s in outer:                   # a loop: this runs on every decode call
        if s % unit:
            return False
    return True


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int | None, q_offset: int,
                scale: float | None, decode: bool = False) -> tuple:
    """Check what the kernel takes and return ``(q, k, v, sizes, flags)``
    as it takes them; raises ``TypeError`` or ``ValueError`` on anything
    else (head dims above :data:`MAX_HEAD_DIM` included).

    Views are passed by their strides when the last dimension is
    contiguous (f32) or when every stride is a multiple of 8 elements and
    the data 16-byte aligned (bf16); others are copied.  For bf16, D is
    zero-padded to a multiple of 16 and Dv to a multiple of 8 (the tensor
    cores' tile; zeros change no score and the extra output columns are
    dropped): ``sizes`` then holds the padded dims.  For the decode kernel
    (``decode``), which copies 16-byte chunks in either dtype, f32 D and Dv
    are padded to multiples of 4 and f32 views need strides in multiples of
    4 elements and 16-byte aligned data."""
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
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"attention kernel supports head dims up to "
                         f"{MAX_HEAD_DIM}, got D={D}, Dv={Dv}")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"attention kernel takes B·Hq <= {_MAX_GRID_Y}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    scale = float(scale if scale is not None else D ** -0.5)
    if q.dtype == torch.bfloat16:
        Dp, Dvp = -(-D // 16) * 16, -(-Dv // 8) * 8
        if Dp != D:
            q, k = (F.pad(t, (0, Dp - D)) for t in (q, k))
        if Dvp != Dv:
            v = F.pad(v, (0, Dvp - Dv))
        D, Dv = Dp, Dvp
        q, k, v = (t if _aligned(t, 8) else t.contiguous() for t in (q, k, v))
    elif decode:
        Dp, Dvp = -(-D // 4) * 4, -(-Dv // 4) * 4
        if Dp != D:
            q, k = (F.pad(t, (0, Dp - D)) for t in (q, k))
        if Dvp != Dv:
            v = F.pad(v, (0, Dvp - Dv))
        D, Dv = Dp, Dvp
        q, k, v = (t if _aligned(t, 4) else t.contiguous() for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
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
    ``D ** -0.5``."""
    if not use_kernel(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    dv = v.shape[-1]
    decode = prefill = False
    if q.dim() == k.dim() == 4:
        shape = (q.shape[2], q.shape[1], k.shape[1], q.shape[3], dv)
        decode = decode_shape(*shape)
        prefill = prefill_shape(*shape, q.dtype)
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale, decode=decode)
    if decode:
        out = _decode(q, k, v, sizes, flags)
    elif prefill:
        out = _prefill(q, k, v, sizes, flags)
    else:
        out = _mma(q, k, v, sizes, flags)
    launches["flash_attention"] += 1
    return out if out.shape[-1] == dv else out[..., :dv]


def _attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int | None = None,
                   q_offset: int = 0, scale: float | None = None
                   ) -> torch.Tensor:
    """CUDA tensors through ``flash_attention.cu`` at any shape
    (``attention_mma_kernel`` in bf16): the prefill design before
    ``flash_prefill.cu``, kept as the yardstick that ``chip_smoke.py`` and
    the card tests time beside it.  Counts no launch; the serving path
    never calls it."""
    dv = v.shape[-1]
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale)
    out = _mma(q, k, v, sizes, flags)
    return out if out.shape[-1] == dv else out[..., :dv]


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
             flags: tuple) -> torch.Tensor:
    """Launch ``csrc/flash_prefill.cu`` on :func:`kernel_args`' output,
    head dims zero-padded to :func:`prefill_dims`."""
    lib = _build.load("flash_prefill", _PREFILL_SIGNATURES)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    Dp, Dvp = prefill_dims(D, Dv)
    if Dp != D:
        q, k = (F.pad(t, (0, Dp - D)) for t in (q, k))
    if Dvp != Dv:
        v = F.pad(v, (0, Dvp - Dv))
    out = torch.empty((B, Hq, Sq, Dvp), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q, k, v, out),
            B, Hq, Hkv, Sq, Sk, Dp, Dvp, *flags,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_prefill", err)
    launches["flash_attention_prefill"] += 1
    return out


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
            *flags, *plan, _DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_decode", err)
    launches["flash_attention_decode"] += 1
    return out
