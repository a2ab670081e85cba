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
TF32 tensor-core kernel of ``csrc/flash_prefill_f32.cu``.  Both prefill kernels are instantiated
at a few head dims and run the smallest that holds the call's
(:func:`prefill_dims`); TMA zero-fills the columns past the real dims, so
nothing is padded on the host.  ``csrc/flash_attention.cu``, the first
design, is no route of :func:`attention`: :func:`_attention_mma` and
:func:`_attention_simt` keep its kernels callable as yardsticks.
:data:`launches` counts launches where they are made and nowhere else:
``flash_attention`` every kernel call of :func:`attention`,
``flash_attention_prefill``, ``flash_attention_prefill_f32`` and
``flash_attention_decode`` those that took each kernel.

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
            "flash_attention_prefill_f32": 0, "flash_attention_decode": 0}

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
_PREFILL_ARGS = [_P, _P, _P, _P, *[_L] * 12, *[_I] * 12, _F, _P]
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


def route(Sq: int, Hq: int, Hkv: int, D: int, Dv: int,
          dtype: torch.dtype) -> str:
    """The source whose kernel :func:`attention` launches for a call:
    ``flash_decode`` for :func:`decode_shape`, else the prefill kernel of
    the dtype (``flash_prefill`` in bf16, ``flash_prefill_f32`` in f32) at
    any head dims from 1 to :data:`MAX_HEAD_DIM`; raises ``ValueError``
    for any other call."""
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
    on a 16-byte boundary: the kernels copy 16-byte chunks."""
    *outer, last = t.stride()
    if last != 1 or t.data_ptr() % 16:
        return False
    for s in outer:                   # a loop: this runs on every decode call
        if s % unit:
            return False
    return True


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int | None, q_offset: int,
                scale: float | None) -> tuple:
    """Check what the kernel takes and return ``(q, k, v, sizes, flags)``
    as it takes them; raises ``TypeError`` or ``ValueError`` on anything
    else (head dims above :data:`MAX_HEAD_DIM` included).

    Every kernel copies 16-byte chunks (TMA, or 16-byte loads): views are
    passed by their strides when the last dimension is contiguous, the
    data 16-byte aligned and every other stride a multiple of 16 bytes (8
    bf16, 4 f32 elements); others are copied.  D and Dv are zero-padded to
    multiples of 16 and 8 in bf16 (the tensor cores' tile) and of 4 in f32
    (zeros change no score and the extra output columns are dropped):
    ``sizes`` then holds the padded dims."""
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
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"attention kernel supports head dims from 1 up to "
                         f"{MAX_HEAD_DIM}, got D={D}, Dv={Dv}")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"attention kernel takes B·Hq <= {_MAX_GRID_Y}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    scale = float(scale if scale is not None else D ** -0.5)
    bf16 = q.dtype == torch.bfloat16
    unit = 8 if bf16 else 4               # elements in 16 bytes
    d_unit = 16 if bf16 else 4            # bf16 D: the k16 tensor-core tile
    Dp, Dvp = -(-D // d_unit) * d_unit, -(-Dv // unit) * unit
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
    ``D ** -0.5``."""
    if not use_kernel(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    dv = v.shape[-1]
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    source = route(Sq, Hq, Hkv, D, Dv, q.dtype)
    out = (_decode if source == "flash_decode" else _prefill)(
        q, k, v, sizes, flags)
    launches["flash_attention"] += 1
    return out if out.shape[-1] == dv else out[..., :dv]


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
             flags: tuple) -> torch.Tensor:
    """Launch the prefill kernel of ``q``'s dtype (``csrc/flash_prefill.cu``
    in bf16, ``csrc/flash_prefill_f32.cu`` in f32) on :func:`kernel_args`'
    output, at the instantiation :func:`prefill_dims` picks; the kernel
    reads the real head dims and writes a ``[B, Hq, Sq, Dv]`` output."""
    source, counter, dims = _PREFILL[q.dtype]
    fn = f"{source}_launch"
    lib = _build.load(source, {fn: _PREFILL_ARGS})
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q, k, v, out), *sizes, *prefill_dims(D, Dv, dims),
            *flags, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, fn, err)
    launches[counter] += 1
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
