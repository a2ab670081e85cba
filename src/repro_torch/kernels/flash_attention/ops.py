"""Public attention wrapper.

:func:`attention` keeps the JAX package's signature
(``repro/kernels/flash_attention/ops.py::attention``) without ``impl``:
it dispatches by the device of its tensors
(:mod:`repro_torch.kernels.policy`).  CPU tensors go to the plain version
in ``ref.py``.  CUDA tensors go to one of two hand-written kernels, built
at first use: calls with few query rows per KV head (:func:`decode_shape`:
decode) to the split-K kernel of ``csrc/flash_decode.cu``, every other
call to ``csrc/flash_attention.cu``.  :data:`launches` counts launches
where they are made and nowhere else: ``flash_attention`` every kernel
call of :func:`attention`, ``flash_attention_decode`` those that took the
split-K kernel.

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

launches = {"flash_attention": 0, "flash_attention_decode": 0}

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

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {"flash_attention_launch": [_P, _P, _P, _P, *[_L] * 12,
                                          *[_I] * 10, _F, _I, _P]}
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
    decode = q.dim() == k.dim() == 4 and decode_shape(
        q.shape[2], q.shape[1], k.shape[1], q.shape[3], dv)
    q, k, v, sizes, flags = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale, decode=decode)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    if decode:
        out = _decode(q, k, v, strides, sizes, flags)
    else:
        lib = _build.load("flash_attention", _SIGNATURES)
        out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *strides, *out.stride()[:3], *sizes, *flags,
                _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, "flash_attention", err)
    launches["flash_attention"] += 1
    return out if Dv == dv else out[..., :dv]


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            strides: list[int], sizes: tuple, flags: tuple) -> torch.Tensor:
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
            ws.data_ptr(), ws[rows * Dv:].data_ptr(), *strides,
            *out.stride()[:3], *sizes, *flags, *plan, _DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_decode", err)
    launches["flash_attention_decode"] += 1
    return out
