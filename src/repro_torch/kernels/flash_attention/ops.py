"""Public attention wrapper.

:func:`attention` keeps the JAX package's signature
(``repro/kernels/flash_attention/ops.py::attention``) without ``impl``:
it dispatches by the device of its tensors
(:mod:`repro_torch.kernels.policy`).  CPU tensors go to the plain version
in ``ref.py``, CUDA tensors to ``csrc/flash_attention.cu`` (built at first
use).  :data:`launches` counts kernel launches, incremented where the
kernel is launched and nowhere else.

GQA is not broadcast here: the kernel reads KV head ``h // (Hq / Hkv)``
itself.  Inputs may be strided views (a transposed projection, a slice of
a cache): :func:`kernel_args` says which are passed as they are.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..policy import use_kernel
from .ref import attention_ref

launches = {"flash_attention": 0}

MAX_HEAD_DIM = 256          # the kernel keeps a row's Dv outputs in registers
_MAX_GRID_Y = 65535         # B·Hq blocks on the grid's second axis
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {"flash_attention_launch": [_P, _P, _P, _P, *[_L] * 12,
                                          *[_I] * 10, _F, _I, _P]}


def _aligned(t: torch.Tensor, unit: int) -> bool:
    """Every stride a multiple of ``unit`` elements and the first element
    on a 16-byte boundary: the bf16 kernel copies 16-byte chunks."""
    return (t.stride(-1) == 1 and all(s % unit == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int | None, q_offset: int,
                scale: float | None) -> tuple:
    """Check what the kernel takes and return ``(q, k, v, sizes, flags)``
    as it takes them; raises ``TypeError`` or ``ValueError`` on anything
    else (head dims above :data:`MAX_HEAD_DIM` included).

    Views are passed by their strides when the last dimension is
    contiguous (f32) or when every stride is a multiple of 8 elements and
    the data 16-byte aligned (bf16); others are copied.  For bf16, D is
    zero-padded to a multiple of 16 and Dv to a multiple of 8 (the tensor
    cores' tile; zeros change no score and the extra output columns are
    dropped): ``sizes`` then holds the padded dims."""
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
    q, k, v, sizes, (c, win, off, sc) = kernel_args(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale)
    B, Hq, Hkv, Sq, Sk, D, Dv = sizes
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *strides, *sizes, c, win, off, sc, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", err)
    launches["flash_attention"] += 1
    return out if Dv == dv else out[..., :dv]
