"""Plain PyTorch attention: the function ``flash_attention.cu`` computes.

Same semantics as the JAX package's Pallas kernel
(``repro/kernels/flash_attention/flash_attention.py::_kernel``): inputs
upcast to f32, ``s = q·kᵀ·scale``, keys masked by ``kpos < Sk``, causal
``qpos >= kpos`` and window ``qpos - kpos < window`` (``qpos = i +
q_offset``), masked scores set to ``-1e30`` and their probabilities zeroed,
output ``acc / max(l, 1e-30)`` in the input dtype.  A row with no unmasked
key therefore comes out exactly 0 (the JAX ``attention_ref`` gives NaN
there).  GQA goes by head index: query head ``h`` reads KV head
``h // (Hq / Hkv)``.  It materialises the full score matrix, in one pass
rather than online; the CPU path and the tests use it, and nothing on the
card's main path does.

:func:`attention_splitk_ref` is the algebra of ``flash_decode.cu`` in plain
PyTorch (per-split ``(acc, m, l)``, then their combine); only the tests
use it, to show it equals :func:`attention_ref` for any cut of the keys.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible(Sq: int, Sk: int, *, causal: bool, window: int | None,
            q_offset: int, device=None) -> torch.Tensor:
    """``[Sq, Sk]`` bool: which key each query row may attend to."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0, scale: float | None = None
                  ) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k: [B, Hkv, Sk, D]; v: [B, Hkv, Sk, Dv];
    Hq % Hkv == 0 -> [B, Hq, Sq, Dv] in ``q.dtype``."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    mask = visible(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                   device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def attention_splitk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         splits, *, causal: bool = True,
                         window: int | None = None, q_offset: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """:func:`attention_ref` computed as the split-K decode kernel does:
    for each ``(begin, end)`` of ``splits`` the unnormalised ``acc``, the
    max ``m`` (``-1e30`` when the split sees no key) and the sum ``l`` of
    the visible keys in ``[begin, end)``; then ``M = max m``,
    ``L = Σ l·exp(m - M)`` and ``Σ acc·exp(m - M) / max(L, 1e-30)``.
    Equals :func:`attention_ref` when the splits cover every visible key
    once; empty splits add nothing."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    mask = visible(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                   device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    accs, ms, ls = [], [], []
    for begin, end in splits:
        mk = mask & (kpos >= begin) & (kpos < end)
        sm = torch.where(mk, s, NEG_INF)
        m = sm.amax(dim=-1, keepdim=True) if Sk else torch.full(
            s.shape[:-1] + (1,), NEG_INF, device=q.device)
        p = torch.where(mk, torch.exp(sm - m), 0.0)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()))
        ms.append(m)
    m = torch.stack(ms)                        # [n, B, Hkv, G, Sq, 1]
    w = torch.exp(m - m.amax(dim=0))
    den = torch.clamp((torch.stack(ls) * w).sum(dim=0), min=1e-30)
    out = (torch.stack(accs) * w).sum(dim=0) / den
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)
