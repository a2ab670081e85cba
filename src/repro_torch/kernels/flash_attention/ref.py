"""Plain PyTorch attention: the function the CUDA kernels compute.

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

:func:`split_bf16` and :func:`split_tf32` emulate how the prefill kernels
carry f32 values into the tensor cores (``attention_ref``'s ``p_terms``
and ``tf32_terms``; tests only).  :func:`attention_splitk_ref` is the
algebra of ``flash_decode.cu`` in plain PyTorch (per-split ``(acc, m,
l)``, then their combine); only the tests use it, to show it equals
:func:`attention_ref` for any cut of the keys.
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
                  q_offset: int = 0, scale: float | None = None,
                  p_terms: int | None = None,
                  tf32_terms: int | None = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k: [B, Hkv, Sk, D]; v: [B, Hkv, Sk, Dv];
    Hq % Hkv == 0 -> [B, Hq, Sq, Dv] in ``q.dtype``.

    ``p_terms`` (tests only) carries p into p·v as ``flash_prefill.cu``
    does, as a sum of bf16 terms: 2 gives ``P_hi + P_lo`` with ``P_hi =
    bf16(p)`` and ``P_lo = bf16(p - P_hi)`` (within 2^-16 |p| of p), 1
    rounds p once to bf16; None keeps p in f32.  ``tf32_terms`` (tests
    only) takes both products as ``flash_prefill_f32.cu`` does, each a sum
    of TF32 products (:func:`tf32_product`): 3 for the kernel's
    ``A_hi·B_hi + A_hi·B_lo + A_lo·B_hi``, 1 for one TF32 product."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = tf32_product("bhgqd,bhkd->bhgqk", qf, k.float(), tf32_terms) * scale
    mask = visible(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                   device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if p_terms is not None:
        p = split_bf16(p, p_terms)
    out = tf32_product("bhgqk,bhkd->bhgqd", p, v.float(), tf32_terms)
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def split_bf16(p: torch.Tensor, terms: int) -> torch.Tensor:
    """f32 ``p`` as the sum of ``terms`` bf16 terms, each the remainder
    rounded to bf16, summed back in f32."""
    out = torch.zeros_like(p)
    for _ in range(terms):
        t = (p - out).bfloat16().float()
        out = out + t
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: half of the 13 dropped
    bits' unit is added to the magnitude bits, then they are cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: ``hi = tf32(x)``, ``lo = tf32(x - hi)``, so that
    ``|x - hi - lo| <= 2^-22 |x|``."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                 terms: int | None) -> torch.Tensor:
    """``einsum(eq, a, b)`` in f32 (``terms`` None), or as TF32 products
    summed in f32: 3 gives ``A_hi·B_hi + A_hi·B_lo + A_lo·B_hi``, within
    3·2^-22 Σ|a||b| of the f32 product; 1 gives ``A_hi·B_hi``."""
    if terms is None:
        return torch.einsum(eq, a, b)
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = out + (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh))
    elif terms != 1:
        raise ValueError(f"tf32_terms is 1 or 3, got {terms}")
    return out


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
