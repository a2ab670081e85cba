"""Config-driven LM transformer in PyTorch.

Ported from ``repro/models/transformer/model.py``: llama-style GQA + RoPE +
RMSNorm + SwiGLU (yi-34b, stablelm-12b); gemma3-1b's 5:1 local:global
sliding window with two RoPE bases, tied 262k vocabulary, ``sqrt(d)``
embedding scale and logit softcap; deepseek-v3's MLA (latent-compressed
KV, absorbed decode) with shared + routed fine-grained MoE and the
sigmoid aux-free router; arctic's dense FFN ∥ 128-expert top-2 MoE; and
the training loss :func:`loss_fn`, with deepseek-v3's multi-token
prediction (``mtp``: one extra block predicting token t+2), which only the
loss runs, as in the reference.

Parameters are a plain nested dict of tensors in the reference's stacked
layout (``group{gi}/<name>`` of shape ``[L, ...]``), so the JAX package's
trees carry over leaf for leaf
(:func:`repro_torch.interop.params_from_reference`).  Layers run as a
Python loop over the stacked weights, each calling
:func:`repro_torch.kernels.attention`, which on CUDA tensors is one of the
hand-written flash-attention kernels.  MoE dispatch and combine are torch
ops around batched expert products (``torch.matmul``), as the reference
leaves them to XLA.

Unlike the functional JAX version, caches are updated in place: decode
writes the new keys and values (MLA: latents) into the ``max_len`` cache
it is given, and :func:`prefill_step` with ``max_len`` fills a fresh
``max_len`` cache with the prompt's.  The serving steps run under
``torch.no_grad``; :func:`forward` records autograd when its parameters
require grad, and then, with ``cfg.remat``, recomputes each layer in the
backward (``torch.utils.checkpoint``), as the reference's ``scan`` body
is ``jax.checkpoint``-ed.  Training never writes a cache, and the MoE
dispatch's one in-place write fills a fresh buffer that autograd tracks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ...kernels.flash_attention import attention
from ...kernels.policy import resolve_device
from ..common import (ParamDef, apply_rope, constrain, cross_entropy,
                      rmsnorm, silu, softcap, swiglu)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"          # 'softmax' | 'sigmoid_aux_free'
    n_groups: int = 16               # dispatch groups


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 1e4
    rope_theta_global: float | None = None   # gemma3 global layers
    norm_eps: float = 1e-6
    rmsnorm_plus_one: bool = False
    embed_scale: bool = False                # gemma multiplies by sqrt(d)
    tied_embeddings: bool = False
    logit_softcap: float | None = None
    window: int | None = None                # sliding window (local layers)
    local_global_pattern: int | None = None  # N local per 1 global
    moe: MoEConfig | None = None
    n_dense_layers: int = 0                  # leading dense layers (deepseek)
    moe_dense_parallel: bool = False         # arctic: dense ∥ MoE every layer
    mla: MLAConfig | None = None
    mtp: bool = False                        # deepseek multi-token prediction
    dtype: Any = torch.bfloat16
    remat: bool = True                       # recompute layers in training
    # mesh layout of the activations (the dry run's cells set it): each
    # layer's output, and through its first entry the FFN's inner
    # activations, the MoE groups and the logits (models/common.py::
    # constrain); None emits no constraint
    act_spec: tuple | None = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_groups(self) -> list[tuple[str, int]]:
        """Homogeneous (kind, count) groups of stacked layers."""
        if self.moe is None:
            return [("dense", self.n_layers)]
        if self.moe_dense_parallel:
            return [("hybrid", self.n_layers)]
        groups = []
        if self.n_dense_layers:
            groups.append(("dense", self.n_dense_layers))
        groups.append(("moe", self.n_layers - self.n_dense_layers))
        return groups

    def layer_meta(self) -> tuple[list[int], list[float]]:
        """(window, rope_theta) per layer: global layers get window
        ``1 << 30`` (no window) and the global RoPE base."""
        windows, thetas = [], []
        for i in range(self.n_layers):
            is_global = (self.local_global_pattern is None or
                         (i + 1) % (self.local_global_pattern + 1) == 0)
            if self.window is not None and not is_global:
                windows.append(self.window)
                thetas.append(self.rope_theta)
            else:
                windows.append(1 << 30)
                thetas.append(self.rope_theta_global or self.rope_theta)
        return windows, thetas


# ---------------------------------------------------------------------------
# parameter declaration
# ---------------------------------------------------------------------------

def _attn_defs(cfg: TransformerConfig, L: int) -> dict:
    dt, d = cfg.dtype, cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope + m.qk_rope
        return {
            "wq_a": ParamDef((L, d, m.q_lora), ("layers", "embed", None), dt),
            "q_norm": ParamDef((L, m.q_lora), ("layers", None), dt, "ones"),
            "wq_b": ParamDef((L, m.q_lora, cfg.n_heads * qk),
                             ("layers", None, "heads"), dt),
            "wkv_a": ParamDef((L, d, m.kv_lora + m.qk_rope),
                              ("layers", "embed", None), dt),
            "kv_norm": ParamDef((L, m.kv_lora), ("layers", None), dt, "ones"),
            "wkv_b": ParamDef((L, m.kv_lora,
                               cfg.n_heads * (m.qk_nope + m.v_dim)),
                              ("layers", None, "heads"), dt),
            "wo": ParamDef((L, cfg.n_heads * m.v_dim, d),
                           ("layers", "heads", "embed"), dt),
        }
    return {
        "wq": ParamDef((L, d, cfg.q_dim), ("layers", "embed", "heads"), dt),
        "wk": ParamDef((L, d, cfg.kv_dim), ("layers", "embed", "kv"), dt),
        "wv": ParamDef((L, d, cfg.kv_dim), ("layers", "embed", "kv"), dt),
        "wo": ParamDef((L, cfg.q_dim, d), ("layers", "heads", "embed"), dt),
    }


def _ffn_defs(cfg: TransformerConfig, L: int, kind: str) -> dict:
    dt, d = cfg.dtype, cfg.d_model
    out: dict = {}
    if kind in ("dense", "hybrid"):
        out.update({
            "w_gate": ParamDef((L, d, cfg.d_ff), ("layers", "embed", "mlp"), dt),
            "w_up": ParamDef((L, d, cfg.d_ff), ("layers", "embed", "mlp"), dt),
            "w_down": ParamDef((L, cfg.d_ff, d), ("layers", "mlp", "embed"), dt),
        })
    if kind in ("moe", "hybrid"):
        moe = cfg.moe
        E, de = moe.n_experts, moe.d_expert
        out.update({
            "router": ParamDef((L, d, E), ("layers", "embed", None),
                               torch.float32),
            "e_gate": ParamDef((L, E, d, de),
                               ("layers", "experts", "embed", None), dt),
            "e_up": ParamDef((L, E, d, de),
                             ("layers", "experts", "embed", None), dt),
            "e_down": ParamDef((L, E, de, d),
                               ("layers", "experts", None, "embed"), dt),
        })
        if moe.router == "sigmoid_aux_free":
            out["router_bias"] = ParamDef((L, E), ("layers", None),
                                          torch.float32, "zeros")
        if moe.n_shared:
            ds = de * moe.n_shared
            out.update({
                "s_gate": ParamDef((L, d, ds), ("layers", "embed", "mlp"), dt),
                "s_up": ParamDef((L, d, ds), ("layers", "embed", "mlp"), dt),
                "s_down": ParamDef((L, ds, d), ("layers", "mlp", "embed"), dt),
            })
    return out


def param_defs(cfg: TransformerConfig) -> dict:
    """The reference's parameter tree: keys, shapes and dtypes."""
    dt, d = cfg.dtype, cfg.d_model
    tree: dict = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), dt),
        "final_norm": ParamDef((d,), (None,), dt, "ones"),
    }
    if not cfg.tied_embeddings:
        tree["lm_head"] = ParamDef((d, cfg.vocab), ("embed", "vocab"), dt)
    for gi, (kind, L) in enumerate(cfg.layer_groups()):
        g = {"attn_norm": ParamDef((L, d), ("layers", None), dt, "ones"),
             "ffn_norm": ParamDef((L, d), ("layers", None), dt, "ones")}
        g.update(_attn_defs(cfg, L))
        g.update(_ffn_defs(cfg, L, kind))
        tree[f"group{gi}"] = g
    if cfg.mtp:
        g = {"attn_norm": ParamDef((1, d), ("layers", None), dt, "ones"),
             "ffn_norm": ParamDef((1, d), ("layers", None), dt, "ones"),
             "mtp_proj": ParamDef((1, 2 * d, d), ("layers", "embed", None),
                                  dt)}
        g.update(_attn_defs(cfg, 1))
        g.update(_ffn_defs(cfg, 1, "dense" if cfg.moe is None else "moe"))
        tree["mtp"] = g
    return tree


# ---------------------------------------------------------------------------
# attention blocks
# ---------------------------------------------------------------------------

def _gqa_attention(p: dict, i: int, x: torch.Tensor, cfg: TransformerConfig,
                   positions: torch.Tensor, window: int | None, theta: float,
                   cache_kv=None) -> tuple[torch.Tensor, tuple]:
    """Layer ``i`` of the stacked weights ``p``.  ``cache_kv`` is
    ``(cache_k [B,Hkv,Smax,Dh], cache_v, cache_len)``: the new keys and
    values are written into it at ``cache_len`` (in place) and attention
    runs over the whole cache, the causal mask hiding its unwritten tail."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"][i]).view(B, S, H, Dh).transpose(1, 2)
    k = torch.matmul(x, p["wk"][i]).view(B, S, Hkv, Dh).transpose(1, 2)
    v = torch.matmul(x, p["wv"][i]).view(B, S, Hkv, Dh).transpose(1, 2)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if cache_kv is not None:
        ck, cv, cache_len = cache_kv
        ck[:, :, cache_len:cache_len + S] = k
        cv[:, :, cache_len:cache_len + S] = v
        k, v, q_offset = ck, cv, cache_len
    else:
        q_offset = 0
    o = attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    o = o.transpose(1, 2).reshape(B, S, H * Dh)
    return torch.matmul(o, p["wo"][i]), (k, v)


def _mla_attention(p: dict, i: int, x: torch.Tensor, cfg: TransformerConfig,
                   positions: torch.Tensor, window: int | None, theta: float,
                   cache_kv=None) -> tuple[torch.Tensor, tuple]:
    """DeepSeek MLA, layer ``i``: queries from a low-rank latent; keys and
    values from a ``kv_lora``-dim latent plus one shared RoPE key of
    ``qk_rope`` dims.  The cache holds the latent and the un-roped key.

    * Prefill (``cache_kv`` None): per-head K/V materialised from the
      latent, the broadcast RoPE key appended; attention at (D, Dv) =
      (qk_nope + qk_rope, v_dim).
    * Absorbed decode (``cache_kv = (c_kv [B,Smax,c], k_pe [B,Smax,r],
      cache_len)``, written in place at ``cache_len``): ``W_uk`` folded
      into the query and ``W_uv`` into the output, so attention runs in
      latent space over the cache, one KV head of ``c + r`` dims for all
      heads, with v the first ``c`` columns of that key (a view: equal to
      ``c_kv`` bit for bit)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = rmsnorm(torch.matmul(x, p["wq_a"][i]), p["q_norm"][i], cfg.norm_eps)
    q = torch.matmul(cq, p["wq_b"][i]).view(B, S, H, m.qk_nope + m.qk_rope)
    q_nope, q_pe = q[..., :m.qk_nope], q[..., m.qk_nope:]
    kv_a = torch.matmul(x, p["wkv_a"][i])
    c_kv_new = rmsnorm(kv_a[..., :m.kv_lora], p["kv_norm"][i], cfg.norm_eps)
    k_pe_new = kv_a[..., m.kv_lora:]                         # [B, S, r]
    q_pe = apply_rope(q_pe.transpose(1, 2), positions, theta)  # [B,H,S,r]
    scale = (m.qk_nope + m.qk_rope) ** -0.5

    if cache_kv is not None:
        cc, ckpe, cache_len = cache_kv
        cc[:, cache_len:cache_len + S] = c_kv_new
        ckpe[:, cache_len:cache_len + S] = k_pe_new
        Sk = cc.shape[1]
        k_pe = apply_rope(ckpe, torch.arange(Sk, device=x.device), theta)
        wkv = p["wkv_b"][i].view(m.kv_lora, H, m.qk_nope + m.v_dim)
        w_uk = wkv[:, :, :m.qk_nope].permute(1, 2, 0)          # [H, dk, c]
        w_uv = wkv[:, :, m.qk_nope:].permute(1, 0, 2)          # [H, c, dv]
        q_lat = torch.matmul(q_nope.transpose(1, 2), w_uk)     # [B,H,S,c]
        q_cat = torch.cat([q_lat, q_pe], dim=-1)               # [B,H,S,c+r]
        k_cat = torch.cat([cc, k_pe], dim=-1)[:, None]         # [B,1,Sk,c+r]
        o_lat = attention(q_cat, k_cat, k_cat[..., :m.kv_lora], causal=True,
                          window=window, q_offset=cache_len, scale=scale)
        o = torch.matmul(o_lat, w_uv).transpose(1, 2).reshape(
            B, S, H * m.v_dim)
        return torch.matmul(o, p["wo"][i]), (cc, ckpe)

    kv = torch.matmul(c_kv_new, p["wkv_b"][i]).view(B, S, H,
                                                    m.qk_nope + m.v_dim)
    k_nope, v = kv[..., :m.qk_nope], kv[..., m.qk_nope:]
    k_pe = apply_rope(k_pe_new[:, None], torch.arange(S, device=x.device),
                      theta)                                   # [B,1,S,r]
    qh = torch.cat([q_nope.transpose(1, 2), q_pe], dim=-1)
    kh = torch.cat([k_nope.transpose(1, 2), k_pe.expand(B, H, S, m.qk_rope)],
                   dim=-1)
    o = attention(qh, kh, v.transpose(1, 2), causal=True, window=window,
                  q_offset=0, scale=scale)
    o = o.transpose(1, 2).reshape(B, S, H * m.v_dim)
    return torch.matmul(o, p["wo"][i]), (c_kv_new, k_pe_new)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _dispatch_group(xf: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                    E: int, K: int, C: int) -> tuple:
    """The reference's ``_dispatch_group`` over a leading group dim (its
    ``vmap`` written out): xf [G, T, d], ids / w [G, T, K] ->
    ``(buf [G, E, C, d], se, slot_c, tok, comb_w)``, the last four
    ``[G, T·K]`` in expert-sorted order.  Assignments are sorted by expert
    (stable, so a slot is the rank in token order), slot = rank within the
    expert, those past capacity C dropped (weight 0, slot 0).

    Every assignment is written, so every shape is static (no
    ``nonzero``, no device-to-host read, and the dispatch traces on the
    ``meta`` device): the buffer is ``G·E·C`` rows plus one spill row,
    kept rows go to their own (unique) row and dropped ones all to the
    spill row, which is cut off; what is left is a contiguous view."""
    G, T, d = xf.shape
    flat_e = ids.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    counts = torch.zeros(G, E, dtype=torch.long, device=xf.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    slot = torch.arange(T * K, device=xf.device) - starts.gather(1, se)
    keep = slot < C
    tok = order // K
    slot_c = torch.where(keep, slot, 0).to(torch.int32)
    comb_w = torch.where(keep, w.reshape(G, T * K).gather(1, order), 0.0)
    g = torch.arange(G, device=xf.device)[:, None]
    row = torch.where(keep, (g * E + se) * C + slot, G * E * C)
    buf = xf.new_zeros((G * E * C + 1, d))
    buf[row.reshape(-1)] = xf[g, tok].reshape(G * T * K, d)
    return buf[:G * E * C].view(G, E, C, d), se, slot_c, tok, comb_w


def _combine_group(h: torch.Tensor, se: torch.Tensor, slot_c: torch.Tensor,
                   tok: torch.Tensor, comb_w: torch.Tensor,
                   T: int) -> torch.Tensor:
    """The reference's ``_combine_group`` over a leading group dim: h
    [G, E, C, d] back to [G, T, d], each token the weighted sum of its K
    expert rows.  The reference scatter-adds them in expert-sorted order,
    so a token's K terms are added in ascending expert order, rounding to
    the model dtype after each add; here a gather of each token's K rows,
    summed in that order: deterministic (no atomics) and, on the CPU,
    equal to the reference."""
    G, E, C, d = h.shape
    K = se.shape[1] // T
    by_tok = torch.argsort(tok, dim=1, stable=True)    # token-major, then
    rows = (se * C + slot_c).gather(1, by_tok).view(G, T, K)  # expert order
    wts = comb_w.gather(1, by_tok).view(G, T, K).to(h.dtype)
    hf = h.reshape(G, E * C, d)
    g = torch.arange(G, device=h.device)[:, None]
    out = h.new_zeros((G, T, d))
    for j in range(K):
        out = out + hf[g, rows[:, :, j]] * wts[:, :, j, None]
    return out


def _route(logits: torch.Tensor, bias: torch.Tensor | None,
           moe: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ids, w)`` [G, T, K] from f32 router logits: ``softmax`` takes the
    top-k logits and softmaxes them; ``sigmoid_aux_free`` takes the top k
    of sigmoid score + bias (the bias only routes) and normalises the
    chosen scores."""
    K = moe.top_k
    if moe.router == "sigmoid_aux_free":
        scores = torch.sigmoid(logits)
        _, ids = torch.topk(scores + bias, K, dim=-1)
        w = scores.gather(-1, ids)
        return ids, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    _, ids = torch.topk(logits, K, dim=-1)
    return ids, torch.softmax(logits.gather(-1, ids), dim=-1)


def _moe_ffn(p: dict, i: int, x: torch.Tensor,
             cfg: TransformerConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped top-k MoE of layer ``i``: sort-based dispatch into
    ``[G, E, C, d]`` capacity buffers, batched expert products, combine;
    plus shared experts.  Returns ``(out [B, S, d], aux)`` with the
    load-balance term ``aux = E · Σ_e mean softmax_e · (assignments to e /
    G·T·K)``.  G = ``n_groups`` when it divides the batch, else 1."""
    moe = cfg.moe
    B, S, d = x.shape
    E, K = moe.n_experts, moe.top_k
    G = moe.n_groups if B % max(moe.n_groups, 1) == 0 else 1
    T = (B // G) * S
    bax = cfg.act_spec[0] if cfg.act_spec is not None else None

    def gc(t, *rest):       # groups (dim 0) on the batch axes
        return t if bax is None else constrain(t, (bax, *rest))

    xf = gc(x.reshape(G, T, d))
    # an f32 product of the bf16-cast router (the reference's
    # preferred_element_type=f32): a bf16 product would round the logits
    logits = gc(torch.matmul(xf.float(),
                             p["router"][i].to(x.dtype).float()))
    ids, w = _route(logits, p["router_bias"][i] if "router_bias" in p
                    else None, moe)
    C = int(math.ceil(T * K * moe.capacity_factor / E))
    buf, se, slot_c, tok, comb_w = _dispatch_group(xf, ids, w, E, K, C)
    buf = gc(buf, "model")
    g = gc(torch.matmul(buf, p["e_gate"][i]), "model")   # [G, E, C, de]
    u = gc(torch.matmul(buf, p["e_up"][i]), "model")
    del buf
    h = gc(torch.matmul(silu(g) * u, p["e_down"][i]), "model")
    del g, u
    out = gc(_combine_group(h, se, slot_c, tok, comb_w, T)).reshape(B, S, d)
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    flat = ids.reshape(-1)
    ce = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float() / (G * T * K)
    aux = E * torch.sum(me * ce)
    if moe.n_shared:
        out = out + swiglu(x, p["s_gate"][i], p["s_up"][i], p["s_down"][i],
                           _inner_spec(cfg))
    return out, aux


def _inner_spec(cfg: TransformerConfig) -> tuple | None:
    """The FFN's inner activations ``[B, S, f]``: f on ``model``."""
    return None if cfg.act_spec is None else (cfg.act_spec[0], None, "model")


def _layer(kind: str, p: dict, i: int, x: torch.Tensor,
           cfg: TransformerConfig, positions: torch.Tensor,
           window: int | None, theta: float, cache_kv=None):
    """One block of a ``kind`` group: ``(x, aux, new_kv)``."""
    attn = _mla_attention if cfg.mla is not None else _gqa_attention
    h, new_kv = attn(p, i, rmsnorm(x, p["attn_norm"][i], cfg.norm_eps,
                                   cfg.rmsnorm_plus_one),
                     cfg, positions, window, theta, cache_kv)
    x = x + h
    y = rmsnorm(x, p["ffn_norm"][i], cfg.norm_eps, cfg.rmsnorm_plus_one)
    aux = 0.0
    if kind == "dense":
        f = swiglu(y, p["w_gate"][i], p["w_up"][i], p["w_down"][i],
                   _inner_spec(cfg))
    elif kind == "moe":
        f, aux = _moe_ffn(p, i, y, cfg)
    else:                       # hybrid: dense residual FFN ∥ MoE (arctic)
        f, aux = _moe_ffn(p, i, y, cfg)
        f = swiglu(y, p["w_gate"][i], p["w_up"][i], p["w_down"][i],
                   _inner_spec(cfg)) + f
    return x + f, aux, new_kv


def _remat_body(kind: str, p: dict, i: int, x: torch.Tensor,
                cfg: TransformerConfig, positions: torch.Tensor,
                window: int | None, theta: float):
    """:func:`_layer` without a cache, its output under ``act_spec``, as
    ``(x, aux)``: what a ``checkpoint``-ed training layer keeps."""
    x, aux, _ = _layer(kind, p, i, x, cfg, positions, window, theta)
    return constrain(x, cfg.act_spec), aux


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            return_cache: bool = False, cache=None, cache_len: int | None = None,
            positions: torch.Tensor | None = None, last_only: bool = False):
    """tokens [B, S] -> ``(logits [B, S, V], aux, caches, hidden)``, as the
    reference returns them (``aux`` the MoE layers' summed load-balance
    term, 0.0 for a dense model).

    ``cache`` is :func:`init_cache`'s list, updated in place at
    ``cache_len`` (for MLA this selects the absorbed decode path);
    ``return_cache`` without ``cache`` returns per-group stacks over the
    prompt: ``(k, v)`` ``[L, B, Hkv, S, Dh]``, or for MLA ``(c_kv
    [L, B, S, kv_lora], k_pe [L, B, S, qk_rope])`` with ``k_pe`` un-roped.
    ``last_only`` applies the head to the last position alone (logits
    ``[B, 1, V]``).  With autograd recording and ``cfg.remat`` (training:
    no cache in or out) each layer is a ``torch.utils.checkpoint``."""
    B, S = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the model dtype first, as the reference does
        # (34.0, not 33.94, for d = 1152 in bf16)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    windows, thetas = cfg.layer_meta()
    remat = (cfg.remat and torch.is_grad_enabled() and cache is None and
             not return_cache)
    aux_total = 0.0
    caches_out = []
    off = 0
    for gi, (kind, L) in enumerate(cfg.layer_groups()):
        g = params[f"group{gi}"]
        ks, vs = [], []
        for i in range(L):
            w = windows[off + i]
            w = None if w >= 1 << 30 else w
            if remat:
                x, aux = checkpoint(_remat_body, kind, g, i, x, cfg,
                                    positions, w, thetas[off + i],
                                    use_reentrant=False)
                aux_total = aux_total + aux
                continue
            cache_kv = None
            if cache is not None:
                cache_kv = (cache[gi][0][i], cache[gi][1][i], cache_len)
            x, aux, (k, v) = _layer(kind, g, i, x, cfg, positions, w,
                                    thetas[off + i], cache_kv)
            x = constrain(x, cfg.act_spec)
            aux_total = aux_total + aux
            if return_cache and cache is None:
                ks.append(k)
                vs.append(v)
        if cache is not None:
            caches_out.append(cache[gi])
        elif return_cache:
            caches_out.append((torch.stack(ks), torch.stack(vs)))
        off += L
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.rmsnorm_plus_one)
    w = params["embed"].t() if cfg.tied_embeddings else params["lm_head"]
    logits = torch.matmul(x[:, -1:] if last_only else x, w.to(cfg.dtype))
    if cfg.act_spec is not None:
        logits = constrain(logits, (cfg.act_spec[0], None, "model"))
    logits = softcap(logits, cfg.logit_softcap)
    caches = caches_out if (return_cache or cache is not None) else None
    return logits, aux_total, caches, x


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig):
    """The reference's training loss (``repro/models/transformer/model.py::
    loss_fn``): next-token cross entropy of ``batch["tokens"] [B, S]``,
    plus 0.01 × the MoE load-balance term, plus, with ``cfg.mtp``
    (deepseek-v3's multi-token prediction, depth 1), 0.3 × the cross
    entropy of token t+2 predicted by one extra block (the ``mtp`` group)
    from the final hidden state at t joined with the embedding of token
    t+1, through the shared head; that block runs at the last layer's
    window and RoPE base and its aux term joins the total.  Returns
    ``(total, {"loss", "aux", "mtp"})``."""
    tokens = batch["tokens"]
    logits, aux, _, hidden = forward(params, tokens, cfg)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    mtp_loss = 0.0
    if cfg.mtp:
        g = params["mtp"]
        emb_next = params["embed"][tokens[:, 1:]].to(cfg.dtype)
        h = torch.cat([hidden[:, :-1], emb_next], dim=-1)
        h = torch.matmul(h, g["mtp_proj"][0])
        kind = "dense" if cfg.moe is None else "moe"
        windows, thetas = cfg.layer_meta()
        w = None if windows[-1] >= 1 << 30 else windows[-1]
        positions = torch.arange(h.shape[1], device=tokens.device)
        h, mtp_aux, _ = _layer(kind, g, 0, h, cfg, positions, w, thetas[-1])
        head = params["embed"].t() if cfg.tied_embeddings else \
            params["lm_head"]
        mtp_logits = softcap(torch.matmul(h, head.to(cfg.dtype)),
                             cfg.logit_softcap)
        mtp_loss = cross_entropy(mtp_logits[:, :-1], tokens[:, 2:])
        aux = aux + mtp_aux
    total = loss + 0.01 * aux + 0.3 * mtp_loss
    return total, {"loss": loss, "aux": aux, "mtp": mtp_loss}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-group caches, on the card unless ``device="cpu"`` (the default
    raises without one): GQA ``(k, v)``, each ``[L, B, Hkv, max_len,
    Dh]``; MLA ``(c_kv [L, B, max_len, kv_lora], k_pe [L, B, max_len,
    qk_rope])``, the latents."""
    device = resolve_device(device)
    caches = []
    for _, L in cfg.layer_groups():
        if cfg.mla is not None:
            shapes = ((L, batch, max_len, cfg.mla.kv_lora),
                      (L, batch, max_len, cfg.mla.qk_rope))
        else:
            shapes = ((L, batch, cfg.n_kv_heads, max_len, cfg.head_dim),) * 2
        caches.append(tuple(torch.zeros(s, dtype=cfg.dtype, device=device)
                            for s in shapes))
    return caches


@torch.no_grad()
def prefill_step(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                 max_len: int | None = None):
    """Prefill: the last position's logits ``[B, V]`` and the caches.

    Without ``max_len`` the caches are :func:`forward`'s per-group stacks
    over the prompt, as the reference returns them.  With ``max_len`` they
    are a fresh :func:`init_cache` of that length, ready for
    :func:`decode_step`: GQA writes the prompt's keys and values straight
    into it; MLA runs the prefill path (a cache would select the absorbed
    decode path, a different computation) and copies the prompt's latents
    into ``[0:S]``, as the reference's ``serve_lm`` does.  The head runs
    on the last position only."""
    if max_len is not None and cfg.mla is None:
        cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
        logits, _, caches, _ = forward(params, tokens, cfg, cache=cache,
                                       cache_len=0, last_only=True)
        return logits[:, -1], caches
    logits, _, caches, _ = forward(params, tokens, cfg, return_cache=True,
                                   last_only=True)
    if max_len is not None:
        S = tokens.shape[1]
        cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
        for (c, kpe), (pc, pk) in zip(cache, caches):
            c[:, :, :S] = pc
            kpe[:, :, :S] = pk
        caches = cache
    return logits[:, -1], caches


@torch.no_grad()
def decode_step(params: dict, cache, tokens: torch.Tensor, cache_len: int,
                cfg: TransformerConfig):
    """One decode step: tokens [B, 1] against caches filled to
    ``cache_len``; writes the step's keys and values into ``cache`` in
    place and returns ``(logits [B, V], cache)``."""
    positions = cache_len + torch.arange(tokens.shape[1],
                                         device=tokens.device)
    logits, _, new_cache, _ = forward(params, tokens, cfg, cache=cache,
                                      cache_len=cache_len,
                                      positions=positions, last_only=True)
    return logits[:, -1], new_cache
