"""Config-driven LM transformer, dense GQA part, in PyTorch.

Ported from ``repro/models/transformer/model.py``: llama-style GQA + RoPE +
RMSNorm + SwiGLU (yi-34b, stablelm-12b) and gemma3-1b's 5:1
local:global sliding window with two RoPE bases, tied 262k vocabulary,
``sqrt(d)`` embedding scale and logit softcap.  MLA (deepseek-v3) and MoE
dispatch (deepseek-v3, arctic) come with a later slice of the port: a
config with ``mla`` or ``moe`` set raises :class:`NotImplementedError`.

Parameters are a plain nested dict of tensors in the reference's stacked
layout (``group{gi}/<name>`` of shape ``[L, ...]``), so the JAX package's
trees carry over leaf for leaf
(:func:`repro_torch.interop.params_from_reference`).  Layers run as a
Python loop over the stacked weights, each calling
:func:`repro_torch.kernels.attention`, which on CUDA tensors is the
hand-written flash-attention kernel.

Unlike the functional JAX version, KV caches are updated in place: decode
writes the new keys and values into the ``max_len`` cache it is given, and
:func:`prefill_step` with ``max_len`` writes the prompt's straight into a
fresh ``max_len`` cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ...kernels.flash_attention import attention
from ...kernels.policy import resolve_device
from ..common import ParamDef, apply_rope, rmsnorm, softcap, swiglu

_LATER = ("the port's next slice (MLA and MoE dispatch, with deepseek-v3 "
          "and arctic)")


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


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.mla is not None or cfg.moe is not None or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: MLA, MoE and MTP are not ported yet; they come "
            f"with {_LATER}")


# ---------------------------------------------------------------------------
# parameter declaration
# ---------------------------------------------------------------------------

def param_defs(cfg: TransformerConfig) -> dict:
    """The reference's parameter tree for a dense GQA config."""
    _dense_only(cfg)
    dt, d = cfg.dtype, cfg.d_model
    tree: dict = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), dt),
        "final_norm": ParamDef((d,), (None,), dt, "ones"),
    }
    if not cfg.tied_embeddings:
        tree["lm_head"] = ParamDef((d, cfg.vocab), ("embed", "vocab"), dt)
    for gi, (_, L) in enumerate(cfg.layer_groups()):
        tree[f"group{gi}"] = {
            "attn_norm": ParamDef((L, d), ("layers", None), dt, "ones"),
            "ffn_norm": ParamDef((L, d), ("layers", None), dt, "ones"),
            "wq": ParamDef((L, d, cfg.q_dim), ("layers", "embed", "heads"), dt),
            "wk": ParamDef((L, d, cfg.kv_dim), ("layers", "embed", "kv"), dt),
            "wv": ParamDef((L, d, cfg.kv_dim), ("layers", "embed", "kv"), dt),
            "wo": ParamDef((L, cfg.q_dim, d), ("layers", "heads", "embed"), dt),
            "w_gate": ParamDef((L, d, cfg.d_ff), ("layers", "embed", "mlp"), dt),
            "w_up": ParamDef((L, d, cfg.d_ff), ("layers", "embed", "mlp"), dt),
            "w_down": ParamDef((L, cfg.d_ff, d), ("layers", "mlp", "embed"), dt),
        }
    return tree


# ---------------------------------------------------------------------------
# blocks
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


def _layer(p: dict, i: int, x: torch.Tensor, cfg: TransformerConfig,
           positions: torch.Tensor, window: int | None, theta: float,
           cache_kv=None) -> tuple[torch.Tensor, tuple]:
    h, new_kv = _gqa_attention(
        p, i, rmsnorm(x, p["attn_norm"][i], cfg.norm_eps,
                      cfg.rmsnorm_plus_one),
        cfg, positions, window, theta, cache_kv)
    x = x + h
    y = rmsnorm(x, p["ffn_norm"][i], cfg.norm_eps, cfg.rmsnorm_plus_one)
    return x + swiglu(y, p["w_gate"][i], p["w_up"][i], p["w_down"][i]), new_kv


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            return_cache: bool = False, cache=None, cache_len: int | None = None,
            positions: torch.Tensor | None = None, last_only: bool = False):
    """tokens [B, S] -> ``(logits [B, S, V], aux, caches, hidden)``, as the
    reference returns them (``aux`` is 0.0: dense layers add no loss).

    ``cache`` is :func:`init_cache`'s list, updated in place at
    ``cache_len``; ``return_cache`` without ``cache`` returns per-group
    ``(k, v)`` stacks ``[L, B, Hkv, S, Dh]``.  ``last_only`` applies the
    head to the last position alone (logits ``[B, 1, V]``)."""
    _dense_only(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the model dtype first, as the reference does
        # (34.0, not 33.94, for d = 1152 in bf16)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    windows, thetas = cfg.layer_meta()
    caches_out = []
    off = 0
    for gi, (_, L) in enumerate(cfg.layer_groups()):
        g = params[f"group{gi}"]
        ks, vs = [], []
        for i in range(L):
            w = windows[off + i]
            cache_kv = None
            if cache is not None:
                cache_kv = (cache[gi][0][i], cache[gi][1][i], cache_len)
            x, (k, v) = _layer(g, i, x, cfg, positions,
                               None if w >= 1 << 30 else w, thetas[off + i],
                               cache_kv)
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
    logits = softcap(torch.matmul(x[:, -1:] if last_only else x,
                                  w.to(cfg.dtype)), cfg.logit_softcap)
    caches = caches_out if (return_cache or cache is not None) else None
    return logits, 0.0, caches, x


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-group KV caches ``(k, v)``, each ``[L, B, Hkv, max_len, Dh]``,
    on the card unless ``device="cpu"`` (the default raises without one)."""
    _dense_only(cfg)
    device = resolve_device(device)
    caches = []
    for _, L in cfg.layer_groups():
        shape = (L, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        caches.append((torch.zeros(shape, dtype=cfg.dtype, device=device),
                       torch.zeros(shape, dtype=cfg.dtype, device=device)))
    return caches


def prefill_step(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                 max_len: int | None = None):
    """Prefill: the last position's logits ``[B, V]`` and the caches.

    Without ``max_len`` the caches are per-group ``(k, v)`` stacks over
    the prompt, ``[L, B, Hkv, S, Dh]``, as the reference returns them.
    With ``max_len`` the prompt's keys and values are written straight into
    a fresh :func:`init_cache` of that length, ready for
    :func:`decode_step`.  The head runs on the last position only."""
    if max_len is None:
        logits, _, caches, _ = forward(params, tokens, cfg,
                                       return_cache=True, last_only=True)
        return logits[:, -1], caches
    cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    logits, _, caches, _ = forward(params, tokens, cfg, cache=cache,
                                   cache_len=0, last_only=True)
    return logits[:, -1], caches


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
