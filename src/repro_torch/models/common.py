"""Shared model substrate: parameter trees, norms, rotary embeddings and
activation helpers, in PyTorch.

Parameters are declared once as :class:`ParamDef` trees (nested dicts) with
the JAX package's logical axis names kept beside each shape, so a tree here
has exactly the keys, shapes and dtypes of the reference's.  The sharding
helpers of the reference (``logical_to_spec``, ``param_shardings``,
``param_pspecs``) are not ported: one card has no mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..kernels.policy import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]        # logical axis per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                # normal | zeros | ones

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Tree = dict[str, Any]  # nested dict of ParamDef


def tree_map_defs(fn: Callable[[ParamDef], Any], tree: Tree) -> Tree:
    out = {}
    for k, v in tree.items():
        out[k] = fn(v) if isinstance(v, ParamDef) else tree_map_defs(fn, v)
    return out


# A leaf whose f32 draw would pass DRAW_LIMIT_BYTES is drawn in runs of its
# trailing matrices (along the flattened leading dims, each run's f32 draw
# within DRAW_RUN_BYTES) into a preallocated leaf of its own dtype:
# deepseek-v3's e_gate at 2 MoE layers is 7.5 G elements, 30 GB in f32, and
# drawn whole (twice over, with the scaled copy) it alone would pass the
# card's 80 GB.  The limit is above stablelm-12b's largest leaf (w_gate,
# 11.3 GB in f32), so smaller models keep the weights a single draw per
# leaf gave them.
DRAW_LIMIT_BYTES = 16 << 30
DRAW_RUN_BYTES = 1 << 30


def init_params(tree: Tree, generator: torch.Generator,
                device="cuda") -> Tree:
    """Random parameters for ``tree``: ``normal`` leaves are N(0, 1) / sqrt
    (fan-in) drawn in f32 from ``generator`` (which must live on
    ``device``) and cast to the leaf's dtype, fan-in being the next-to-last
    dimension (the last for a vector); ``zeros`` / ``ones`` as named.
    Leaves are drawn in the reference's order, those past
    :data:`DRAW_LIMIT_BYTES` in f32 in runs of matrices of at most
    :data:`DRAW_RUN_BYTES`, but ``torch`` and
    ``jax.random`` give different numbers from one seed: carry the
    reference's weights with :func:`repro_torch.interop.params_from_reference`
    where the two must agree.  ``device`` is the card unless the caller
    asks for the CPU; without a card the default raises."""
    device = resolve_device(device)

    def leaf(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        if 4 * math.prod(d.shape) <= DRAW_LIMIT_BYTES or len(d.shape) < 3:
            v = torch.randn(d.shape, generator=generator,
                            dtype=torch.float32, device=device)
            return (v * scale).to(d.dtype)
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        mats = out.view(-1, *d.shape[-2:])
        run = max(1, DRAW_RUN_BYTES // (4 * math.prod(d.shape[-2:])))
        for j in range(0, mats.shape[0], run):
            dst = mats[j:j + run]
            v = torch.randn(dst.shape, generator=generator,
                            dtype=torch.float32, device=device)
            dst.copy_(v.mul_(scale))
            del v
        return out

    return tree_map_defs(leaf, tree)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    base = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / (base ** (i / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, D]; positions: [S].  Rotates the two halves of the last
    dimension in f32 and casts back to ``x.dtype``."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                     # [D/2]
    ang = positions[..., :, None].float() * freqs              # [S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with ``sigmoid = 1 / (1 + exp(-x))``, one op at a
    time in ``x.dtype``: the reference's ``jax.nn.silu`` rounds a bf16
    input after each of these ops, where ``F.silu`` rounds once."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = silu(torch.matmul(x, w_gate)) * torch.matmul(x, w_up)
    return torch.matmul(h, w_down)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def seg_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` added into ``n`` segments
    by ``index_add`` into zeros, in ``data``'s dtype (on the card with
    float atomics, so in no fixed order)."""
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids, data)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` under ``logits [..., V]``
    (``mask``: the mean over its nonzero positions), in f32, as the
    reference computes it (``repro/models/common.py::cross_entropy``): the
    gold logit as a one-hot mask-sum, ``where(iota == target, logits,
    0).sum(-1)``, which adds exact zeros to the one gold term and so equals
    a gather bit for bit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab == targets[..., None], logits, 0.0).sum(-1)
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
