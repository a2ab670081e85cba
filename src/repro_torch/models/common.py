"""Shared model substrate: parameter trees, norms, rotary embeddings and
activation helpers, in PyTorch.

Parameters are declared once as :class:`ParamDef` trees (nested dicts) with
the JAX package's logical axis names kept beside each shape, so a tree here
has exactly the keys, shapes and dtypes of the reference's.  Of the
reference's sharding helpers, :func:`logical_to_spec` and
:func:`param_pspecs` are ported for the dry run, with a partition spec as
a plain tuple (one mesh axis name, a tuple of names, or ``None`` per
dimension); ``param_shardings`` is not: the port places no tensor on a
mesh.  :func:`abstract_params` gives ``meta`` tensors, the dry run's
stand-in for the reference's ``ShapeDtypeStruct``s.  :func:`constrain` is
the reference's ``with_sharding_constraint``: an identity that the dry
run's sharding pass (``launch/sharding.py``) reads, emitted only where a
spec is set.
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


def abstract_params(tree: Tree) -> Tree:
    """A ``meta`` tensor of each leaf's shape and dtype: no allocation."""
    return tree_map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                               device="meta"), tree)


# ---------------------------------------------------------------------------
# sharding constraints
# ---------------------------------------------------------------------------
#
# ``repro_torch::constrain(x, spec)`` returns a view of ``x``: no copy, no
# bytes, no storage, on any device.  The reference's
# ``jax.lax.with_sharding_constraint`` tells XLA's partitioner where a
# tensor lies on the mesh; here the op only marks the place in a traced
# program, for ``launch/sharding.py`` to replay.  Its gradient is the
# incoming gradient under the same spec, as the transpose of a sharding
# constraint is one.  A spec travels as a string: one entry a dimension,
# ``|`` between them, each the dimension's mesh axes joined by ``+`` (empty:
# not sharded).

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("constrain(Tensor(a) x, str spec) -> Tensor(a)")


def _constrain_view(x: torch.Tensor, spec: str) -> torch.Tensor:
    return x.view_as(x)


for _key in ("CPU", "CUDA", "Meta"):
    _LIB.impl("constrain", _constrain_view, _key)


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        with torch._C._AutoDispatchBelowAutograd():
            return torch.ops.repro_torch.constrain(x, spec)

    @staticmethod
    def backward(ctx, g):
        return torch.ops.repro_torch.constrain(g, ctx.spec), None


def _constrain_autograd(x: torch.Tensor, spec: str) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, spec)
    with torch._C._AutoDispatchBelowAutograd():
        return torch.ops.repro_torch.constrain(x, spec)


_LIB.impl("constrain", _constrain_autograd, "Autograd")


def encode_spec(spec: tuple) -> str:
    """A spec tuple (per dimension: ``None``, an axis name or a tuple of
    names) as the op's string."""
    return "|".join("" if ax is None else
                    "+".join(ax if isinstance(ax, tuple) else (ax,))
                    for ax in spec)


def decode_spec(text: str, ndim: int) -> tuple[tuple[str, ...], ...]:
    """The op's string back as ``ndim`` tuples of axis names (missing
    trailing entries: not sharded)."""
    dims = [tuple(a for a in e.split("+") if a) for e in text.split("|")]
    return tuple(dims[:ndim]) + ((),) * (ndim - len(dims))


def constrain(x: torch.Tensor, spec: tuple | None) -> torch.Tensor:
    """``x`` laid out by ``spec`` (one entry a dimension, trailing ones may
    be left out): ``x`` itself when ``spec`` is ``None``, so that no op is
    emitted at all, else ``x`` through ``repro_torch::constrain``."""
    if spec is None:
        return x
    return torch.ops.repro_torch.constrain(x, encode_spec(spec))


def logical_to_spec(axes: tuple[str | None, ...],
                    rules: dict[str, Any]) -> tuple:
    """The mesh axes of each logical axis under ``rules`` (``None`` where
    an axis has no rule): the reference's ``PartitionSpec`` as a tuple."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def param_pspecs(tree: Tree, rules: dict[str, Any]) -> Tree:
    return tree_map_defs(lambda d: logical_to_spec(d.axes, rules), tree)


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
           w_down: torch.Tensor, inner_spec: tuple | None = None
           ) -> torch.Tensor:
    h = silu(torch.matmul(x, w_gate)) * torch.matmul(x, w_up)
    return torch.matmul(constrain(h, inner_spec), w_down)


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
