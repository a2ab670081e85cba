"""Gradient compression for the data-parallel reduction, in torch: the port
of ``repro/runtime/compression.py``.

``bf16``  — cast the f32 gradients to bf16 (half the bytes on the wire).
``int8``  — per-tensor symmetric int8 with an f32 scale (a quarter of the
bytes), rounded stochastically: ``q = clip(round(g / scale + u), -127,
127)`` with ``u`` uniform in [-0.5, 0.5), so the rounding is unbiased.

The reference draws ``u`` from ``jax.random`` under a key that defaults to
``PRNGKey(0)`` on every call; here it comes from an explicit
``torch.Generator`` seeded 0 on every call (one draw per leaf, in flatten
order), or is passed in as ``noise`` (one array per leaf), so that a test
can hand both packages the same draws.  Both
functions are pure: the port compresses the values a reduction would
carry, as the reference does.
"""
from __future__ import annotations

import torch

from ..tree_util import leaves, tree_map, unflatten


def _quant_int8(g: torch.Tensor, noise: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    x = gf / scale
    q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_noise(grads) -> list[torch.Tensor]:
    """One uniform [-0.5, 0.5) f32 draw per leaf of ``grads`` (flatten
    order), from a ``torch.Generator`` seeded 0 on the leaves' device."""
    ls = leaves(grads)
    gen = torch.Generator(device=ls[0].device).manual_seed(0)
    return [torch.rand(g.shape, generator=gen, dtype=torch.float32,
                       device=g.device) - 0.5 for g in ls]


def compress_tree(grads, kind: str = "bf16", noise=None):
    """``grads`` (a tree of tensors) packed as ``kind``.  For ``int8`` the
    rounding noise is ``noise`` (one tensor or array per leaf, flatten
    order) when given, else :func:`int8_noise`."""
    if kind == "bf16":
        return {"kind": "bf16",
                "data": tree_map(lambda g: g.to(torch.bfloat16), grads)}
    if kind == "int8":
        ls = leaves(grads)
        if noise is None:
            noise = int8_noise(grads)
        if len(noise) != len(ls):
            raise ValueError(f"{len(noise)} noise arrays for {len(ls)} "
                             f"leaves")
        qs = [_quant_int8(g, torch.as_tensor(u, dtype=torch.float32,
                                             device=g.device))
              for g, u in zip(ls, noise)]
        return {"kind": "int8", "like": grads,
                "q": [q for q, _ in qs], "scale": [s for _, s in qs]}
    raise ValueError(f"unknown compression {kind!r}")


def decompress_tree(packed, like):
    """The f32 gradients ``packed`` carries, in ``like``'s structure."""
    if packed["kind"] == "bf16":
        return tree_map(lambda g: g.float(), packed["data"])
    if packed["kind"] == "int8":
        return unflatten(like, [q.float() * s for q, s in
                                zip(packed["q"], packed["scale"])])
    raise ValueError(packed["kind"])
