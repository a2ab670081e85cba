"""Differential functions (paper §5.2, Table 2).

A differential function ``f`` builds the (virtual) graph of an interior
DeltaGraph node from its children's graphs.  The choice of ``f`` is the main
tuning knob for the retrieval-latency distribution over history:

* ``intersection`` — minimal disk space, skewed latencies (older = faster on
  growing graphs); root of a growing-only graph is exactly ``G_0``.
* ``union`` — the opposite skew.
* ``balanced`` — equal delta sizes to every child → uniform latencies.
* ``skewed(r)`` / ``right_skewed`` / ``left_skewed`` — tunable interpolation.
* ``mixed(r1, r2)`` — general form; ``r1 = r2 = 0.5`` is ``balanced``.
* ``empty`` — parent is ∅ ⇒ DeltaGraph degenerates to **Copy+Log** (§4.1).

Event-fraction selection (`r·δ_ab`) uses a deterministic hash of the slot id,
exactly the paper's trick for making ``a + r·δ_ab − r·ρ_ab`` well defined
(the same hash picks both the added and the removed halves).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .events import MaterializedState

DiffFn = Callable[[Sequence[MaterializedState]], MaterializedState]

_REGISTRY: dict[str, Callable[..., DiffFn]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str, **params) -> DiffFn:
    """Look up a differential function, e.g. ``get('mixed', r1=.7, r2=.3)``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown differential function {name!r}; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)


def names() -> list[str]:
    return sorted(_REGISTRY)


def _slot_hash(n: int, seed: int = 0x9E3779B9) -> np.ndarray:
    """Deterministic per-slot uniform in [0, 1) (splitmix-style)."""
    x = (np.arange(n, dtype=np.uint64) + np.uint64(1)) * np.uint64(seed)
    x ^= x >> np.uint64(16)
    x *= np.uint64(0x85EBCA6B)
    x ^= x >> np.uint64(13)
    x *= np.uint64(0xC2B2AE35)
    x ^= x >> np.uint64(16)
    return (x & np.uint64(0xFFFFFF)).astype(np.float64) / float(1 << 24)


def _merge_attrs(children: Sequence[MaterializedState], node_mask, edge_mask):
    """Interior-node attribute values: first child containing the element
    wins (any deterministic rule is valid — deltas correct the residue)."""
    na = children[0].node_attrs.copy()
    ea = children[0].edge_attrs.copy()
    filled_n = children[0].node_mask.copy()
    filled_e = children[0].edge_mask.copy()
    for c in children[1:]:
        take_n = ~filled_n & c.node_mask
        take_e = ~filled_e & c.edge_mask
        if na.size:
            na[take_n] = c.node_attrs[take_n]
        if ea.size:
            ea[take_e] = c.edge_attrs[take_e]
        filled_n |= c.node_mask
        filled_e |= c.edge_mask
    return na, ea


def _state(node_mask, edge_mask, children) -> MaterializedState:
    na, ea = _merge_attrs(children, node_mask, edge_mask)
    return MaterializedState(node_mask, edge_mask, na, ea)


@register("intersection")
def _intersection() -> DiffFn:
    def f(children: Sequence[MaterializedState]) -> MaterializedState:
        nm = children[0].node_mask.copy()
        em = children[0].edge_mask.copy()
        for c in children[1:]:
            nm &= c.node_mask
            em &= c.edge_mask
        return _state(nm, em, children)
    return f


@register("union")
def _union() -> DiffFn:
    def f(children: Sequence[MaterializedState]) -> MaterializedState:
        nm = children[0].node_mask.copy()
        em = children[0].edge_mask.copy()
        for c in children[1:]:
            nm |= c.node_mask
            em |= c.edge_mask
        return _state(nm, em, children)
    return f


@register("empty")
def _empty() -> DiffFn:
    def f(children: Sequence[MaterializedState]) -> MaterializedState:
        z = children[0]
        return MaterializedState(
            np.zeros_like(z.node_mask), np.zeros_like(z.edge_mask),
            np.full_like(z.node_attrs, np.nan), np.full_like(z.edge_attrs, np.nan))
    return f


@register("mixed")
def _mixed(r1: float = 0.5, r2: float = 0.5) -> DiffFn:
    if not (0.0 <= r2 <= r1 <= 1.0):
        raise ValueError("require 0 <= r2 <= r1 <= 1")

    def f(children: Sequence[MaterializedState]) -> MaterializedState:
        a = children[0]
        nm, em = a.node_mask.copy(), a.edge_mask.copy()
        hn = _slot_hash(nm.size)
        he = _slot_hash(em.size)
        for prev, cur in zip(children[:-1], children[1:]):
            dn = cur.node_mask & ~prev.node_mask
            rn = prev.node_mask & ~cur.node_mask
            de = cur.edge_mask & ~prev.edge_mask
            re = prev.edge_mask & ~cur.edge_mask
            nm |= dn & (hn < r1)
            nm &= ~(rn & (hn < r2))
            em |= de & (he < r1)
            em &= ~(re & (he < r2))
        return _state(nm, em, children)
    return f


@register("balanced")
def _balanced() -> DiffFn:
    """Special case of mixed with r1 = r2 = ½ → |Δ(a,p)| = |Δ(b,p)|."""
    return _mixed(0.5, 0.5)


@register("skewed")
def _skewed(r: float = 0.5) -> DiffFn:
    """f(a,b) = a + r·(b−a): move an r-fraction of *all* of b's differences
    (both additions and removals) toward b."""
    if not (0.0 <= r <= 1.0):
        raise ValueError("require 0 <= r <= 1")
    return _mixed(r, r)


@register("right_skewed")
def _right_skewed(r: float = 0.5) -> DiffFn:
    """f(a,b) = a∩b + r·(b − a∩b): keep the intersection, pull in an
    r-fraction of b-only elements."""

    def f(children: Sequence[MaterializedState]) -> MaterializedState:
        inter = get("intersection")(children)
        last = children[-1]
        hn = _slot_hash(inter.node_mask.size)
        he = _slot_hash(inter.edge_mask.size)
        nm = inter.node_mask | ((last.node_mask & ~inter.node_mask) & (hn < r))
        em = inter.edge_mask | ((last.edge_mask & ~inter.edge_mask) & (he < r))
        return _state(nm, em, children)
    return f


@register("left_skewed")
def _left_skewed(r: float = 0.5) -> DiffFn:
    """f(a,b) = a∩b + r·(a − a∩b)."""

    def f(children: Sequence[MaterializedState]) -> MaterializedState:
        inter = get("intersection")(children)
        first = children[0]
        hn = _slot_hash(inter.node_mask.size)
        he = _slot_hash(inter.edge_mask.size)
        nm = inter.node_mask | ((first.node_mask & ~inter.node_mask) & (hn < r))
        em = inter.edge_mask | ((first.edge_mask & ~inter.edge_mask) & (he < r))
        return _state(nm, em, children)
    return f
