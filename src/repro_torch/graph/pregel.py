"""Pregel-like vertex-centric iteration (paper §3.2 / §7: "we have
implemented an iterative vertex-based message-passing system analogous to
Pregel").

``run_pregel`` executes supersteps of

    messages = msg_fn(state[src], state[dst], edge_live)
    agg      = segment_sum(messages, dst)
    state    = update_fn(state, agg, superstep)

on a masked snapshot.

API difference from the JAX package: ``msg_fn`` and ``update_fn`` are
torch callables.  They receive tensors on the solver's device (``state``
rows gathered by edge, the bool live-edge mask, the aggregated messages)
and ``superstep`` as a Python int, and return tensors; the reference's are
``jax.numpy`` functions traced under ``lax.scan`` / ``while_loop``.
Inputs may be numpy arrays or tensors; they run on ``device=`` (default
``"cuda"``; a missing card raises unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.policy import resolve_device
from ..core import bitmaps as bm
from .algorithms import _fixpoint, _tensor


def _by_node(messages: torch.Tensor, ids: torch.Tensor,
             num_nodes: int) -> torch.Tensor:
    """Segment sum of per-edge ``messages [E, ...]`` into ``[N, ...]``."""
    out = messages.new_zeros((num_nodes, *messages.shape[1:]))
    return out.index_add_(0, ids, messages)


def _superstep(msg_fn, update_fn, es, ed, emask, num_nodes, bidirectional):
    def one(state, step):
        m = msg_fn(state[es], state[ed], emask)
        agg = _by_node(m, ed, num_nodes)
        if bidirectional:
            m2 = msg_fn(state[ed], state[es], emask)
            agg = agg + _by_node(m2, es, num_nodes)
        return update_fn(state, agg, step)
    return one


def _inputs(state0, edge_src, edge_dst, edge_plane, device):
    dev = resolve_device(device)
    es = _tensor(edge_src, dev, torch.int64)
    ed = _tensor(edge_dst, dev, torch.int64)
    emask = bm.unpack(_tensor(edge_plane, dev), es.shape[0])
    return _tensor(state0, dev), es, ed, emask


def run_pregel(state0, edge_src, edge_dst, edge_plane,
               msg_fn: Callable, update_fn: Callable, *,
               num_supersteps: int, num_nodes: int,
               bidirectional: bool = True, device="cuda") -> torch.Tensor:
    state, es, ed, emask = _inputs(state0, edge_src, edge_dst, edge_plane,
                                   device)
    one = _superstep(msg_fn, update_fn, es, ed, emask, num_nodes,
                     bidirectional)
    for step in range(num_supersteps):
        state = one(state, step)
    return state


def run_pregel_until(state0, edge_src, edge_dst, edge_plane,
                     msg_fn: Callable, update_fn: Callable, *,
                     max_supersteps: int, num_nodes: int,
                     tol: float = 0.0, bidirectional: bool = True,
                     device="cuda") -> tuple[torch.Tensor, int]:
    """Convergence-checked Pregel: supersteps run until the state's L1
    change drops to ``tol`` (or ``max_supersteps``).  This is the
    warm-start hook for interval analytics (:mod:`repro_torch.core.temporal`):
    seeding ``state0`` with the previous snapshot's converged state makes
    the superstep count proportional to how much the snapshot actually
    changed, not to the graph's diameter.  Returns ``(state, steps_used)``;
    the change is checked on the device once per block of supersteps
    (:func:`repro_torch.graph.algorithms._fixpoint`), and the state
    returned is the first that met ``tol``."""
    state, es, ed, emask = _inputs(state0, edge_src, edge_dst, edge_plane,
                                   device)
    one = _superstep(msg_fn, update_fn, es, ed, emask, num_nodes,
                     bidirectional)
    return _fixpoint(
        state, one,
        lambda new, old: ~((new.float() - old.float()).abs().sum() > tol),
        max_supersteps)
