"""The churn history: a vectorised, frozen copy of the program's
``churn_network`` (``repro_torch/data/generators.py``).

A starting graph of ``n_initial_edges // 3`` nodes (each with ``n_attrs``
attributes) and up to ``n_initial_edges`` distinct undirected edges, then
``n_events`` events: transient edges, attribute updates, deletes of a
uniform live edge and adds of a new distinct edge.  The original's
``list(live.keys())`` on every delete is quadratic at two million events;
here a delete swaps the chosen edge with the last live one and pops it,
and the random numbers are drawn in bulk.  It keeps the original's
semantics and distributions, not its random stream.  Event times: the
starting graph at 0 and 1, then sorted uniform integers in
``[2, 10 n + 2)``.

Configuration keys (``history``): ``n_events``,
``initial_edges_divisor`` (``n_initial_edges = n_events // divisor``),
``p_delete``, ``p_attr_update``, ``p_transient``, ``n_attrs``.
"""
from __future__ import annotations

import numpy as np

from hgbench.history import (ADD_EDGE, ADD_NODE, DEL_EDGE, SET_NODE_ATTR,
                             TRANSIENT_EDGE, History, event_times)


def generate(params: dict, seed: int) -> History:
    return churn(params["n_events"] // params["initial_edges_divisor"],
                 params["n_events"], seed, p_delete=params["p_delete"],
                 p_attr_update=params["p_attr_update"],
                 p_transient=params["p_transient"],
                 n_attrs=params["n_attrs"])


def churn(n_initial_edges: int, n_events: int, seed: int,
          p_delete: float = 0.4, p_attr_update: float = 0.1,
          p_transient: float = 0.02, n_attrs: int = 2) -> History:
    """A starting graph, then interleaved edge adds
    and deletes, attribute updates and transient edges."""
    rng = np.random.default_rng(seed)
    n_nodes = max(8, n_initial_edges // 3)
    # the starting graph: every node with its attributes at 0, then the
    # distinct undirected edges at 1
    vals = rng.random((n_nodes, n_attrs)).astype(np.float32)
    per = 1 + n_attrs
    s_kind = np.full((n_nodes, per), SET_NODE_ATTR, np.int8)
    s_kind[:, 0] = ADD_NODE
    s_a = np.repeat(np.arange(n_nodes, dtype=np.int64), per).reshape(
        n_nodes, per)
    s_b = np.tile(np.arange(-1, n_attrs, dtype=np.int64), (n_nodes, 1))
    s_val = np.concatenate([np.full((n_nodes, 1), np.nan, np.float32), vals],
                           axis=1)
    live_key: list[int] = []     # undirected key of each live edge
    live_edge: list[int] = []    # its edge number
    where: dict[int, int] = {}   # key -> index in the live lists
    init_u, init_v = [], []
    for u, v in rng.integers(0, n_nodes, (n_initial_edges, 2)).tolist():
        key = min(u, v) * n_nodes + max(u, v)
        if u == v or key in where:
            continue
        where[key] = len(live_key)
        live_key.append(key)
        live_edge.append(len(init_u))
        init_u.append(u)
        init_v.append(v)
    n_init = len(init_u)
    times = event_times(rng, n_events) + 2
    # the main phase, one draw of everything an iteration may need; an add
    # of an edge that exists (or a loop) emits nothing, as in the original
    steps = int(n_events * 1.1) + 1024
    x = rng.random(steps)
    uv = rng.integers(0, n_nodes, (steps, 2))
    frac = rng.random(steps)
    col = rng.integers(0, n_attrs, steps)
    val = rng.random(steps, dtype=np.float32)
    cls = np.full(steps, ADD_EDGE, np.int8)
    cls[x < p_transient + p_attr_update + p_delete] = DEL_EDGE
    cls[x < p_transient + p_attr_update] = SET_NODE_ATTR
    cls[x < p_transient] = TRANSIENT_EDGE
    transient = cls == TRANSIENT_EDGE
    first_edge = n_init + np.cumsum(transient) - transient
    emitted = np.ones(steps, bool)
    edge_of = np.full(steps, -1, np.int64)    # the edge deleted or added
    live_or_new = np.nonzero(cls <= DEL_EDGE)[0]
    adds = skipped = 0
    for i, c, f, u, v in zip(live_or_new.tolist(),
                             cls[live_or_new].tolist(),
                             frac[live_or_new].tolist(),
                             uv[live_or_new, 0].tolist(),
                             uv[live_or_new, 1].tolist()):
        if i - skipped >= n_events:           # enough events before i
            break
        if c == DEL_EDGE and live_key:
            j = int(f * len(live_key))
            edge_of[i] = live_edge[j]
            del where[live_key[j]]
            k, e = live_key.pop(), live_edge.pop()
            if j < len(live_key):
                live_key[j], live_edge[j] = k, e
                where[k] = j
            continue
        cls[i] = ADD_EDGE
        key = min(u, v) * n_nodes + max(u, v)
        if u == v or key in where:
            emitted[i] = False
            skipped += 1
            continue
        e = int(first_edge[i]) + adds
        adds += 1
        edge_of[i] = e
        where[key] = len(live_key)
        live_key.append(key)
        live_edge.append(e)
    n_iter = n_events + skipped               # the iterations that emit
    if n_iter > steps:
        raise RuntimeError(f"{skipped} adds of existing edges: draw more")
    it = np.nonzero(emitted[:n_iter])[0]
    kind = cls[it]
    a = np.where(kind == DEL_EDGE, edge_of[it], uv[it, 0])
    b = np.where(kind == SET_NODE_ATTR, col[it], uv[it, 1])
    b = np.where(kind == DEL_EDGE, -1, b)
    value = np.where(kind == SET_NODE_ATTR, val[it], np.float32(np.nan))
    t = times[np.minimum(it, n_events - 1)]
    n0 = n_nodes * per
    return History(
        np.concatenate([np.zeros(n0, np.int64), np.ones(n_init, np.int64),
                        t]),
        np.concatenate([s_kind.reshape(-1),
                        np.full(n_init, ADD_EDGE, np.int8), kind]),
        np.concatenate([s_a.reshape(-1), np.asarray(init_u, np.int64), a]),
        np.concatenate([s_b.reshape(-1), np.asarray(init_v, np.int64), b]),
        np.concatenate([s_val.reshape(-1), np.full(n_init, np.nan,
                                                   np.float32),
                        value.astype(np.float32)]),
        n_attrs=n_attrs)
