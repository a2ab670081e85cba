"""Synthetic historical-trace generators mirroring the paper's datasets (§7).

* :func:`growing_network`  — Dataset 1 analogue: a growing-only
  co-authorship-style network (preferential attachment, nodes+edges only
  added, per-node attribute key-value pairs).
* :func:`churn_network`    — Dataset 2/3 analogue: a starting snapshot
  followed by interleaved edge additions and deletions (and optional
  attribute updates / transient "message" events).
* :func:`random_history`   — fully random small traces for property tests.

All generators return ``(universe, events)`` via the builder, with event
times drawn from a super-linear event-density g(t) when requested (§5.1).
"""
from __future__ import annotations

import numpy as np

from ..core.events import EventList, GraphHistoryBuilder, GraphUniverse

ATTR_NAMES = [f"attr{i}" for i in range(10)]


def _times(rng: np.ndarray, n: int, superlinear: bool) -> np.ndarray:
    if superlinear:
        # event density increasing over time: t ~ sqrt(uniform)
        u = np.sort(rng.uniform(0, 1, n))
        t = (np.sqrt(u) * n * 10).astype(np.int64)
    else:
        t = np.sort(rng.integers(0, n * 10, n).astype(np.int64))
    return t


def growing_network(n_events: int = 4000, seed: int = 0,
                    n_attrs: int = 3, attrs_on_add: bool = True,
                    superlinear: bool = False) -> tuple[GraphUniverse, EventList]:
    rng = np.random.default_rng(seed)
    b = GraphHistoryBuilder()
    times = _times(rng, n_events, superlinear)
    nodes: list[int] = []
    budget = n_events
    i = 0
    nid = 0
    while budget > 0:
        t = int(times[min(i, len(times) - 1)])
        if len(nodes) < 2 or rng.random() < 0.3:
            attrs = ({ATTR_NAMES[j]: float(rng.random())
                      for j in range(n_attrs)} if attrs_on_add else None)
            b.add_node(nid, t, attrs=attrs)
            nodes.append(nid)
            nid += 1
            budget -= 1 + (n_attrs if attrs_on_add else 0)
        else:
            # preferential-ish: bias toward recent nodes
            u = nodes[int(len(nodes) * rng.beta(2, 1)) - 1]
            v = nodes[rng.integers(0, len(nodes))]
            if u != v:
                b.add_edge(u, v, t, edge_id=("e", u, v, i))
                budget -= 1
        i += 1
    return b.finalize()


def churn_network(n_initial_edges: int = 500, n_events: int = 4000,
                  seed: int = 0, p_delete: float = 0.4,
                  p_attr_update: float = 0.1, p_transient: float = 0.02,
                  n_attrs: int = 2,
                  superlinear: bool = False) -> tuple[GraphUniverse, EventList]:
    rng = np.random.default_rng(seed)
    b = GraphHistoryBuilder()
    n_nodes = max(8, n_initial_edges // 3)
    for n in range(n_nodes):
        b.add_node(n, 0, attrs={ATTR_NAMES[j]: float(rng.random())
                                for j in range(n_attrs)})
    live: dict[tuple[int, int], int] = {}
    eid = 0
    for _ in range(n_initial_edges):
        u, v = rng.integers(0, n_nodes, 2)
        if u == v or (int(u), int(v)) in live or (int(v), int(u)) in live:
            continue
        live[(int(u), int(v))] = b.add_edge(int(u), int(v), 1,
                                            edge_id=("e", eid))
        eid += 1
    times = _times(rng, n_events, superlinear) + 2
    i = 0
    emitted = 0
    while emitted < n_events:
        t = int(times[min(i, len(times) - 1)])
        i += 1
        r = rng.random()
        if r < p_transient:
            u, v = rng.integers(0, n_nodes, 2)
            b.transient_edge(int(u), int(v), t)
            emitted += 1
        elif r < p_transient + p_attr_update:
            n = int(rng.integers(0, n_nodes))
            b.set_node_attr(n, ATTR_NAMES[int(rng.integers(0, n_attrs))],
                            float(rng.random()), t)
            emitted += 1
        elif live and r < p_transient + p_attr_update + p_delete:
            key = list(live.keys())[int(rng.integers(0, len(live)))]
            slot = live.pop(key)
            b.delete_edge_slot(slot, t)
            emitted += 1
        else:
            u, v = rng.integers(0, n_nodes, 2)
            if u == v or (int(u), int(v)) in live or (int(v), int(u)) in live:
                continue
            live[(int(u), int(v))] = b.add_edge(int(u), int(v), t,
                                                edge_id=("e", eid))
            eid += 1
            emitted += 1
    return b.finalize()


def dense_intervals(tmax: int, n: int, points: int,
                    window_frac: float = 0.05,
                    seed: int = 0) -> list[list[int]]:
    """``n`` evolutionary-query windows of ``points`` evenly spaced
    timepoints, each spanning ``window_frac`` of the history — the dense
    "daily snapshots over a period" dashboard workload that
    ``GraphManager.evolve`` / ``benchmarks/temporal_bench.py`` /
    ``serve --mode evolve`` drive."""
    rng = np.random.default_rng(seed)
    span = max(int(tmax * window_frac), points)
    starts = rng.integers(0, max(tmax - span, 1), n)
    return [[int(t) for t in np.linspace(s, s + span, points)]
            for s in starts]


def random_history(n_events: int, seed: int,
                   n_attrs: int = 2, p_node: float = 0.3,
                   p_delete: float = 0.3, p_attr: float = 0.2,
                   p_transient: float = 0.05,
                   max_time_step: int = 3) -> tuple[GraphUniverse, EventList]:
    """Small fully-random trace; duplicate timestamps on purpose (straddled
    leaf boundaries are a key edge case)."""
    rng = np.random.default_rng(seed)
    b = GraphHistoryBuilder()
    live_nodes: list[int] = []
    live_edges: list[tuple] = []
    t = 0
    nid = 0
    emitted = 0
    while emitted < n_events:
        t += int(rng.integers(0, max_time_step + 1))  # may repeat
        r = rng.random()
        if not live_nodes or r < p_node:
            b.add_node(nid, t)
            live_nodes.append(nid)
            nid += 1
        elif r < p_node + p_attr:
            n = live_nodes[int(rng.integers(0, len(live_nodes)))]
            b.set_node_attr(n, ATTR_NAMES[int(rng.integers(0, n_attrs))],
                            float(np.round(rng.random(), 3)), t)
        elif r < p_node + p_attr + p_transient and len(live_nodes) >= 2:
            u, v = rng.choice(len(live_nodes), 2, replace=False)
            b.transient_edge(live_nodes[u], live_nodes[v], t)
        elif live_edges and r < p_node + p_attr + p_transient + p_delete:
            j = int(rng.integers(0, len(live_edges)))
            slot = live_edges.pop(j)
            b.delete_edge_slot(slot, t)
        elif len(live_nodes) >= 2:
            u, v = rng.choice(len(live_nodes), 2, replace=False)
            live_edges.append(b.add_edge(live_nodes[u], live_nodes[v], t,
                                         edge_id=("e", emitted)))
        else:
            continue
        emitted += 1
    return b.finalize()
