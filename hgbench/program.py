"""Hands a generated history to the program under test, ``repro_torch``.

The only place the benchmark turns its plain event arrays into the
program's own structures: one ``GraphHistoryBuilder`` call per event, in
generation order, then the ``GraphManager`` over the finished history
with the configuration's index parameters.  Importing this module imports
nothing of the program; :func:`build_manager` does.
"""
from __future__ import annotations

from .history import (ADD_EDGE, ADD_NODE, DEL_EDGE, SET_NODE_ATTR,
                      TRANSIENT_EDGE, History)


def to_program(hist: History):
    """``(universe, events)`` of the program, built by its
    ``GraphHistoryBuilder`` from ``hist``."""
    from repro_torch.core.events import GraphHistoryBuilder
    b = GraphHistoryBuilder()
    names = [f"attr{j}" for j in range(hist.n_attrs)]
    slots: list[int] = []           # edge number -> the builder's slot
    for t, k, a, c, v in zip(hist.time.tolist(), hist.kind.tolist(),
                             hist.a.tolist(), hist.b.tolist(),
                             hist.value.tolist()):
        if k == ADD_EDGE:
            slots.append(b.add_edge(a, c, t, edge_id=len(slots)))
        elif k == ADD_NODE:
            b.add_node(a, t)
        elif k == DEL_EDGE:
            b.delete_edge_slot(slots[a], t)
        elif k == SET_NODE_ATTR:
            b.set_node_attr(a, names[c], v, t)
        elif k == TRANSIENT_EDGE:
            slots.append(b.transient_edge(a, c, t))
        else:
            raise ValueError(f"unknown event kind {k}")
    return b.finalize()


def build_manager(config: dict, universe, events, device):
    """The configuration's ``GraphManager`` (index built over ``events``)
    on an in-memory store."""
    from repro_torch.core import GraphManager
    from repro_torch.storage.kv import MemKV
    ix = config["index"]
    if ix["store"] != "mem":
        raise ValueError(f"unknown store {ix['store']!r}")
    return GraphManager(universe, events, store=MemKV(), L=ix["L"],
                        k=ix["k"], diff_fn=ix["diff_fn"],
                        cache_bytes=ix["cache_bytes"], device=device)
