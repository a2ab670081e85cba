"""The growing history: a vectorised, frozen copy of the program's
``growing_network`` (``repro_torch/data/generators.py``), nodes and
undirected edges only added.

It keeps the original's semantics and distributions, not its random
stream: a node with probability 0.3 (the first two steps always),
otherwise an edge from ``nodes[int(n * beta(2, 1)) - 1]`` (index -1 is
the newest node, as in the original) to a uniform node, dropped when both
ends are one node.  Every step is drawn at once.  Event times are the
original's: sorted uniform integers in ``[0, 10 n)``.

Configuration keys (``history``): ``n_events``; ``attrs_on_add`` must be
false (no attributes, as the deployment runs it).
"""
from __future__ import annotations

import numpy as np

from hgbench.history import ADD_EDGE, ADD_NODE, History, event_times


def generate(params: dict, seed: int) -> History:
    if params.get("attrs_on_add", False):
        raise ValueError("the growing generator makes no attributes")
    return growing(params["n_events"], seed)


def growing(n_events: int, seed: int) -> History:
    """``n_events`` node and edge additions from ``seed``."""
    rng = np.random.default_rng(seed)
    times = event_times(rng, n_events)
    steps = int(n_events * 1.05) + 64
    while True:
        r = rng.random(steps)
        beta = rng.beta(2.0, 1.0, steps)
        pick = rng.random(steps)
        is_node = r < 0.3
        is_node[:2] = True
        n_before = np.cumsum(is_node) - is_node
        n_safe = np.maximum(n_before, 1)
        u = np.floor(n_safe * beta).astype(np.int64) - 1
        u[u < 0] += n_safe[u < 0]
        v = np.minimum(np.floor(pick * n_safe).astype(np.int64), n_safe - 1)
        emits = is_node | (u != v)
        done = np.cumsum(emits)
        if done[-1] >= n_events:
            break
        steps *= 2
    last = int(np.searchsorted(done, n_events))      # the step of event n
    step = np.nonzero(emits[:last + 1])[0]
    node = is_node[step]
    kind = np.where(node, ADD_NODE, ADD_EDGE).astype(np.int8)
    a = np.where(node, n_before[step], u[step])
    b = np.where(node, -1, v[step])
    time = times[np.minimum(step, n_events - 1)]
    value = np.full(step.size, np.nan, np.float32)
    return History(time, kind, a.astype(np.int64), b.astype(np.int64), value,
                   n_attrs=0)
