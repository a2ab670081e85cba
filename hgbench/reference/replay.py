"""The plain reference: a straightforward replay of a generated history.

It reads only the generator's event arrays (``hgbench/history.py``) and
works everything out again itself: slot numbers (nodes and edges in the
order they were created), when each slot was added and deleted, which
edges are transient, and from those the snapshot at any ``t`` (every event
with time at most ``t`` applied, transient elements excluded), each node's
degree, the live counts and a weighted total.  Plain NumPy; nothing of the
program is imported or called.
"""
from __future__ import annotations

import numpy as np

from ..history import (ADD_EDGE, ADD_NODE, DEL_EDGE, TRANSIENT_EDGE,
                       History)

NEVER = np.iinfo(np.int64).max


class Replay:
    """Per-slot add and delete times of one history."""

    def __init__(self, hist: History):
        k = hist.kind
        nodes = k == ADD_NODE
        # node slots in order of creation; ids map to them
        node_ids = hist.a[nodes]
        self.num_nodes = int(node_ids.size)
        slot_of = np.full(int(node_ids.max(initial=-1)) + 1, -1, np.int64)
        slot_of[node_ids] = np.arange(self.num_nodes)
        self.node_added = hist.time[nodes]
        # edge slots in order of creation (adds and transient edges alike)
        made = (k == ADD_EDGE) | (k == TRANSIENT_EDGE)
        self.num_edges = int(made.sum())
        self.edge_added = hist.time[made]
        self.edge_src = slot_of[hist.a[made]]
        self.edge_dst = slot_of[hist.b[made]]
        self.edge_transient = k[made] == TRANSIENT_EDGE
        self.edge_deleted = np.full(self.num_edges, NEVER, np.int64)
        dels = k == DEL_EDGE
        self.edge_deleted[hist.a[dels]] = hist.time[dels]
        self.event_times = hist.time

    def masks(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """(node_mask, edge_mask) of the snapshot at ``t``."""
        nm = self.node_added <= t
        em = ((self.edge_added <= t) & (self.edge_deleted > t)
              & ~self.edge_transient)
        return nm, em

    def stale_masks(self, t: int, L: int) -> tuple[np.ndarray, np.ndarray]:
        """The snapshot at the last boundary of ``L`` events at or before
        ``t``: what a retrieval that skipped the partial eventlist would
        return: the stale control (``hgbench/drivers/point_analytics.py``)."""
        n = int(np.searchsorted(self.event_times, t, side="right"))
        cut = (n // L) * L
        if cut == 0:
            return (np.zeros(self.num_nodes, bool),
                    np.zeros(self.num_edges, bool))
        return self.masks(int(self.event_times[cut - 1]))

    def degrees(self, edge_mask: np.ndarray) -> np.ndarray:
        """Each node's degree over the live edges, both ends counted."""
        return (np.bincount(self.edge_src[edge_mask],
                            minlength=self.num_nodes)
                + np.bincount(self.edge_dst[edge_mask],
                              minlength=self.num_nodes))


def weighted_total(node_mask: np.ndarray, weights: np.ndarray) -> float:
    """Sum of ``weights`` over the live nodes, in float64."""
    return float(weights[node_mask].sum(dtype=np.float64))


def count_differing(got: np.ndarray, want: np.ndarray) -> int:
    """Elements of ``got`` that differ from ``want``; every one where the
    lengths differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return max(got.size, want.size)
    return int(np.count_nonzero(got != want))
