"""Extensibility: auxiliary indexes over the DeltaGraph (paper §4.7).

The user supplies an :class:`AuxIndex` implementation with the paper's
three hooks:

* ``create_aux_event(event_ctx)``  — AuxiliaryEvents for a plain event,
  given the current graph + latest auxiliary snapshot;
* ``create_aux_snapshot(prev, aux_events)`` — next leaf AuxiliarySnapshot;
* ``aux_df(children)`` — differential function for auxiliary snapshots.

AuxiliarySnapshots are hashtables of string key→value pairs (paper's
structure); AuxiliaryEvents are (time, op, key, value) with op ∈
{ADD, DEL, SET}.  The HistoryManager indexes them automatically alongside
the graph: leaf aux-snapshots spaced L events apart, interior nodes via
``aux_df``, deltas stored columnar in the same KV store under
``aux.<name>`` components.  Queries subclass :class:`AuxHistQueryPoint` /
``...Interval`` / :class:`AuxHistQuery`.

Shipped example: :class:`LabelPathIndex` — the paper's subgraph-pattern
index (all label-paths of length ``plen``), with the paper's intersection
semantics ("a path is associated with an interior node iff present in all
snapshots below it"), plus :class:`DegreeHistogramIndex` used in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from ..storage import columnar as col
from ..storage.kv import KVStore
from .events import (EV_DEL_EDGE, EV_NEW_EDGE, EventList, GraphUniverse,
                     MaterializedState, apply_events, replay)

ADD, DEL, SET = 0, 1, 2

AuxSnapshot = dict[str, Any]


@dataclasses.dataclass
class AuxEvent:
    time: int
    op: int
    key: str
    value: Any = None


def apply_aux_events(snap: AuxSnapshot, evs: Sequence[AuxEvent]) -> AuxSnapshot:
    out = dict(snap)
    for e in evs:
        if e.op == DEL:
            out.pop(e.key, None)
        else:
            out[e.key] = e.value
    return out


class AuxIndex:
    """Abstract auxiliary index (paper §4.7)."""

    name: str = "aux"

    def create_aux_events(self, event_idx: int, events: EventList,
                          graph: MaterializedState,
                          universe: GraphUniverse,
                          latest: AuxSnapshot) -> list[AuxEvent]:
        raise NotImplementedError

    def create_aux_snapshot(self, prev: AuxSnapshot,
                            aux_events: Sequence[AuxEvent]) -> AuxSnapshot:
        return apply_aux_events(prev, aux_events)

    def aux_df(self, children: Sequence[AuxSnapshot]) -> AuxSnapshot:
        """Default: intersection with equal values (paper's pattern-index
        semantics: present at an interior node iff present below it)."""
        out = {}
        first = children[0]
        for k, v in first.items():
            if all(k in c and c[k] == v for c in children[1:]):
                out[k] = v
        return out


class AuxHistoryIndex:
    """Builds and queries the historical index for one AuxIndex, mirroring
    the DeltaGraph shape: leaf aux-snapshots every L events, interior
    aux-snapshots via aux_df, aux-deltas on edges.

    (For clarity this implementation keys aux payloads by the *skeleton
    node/edge ids* of an existing DeltaGraph, reusing its planner: a
    snapshot query resolves the same Dijkstra path and applies aux deltas.)
    """

    def __init__(self, aux: AuxIndex, dg, events: EventList) -> None:
        self.aux = aux
        self.dg = dg
        uni = dg.universe
        # leaf aux snapshots
        state = MaterializedState.empty(uni)
        snap: AuxSnapshot = {}
        self._leaf_snaps: list[AuxSnapshot] = [dict(snap)]
        pos = 0
        for leaf_i in range(1, len(dg.leaf_nids)):
            nxt = dg.leaf_pos[leaf_i]
            evs: list[AuxEvent] = []
            prev_snap = snap
            for i in range(pos, nxt):
                evs_i = self.aux.create_aux_events(i, events, state, uni, snap)
                evs.extend(evs_i)
                snap = apply_aux_events(snap, evs_i)  # keep `latest` fresh
                state = apply_events(state, events[i:i + 1], forward=True)
            # the paper hook: leaf snapshot from (previous snapshot, events)
            snap = self.aux.create_aux_snapshot(prev_snap, evs)
            self._leaf_snaps.append(dict(snap))
            pos = nxt
        # events kept for the residual tail within a leaf eventlist
        self._events = events

    # -- persistence ---------------------------------------------------------
    # aux leaf snapshots ride the same codec-compressed, checksummed blob
    # path as every other payload, keyed ``(0, -10, "aux.<name>")`` next to
    # the skeleton's reserved ids
    _AUX_PID = -10

    def save(self, store: KVStore | None = None) -> int:
        """Persist the leaf aux-snapshots; returns bytes written.
        Snapshot values must be JSON-representable (numpy scalars are
        coerced; tuples round-trip as lists)."""
        import json as _json

        def _coerce(o):
            if isinstance(o, np.integer):
                return int(o)
            if isinstance(o, np.floating):
                return float(o)
            raise TypeError(f"aux snapshot value {o!r} is not "
                            f"JSON-representable")

        store = store if store is not None else self.dg.store
        payload = _json.dumps({"name": self.aux.name,
                               "leaf_snaps": self._leaf_snaps},
                              default=_coerce).encode()
        blob = col.pack_arrays(
            {"json": np.frombuffer(payload, np.uint8)})
        store.put((0, self._AUX_PID, f"aux.{self.aux.name}"), blob)
        return len(blob)

    @classmethod
    def load_snaps(cls, store: KVStore, name: str) -> list[AuxSnapshot]:
        """Decode a persisted aux index's leaf snapshots (standalone — the
        residual-tail replay still needs the event trace)."""
        import json as _json

        blob = store.get((0, cls._AUX_PID, f"aux.{name}"))
        arrays = col.unpack_arrays(blob)
        payload = _json.loads(bytes(arrays["json"]).decode())
        return payload["leaf_snaps"]

    # -- queries -------------------------------------------------------------
    def snapshot_at(self, t: int) -> AuxSnapshot:
        li = self.dg._leaf_for_time(t)
        li = min(li, len(self._leaf_snaps) - 1)
        snap = dict(self._leaf_snaps[li])
        uni = self.dg.universe
        pos = self.dg.leaf_pos[li]
        # leaf state is defined by event *position* (exact under timestamps
        # straddling a leaf boundary), not by boundary time
        state = apply_events(MaterializedState.empty(uni),
                             self._events[:pos], forward=True)
        ev = self._events
        while pos < len(ev) and ev.time[pos] <= t:
            evs = self.aux.create_aux_events(pos, ev, state, uni, snap)
            snap = apply_aux_events(snap, evs)
            state = apply_events(state, ev[pos:pos + 1], forward=True)
            pos += 1
        return snap

    def query_point(self, t: int, key: str) -> Any:
        return self.snapshot_at(t).get(key)

    def query_whole_history(self, key: str) -> bool:
        """Paper's root semantics under intersection aux_df: key present
        throughout history iff present at every leaf."""
        return all(key in s for s in self._leaf_snaps)

    def query_interval(self, ts: int, te: int, key: str) -> bool:
        return any(key in self.snapshot_at(t) for t in (ts, te))


# ---------------------------------------------------------------------------
# shipped aux indexes
# ---------------------------------------------------------------------------

class LabelPathIndex(AuxIndex):
    """Paper §4.7's subgraph-pattern index: key = label path of length
    ``plen`` (node labels joined by '|'), value = count of matching paths.

    ``labels`` maps node slot → label string.  ``create_aux_events`` finds
    the paths affected by an edge addition/deletion in the *current* graph
    context (exactly the paper's CreateAuxEvent contract).
    """

    def __init__(self, labels: Sequence[str], plen: int = 3) -> None:
        self.name = f"labelpath{plen}"
        self.labels = list(labels)
        self.plen = plen

    def _paths_through(self, graph: MaterializedState, uni: GraphUniverse,
                       u: int, v: int) -> list[tuple[int, ...]]:
        """All node paths of length plen that use edge (u, v), in the graph
        *with* the edge present."""
        from ..graph.csr import build_csr
        csr = build_csr(uni.edge_src, uni.edge_dst, uni.num_nodes,
                        graph.edge_mask, uni.edge_directed)
        plen = self.plen
        out: set[tuple[int, ...]] = set()

        def forward(path: tuple[int, ...]):
            if len(path) == plen:
                out.add(path)
                return
            for w in csr.neighbors(path[-1]):
                if w not in path:
                    forward(path + (int(w),))

        def backward(path: tuple[int, ...], want: int):
            if len(path) == want:
                forward(path)
                return
            for w in csr.neighbors(path[0]):
                if w not in path:
                    backward((int(w),) + path, want)

        # paths with (a, b) as a consecutive pair, any prefix length
        def around(a: int, b: int):
            if b not in csr.neighbors(a):
                return  # directed edge not traversable this way
            for pre_len in range(plen - 1):
                backward((a, b), pre_len + 2)

        around(u, v)
        around(v, u)
        return list(out)

    def create_aux_events(self, i, events, graph, uni, latest):
        et = int(events.etype[i])
        if et not in (EV_NEW_EDGE, EV_DEL_EDGE):
            return []
        slot = int(events.slot[i])
        u, v = int(uni.edge_src[slot]), int(uni.edge_dst[slot])
        t = int(events.time[i])
        # evaluate in the graph *with* the edge present (for deletions the
        # removed paths are exactly those through the still-present edge)
        g = graph.copy()
        g.edge_mask[slot] = True
        paths = self._paths_through(g, uni, u, v)
        evs = []
        sign = 1 if et == EV_NEW_EDGE else -1
        counts: dict[str, int] = {}
        for p in paths:
            key = "|".join(self.labels[n] for n in p)
            counts[key] = counts.get(key, 0) + sign
        for key, dc in counts.items():
            cur = latest.get(key, 0)
            new = cur + dc
            evs.append(AuxEvent(t, SET if new > 0 else DEL, key,
                                new if new > 0 else None))
            latest = apply_aux_events(latest, [evs[-1]])
        return evs


class DegreeHistogramIndex(AuxIndex):
    """Tiny aux index used in tests: key = f"deg{d}" → number of nodes with
    degree d (undirected count)."""

    name = "deghist"

    def create_aux_events(self, i, events, graph, uni, latest):
        et = int(events.etype[i])
        if et not in (EV_NEW_EDGE, EV_DEL_EDGE):
            return []
        slot = int(events.slot[i])
        u, v = int(uni.edge_src[slot]), int(uni.edge_dst[slot])
        t = int(events.time[i])
        deg = np.zeros(uni.num_nodes, np.int64)
        eidx = np.nonzero(graph.edge_mask)[0]
        np.add.at(deg, uni.edge_src[eidx], 1)
        np.add.at(deg, uni.edge_dst[eidx], 1)
        sign = 1 if et == EV_NEW_EDGE else -1
        evs: list[AuxEvent] = []
        snap = dict(latest)
        for n in (u, v):
            d0 = int(deg[n])
            d1 = d0 + sign
            for d, dc in ((d0, -1), (d1, +1)):
                if d == 0:
                    continue  # degree-0 nodes are not histogrammed
                key = f"deg{d}"
                cur = snap.get(key, 0) + dc
                ev = AuxEvent(t, SET if cur > 0 else DEL, key,
                              cur if cur > 0 else None)
                snap = apply_aux_events(snap, [ev])
                evs.append(ev)
        return evs
