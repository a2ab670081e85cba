"""Prior snapshot-retrieval techniques the paper evaluates against (§4.1,
§7): in-memory **interval trees**, **Copy+Log**, and the naive **Log**.

All three plug into the same benchmark harness as DeltaGraph (same
universe/events, same MaterializedState output) so retrieval-time and
storage comparisons are apples-to-apples.
"""
from __future__ import annotations

import numpy as np

from ..storage import columnar as col
from ..storage.kv import KVStore, MemKV
from .events import (EV_DEL_EDGE, EV_DEL_NODE, EV_NEW_EDGE, EV_NEW_NODE,
                     EventList, GraphUniverse, MaterializedState,
                     apply_events)


def _element_intervals(universe: GraphUniverse, events: EventList):
    """(kind, slot) → [birth, death) from the event trace (ids never
    reused ⇒ exactly one interval per element)."""
    INF = np.iinfo(np.int64).max
    n_birth = np.full(universe.num_nodes, INF, np.int64)
    n_death = np.full(universe.num_nodes, INF, np.int64)
    e_birth = np.full(universe.num_edges, INF, np.int64)
    e_death = np.full(universe.num_edges, INF, np.int64)
    for arr_b, arr_d, add_c, del_c in ((n_birth, n_death, EV_NEW_NODE, EV_DEL_NODE),
                                       (e_birth, e_death, EV_NEW_EDGE, EV_DEL_EDGE)):
        for code, arr in ((add_c, arr_b), (del_c, arr_d)):
            m = events.etype == code
            arr[events.slot[m]] = events.time[m]
    return n_birth, n_death, e_birth, e_death


class IntervalTreeIndex:
    """Centered (Edelsbrunner) interval tree per element kind.

    ``query(t)`` returns every element whose [birth, death) contains t —
    the valid-timeslice query — in O(log n + answer).
    """

    class _Node:
        __slots__ = ("center", "left", "right", "by_start", "by_end")

        def __init__(self, center):
            self.center = center
            self.left = None
            self.right = None
            self.by_start = None   # (starts sorted asc, ids)
            self.by_end = None     # (ends sorted desc, ids)

    def __init__(self, starts: np.ndarray, ends: np.ndarray) -> None:
        ids = np.arange(starts.size, dtype=np.int64)
        # zero-length intervals ([s, s): added and deleted at the same
        # timestamp) are never alive under half-open semantics — and they
        # make centered splits degenerate
        live = (starts < np.iinfo(np.int64).max) & (ends > starts)
        self.root = self._build_iter(starts[live], ends[live], ids[live])
        self.nbytes = int(starts.nbytes + ends.nbytes) * 2  # rough

    def _build_iter(self, starts, ends, ids):
        """Iterative build (deep skewed traces overflow Python recursion);
        degenerate splits fall back to the start median."""
        if ids.size == 0:
            return None
        INF = np.iinfo(np.int64).max
        root = self._Node(0)
        stack = [(starts, ends, ids, root)]
        while stack:
            starts, ends, ids, node = stack.pop()
            fin = ends[ends < INF]
            vals = np.concatenate([starts, fin]) if fin.size else starts
            center = np.median(vals)
            in_l = ends <= center
            in_r = starts > center
            if in_l.all() or in_r.all():
                center = np.median(starts)  # degenerate — split by starts
                in_l = ends <= center
                in_r = starts > center
                if in_l.all() or in_r.all():  # still stuck: keep all here
                    in_l[:] = False
                    in_r[:] = False
            mid = ~(in_l | in_r)
            node.center = center
            s, e, i = starts[mid], ends[mid], ids[mid]
            o1 = np.argsort(s)
            node.by_start = (s[o1], i[o1])
            o2 = np.argsort(-e)
            node.by_end = (e[o2], i[o2])
            if in_l.any():
                node.left = self._Node(0)
                stack.append((starts[in_l], ends[in_l], ids[in_l], node.left))
            if in_r.any():
                node.right = self._Node(0)
                stack.append((starts[in_r], ends[in_r], ids[in_r], node.right))
        return root

    def query(self, t: int) -> np.ndarray:
        out: list[np.ndarray] = []
        node = self.root
        while node is not None:
            if t < node.center:
                s, i = node.by_start
                k = np.searchsorted(s, t, side="right")
                out.append(i[:k])
                node = node.left
            elif t > node.center:
                e, i = node.by_end
                # half-open [birth, death): stabbed iff death > t
                k = np.searchsorted(-e, -t, side="left")
                out.append(i[:k])
                node = node.right
            else:
                # start <= center == t for all node intervals; still filter
                # by death > t (degenerate-kept intervals may end early)
                e, i = node.by_end
                k = np.searchsorted(-e, -t, side="left")
                out.append(i[:k])
                node = None
        if not out:
            return np.zeros(0, np.int64)
        res = np.concatenate(out)
        return res


class IntervalTreeStore:
    """Full baseline: one interval tree for nodes, one for edges."""

    def __init__(self, universe: GraphUniverse, events: EventList) -> None:
        self.universe = universe
        nb, nd, eb, ed = _element_intervals(universe, events)
        # an element is live in [birth, death); deletion at te removes at te
        self.nodes = IntervalTreeIndex(nb, nd)
        self.edges = IntervalTreeIndex(eb, ed)

    def get_snapshot(self, t: int) -> MaterializedState:
        st = MaterializedState.empty(self.universe)
        st.node_mask[self.nodes.query(t)] = True
        st.edge_mask[self.edges.query(t)] = True
        st.edge_mask &= ~self.universe.edge_transient[: st.edge_mask.size]
        st.node_mask &= ~self.universe.node_transient[: st.node_mask.size]
        return st

    def memory_bytes(self) -> int:
        return self.nodes.nbytes + self.edges.nbytes


class CopyLogStore:
    """Copy+Log (§4.1): a full packed snapshot every L events in the KV
    store + the eventlists; retrieval = nearest snapshot + replay."""

    def __init__(self, universe: GraphUniverse, events: EventList, L: int,
                 store: KVStore | None = None) -> None:
        self.universe = universe
        self.L = L
        self.store = store if store is not None else MemKV()
        self.events = events
        self.snap_pos: list[int] = []
        self.snap_time: list[int] = []
        state = MaterializedState.empty(universe)
        pos = 0
        sid = 0
        while True:
            # a *copy* stores the live element ids (4 B/element), like the
            # paper's full snapshots — not a packed bitmap, whose size would
            # be O(universe/8) and hide the Copy approach's true cost
            self.store.put((0, sid, "snap"), col.pack_arrays({
                "n": np.nonzero(state.node_mask)[0].astype(np.int32),
                "e": np.nonzero(state.edge_mask)[0].astype(np.int32)}))
            self.snap_pos.append(pos)
            self.snap_time.append(int(events.time[pos - 1]) if pos else
                                  (int(events.time[0]) - 1 if len(events) else 0))
            if pos >= len(events):
                break
            chunk = events[pos: pos + L]
            self.store.put((0, sid, "elist"),
                           col.encode_eventlist(chunk)[col.ELIST_STRUCT])
            state = apply_events(state, chunk, forward=True)
            pos += len(chunk)
            sid += 1

    def get_snapshot(self, t: int) -> MaterializedState:
        i = int(np.searchsorted(np.asarray(self.snap_time[1:]), t,
                                side="right"))
        i = min(i, len(self.snap_pos) - 1)
        blob = self.store.get((0, i, "snap"))
        arrs = col.unpack_arrays(blob)
        st = MaterializedState.empty(self.universe)
        st.node_mask[arrs["n"]] = True
        st.edge_mask[arrs["e"]] = True
        if i < len(self.snap_pos) - 1 or self.snap_pos[i] < len(self.events):
            try:
                s = col.unpack_arrays(self.store.get((0, i, "elist")))
            except KeyError:
                s = None
            if s is not None:
                m = s["time"] <= t
                et, sl = s["etype"][m], s["slot"][m]
                ncnt = st.node_mask.astype(np.int32)
                np.add.at(ncnt, sl[et == EV_NEW_NODE], 1)
                np.add.at(ncnt, sl[et == EV_DEL_NODE], -1)
                st.node_mask = ncnt > 0
                ecnt = st.edge_mask.astype(np.int32)
                np.add.at(ecnt, sl[et == EV_NEW_EDGE], 1)
                np.add.at(ecnt, sl[et == EV_DEL_EDGE], -1)
                st.edge_mask = ecnt > 0
        st.edge_mask &= ~self.universe.edge_transient[: st.edge_mask.size]
        st.node_mask &= ~self.universe.node_transient[: st.node_mask.size]
        return st

    def storage_bytes(self) -> int:
        return self.store.total_bytes()


class LogStore:
    """The naive Log approach: scan every event from the beginning."""

    def __init__(self, universe: GraphUniverse, events: EventList) -> None:
        self.universe = universe
        self.events = events

    def get_snapshot(self, t: int) -> MaterializedState:
        from .events import replay
        return replay(self.universe, self.events, t)

    def storage_bytes(self) -> int:
        return self.events.nbytes()
