"""DeltaGraph: the hierarchical index over a historical graph trace (§4).

Construction is a single pass over the eventlist, bottom-up like a
bulk-loaded B+-tree (§4.6): leaves are implicit snapshots every ``L``
events; every ``k`` nodes of a level get a parent whose (virtual) graph is
``f(children)`` for a pluggable differential function ``f`` (§5.2); only the
*deltas* along edges are persisted — columnar, partitioned by the node-ID
space, into a get/put KV store under ``⟨partition, delta_id, component⟩``
keys (§4.2).

The in-memory **skeleton** holds topology + byte statistics only.  Planning:

* singlepoint  → multi-source Dijkstra (super-root + every materialized
  node + the current graph are distance-0 sources) over the skeleton plus
  per-query virtual nodes (§4.3);
* multipoint   → metric-closure MST 2-approximate Steiner tree, unfolded
  onto the skeleton and pruned (§4.4); shared prefixes execute once
  (multi-query optimization).

Incremental maintenance (§6 "updates to the current graph"): new events
accumulate in a *recent* eventlist; at ``L`` events it becomes a new leaf
and the ragged right spine ("cap") is torn down and rebuilt.
"""
from __future__ import annotations

import copy
import dataclasses
import heapq
import json
import time
from typing import Any, Callable, Sequence

import numpy as np

from ..storage import columnar as col
from ..storage.kv import KVStore
from . import diff_functions
from .deltas import AttrDelta, Delta, apply_delta, state_diff
from .events import (EV_DEL_EDGE, EV_DEL_NODE, EV_NEW_EDGE, EV_NEW_NODE,
                     EventList, GraphUniverse, MaterializedState, apply_events)
from .planir import PlanBuilder, PlanIR
from .query import NO_ATTRS, AttrOptions

# every planner emits the unified retrieval-plan IR (core/planir.py);
# ``Plan`` is kept as the public name for the emitted DAG
Plan = PlanIR

SUPERROOT = 0

# Decode-aware plan cost model: traversing an edge costs
# ``α·stored_bytes + β·logical_bytes`` — fetching a payload moves its
# *stored* (compressed, at-rest) bytes over the store, while decoding it
# back into arrays costs roughly its *logical* (decoded) bytes.  In-memory
# event replay (the recent eventlist / CURRENT crossings) has no fetch
# half, so it is priced at β·logical only.  With the raw codec
# stored == logical and the model degrades to the paper's bytes-fetched.
COST_ALPHA_STORED = 1.0
COST_BETA_DECODE = 0.15

# ---------------------------------------------------------------------------
# skeleton
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NodeInfo:
    nid: int
    kind: str                      # 'superroot' | 'interior' | 'leaf'
    level: int                     # leaves = 1 (paper numbers from bottom)
    leaf_index: int = -1
    pos: int = -1                  # event-prefix length defining a leaf
    time: int = 0                  # boundary time (leaves)
    hierarchy: int = 0             # which diff-function hierarchy (fig 3b)
    materialized_as: int | None = None  # GraphPool graph id
    mat_node_cols: tuple | None = None  # attr columns stored at materialization
    mat_edge_cols: tuple | None = None


@dataclasses.dataclass
class EdgeInfo:
    eid: int
    src: int                       # apply `forward` = src -> dst
    dst: int
    kind: str                      # 'delta' | 'elist'
    payload_id: int
    w_struct: int = 0              # stored (at-rest, compressed) bytes
    w_nodeattr: np.ndarray | None = None   # int64[A_n] stored bytes per column
    w_edgeattr: np.ndarray | None = None
    n_events: int = 0              # elist edges: struct event count
    is_cap: bool = False           # part of the tear-down-able right spine
    w_struct_logical: int = 0      # decoded (raw array) bytes
    w_nodeattr_logical: np.ndarray | None = None
    w_edgeattr_logical: np.ndarray | None = None

    def weight(self, options: AttrOptions, frac: float = 1.0,
               backward: bool = False) -> float:
        """Cost to fetch+decode+apply this edge under the given options:
        ``α·stored + β·logical`` bytes (``COST_ALPHA_STORED`` /
        ``COST_BETA_DECODE``) — the planner prices compressed payloads by
        what they actually move over the store *and* what they cost to
        decode back into arrays.

        Backward traversal of *eventlist* edges cannot restore attributes of
        elements whose attribute events lie before the traversed window
        (deleted-element revival), so it is priced at +inf for attribute-
        carrying queries; structure-only backward traversal is exact.
        """
        if options.wants_attrs and self.kind == "elist" and backward:
            return float("inf")
        stored = float(self.w_struct)
        logical = float(self.w_struct_logical)
        if options.wants_node and self.w_nodeattr is not None and self.w_nodeattr.size:
            cols = [c for c in options.node_cols if c < self.w_nodeattr.size]
            stored += float(self.w_nodeattr[cols].sum())
            if (self.w_nodeattr_logical is not None
                    and self.w_nodeattr_logical.size):
                logical += float(self.w_nodeattr_logical[cols].sum())
        if options.wants_edge and self.w_edgeattr is not None and self.w_edgeattr.size:
            cols = [c for c in options.edge_cols if c < self.w_edgeattr.size]
            stored += float(self.w_edgeattr[cols].sum())
            if (self.w_edgeattr_logical is not None
                    and self.w_edgeattr_logical.size):
                logical += float(self.w_edgeattr_logical[cols].sum())
        return (COST_ALPHA_STORED * stored + COST_BETA_DECODE * logical) * frac


class DeltaGraph:
    """Build once (or incrementally maintain) and query forever."""

    def __init__(self, universe: GraphUniverse, store: KVStore, *,
                 L: int = 1000, k: int = 2,
                 diff_fn: str | Sequence[str] = "balanced",
                 diff_params: dict | Sequence[dict] | None = None,
                 num_partitions: int = 1,
                 partition_fn: str = "word_cyclic") -> None:
        if k < 2:
            raise ValueError("arity k must be >= 2")
        self.universe = universe
        self.store = store
        self.L = int(L)
        self.k = int(k)
        fns = [diff_fn] if isinstance(diff_fn, str) else list(diff_fn)
        prm = diff_params
        if prm is None:
            prm = [{}] * len(fns)
        elif isinstance(prm, dict):
            prm = [prm]
        self.diff_names = fns
        self.diff_params = list(prm)
        self.diff_fns = [diff_functions.get(n, **p) for n, p in zip(fns, prm)]
        self.P = int(num_partitions)
        self.partition_fn_name = partition_fn
        from ..runtime.partition import get_partitioner
        self._hp = get_partitioner(partition_fn)

        # skeleton ----------------------------------------------------------
        self.nodes: dict[int, NodeInfo] = {
            SUPERROOT: NodeInfo(SUPERROOT, "superroot", level=10**6)}
        self.edges: dict[int, EdgeInfo] = {}
        self.adj: dict[int, list[int]] = {SUPERROOT: []}
        self._next_nid = 1
        self._next_eid = 0
        self._next_payload = 0
        self.leaf_nids: list[int] = []
        self.leaf_pos: list[int] = []      # event-prefix length per leaf
        self.leaf_time: list[int] = []     # boundary time per leaf
        # bulk-load frontier: per hierarchy, per level, list of (nid, state)
        self._frontier: list[list[list[tuple[int, MaterializedState]]]] = [
            [] for _ in fns]
        self._cap_nodes: list[int] = []
        self._cap_edges: list[int] = []
        self._last_leaf_state: MaterializedState | None = None
        # recent (unindexed) events, §6
        self.recent = EventList.empty()
        self._total_events = 0
        # red/green rebuilds (core/ingest.py): when set, payload deletion
        # is *deferred* — keys append here instead of hitting the store, so
        # readers pinned to an older epoch keep their cap deltas until the
        # epoch registry drains them
        self.reclaim_sink: list | None = None
        # cooperative-yield hook for background folds (core/ingest.py):
        # called between fold sub-steps so a rollover running on a worker
        # thread hands the GIL to query threads instead of holding it for
        # the whole multi-ms fold
        self.nice = None
        # online query-traffic histogram (materialize.WorkloadStats),
        # attached by GraphManager; every execute() records into it
        self.workload = None

    def _nice(self) -> None:
        n = self.nice
        if n is not None:
            n()

    # ------------------------------------------------------------------ build
    def build(self, events: EventList) -> "DeltaGraph":
        """Single-pass bottom-up construction (§4.6)."""
        state = MaterializedState.empty(self.universe)
        self._emit_leaf(state, pos=0,
                        time=int(events.time[0]) - 1 if len(events) else 0)
        n_full = len(events) // self.L
        for i in range(n_full):
            chunk = events[i * self.L:(i + 1) * self.L]
            state = apply_events(state, chunk, forward=True)
            self._store_eventlist(self.leaf_nids[-1], chunk)
            self._emit_leaf(state, pos=(i + 1) * self.L,
                            time=int(chunk.time[-1]))
        self.recent = events[n_full * self.L:]
        self._total_events = len(events)
        self._cap()
        return self

    def _emit_leaf(self, state: MaterializedState, pos: int, time: int) -> None:
        nid = self._new_node("leaf", level=1, leaf_index=len(self.leaf_nids),
                             pos=pos, time=time)
        self.leaf_nids.append(nid)
        self.leaf_pos.append(pos)
        self.leaf_time.append(time)
        self._last_leaf_state = state.copy()
        for h in range(len(self.diff_fns)):
            self._push_frontier(h, 0, nid, state.copy(), cap=False)

    def _push_frontier(self, h: int, depth: int, nid: int,
                       state: MaterializedState, cap: bool) -> None:
        levels = self._frontier[h]
        while len(levels) <= depth:
            levels.append([])
        levels[depth].append((nid, state))
        if len(levels[depth]) == self.k:
            self._make_parent(h, depth, levels[depth], cap=cap)
            levels[depth] = []

    def _make_parent(self, h: int, depth: int,
                     children: list[tuple[int, MaterializedState]],
                     cap: bool) -> int:
        # children may predate live universe growth (§6) — resize first
        children = [(nid, st.resized(self.universe)) for nid, st in children]
        states = [s for _, s in children]
        pstate = self.diff_fns[h](states)
        pnid = self._new_node("interior", level=depth + 2, hierarchy=h)
        if cap:
            self._cap_nodes.append(pnid)
        for cnid, cstate in children:
            d = state_diff(cstate, pstate)
            self._add_delta_edge(pnid, cnid, d, cap=cap)
        self._push_frontier(h, depth + 1, pnid, pstate, cap=cap)
        return pnid

    def _cap(self) -> None:
        """Close the ragged right spine up to a root per hierarchy and hang
        the root off the super-root.  Cap nodes/edges are torn down by
        :meth:`_uncap` when appends arrive (§6).  Pending frontier nodes are
        flattened top-level-first (chronological order) and grouped ≤ k."""
        for h in range(len(self.diff_fns)):
            cur: list[tuple[int, MaterializedState]] = []
            for lv in reversed(self._frontier[h]):
                cur.extend(lv)
            if not cur:
                continue
            cur = [(nid, st.resized(self.universe)) for nid, st in cur]
            depth = 1
            while len(cur) > 1:
                nxt: list[tuple[int, MaterializedState]] = []
                for j in range(0, len(cur), self.k):
                    sub = cur[j:j + self.k]
                    if len(sub) == 1:
                        nxt.extend(sub)
                        continue
                    states = [s for _, s in sub]
                    pstate = self.diff_fns[h](states)
                    pnid = self._new_node("interior", level=depth + 1,
                                          hierarchy=h)
                    self._cap_nodes.append(pnid)
                    for cnid, cstate in sub:
                        d = state_diff(cstate, pstate)
                        self._add_delta_edge(pnid, cnid, d, cap=True)
                    nxt.append((pnid, pstate))
                cur = nxt
                depth += 1
            root_nid, root_state = cur[0]
            d = state_diff(root_state, MaterializedState.empty(self.universe))
            self._add_delta_edge(SUPERROOT, root_nid, d, cap=True)

    def _uncap(self) -> None:
        for eid in self._cap_edges:
            e = self.edges.pop(eid)
            self.adj[e.src].remove(eid)
            self.adj[e.dst].remove(eid)
            self._delete_payload(e.payload_id, col.DELTA_COMPONENTS, attrs=True)
        for nid in self._cap_nodes:
            self.nodes.pop(nid, None)
            self.adj.pop(nid, None)
        self._cap_edges = []
        self._cap_nodes = []

    # --------------------------------------------------------- §6 maintenance
    def append_events(self, ev: EventList) -> None:
        """Record new events into the recent eventlist; fold full leaves into
        the index as they fill (§6)."""
        self.recent = EventList.concat([self.recent, ev])
        self._total_events += len(ev)
        # live updates may have grown the slot universe (§6)
        self._last_leaf_state = self._last_leaf_state.resized(self.universe)
        while len(self.recent) >= self.L:
            chunk = self.recent[: self.L]
            self.recent = self.recent[self.L:]
            self._uncap()
            self._nice()
            state = apply_events(self._last_leaf_state, chunk, forward=True)
            self._store_eventlist(self.leaf_nids[-1], chunk)
            self._nice()
            self._emit_leaf(state, pos=self.leaf_pos[-1] + self.L,
                            time=int(chunk.time[-1]))
            self._cap()
            self._nice()

    # ----------------------------------------------------- red/green epochs
    def clone_for_commit(self, ev: EventList) -> "DeltaGraph":
        """Cheap per-group epoch clone: shares the whole skeleton with this
        graph and differs only in the ``recent`` tail.  The clone must never
        be structurally mutated (``append_events``) — rollovers go through
        :meth:`fork`."""
        dg = copy.copy(self)
        if len(ev):
            dg.recent = EventList.concat([self.recent, ev])
            dg._total_events = self._total_events + len(ev)
        if dg._last_leaf_state is not None:
            dg._last_leaf_state = dg._last_leaf_state.resized(self.universe)
        return dg

    def fork(self) -> "DeltaGraph":
        """Structural copy-on-write fork for shadow (green) rebuilds: own
        skeleton containers so ``append_events`` on the fork never mutates
        what readers pinned to this (red) version see.  Node/edge records
        and frontier states are shared — folds only add new entries and pop
        cap entries from the fork's own dicts."""
        dg = copy.copy(self)
        dg.nodes = dict(self.nodes)
        dg.edges = dict(self.edges)
        dg.adj = {nid: list(eids) for nid, eids in self.adj.items()}
        dg.leaf_nids = list(self.leaf_nids)
        dg.leaf_pos = list(self.leaf_pos)
        dg.leaf_time = list(self.leaf_time)
        dg._frontier = [[list(lv) for lv in h] for h in self._frontier]
        dg._cap_nodes = list(self._cap_nodes)
        dg._cap_edges = list(self._cap_edges)
        dg.reclaim_sink = None
        return dg

    def restore_append_state(self) -> None:
        """Rebuild the in-memory append machinery (`_last_leaf_state` and the
        bulk-load frontier) that :meth:`save_skeleton` does not persist, by
        retrieving the relevant node states through the index itself — after
        this a loaded skeleton accepts :meth:`append_events` again (crash
        recovery, ``core/ingest.py``)."""
        opts = AttrOptions(tuple(range(self.universe.num_node_attrs)),
                           tuple(range(self.universe.num_edge_attrs)))
        cap = set(self._cap_nodes)
        # pending frontier membership: any non-cap leaf/interior node with no
        # non-cap delta parent still awaits a parent at depth = level - 1
        pending: list[list[list[int]]] = []
        want: set[int] = {self.leaf_nids[-1]}
        for h in range(len(self.diff_fns)):
            levels: list[list[int]] = []
            for nid, info in self.nodes.items():
                if info.kind == "superroot" or nid in cap:
                    continue
                if info.kind == "interior" and info.hierarchy != h:
                    continue
                has_parent = any(
                    e.kind == "delta" and e.dst == nid and not e.is_cap
                    and self.nodes[e.src].kind == "interior"
                    and self.nodes[e.src].hierarchy == h
                    for e in (self.edges[eid] for eid in self.adj[nid]))
                if has_parent:
                    continue
                depth = info.level - 1
                while len(levels) <= depth:
                    levels.append([])
                levels[depth].append(nid)
                want.add(nid)
            # nid order is creation (chronological) order within a level
            for lv in levels:
                lv.sort()
            pending.append(levels)
        plans = {nid: self.plan_node(nid, opts) for nid in sorted(want)}
        states = {}
        for nid, plan in plans.items():
            states[nid] = self.execute(plan, opts)[("node", nid)]
        self._last_leaf_state = states[self.leaf_nids[-1]].copy()
        self._frontier = [
            [[(nid, states[nid]) for nid in lv] for lv in levels]
            for levels in pending]

    # ------------------------------------------------------------ persistence
    def _new_node(self, kind: str, level: int, **kw) -> int:
        nid = self._next_nid
        self._next_nid += 1
        self.nodes[nid] = NodeInfo(nid, kind, level=level, **kw)
        self.adj[nid] = []
        return nid

    def _add_edge(self, info: EdgeInfo) -> int:
        self.edges[info.eid] = info
        self.adj.setdefault(info.src, []).append(info.eid)
        self.adj.setdefault(info.dst, []).append(info.eid)
        return info.eid

    def _add_delta_edge(self, src: int, dst: int, d: Delta, cap: bool) -> int:
        pid = self._next_payload
        self._next_payload += 1
        wn, we, wnl, wel, struct_stored = self._store_delta(pid, d)
        eid = self._next_eid
        self._next_eid += 1
        self._add_edge(EdgeInfo(eid, src, dst, "delta", pid,
                                w_struct=struct_stored,
                                w_nodeattr=wn, w_edgeattr=we, is_cap=cap,
                                w_struct_logical=d.struct_nbytes(),
                                w_nodeattr_logical=wnl,
                                w_edgeattr_logical=wel))
        if cap:
            self._cap_edges.append(eid)
        return eid

    def _split_attr(self, a: AttrDelta, by_node: bool) -> list[np.ndarray]:
        part = self._hp(a.slot, self.P)
        return [np.nonzero(part == p)[0] for p in range(self.P)]

    def _store_delta(self, pid: int, d: Delta):
        """Encode + persist one delta's components; returns the per-column
        stored (at-rest blob) and logical (decoded array) byte tallies the
        planner's decode-aware cost model weighs."""
        A_n = self.universe.num_node_attrs
        A_e = self.universe.num_edge_attrs
        wn = np.zeros(A_n, np.int64)
        we = np.zeros(A_e, np.int64)
        wn_lg = np.zeros(A_n, np.int64)
        we_lg = np.zeros(A_e, np.int64)
        struct_stored = 0
        for p in range(self.P):
            sub = self._partition_delta(d, p)
            self._nice()
            b = col.encode_delta_struct(sub)
            struct_stored += len(b)
            self.store.put((p, pid, col.STRUCT), b)
            self._nice()
            for c in range(A_n):
                m = sub.node_attr.col == c
                ad = AttrDelta(sub.node_attr.slot[m], sub.node_attr.col[m],
                               sub.node_attr.new[m], sub.node_attr.old[m])
                b = col.encode_attr(ad)
                wn[c] += len(b)
                wn_lg[c] += ad.nbytes()
                self.store.put((p, pid, f"{col.NODEATTR}.{c}"), b)
                self._nice()
            for c in range(A_e):
                m = sub.edge_attr.col == c
                ad = AttrDelta(sub.edge_attr.slot[m], sub.edge_attr.col[m],
                               sub.edge_attr.new[m], sub.edge_attr.old[m])
                b = col.encode_attr(ad)
                we[c] += len(b)
                we_lg[c] += ad.nbytes()
                self.store.put((p, pid, f"{col.EDGEATTR}.{c}"), b)
                self._nice()
        return wn, we, wn_lg, we_lg, struct_stored

    def _partition_delta(self, d: Delta, p: int) -> Delta:
        if self.P == 1:
            return d
        hp = self._hp
        def f(a):
            return a[hp(a, self.P) == p]
        def fa(a: AttrDelta):
            m = hp(a.slot, self.P) == p
            return AttrDelta(a.slot[m], a.col[m], a.new[m], a.old[m])
        return Delta(f(d.node_add), f(d.node_del), f(d.edge_add), f(d.edge_del),
                     fa(d.node_attr), fa(d.edge_attr))

    def _store_eventlist(self, left_leaf_nid: int, ev: EventList) -> None:
        """Store the leaf-eventlist between leaf i and the upcoming leaf
        i+1, and add the bidirectional leaf edge."""
        pid = self._next_payload
        self._next_payload += 1
        A_n = self.universe.num_node_attrs
        A_e = self.universe.num_edge_attrs
        wn = np.zeros(A_n, np.int64)
        we = np.zeros(A_e, np.int64)
        wn_lg = np.zeros(A_n, np.int64)
        we_lg = np.zeros(A_e, np.int64)
        n_struct = 0
        w_struct = 0
        w_struct_lg = 0
        hp = self._hp
        part_all = hp(ev.slot, self.P)
        for p in range(self.P):
            sub = ev[part_all == p] if self.P > 1 else ev
            # component *arrays* (pre-encode) — attr components re-key per
            # column without decoding a just-encoded blob
            comps = col.eventlist_components(sub)
            self._nice()
            b_struct = col.pack_arrays(comps[col.ELIST_STRUCT])
            self.store.put((p, pid, col.ELIST_STRUCT), b_struct)
            self._nice()
            self.store.put((p, pid, col.ELIST_TRANSIENT),
                           col.pack_arrays(comps[col.ELIST_TRANSIENT]))
            self._nice()
            n_struct += comps[col.ELIST_STRUCT]["slot"].size
            w_struct += len(b_struct)
            w_struct_lg += col.logical_nbytes(comps[col.ELIST_STRUCT])
            for base, ws, ws_lg, A in ((col.ELIST_NODEATTR, wn, wn_lg, A_n),
                                       (col.ELIST_EDGEATTR, we, we_lg, A_e)):
                arrays = comps[base]
                for c in range(A):
                    m = arrays["col"] == c
                    sub_arrays = {k: v[m] for k, v in arrays.items()}
                    b = col.pack_arrays(sub_arrays)
                    ws[c] += len(b)
                    ws_lg[c] += col.logical_nbytes(sub_arrays)
                    self.store.put((p, pid, f"{base}.{c}"), b)
                    self._nice()
        eid = self._next_eid
        self._next_eid += 1
        # dst is the leaf about to be emitted (nid of next node)
        self._add_edge(EdgeInfo(eid, left_leaf_nid, self._next_nid, "elist",
                                pid, w_struct=w_struct, w_nodeattr=wn,
                                w_edgeattr=we, n_events=len(ev),
                                w_struct_logical=w_struct_lg,
                                w_nodeattr_logical=wn_lg,
                                w_edgeattr_logical=we_lg))

    def _delete_payload(self, pid: int, comps, attrs: bool) -> None:
        keys = []
        for p in range(self.P):
            for c in comps:
                keys.append((p, pid, c))
            if attrs:
                for c in range(self.universe.num_node_attrs):
                    keys.append((p, pid, f"{col.NODEATTR}.{c}"))
                for c in range(self.universe.num_edge_attrs):
                    keys.append((p, pid, f"{col.EDGEATTR}.{c}"))
        if self.reclaim_sink is not None:
            self.reclaim_sink.extend(keys)
        else:
            for key in keys:
                self.store.delete(key)

    # ----------------------------------------------------------------- stats
    @staticmethod
    def _edge_total_bytes(e: EdgeInfo, stored: bool) -> int:
        if stored:
            w = e.w_struct
            wn, we = e.w_nodeattr, e.w_edgeattr
        else:
            w = e.w_struct_logical
            wn, we = e.w_nodeattr_logical, e.w_edgeattr_logical
        if wn is not None:
            w += int(wn.sum())
        if we is not None:
            w += int(we.sum())
        return int(w)

    def skeleton_stats(self) -> dict:
        """Index-size report.  ``*_bytes`` fields are *logical* (decoded
        array) bytes — what the §5 analytical models predict; the
        ``stored_*`` mirrors report at-rest bytes after the payload codec,
        and ``compression_ratio`` is their quotient (per level and
        overall).  With the raw codec the two coincide up to blob-header
        overhead."""
        per_level: dict[int, int] = {}
        per_level_nocap: dict[int, int] = {}
        struct_nocap: dict[int, int] = {}
        stored_level: dict[int, int] = {}
        for e in self.edges.values():
            if e.kind == "delta":
                lvl = self.nodes[e.src].level if e.src != SUPERROOT else -1
                w = self._edge_total_bytes(e, stored=False)
                per_level[lvl] = per_level.get(lvl, 0) + w
                stored_level[lvl] = (stored_level.get(lvl, 0)
                                     + self._edge_total_bytes(e, stored=True))
                if not e.is_cap:
                    per_level_nocap[lvl] = per_level_nocap.get(lvl, 0) + w
                    struct_nocap[lvl] = (struct_nocap.get(lvl, 0)
                                         + e.w_struct_logical)
        total_delta = sum(per_level.values())
        stored_delta = sum(stored_level.values())
        elists = [e for e in self.edges.values() if e.kind == "elist"]
        total_elist = sum(self._edge_total_bytes(e, stored=False)
                          for e in elists)
        stored_elist = sum(self._edge_total_bytes(e, stored=True)
                           for e in elists)
        total = total_delta + total_elist
        stored_total = stored_delta + stored_elist
        return {"num_nodes": len(self.nodes), "num_edges": len(self.edges),
                "num_leaves": len(self.leaf_nids),
                "delta_bytes_per_level": per_level,
                "delta_bytes_per_level_nocap": per_level_nocap,
                "struct_bytes_per_level_nocap": struct_nocap,
                "delta_bytes": total_delta, "eventlist_bytes": total_elist,
                "total_bytes": total,
                "stored_delta_bytes_per_level": stored_level,
                "stored_delta_bytes": stored_delta,
                "stored_eventlist_bytes": stored_elist,
                "stored_total_bytes": stored_total,
                "compression_ratio_per_level": {
                    lvl: per_level[lvl] / max(stored_level.get(lvl, 0), 1)
                    for lvl in per_level},
                "compression_ratio": total / max(stored_total, 1)}

    # ------------------------------------------------------------- planning
    def _leaf_for_time(self, t: int) -> int:
        """Largest leaf index i with boundary time <= t (leaf 0 has -inf)."""
        i = int(np.searchsorted(np.asarray(self.leaf_time[1:]), t, side="right"))
        return min(i, len(self.leaf_nids) - 1)

    def _first_leaf_covering(self, ts: int) -> int:
        """First eventlist index whose rows can include ``time >= ts`` —
        the *inclusive-start* counterpart of :meth:`_leaf_for_time` (which
        is exclusive at its bound).  Expressed directly with a
        ``side="left"`` search instead of ``_leaf_for_time(ts - 1)``
        arithmetic; for integer timestamps the two coincide
        (#{j : leaf_time[j] < ts} either way) — pinned by
        ``tests/test_boundary_slices.py``."""
        i = int(np.searchsorted(np.asarray(self.leaf_time[1:]), ts, side="left"))
        return min(i, len(self.leaf_nids) - 1)

    def elists_covering(self, lo: int, hi: int) -> list[int]:
        """Leaf-eventlist indices holding rows with ``lo < time <= hi``
        (the interval-slice convention used everywhere in planning).
        Chunk ``i``'s rows satisfy ``leaf_time[i] <= time <= leaf_time[i+1]``
        — times are chronologically sorted and boundary timestamps may
        repeat across the cut — so the covering range is
        ``[_leaf_for_time(lo), _leaf_for_time(hi)]`` clipped to real
        eventlists; rows past the last leaf live in ``self.recent``."""
        if hi <= lo or len(self.leaf_nids) < 2:
            return []
        i0 = self._leaf_for_time(lo)
        i1 = min(self._leaf_for_time(hi), len(self.leaf_nids) - 2)
        return list(range(i0, i1 + 1))

    def _recent_cost(self, frac: float = 1.0) -> float:
        """Applying a slice of the in-memory recent eventlist has no fetch
        half — β·logical bytes, same units as :meth:`EdgeInfo.weight`."""
        return COST_BETA_DECODE * self.recent.nbytes() * frac

    def _virtual_edges(self, t: int, options: AttrOptions):
        """Edges connecting the virtual node S_t to the skeleton (§4.3).

        Partial-eventlist actions are ``(kind, payload, forward, (lo, hi))``
        — apply the rows with ``lo < time <= hi``; the explicit range makes
        the action invertible (flip ``forward``) so virtual nodes can be
        traversed *through* by multipoint plans.
        """
        NEG, POS = -(1 << 62), (1 << 62)
        li = self._leaf_for_time(t)
        out = []
        if li + 1 < len(self.leaf_nids):
            eid = self._leaf_elist_eid(li)
            e = self.edges[eid]
            t0, t1 = self.leaf_time[li], self.leaf_time[li + 1]
            frac = 0.5 if t1 <= t0 else min(max((t - t0) / (t1 - t0), 0.0), 1.0)
            out.append((self.leaf_nids[li], ("elist", e.payload_id, True, (NEG, t)),
                        e.weight(options, frac=frac)))
            out.append((self.leaf_nids[li + 1],
                        ("elist", e.payload_id, False, (t, POS)),
                        e.weight(options, frac=1.0 - frac, backward=True)))
        else:
            # t falls in the recent (unindexed) region past the last leaf
            n = len(self.recent)
            if n:
                cut = self.recent.search_time(t, side="right")
                frac = cut / n
                out.append((self.leaf_nids[li],
                            ("recent", None, True, (NEG, t)),
                            self._recent_cost(frac)))
                wb = (float("inf") if options.wants_attrs
                      else self._recent_cost(1 - frac))
                out.append(("CURRENT", ("recent", None, False, (t, POS)), wb))
            else:
                out.append((self.leaf_nids[li], ("noop", None, True, None), 0.0))
        return out

    def _chain_edges(self, times: list[int], options: AttrOptions,
                     virtuals: dict[Any, list]) -> None:
        """Direct S_ta -> S_tb partial edges for consecutive query times that
        share a leaf-eventlist (fig 4b: one eventlist serving several
        targets), appended into ``virtuals`` in place."""
        order = sorted(set(times))
        for ta, tb in zip(order, order[1:]):
            la, lb = self._leaf_for_time(ta), self._leaf_for_time(tb)
            if la != lb:
                continue
            if la + 1 < len(self.leaf_nids):
                e = self.edges[self._leaf_elist_eid(la)]
                t0, t1 = self.leaf_time[la], self.leaf_time[la + 1]
                frac = 0.5 if t1 <= t0 else min((tb - ta) / (t1 - t0), 1.0)
                virtuals[("t", tb)].append(
                    (("t", ta), ("elist", e.payload_id, True, (ta, tb)),
                     e.weight(options, frac=frac)))
            elif len(self.recent):
                n = len(self.recent)
                frac = (self.recent.search_time(tb) - self.recent.search_time(ta)) / n
                virtuals[("t", tb)].append(
                    (("t", ta), ("recent", None, True, (ta, tb)),
                     self._recent_cost(frac)))

    def _leaf_elist_eid(self, leaf_index: int) -> int:
        a, b = self.leaf_nids[leaf_index], self.leaf_nids[leaf_index + 1]
        for eid in self.adj[a]:
            e = self.edges[eid]
            if e.kind == "elist" and {e.src, e.dst} == {a, b}:
                return eid
        raise KeyError(f"no eventlist edge between leaves {leaf_index}, {leaf_index+1}")

    def _sources(self, use_current: bool,
                 options: AttrOptions = NO_ATTRS) -> list[tuple[Any, tuple]]:
        src: list[tuple[Any, tuple]] = [(SUPERROOT, ("empty",))]
        for nid, info in self.nodes.items():
            if info.materialized_as is None:
                continue
            # a materialized node is a usable source only if it holds every
            # attribute column the query needs
            if (set(options.node_cols) <= set(info.mat_node_cols or ())
                    and set(options.edge_cols) <= set(info.mat_edge_cols or ())):
                src.append((nid, ("mat", info.materialized_as)))
        if use_current and self._last_leaf_state is not None:
            src.append(("CURRENT", ("current",)))
        return src

    def _dijkstra(self, starts: dict[Any, float], options: AttrOptions,
                  virtuals: dict[Any, list[tuple[Any, tuple, float]]],
                  use_current: bool):
        """Shortest paths over skeleton ∪ virtual nodes.

        ``virtuals`` maps virtual node key -> [(skeleton nid, action, w)].
        Returns (dist, prev) with prev[v] = (u, action, w).
        """
        # adjacency including virtual edges (bidirectional where legal)
        vadj: dict[Any, list[tuple[Any, tuple, float]]] = {}
        for v, conns in virtuals.items():
            for u, action, w in conns:
                vadj.setdefault(u, []).append((v, action, w))
                # virtual nodes can be traversed *through* (multipoint
                # chains); the inverse flips direction over the same range
                if action[0] in ("elist", "recent"):
                    inv_fwd = not action[2]
                    if not inv_fwd and options.wants_attrs:
                        continue  # backward event replay can't restore attrs
                    inv = (action[0], action[1], inv_fwd, action[3])
                    vadj.setdefault(v, []).append((u, inv, w))
        if use_current and self.leaf_nids and not options.wants_attrs:
            # CURRENT = last leaf + recent events; crossing it backward
            # restores the last leaf (structure-only, §6)
            w = self._recent_cost()
            vadj.setdefault("CURRENT", []).append(
                (self.leaf_nids[-1], ("recent", None, False, None), w))
            vadj.setdefault(self.leaf_nids[-1], []).append(
                ("CURRENT", ("recent", None, True, None), w))

        dist: dict[Any, float] = dict(starts)
        prev: dict[Any, tuple] = {}
        pq = [(d, repr(n), n) for n, d in starts.items()]
        heapq.heapify(pq)
        seen: set = set()
        while pq:
            d, _, u = heapq.heappop(pq)
            if u in seen:
                continue
            seen.add(u)
            for eid in self.adj.get(u, []):
                e = self.edges[eid]
                v = e.dst if e.src == u else e.src
                fwd = e.src == u
                w = e.weight(options, backward=(e.kind == "elist" and not fwd))
                if w == float("inf"):
                    continue
                nd = d + w
                if nd < dist.get(v, float("inf")):
                    dist[v] = nd
                    prev[v] = (u, (e.kind, e.payload_id, fwd, None), w)
                    heapq.heappush(pq, (nd, repr(v), v))
            for (v, action, w) in vadj.get(u, []):
                if w == float("inf"):
                    continue
                nd = d + w
                if nd < dist.get(v, float("inf")):
                    dist[v] = nd
                    prev[v] = (u, action, w)
                    heapq.heappush(pq, (nd, repr(v), v))
        return dist, prev

    @staticmethod
    def _emit_chain(b: PlanBuilder, prev: dict, src_action: dict,
                    target: Any) -> None:
        """Unwind a Dijkstra predecessor map from ``target`` back to a
        source (or an already-emitted state) into the builder."""
        chain = []
        u = target
        while u in prev and not b.has_state(u):
            p, action, w = prev[u]
            chain.append((u, p, action, w))
            u = p
        if not b.has_state(u):
            b.source(u, src_action[u])
        for key, parent, action, w in reversed(chain):
            b.apply(key, parent, action, w)

    def plan_singlepoint(self, t: int, options: AttrOptions = NO_ATTRS,
                         use_current: bool = True) -> Plan:
        virtuals = {("t", t): self._virtual_edges(t, options)}
        sources = self._sources(use_current, options)
        starts = {n: 0.0 for n, _ in sources}
        dist, prev = self._dijkstra(starts, options, virtuals, use_current)
        target = ("t", t)
        if target not in dist:
            raise RuntimeError(f"no retrieval path for t={t}")
        b = PlanBuilder()
        self._emit_chain(b, prev, dict(sources), target)
        b.target(t, target)
        return b.build()

    def plan_node(self, nid: int, options: AttrOptions = NO_ATTRS) -> Plan:
        """Plan retrieval of a *skeleton* node's (virtual) graph — used for
        memory materialization (§4.5)."""
        sources = self._sources(False, options)
        starts = {n: 0.0 for n, _ in sources}
        dist, prev = self._dijkstra(starts, options, {}, False)
        b = PlanBuilder()
        self._emit_chain(b, prev, dict(sources), nid)
        b.target(("node", nid), nid)
        return b.build()

    def plan_multipoint(self, times: Sequence[int],
                        options: AttrOptions = NO_ATTRS,
                        use_current: bool = True) -> Plan:
        """Metric-closure MST 2-approx Steiner tree (§4.4)."""
        times = list(dict.fromkeys(times))  # dedup, keep order
        if len(times) == 1:
            return self.plan_singlepoint(times[0], options, use_current)
        virtuals: dict[Any, list] = {}
        for t in times:
            virtuals[("t", t)] = self._virtual_edges(t, options)
        self._chain_edges(times, options, virtuals)
        sources = self._sources(use_current, options)
        terminals = [("t", t) for t in times]

        # Dijkstra from the collapsed source set, then from each terminal.
        runs: dict[Any, tuple[dict, dict]] = {}
        runs["SRC"] = self._dijkstra({n: 0.0 for n, _ in sources}, options,
                                     virtuals, use_current)
        for tm in terminals:
            runs[tm] = self._dijkstra({tm: 0.0}, options, virtuals, use_current)

        # Prim over {SRC} ∪ terminals in the metric closure
        in_tree = {"SRC"}
        tree_paths: list[tuple[Any, Any]] = []  # (metric edge: from, to)
        rem = set(terminals)
        while rem:
            best = None
            for a in in_tree:
                da = runs[a][0]
                for b in rem:
                    d = da.get(b, float("inf"))
                    if best is None or d < best[0]:
                        best = (d, a, b)
            if best is None or best[0] == float("inf"):
                raise RuntimeError("unreachable multipoint target")
            _, a, b = best
            in_tree.add(b)
            rem.discard(b)
            tree_paths.append((a, b))

        # unfold: union of the chosen shortest paths as a directed step DAG
        src_action = dict(sources)
        builder = PlanBuilder()

        def add_path(run_key: Any, target: Any):
            _, prev = runs[run_key]
            chain = []
            u = target
            while u in prev and not builder.has_state(u):
                p, action, w = prev[u]
                chain.append((u, p, action, w))
                u = p
            if not builder.has_state(u):
                if run_key == "SRC":
                    builder.source(u, src_action[u])
                else:
                    # path hangs off an already-computed state
                    assert u == run_key, u
            for key, parent, action, w in reversed(chain):
                builder.apply(key, parent, action, w)

        for a, b in tree_paths:
            add_path(a, b)

        for t in times:
            builder.target(t, ("t", t))
        return builder.build()

    # ------------------------------------------------------------- execution
    def _mget(self, keys: list) -> list:
        from ..storage.kv import mget_optional
        return mget_optional(self.store, keys)

    def _delta_keys(self, pid: int, options: AttrOptions,
                    parts: tuple[int, ...] | None = None
                    ) -> tuple[list, list, list]:
        """Component keys for one delta payload.  ``parts`` restricts to a
        subset of the storage partitions (sharded execution fetches only
        the partitions a shard owns); ``None`` = all of them."""
        ps = range(self.P) if parts is None else parts
        keys = [(p, pid, col.STRUCT) for p in ps]
        na_keys = [(p, pid, f"{col.NODEATTR}.{c}")
                   for p in ps for c in options.node_cols]
        ea_keys = [(p, pid, f"{col.EDGEATTR}.{c}")
                   for p in ps for c in options.edge_cols]
        return keys, na_keys, ea_keys

    def _fetch_delta(self, pid: int, options: AttrOptions,
                     parts: tuple[int, ...] | None = None) -> Delta:
        keys, na_keys, ea_keys = self._delta_keys(pid, options, parts)
        blobs = self._mget(keys + na_keys + ea_keys)
        return self._decode_delta(blobs, len(keys), len(na_keys))

    def _decode_delta(self, blobs: list, n_struct: int, n_na: int) -> Delta:
        structs = [col.decode_delta_struct(b) for b in blobs[:n_struct]]
        na_blobs = blobs[n_struct: n_struct + n_na]
        ea_blobs = blobs[n_struct + n_na:]
        nas = [col.decode_attr(b) for b in na_blobs if b is not None]
        eas = [col.decode_attr(b) for b in ea_blobs if b is not None]

        def cat(field):
            return np.concatenate([s[field] for s in structs]) if structs else np.zeros(0, np.int32)

        def cat_attr(parts: list[AttrDelta]) -> AttrDelta:
            if not parts:
                return AttrDelta.empty()
            return AttrDelta(np.concatenate([a.slot for a in parts]),
                             np.concatenate([a.col for a in parts]),
                             np.concatenate([a.new for a in parts]),
                             np.concatenate([a.old for a in parts]))

        return Delta(cat("node_add"), cat("node_del"), cat("edge_add"),
                     cat("edge_del"), cat_attr(nas), cat_attr(eas))

    def _elist_keys(self, pid: int, options: AttrOptions,
                    transient: bool = False,
                    parts: tuple[int, ...] | None = None) -> list:
        comps = [col.ELIST_STRUCT]
        comps += [f"{col.ELIST_NODEATTR}.{c}" for c in options.node_cols]
        comps += [f"{col.ELIST_EDGEATTR}.{c}" for c in options.edge_cols]
        if transient:
            comps.append(col.ELIST_TRANSIENT)
        ps = range(self.P) if parts is None else parts
        return [(p, pid, c) for p in ps for c in comps]

    def _fetch_elist(self, pid: int, options: AttrOptions,
                     transient: bool = False,
                     parts: tuple[int, ...] | None = None
                     ) -> dict[str, dict[str, np.ndarray]]:
        keys = self._elist_keys(pid, options, transient, parts)
        return self._decode_elist(keys, self._mget(keys))

    @staticmethod
    def _decode_elist(keys: list, blobs: list
                      ) -> dict[str, dict[str, np.ndarray]]:
        out: dict[str, list[dict[str, np.ndarray]]] = {}
        for (pkey, blob) in zip(keys, blobs):
            if blob is not None:
                out.setdefault(pkey[2], []).append(col.unpack_arrays(blob))
        merged = {}
        for comp, parts in out.items():
            merged[comp] = {k: np.concatenate([p[k] for p in parts])
                            for k in parts[0]}
        return merged

    def _apply_elist(self, state: MaterializedState,
                     comps: dict[str, dict[str, np.ndarray]],
                     forward: bool, rng: tuple[int, int] | None,
                     options: AttrOptions) -> MaterializedState:
        """Apply a (possibly partial) leaf-eventlist from its columnar
        components.  ``rng = (lo, hi)`` selects rows with lo < time <= hi;
        the same row set is applied forward or backward."""
        out = state.copy()
        s = comps[col.ELIST_STRUCT]

        def sel(times: np.ndarray) -> np.ndarray:
            if rng is None:
                return np.ones(times.shape, bool)
            lo, hi = rng
            return (times > lo) & (times <= hi)

        m = sel(s["time"])
        et, slot = s["etype"][m], s["slot"][m]
        add_n, del_n = (EV_NEW_NODE, EV_DEL_NODE) if forward else (EV_DEL_NODE, EV_NEW_NODE)
        add_e, del_e = (EV_NEW_EDGE, EV_DEL_EDGE) if forward else (EV_DEL_EDGE, EV_NEW_EDGE)
        ncnt = out.node_mask.astype(np.int32)
        np.add.at(ncnt, slot[et == add_n], 1)
        np.add.at(ncnt, slot[et == del_n], -1)
        out.node_mask = ncnt > 0
        ecnt = out.edge_mask.astype(np.int32)
        np.add.at(ecnt, slot[et == add_e], 1)
        np.add.at(ecnt, slot[et == del_e], -1)
        out.edge_mask = ecnt > 0

        for base, attrs, cols in ((col.ELIST_NODEATTR, out.node_attrs, options.node_cols),
                                  (col.ELIST_EDGEATTR, out.edge_attrs, options.edge_cols)):
            for c in cols:
                comp = comps.get(f"{base}.{c}")
                if comp is None:
                    continue
                m = sel(comp["time"])
                pos, sl = comp["pos"][m], comp["slot"][m]
                val = (comp["new"] if forward else comp["old"])[m]
                order = np.argsort(pos, kind="stable")
                if not forward:
                    order = order[::-1]
                attrs[sl[order], c] = val[order]
        return out

    def execute(self, plan: Plan, options: AttrOptions = NO_ATTRS,
                pool=None, prefetch=None) -> dict[Any, MaterializedState]:
        """Run a plan IR on the host backend; returns states keyed by the
        plan's query targets.  ``prefetch`` takes a
        :class:`repro_torch.runtime.executor.Prefetcher` to overlap KV gets with
        delta/eventlist application."""
        from ..runtime.executor import HostExecutor
        t_start = time.perf_counter()
        out = HostExecutor(self, prefetcher=prefetch).run(plan, options, pool)
        self._record_workload(plan, options, t_start)
        return out

    def _record_workload(self, plan: Plan, options: AttrOptions,
                         t_start: float) -> None:
        """Feed one executed plan into the workload stats (advisor input).
        Shared by :meth:`execute` and the sharded retriever, which runs the
        scattered plan through its own executor pool."""
        if self.workload is not None:
            # time-point targets only (node-materialization plans carry
            # ("node", nid) targets and are not workload — recording their
            # routes would let the advisor reinforce its own pins)
            tts = [t for t in plan.targets
                   if isinstance(t, (int, np.integer))]
            if tts:
                # per-IR-node hit counts feed the advisor candidate ranking
                self.workload.record_nodes(
                    [k for k in plan.state_keys()
                     if isinstance(k, (int, np.integer)) and k in self.nodes])
                wall = (time.perf_counter() - t_start) / len(tts)
                share = plan.total_weight / len(tts)
                for t in tts:
                    self.workload.record(self._leaf_for_time(int(t)), share,
                                         options, wall)

    # --------------------------------------------------------------- queries
    def get_snapshot(self, t: int, options: AttrOptions = NO_ATTRS,
                     pool=None, use_current: bool = True,
                     prefetch=None) -> MaterializedState:
        plan = self.plan_singlepoint(t, options, use_current)
        return self.execute(plan, options, pool, prefetch=prefetch)[t]

    def get_snapshots(self, times: Sequence[int],
                      options: AttrOptions = NO_ATTRS, pool=None,
                      use_current: bool = True,
                      prefetch=None) -> dict[int, MaterializedState]:
        """Batched multipoint retrieval: one Steiner plan, shared prefixes
        fetch and apply once (§4.4 multi-query optimization)."""
        plan = self.plan_multipoint(times, options, use_current)
        return self.execute(plan, options, pool, prefetch=prefetch)

    def get_interval(self, ts: int, te: int) -> dict[str, np.ndarray]:
        """GetHistGraphInterval: elements *added* during [ts, te), plus the
        transient events in that window (§3.2.1)."""
        node_add, edge_add, tr_slot, tr_time = [], [], [], []
        li = self._first_leaf_covering(ts)
        for i in range(li, len(self.leaf_nids) - 1):
            if self.leaf_time[i] >= te:
                break
            e = self.edges[self._leaf_elist_eid(i)]
            comps = self._fetch_elist(e.payload_id, NO_ATTRS, transient=True)
            s = comps[col.ELIST_STRUCT]
            m = (s["time"] >= ts) & (s["time"] < te)
            node_add.append(s["slot"][m & (s["etype"] == EV_NEW_NODE)])
            edge_add.append(s["slot"][m & (s["etype"] == EV_NEW_EDGE)])
            tr = comps[col.ELIST_TRANSIENT]
            mt = (tr["time"] >= ts) & (tr["time"] < te)
            tr_slot.append(tr["slot"][mt])
            tr_time.append(tr["time"][mt])
        rec = self.recent
        if len(rec):
            m = (rec.time >= ts) & (rec.time < te)
            node_add.append(rec.slot[m & (rec.etype == EV_NEW_NODE)])
            edge_add.append(rec.slot[m & (rec.etype == EV_NEW_EDGE)])
            from .events import EV_TRANS_EDGE, EV_TRANS_NODE
            mt = m & np.isin(rec.etype, (EV_TRANS_EDGE, EV_TRANS_NODE))
            tr_slot.append(rec.slot[mt])
            tr_time.append(rec.time[mt])

        def cat(parts, dtype):
            return (np.unique(np.concatenate(parts)).astype(dtype)
                    if parts else np.zeros(0, dtype))

        return {"node_added": cat(node_add, np.int32),
                "edge_added": cat(edge_add, np.int32),
                "transient_slot": (np.concatenate(tr_slot) if tr_slot
                                   else np.zeros(0, np.int32)),
                "transient_time": (np.concatenate(tr_time) if tr_time
                                   else np.zeros(0, np.int64))}

    # -------------------------------------------------------- materialization
    def materialize(self, nid: int, pool, options: AttrOptions | None = None) -> int:
        """Fetch a skeleton node's graph into the GraphPool and add the
        zero-weight shortcut (§4.5).  Returns the pool graph id."""
        options = options if options is not None else NO_ATTRS
        plan = self.plan_node(nid, options)
        st = self.execute(plan, options, pool)[("node", nid)]
        gid = pool.insert_materialized(st)
        info = self.nodes[nid]
        info.materialized_as = gid
        info.mat_node_cols = tuple(options.node_cols)
        info.mat_edge_cols = tuple(options.edge_cols)
        return gid

    def unmaterialize(self, nid: int, pool) -> None:
        info = self.nodes[nid]
        if info.materialized_as is not None:
            pool.release(info.materialized_as)
            info.materialized_as = None

    def root_nids(self) -> list[int]:
        return [self.edges[eid].dst for eid in self.adj[SUPERROOT]]

    def save_skeleton(self) -> None:
        """Persist the skeleton so the index can be reopened later
        (``loadDeltaGraphIndex``)."""
        payload = {
            "L": self.L, "k": self.k, "P": self.P,
            "diff_names": self.diff_names, "diff_params": self.diff_params,
            "partition_fn": self.partition_fn_name,
            "next": [self._next_nid, self._next_eid, self._next_payload],
            "leaf_nids": self.leaf_nids, "leaf_pos": self.leaf_pos,
            "leaf_time": self.leaf_time,
            "cap_nodes": self._cap_nodes, "cap_edges": self._cap_edges,
            "total_events": self._total_events,
            "nodes": [dataclasses.asdict(n) for n in self.nodes.values()],
        }
        self._nice()
        payload["edges"] = [{**dataclasses.asdict(e),
                             "w_nodeattr": None, "w_edgeattr": None,
                             "w_nodeattr_logical": None,
                             "w_edgeattr_logical": None}
                            for e in self.edges.values()]
        self._nice()
        arrays = {}
        for e in self.edges.values():
            if e.w_nodeattr is not None:
                arrays[f"wn{e.eid}"] = e.w_nodeattr
            if e.w_edgeattr is not None:
                arrays[f"we{e.eid}"] = e.w_edgeattr
            if e.w_nodeattr_logical is not None:
                arrays[f"wnl{e.eid}"] = e.w_nodeattr_logical
            if e.w_edgeattr_logical is not None:
                arrays[f"wel{e.eid}"] = e.w_edgeattr_logical
        arrays["json"] = np.frombuffer(json.dumps(payload).encode(), np.uint8)
        self._nice()
        self.store.put((0, -1, "skeleton"), col.pack_arrays(arrays))

    @staticmethod
    def load_skeleton(universe: GraphUniverse, store: KVStore) -> "DeltaGraph":
        arrays = col.unpack_arrays(store.get((0, -1, "skeleton")))
        payload = json.loads(bytes(arrays["json"]).decode())
        dg = DeltaGraph(universe, store, L=payload["L"], k=payload["k"],
                        diff_fn=payload["diff_names"],
                        diff_params=payload["diff_params"],
                        num_partitions=payload["P"],
                        partition_fn=payload["partition_fn"])
        dg._next_nid, dg._next_eid, dg._next_payload = payload["next"]
        dg.leaf_nids = payload["leaf_nids"]
        dg.leaf_pos = payload["leaf_pos"]
        dg.leaf_time = payload["leaf_time"]
        dg._cap_nodes = payload["cap_nodes"]
        dg._cap_edges = payload["cap_edges"]
        dg._total_events = payload["total_events"]
        dg.nodes = {}
        dg.adj = {}
        for nd in payload["nodes"]:
            info = NodeInfo(**nd)
            dg.nodes[info.nid] = info
            dg.adj[info.nid] = []
        dg.edges = {}
        for ed in payload["edges"]:
            # skeletons saved before the codec layer lack the logical-byte
            # fields — EdgeInfo defaults keep them loadable (decode cost
            # simply prices as zero until a rebuild)
            e = EdgeInfo(**ed)
            e.w_nodeattr = arrays.get(f"wn{e.eid}")
            e.w_edgeattr = arrays.get(f"we{e.eid}")
            e.w_nodeattr_logical = arrays.get(f"wnl{e.eid}")
            e.w_edgeattr_logical = arrays.get(f"wel{e.eid}")
            dg._add_edge(e)
        return dg
