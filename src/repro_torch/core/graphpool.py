"""GraphPool: overlaid in-memory storage for many graphs (paper §6).

One *union* structure + packed bit-planes decide membership of every
element in every active graph:

* bits 0/1 are reserved for the **current graph** (bit 1 flags elements
  deleted recently but not yet folded into the DeltaGraph index);
* a **materialized graph** (DeltaGraph interior/leaf node) takes one bit;
* a **historical snapshot** takes a bit *pair* ``{2i, 2i+1}`` with the
  paper's dependency optimization: when the snapshot is close to the
  current graph or to a materialized graph, bit ``2i`` means "same
  membership as the parent graph" and only the differing elements are
  written — insertion cost proportional to the difference, not the graph.

Planes are stored as rows of packed ``uint32`` words ``[B, W]`` so that
resolution (``(same & parent) | (~same & own)``) and multi-snapshot
analytics are pure vector ops (``vmap`` over plane rows feeds the
bitmap-masked SpMM kernel).  Clean-up is lazy (§6): released rows are
zeroed and recycled by the cleaner, which runs opportunistically or under
memory pressure (``cleaner(force=True)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from . import bitmaps as bm
from .events import EventList, GraphUniverse, MaterializedState, apply_events

CURRENT_GID = 0


@dataclasses.dataclass
class PoolEntry:
    gid: int
    kind: str                  # 'current' | 'historical' | 'materialized'
    bits: tuple[int, ...]      # plane row indices (1 or 2 of them)
    dep_gid: int | None = None # dependency parent (historical only)
    released: bool = False
    # attribute columns actually fetched for this graph: {col: float32[U]}
    node_attr_cols: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    edge_attr_cols: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


class GraphPool:
    DEP_THRESHOLD = 0.25  # dependent storage if diff < 25% of live elements

    def __init__(self, universe: GraphUniverse, initial_bits: int = 8) -> None:
        self.universe = universe
        self.Wn = bm.num_words(universe.num_nodes)
        self.We = bm.num_words(universe.num_edges)
        self.node_planes = np.zeros((initial_bits, self.Wn), np.uint32)
        self.edge_planes = np.zeros((initial_bits, self.We), np.uint32)
        self._free_bits = list(range(2, initial_bits))
        self.table: dict[int, PoolEntry] = {
            CURRENT_GID: PoolEntry(CURRENT_GID, "current", (0, 1))}
        self._next_gid = 1
        self._pending_clean: list[int] = []
        self.overlay_ops = 0   # elements touched on insert (fig 8a companion)

    # ---------------------------------------------------------------- sizing
    def _ensure_universe(self) -> None:
        """Grow plane width when the universe has grown (appends)."""
        Wn = bm.num_words(self.universe.num_nodes)
        We = bm.num_words(self.universe.num_edges)
        if Wn > self.Wn:
            pad = np.zeros((self.node_planes.shape[0], Wn - self.Wn), np.uint32)
            self.node_planes = np.concatenate([self.node_planes, pad], axis=1)
            self.Wn = Wn
        if We > self.We:
            pad = np.zeros((self.edge_planes.shape[0], We - self.We), np.uint32)
            self.edge_planes = np.concatenate([self.edge_planes, pad], axis=1)
            self.We = We

    def _alloc_bits(self, n: int) -> tuple[int, ...]:
        while len(self._free_bits) < n:
            if self._pending_clean:
                self.cleaner(force=True)
                continue
            B = self.node_planes.shape[0]
            grow = max(B, 4)
            self.node_planes = np.concatenate(
                [self.node_planes, np.zeros((grow, self.Wn), np.uint32)])
            self.edge_planes = np.concatenate(
                [self.edge_planes, np.zeros((grow, self.We), np.uint32)])
            self._free_bits.extend(range(B, B + grow))
        return tuple(self._free_bits.pop(0) for _ in range(n))

    # --------------------------------------------------------------- inserts
    def set_current(self, state: MaterializedState) -> None:
        self._ensure_universe()
        self.node_planes[0, :] = 0
        self.edge_planes[0, :] = 0
        self.node_planes[0, : bm.num_words(state.node_mask.size)] = bm.np_pack(state.node_mask)
        self.edge_planes[0, : bm.num_words(state.edge_mask.size)] = bm.np_pack(state.edge_mask)
        e = self.table[CURRENT_GID]
        e.node_attr_cols = {c: state.node_attrs[:, c].copy()
                            for c in range(state.node_attrs.shape[1])}
        e.edge_attr_cols = {c: state.edge_attrs[:, c].copy()
                            for c in range(state.edge_attrs.shape[1])}

    def update_current(self, ev: EventList) -> None:
        """Apply live updates; deletions raise bit 1 ("recently deleted,
        not yet in the index") until :meth:`mark_flushed` drops them."""
        self._ensure_universe()
        st = self.get_state(CURRENT_GID, with_attrs=True)
        before_n, before_e = st.node_mask.copy(), st.edge_mask.copy()
        st2 = apply_events(st, ev, forward=True)
        self.set_current(st2)
        del_n = before_n & ~st2.node_mask
        del_e = before_e & ~st2.edge_mask
        self.node_planes[1, : bm.num_words(del_n.size)] |= bm.np_pack(del_n)
        self.edge_planes[1, : bm.num_words(del_e.size)] |= bm.np_pack(del_e)

    def mark_flushed(self) -> None:
        """The DeltaGraph folded the recent eventlist into the index —
        recently-deleted markers can be dropped."""
        self.node_planes[1, :] = 0
        self.edge_planes[1, :] = 0

    def insert_materialized(self, state: MaterializedState) -> int:
        self._ensure_universe()
        (b,) = self._alloc_bits(1)
        self._write_plane(b, state)
        gid = self._next_gid
        self._next_gid += 1
        entry = PoolEntry(gid, "materialized", (b,))
        self._store_attrs(entry, state)
        self.table[gid] = entry
        return gid

    def insert_snapshot(self, state: MaterializedState) -> int:
        """Overlay a retrieved historical snapshot (bit pair + dependency
        optimization)."""
        return self.insert_snapshots([state])[0]

    def insert_snapshots(self, states: list[MaterializedState]) -> list[int]:
        """Batched overlay: allocate every bit pair in one pass, then write
        the ``B`` snapshots' planes — the landing step of the batched
        retrieval engine (one pool pass per query batch, not per query)."""
        self._ensure_universe()
        packed = []
        for st in states:
            packed.append((self._fit(bm.np_pack(st.node_mask), self.Wn),
                           self._fit(bm.np_pack(st.edge_mask), self.We)))
        return self._insert_packed(packed, states)

    def insert_snapshots_packed(self, pairs: list[tuple[np.ndarray, np.ndarray]]
                                ) -> list[int]:
        """Batched overlay of already-packed ``(node_words, edge_words)``
        bitmaps (the device executor lands device results here without an
        unpack/re-pack round-trip).  No attribute columns are stored."""
        self._ensure_universe()
        packed = [(self._fit(np.asarray(n, np.uint32), self.Wn),
                   self._fit(np.asarray(e, np.uint32), self.We))
                  for n, e in pairs]
        return self._insert_packed(packed, [None] * len(packed))

    def _insert_packed(self, packed: list[tuple[np.ndarray, np.ndarray]],
                       states: list[MaterializedState | None]) -> list[int]:
        bits = self._alloc_bits(2 * len(packed))
        gids = []
        # snapshot the dependency candidates once per batch (current +
        # materialized graphs; batch members don't depend on each other)
        cands = []
        for gid, e in self.table.items():
            if e.released or e.kind == "historical":
                continue
            pn, pe = self._resolve_masks(gid)
            cands.append((gid, pn, pe))
        for i, ((nbm, ebm), state) in enumerate(zip(packed, states)):
            live = int(bm.np_popcount(nbm) + bm.np_popcount(ebm))
            best: tuple[int, int] | None = None  # (diff, candidate index)
            for ci, (gid, pn, pe) in enumerate(cands):
                diff = int(bm.np_popcount(pn ^ nbm) + bm.np_popcount(pe ^ ebm))
                if best is None or diff < best[0]:
                    best = (diff, ci)
            b_same, b_own = bits[2 * i], bits[2 * i + 1]
            gid = self._next_gid
            self._next_gid += 1
            if best is not None and best[0] < self.DEP_THRESHOLD * max(live, 1):
                dep, pn, pe = cands[best[1]]
                self.node_planes[b_same] = ~(pn ^ nbm)   # 1 = same as parent
                self.edge_planes[b_same] = ~(pe ^ ebm)
                self.node_planes[b_own] = nbm & (pn ^ nbm)
                self.edge_planes[b_own] = ebm & (pe ^ ebm)
                self.overlay_ops += best[0]
                entry = PoolEntry(gid, "historical", (b_same, b_own),
                                  dep_gid=dep)
            else:
                self.node_planes[b_same] = 0  # same-as-parent nowhere
                self.edge_planes[b_same] = 0
                self.node_planes[b_own] = nbm
                self.edge_planes[b_own] = ebm
                self.overlay_ops += live
                entry = PoolEntry(gid, "historical", (b_same, b_own))
            if state is not None:
                self._store_attrs(entry, state)
            self.table[gid] = entry
            gids.append(gid)
        return gids

    def _fit(self, words: np.ndarray, W: int) -> np.ndarray:
        return bm.np_fit_words(words, W)

    def _write_plane(self, b: int, state: MaterializedState) -> None:
        self.node_planes[b] = self._fit(bm.np_pack(state.node_mask), self.Wn)
        self.edge_planes[b] = self._fit(bm.np_pack(state.edge_mask), self.We)
        self.overlay_ops += int(state.node_mask.sum() + state.edge_mask.sum())

    def _store_attrs(self, entry: PoolEntry, state: MaterializedState) -> None:
        for c in range(state.node_attrs.shape[1]):
            colv = state.node_attrs[:, c]
            if not np.all(np.isnan(colv)):
                entry.node_attr_cols[c] = colv.copy()
        for c in range(state.edge_attrs.shape[1]):
            colv = state.edge_attrs[:, c]
            if not np.all(np.isnan(colv)):
                entry.edge_attr_cols[c] = colv.copy()

    # -------------------------------------------------------------- resolve
    def _resolve_masks(self, gid: int) -> tuple[np.ndarray, np.ndarray]:
        e = self.table[gid]
        if e.kind == "current":
            return self.node_planes[0].copy(), self.edge_planes[0].copy()
        if e.kind == "materialized":
            return self.node_planes[e.bits[0]].copy(), self.edge_planes[e.bits[0]].copy()
        b_same, b_own = e.bits
        if e.dep_gid is not None:
            pn, pe = self._resolve_masks(e.dep_gid)
            n = (self.node_planes[b_same] & pn) | (~self.node_planes[b_same]
                                                   & self.node_planes[b_own])
            m = (self.edge_planes[b_same] & pe) | (~self.edge_planes[b_same]
                                                   & self.edge_planes[b_own])
            return n, m
        return self.node_planes[b_own].copy(), self.edge_planes[b_own].copy()

    def get_node_mask(self, gid: int) -> np.ndarray:
        return bm.np_unpack(self._resolve_masks(gid)[0], self.universe.num_nodes)

    def get_edge_mask(self, gid: int) -> np.ndarray:
        return bm.np_unpack(self._resolve_masks(gid)[1], self.universe.num_edges)

    def get_state(self, gid: int, with_attrs: bool = False) -> MaterializedState:
        U_n, U_e = self.universe.num_nodes, self.universe.num_edges
        A_n, A_e = self.universe.num_node_attrs, self.universe.num_edge_attrs
        nmask = self.get_node_mask(gid)
        emask = self.get_edge_mask(gid)
        na = np.full((U_n, A_n), np.nan, np.float32)
        ea = np.full((U_e, A_e), np.nan, np.float32)
        if with_attrs:
            e = self.table[gid]
            for c, v in e.node_attr_cols.items():
                na[: v.size, c] = v
            for c, v in e.edge_attr_cols.items():
                ea[: v.size, c] = v
        return MaterializedState(nmask, emask, na, ea)

    def stacked_planes(self, gids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Resolved [G, W] packed membership planes for analytics vmap."""
        ns, es = [], []
        for g in gids:
            n, e = self._resolve_masks(g)
            ns.append(n)
            es.append(e)
        return np.stack(ns), np.stack(es)

    def union_masks(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.node_planes[0].copy()
        e = self.edge_planes[0].copy()
        for g in self.active_gids():
            rn, re = self._resolve_masks(g)
            n |= rn
            e |= re
        return n, e

    def active_gids(self) -> list[int]:
        return [g for g, e in self.table.items() if not e.released]

    # -------------------------------------------------------------- cleanup
    def release(self, gid: int) -> None:
        """Logically drop a graph; physical clean-up is lazy (§6)."""
        e = self.table[gid]
        if e.kind == "current":
            raise ValueError("cannot release the current graph")
        for other in self.table.values():
            if other.dep_gid == gid and not other.released:
                # un-depend before the parent goes away
                n, m = self._resolve_masks(other.gid)
                b_same, b_own = other.bits
                self.node_planes[b_same] = 0
                self.edge_planes[b_same] = 0
                self.node_planes[b_own] = n
                self.edge_planes[b_own] = m
                other.dep_gid = None
        e.released = True
        self._pending_clean.append(gid)

    def cleaner(self, force: bool = False) -> int:
        """Zero released planes and recycle bits.  Returns rows recycled."""
        done = 0
        while self._pending_clean:
            gid = self._pending_clean.pop()
            e = self.table.pop(gid)
            for b in e.bits:
                self.node_planes[b] = 0
                self.edge_planes[b] = 0
                self._free_bits.append(b)
            done += 1
            if not force and done >= 4:
                break  # lazy: bounded work per opportunity
        return done

    # ------------------------------------------------------------ accounting
    def entry_attr_bytes(self, gid: int) -> int:
        e = self.table[gid]
        return (sum(v.nbytes for v in e.node_attr_cols.values())
                + sum(v.nbytes for v in e.edge_attr_cols.values()))

    def projected_bytes(self, extra_bits: int = 0,
                        extra_attr_bytes: int = 0) -> int:
        """What :meth:`memory_bytes` would read after allocating
        ``extra_bits`` more plane rows (accounting for free/recyclable bits
        and the doubling growth policy) plus ``extra_attr_bytes`` of
        attribute columns.  The materialization advisor budgets against
        this before touching the pool."""
        free = len(self._free_bits) + sum(
            len(self.table[g].bits) for g in self._pending_clean
            if g in self.table)
        rows = self.node_planes.shape[0]
        need = extra_bits - free
        while need > 0:
            grow = max(rows, 4)
            rows += grow
            need -= grow
        planes = rows * (self.Wn + self.We) * 4
        attrs = sum(self.entry_attr_bytes(g) for g, e in self.table.items()
                    if not e.released)
        return planes + attrs + max(extra_attr_bytes, -attrs)

    def memory_bytes(self) -> int:
        planes = self.node_planes.nbytes + self.edge_planes.nbytes
        attrs = 0
        for e in self.table.values():
            attrs += sum(v.nbytes for v in e.node_attr_cols.values())
            attrs += sum(v.nbytes for v in e.edge_attr_cols.values())
        return planes + attrs

    def num_active(self) -> int:
        return len(self.active_gids())
