"""Delta algebra (paper §4.2): columnar, bidirectional deltas.

A delta ``Δ(target, source)`` holds what must change to turn *source* into
*target*.  It is stored **columnar** (paper's key optimization): the
``struct`` component (node/edge membership changes) is separate from the
``nodeattr`` / ``edgeattr`` components, so structure-only retrievals never
fetch attribute bytes.  Deltas are bidirectional — attribute triplets carry
both the target value and the source value — which is what lets the planner
traverse skeleton edges in either direction (leaf eventlists are likewise
bidirectional, §3.1).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .events import (EV_DEL_EDGE, EV_DEL_NODE, EV_NEW_EDGE, EV_NEW_NODE,
                     EV_UPD_EDGE_ATTR, EV_UPD_NODE_ATTR, EventList,
                     MaterializedState)


@dataclasses.dataclass
class AttrDelta:
    """Sparse attribute changes: set ``attrs[slot, col] = new`` going
    forward, ``= old`` going backward.  Rows are ordered by application
    order (later rows win)."""

    slot: np.ndarray  # int32[M]
    col: np.ndarray   # int16[M]
    new: np.ndarray   # float32[M]
    old: np.ndarray   # float32[M]

    @staticmethod
    def empty() -> "AttrDelta":
        return AttrDelta(np.zeros(0, np.int32), np.zeros(0, np.int16),
                         np.zeros(0, np.float32), np.zeros(0, np.float32))

    def __len__(self) -> int:
        return int(self.slot.shape[0])

    def nbytes(self) -> int:
        return self.slot.nbytes + self.col.nbytes + self.new.nbytes + self.old.nbytes

    def select_cols(self, cols: np.ndarray | None) -> "AttrDelta":
        if cols is None:
            return self
        m = np.isin(self.col, cols.astype(self.col.dtype))
        return AttrDelta(self.slot[m], self.col[m], self.new[m], self.old[m])

    def nbytes_cols(self, cols: np.ndarray | None) -> int:
        if cols is None:
            return self.nbytes()
        m = np.isin(self.col, cols.astype(self.col.dtype))
        per_row = 4 + 2 + 4 + 4
        return int(m.sum()) * per_row


@dataclasses.dataclass
class Delta:
    """Columnar delta.  ``node_add``/... are sorted unique int32 slot arrays."""

    node_add: np.ndarray
    node_del: np.ndarray
    edge_add: np.ndarray
    edge_del: np.ndarray
    node_attr: AttrDelta
    edge_attr: AttrDelta

    @staticmethod
    def empty() -> "Delta":
        z = np.zeros(0, np.int32)
        return Delta(z, z, z, z, AttrDelta.empty(), AttrDelta.empty())

    # -- size accounting (skeleton edge weights, §4.3) ------------------------
    def struct_nbytes(self) -> int:
        return (self.node_add.nbytes + self.node_del.nbytes
                + self.edge_add.nbytes + self.edge_del.nbytes)

    def nbytes(self) -> int:
        return self.struct_nbytes() + self.node_attr.nbytes() + self.edge_attr.nbytes()

    def struct_count(self) -> int:
        return (self.node_add.size + self.node_del.size
                + self.edge_add.size + self.edge_del.size)

    def invert(self) -> "Delta":
        return Delta(self.node_del, self.node_add, self.edge_del, self.edge_add,
                     AttrDelta(self.node_attr.slot[::-1], self.node_attr.col[::-1],
                               self.node_attr.old[::-1], self.node_attr.new[::-1]),
                     AttrDelta(self.edge_attr.slot[::-1], self.edge_attr.col[::-1],
                               self.edge_attr.old[::-1], self.edge_attr.new[::-1]))


def state_diff(target: MaterializedState, source: MaterializedState) -> Delta:
    """Δ(target, source): elements of ``source`` to delete (source−target)
    and to add (target−source), plus attribute corrections.

    Attribute rows are *symmetric canonical*: a row ``(slot, col, new, old)``
    is emitted wherever the canonical values (the matrix value for live
    slots, NaN for dead slots) differ between the two sides.  This makes
    every delta edge traversable in both directions even across liveness
    changes (dying slots carry their old values — the WAL-undo analogue),
    which the Steiner planner relies on.
    """
    node_add = np.nonzero(target.node_mask & ~source.node_mask)[0].astype(np.int32)
    node_del = np.nonzero(source.node_mask & ~target.node_mask)[0].astype(np.int32)
    edge_add = np.nonzero(target.edge_mask & ~source.edge_mask)[0].astype(np.int32)
    edge_del = np.nonzero(source.edge_mask & ~target.edge_mask)[0].astype(np.int32)

    def attr_diff(tm, sm, ta, sa) -> AttrDelta:
        if ta.size == 0:
            return AttrDelta.empty()
        tac = np.where(tm[:, None], ta, np.nan)
        sac = np.where(sm[:, None], sa, np.nan)
        diff = ~((tac == sac) | (np.isnan(tac) & np.isnan(sac)))
        slot, col = np.nonzero(diff)
        return AttrDelta(slot.astype(np.int32), col.astype(np.int16),
                         tac[slot, col].astype(np.float32),
                         sac[slot, col].astype(np.float32))

    return Delta(node_add, node_del, edge_add, edge_del,
                 attr_diff(target.node_mask, source.node_mask,
                           target.node_attrs, source.node_attrs),
                 attr_diff(target.edge_mask, source.edge_mask,
                           target.edge_attrs, source.edge_attrs))


def apply_delta(state: MaterializedState, delta: Delta,
                forward: bool = True) -> MaterializedState:
    """Apply Δ (or its inverse) to a materialized state.

    Slots *added* by the delta get their attribute rows reset to NaN first
    ("revival resets attributes"), then the delta's attribute rows are
    applied — together with symmetric canonical rows this keeps every
    reconstructed state's attribute matrix exactly canonical (dead slot ⇒
    NaN), independent of the path taken through the skeleton.
    """
    d = delta if forward else delta.invert()
    out = state.copy()
    out.node_mask[d.node_del] = False
    out.node_mask[d.node_add] = True
    out.edge_mask[d.edge_del] = False
    out.edge_mask[d.edge_add] = True
    if out.node_attrs.size:
        out.node_attrs[d.node_add] = np.nan
        out.node_attrs[d.node_del] = np.nan
    if out.edge_attrs.size:
        out.edge_attrs[d.edge_add] = np.nan
        out.edge_attrs[d.edge_del] = np.nan
    if len(d.node_attr):
        out.node_attrs[d.node_attr.slot, d.node_attr.col] = d.node_attr.new
    if len(d.edge_attr):
        out.edge_attrs[d.edge_attr.slot, d.edge_attr.col] = d.edge_attr.new
    return out


def eventlist_to_delta(ev: EventList) -> Delta:
    """Collapse an eventlist into an equivalent delta (applied forward to the
    state at the start of the list).  Membership: net effect of alternating
    add/del toggles; attributes: last write wins, first old-value is the
    source value."""
    et, sl = ev.etype, ev.slot

    def net(add_code, del_code, n_slots_hint=None):
        cnt: dict[int, int] = {}
        first: dict[int, int] = {}
        for i in np.nonzero((et == add_code) | (et == del_code))[0]:
            s = int(sl[i])
            cnt[s] = cnt.get(s, 0) + (1 if et[i] == add_code else -1)
            first.setdefault(s, 1 if et[i] == add_code else -1)
        adds = sorted(s for s, c in cnt.items() if c > 0)
        dels = sorted(s for s, c in cnt.items() if c < 0)
        return (np.asarray(adds, np.int32), np.asarray(dels, np.int32))

    node_add, node_del = net(EV_NEW_NODE, EV_DEL_NODE)
    edge_add, edge_del = net(EV_NEW_EDGE, EV_DEL_EDGE)

    def attr(code) -> AttrDelta:
        idx = np.nonzero(et == code)[0]
        if idx.size == 0:
            return AttrDelta.empty()
        lastv: dict[tuple[int, int], float] = {}
        firstold: dict[tuple[int, int], float] = {}
        for i in idx:
            k = (int(sl[i]), int(ev.attr_col[i]))
            lastv[k] = float(ev.value[i])
            firstold.setdefault(k, float(ev.old_value[i]))
        keys = sorted(lastv)
        return AttrDelta(np.asarray([k[0] for k in keys], np.int32),
                         np.asarray([k[1] for k in keys], np.int16),
                         np.asarray([lastv[k] for k in keys], np.float32),
                         np.asarray([firstold[k] for k in keys], np.float32))

    return Delta(node_add, node_del, edge_add, edge_del,
                 attr(EV_UPD_NODE_ATTR), attr(EV_UPD_EDGE_ATTR))
