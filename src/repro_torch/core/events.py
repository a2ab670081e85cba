"""Event model for historical graphs (paper §3.1).

An *event* is an atomic activity: node/edge creation or deletion, an
attribute-value change, or a *transient* element valid only at one instant.
Events are bidirectional: they carry enough information (old + new values)
to be applied in either direction of time::

    G_k = G_{k-1} + E,     G_{k-1} = G_k - E

Representation is struct-of-arrays (TPU-friendly, columnar):

* ``time``      int64   event timepoint
* ``etype``     int8    one of the ``EV_*`` codes
* ``slot``      int32   dense slot in the node or edge universe
* ``attr_col``  int16   attribute column (UNA/UEA only, else -1)
* ``value``     float32 new attribute value (UNA/UEA), else NaN
* ``old_value`` float32 previous attribute value (UNA/UEA), else NaN

Node and edge identities: IDs are assigned at creation and never reused
(paper §3.1 — a deletion followed by re-insertion yields a *new* id), which
is what makes dense append-only slot universes possible.  External ids map
to slots through the :class:`GraphUniverse` lookup tables (the paper's
QueryManager id-translation role).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

# Event type codes ----------------------------------------------------------
EV_NEW_NODE = 0      # NN
EV_DEL_NODE = 1      # DN
EV_NEW_EDGE = 2      # NE
EV_DEL_EDGE = 3      # DE
EV_UPD_NODE_ATTR = 4 # UNA
EV_UPD_EDGE_ATTR = 5 # UEA
EV_TRANS_EDGE = 6    # transient edge (valid only at its instant)
EV_TRANS_NODE = 7    # transient node

EVENT_NAMES = {
    EV_NEW_NODE: "NN", EV_DEL_NODE: "DN", EV_NEW_EDGE: "NE", EV_DEL_EDGE: "DE",
    EV_UPD_NODE_ATTR: "UNA", EV_UPD_EDGE_ATTR: "UEA",
    EV_TRANS_EDGE: "TE", EV_TRANS_NODE: "TN",
}

_STRUCT_NODE = (EV_NEW_NODE, EV_DEL_NODE, EV_TRANS_NODE)
_STRUCT_EDGE = (EV_NEW_EDGE, EV_DEL_EDGE, EV_TRANS_EDGE)


class InternTable:
    """Bidirectional string <-> float32 code table so that non-numeric
    attribute values ('job', 'name', ...) can live in numeric columns."""

    def __init__(self) -> None:
        self._to_code: dict[str, float] = {}
        self._to_str: list[str] = []

    def code(self, s: str) -> float:
        c = self._to_code.get(s)
        if c is None:
            c = float(len(self._to_str))
            self._to_code[s] = c
            self._to_str.append(s)
        return c

    def lookup(self, code: float) -> str:
        return self._to_str[int(code)]

    def __len__(self) -> int:
        return len(self._to_str)


@dataclasses.dataclass
class EventList:
    """Chronologically sorted struct-of-arrays eventlist."""

    time: np.ndarray       # int64[M]
    etype: np.ndarray      # int8[M]
    slot: np.ndarray       # int32[M]
    attr_col: np.ndarray   # int16[M]
    value: np.ndarray      # float32[M]
    old_value: np.ndarray  # float32[M]

    def __len__(self) -> int:
        return int(self.time.shape[0])

    def __getitem__(self, sl) -> "EventList":
        return EventList(self.time[sl], self.etype[sl], self.slot[sl],
                         self.attr_col[sl], self.value[sl], self.old_value[sl])

    def nbytes(self) -> int:
        return sum(a.nbytes for a in
                   (self.time, self.etype, self.slot, self.attr_col,
                    self.value, self.old_value))

    @staticmethod
    def empty() -> "EventList":
        return EventList(np.zeros(0, np.int64), np.zeros(0, np.int8),
                         np.zeros(0, np.int32), np.zeros(0, np.int16),
                         np.zeros(0, np.float32), np.zeros(0, np.float32))

    @staticmethod
    def concat(parts: Sequence["EventList"]) -> "EventList":
        if not parts:
            return EventList.empty()
        return EventList(*[np.concatenate([getattr(p, f.name) for p in parts])
                           for f in dataclasses.fields(EventList)])

    def search_time(self, t: int, side: str = "right") -> int:
        """Index of the first event strictly after t (side='right')."""
        return int(np.searchsorted(self.time, t, side=side))


class GraphUniverse:
    """Append-only dense slot registries for nodes, edges and attributes."""

    def __init__(self) -> None:
        self._node_of: dict[Any, int] = {}
        self._edge_of: dict[Any, int] = {}
        self.node_ids: list[Any] = []
        self.edge_ids: list[Any] = []
        self._edge_src: list[int] = []
        self._edge_dst: list[int] = []
        self._edge_directed: list[bool] = []
        self._edge_transient: list[bool] = []
        self._node_transient: list[bool] = []
        self.node_attr_cols: dict[str, int] = {}
        self.edge_attr_cols: dict[str, int] = {}
        self.strings = InternTable()
        self._finalized: dict[str, np.ndarray] = {}

    # -- registration -------------------------------------------------------
    def node_slot(self, ext_id: Any, create: bool = False,
                  transient: bool = False) -> int:
        s = self._node_of.get(ext_id)
        if s is None:
            if not create:
                raise KeyError(f"unknown node id {ext_id!r}")
            s = len(self.node_ids)
            self._node_of[ext_id] = s
            self.node_ids.append(ext_id)
            self._node_transient.append(transient)
            self._finalized.clear()
        return s

    def new_edge_slot(self, ext_id: Any, src_slot: int, dst_slot: int,
                      directed: bool, transient: bool = False) -> int:
        s = len(self.edge_ids)
        self._edge_of[ext_id] = s
        self.edge_ids.append(ext_id)
        self._edge_src.append(src_slot)
        self._edge_dst.append(dst_slot)
        self._edge_directed.append(directed)
        self._edge_transient.append(transient)
        self._finalized.clear()
        return s

    def edge_slot(self, ext_id: Any) -> int:
        return self._edge_of[ext_id]

    def attr_col(self, kind: str, name: str, create: bool = False) -> int:
        table = self.node_attr_cols if kind == "node" else self.edge_attr_cols
        c = table.get(name)
        if c is None:
            if not create:
                raise KeyError(f"unknown {kind} attribute {name!r}")
            c = len(table)
            table[name] = c
        return c

    # -- sizes ---------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def num_edges(self) -> int:
        return len(self.edge_ids)

    @property
    def num_node_attrs(self) -> int:
        return len(self.node_attr_cols)

    @property
    def num_edge_attrs(self) -> int:
        return len(self.edge_attr_cols)

    # -- finalized arrays ----------------------------------------------------
    def _arr(self, name: str, src: list, dtype) -> np.ndarray:
        a = self._finalized.get(name)
        if a is None or a.shape[0] != len(src):
            a = np.asarray(src, dtype=dtype)
            self._finalized[name] = a
        return a

    @property
    def edge_src(self) -> np.ndarray:
        return self._arr("edge_src", self._edge_src, np.int32)

    @property
    def edge_dst(self) -> np.ndarray:
        return self._arr("edge_dst", self._edge_dst, np.int32)

    @property
    def edge_directed(self) -> np.ndarray:
        return self._arr("edge_directed", self._edge_directed, bool)

    @property
    def edge_transient(self) -> np.ndarray:
        return self._arr("edge_transient", self._edge_transient, bool)

    @property
    def node_transient(self) -> np.ndarray:
        return self._arr("node_transient", self._node_transient, bool)


class GraphHistoryBuilder:
    """Ingests activity and emits (universe, chronologically sorted events).

    Mirrors the paper's update path: events are recorded in the direction of
    evolving time; the builder tracks attribute old-values so that events are
    bidirectional.
    """

    def __init__(self) -> None:
        self.universe = GraphUniverse()
        self._rows: list[tuple[int, int, int, int, float, float]] = []
        self._node_attr_state: dict[tuple[int, int], float] = {}
        self._edge_attr_state: dict[tuple[int, int], float] = {}
        self._live_nodes: set[int] = set()
        self._live_edges: set[int] = set()
        self._edge_key_alive: dict[Any, int] = {}
        self._seq = 0

    # -- helpers -------------------------------------------------------------
    def _emit(self, t: int, etype: int, slot: int, col: int = -1,
              value: float = np.nan, old: float = np.nan) -> None:
        self._rows.append((int(t), etype, slot, col, value, old))
        self._seq += 1

    def _coerce(self, v: Any) -> float:
        if isinstance(v, str):
            return self.universe.strings.code(v)
        return float(v)

    # -- public API ----------------------------------------------------------
    def add_node(self, node_id: Any, t: int,
                 attrs: Mapping[str, Any] | None = None) -> int:
        s = self.universe.node_slot(node_id, create=True)
        if s in self._live_nodes:
            raise ValueError(f"node {node_id!r} already alive")
        self._live_nodes.add(s)
        self._emit(t, EV_NEW_NODE, s)
        for k, v in (attrs or {}).items():
            self.set_node_attr(node_id, k, v, t)
        return s

    def delete_node(self, node_id: Any, t: int) -> None:
        s = self.universe.node_slot(node_id)
        self._live_nodes.discard(s)
        self._emit(t, EV_DEL_NODE, s)

    def add_edge(self, u: Any, v: Any, t: int, directed: bool = False,
                 edge_id: Any = None, attrs: Mapping[str, Any] | None = None) -> int:
        su = self.universe.node_slot(u)
        sv = self.universe.node_slot(v)
        key = edge_id if edge_id is not None else ("__e", u, v, t, self._seq)
        s = self.universe.new_edge_slot(key, su, sv, directed)
        self._live_edges.add(s)
        self._edge_key_alive[(u, v)] = s
        self._emit(t, EV_NEW_EDGE, s)
        for k, w in (attrs or {}).items():
            self._set_edge_attr_slot(s, k, w, t)
        return s

    def delete_edge(self, u: Any, v: Any, t: int) -> None:
        s = self._edge_key_alive.pop((u, v))
        self._live_edges.discard(s)
        self._emit(t, EV_DEL_EDGE, s)

    def delete_edge_slot(self, slot: int, t: int) -> None:
        self._live_edges.discard(slot)
        self._emit(t, EV_DEL_EDGE, slot)

    def set_node_attr(self, node_id: Any, name: str, value: Any, t: int) -> None:
        s = self.universe.node_slot(node_id)
        c = self.universe.attr_col("node", name, create=True)
        val = self._coerce(value)
        old = self._node_attr_state.get((s, c), np.nan)
        self._node_attr_state[(s, c)] = val
        self._emit(t, EV_UPD_NODE_ATTR, s, c, val, old)

    def set_edge_attr(self, u: Any, v: Any, name: str, value: Any, t: int) -> None:
        self._set_edge_attr_slot(self._edge_key_alive[(u, v)], name, value, t)

    def _set_edge_attr_slot(self, s: int, name: str, value: Any, t: int) -> None:
        c = self.universe.attr_col("edge", name, create=True)
        val = self._coerce(value)
        old = self._edge_attr_state.get((s, c), np.nan)
        self._edge_attr_state[(s, c)] = val
        self._emit(t, EV_UPD_EDGE_ATTR, s, c, val, old)

    def transient_edge(self, u: Any, v: Any, t: int, directed: bool = True) -> int:
        """e.g. a 'message' from u to v valid only at instant t (§3.1)."""
        su = self.universe.node_slot(u)
        sv = self.universe.node_slot(v)
        s = self.universe.new_edge_slot(("__te", u, v, t, self._seq), su, sv,
                                        directed, transient=True)
        self._emit(t, EV_TRANS_EDGE, s)
        return s

    def finalize(self) -> tuple[GraphUniverse, EventList]:
        rows = self._rows
        order = sorted(range(len(rows)), key=lambda i: rows[i][0])  # stable
        cols = list(zip(*[rows[i] for i in order])) if rows else [[]] * 6
        ev = EventList(
            np.asarray(cols[0], np.int64), np.asarray(cols[1], np.int8),
            np.asarray(cols[2], np.int32), np.asarray(cols[3], np.int16),
            np.asarray(cols[4], np.float32), np.asarray(cols[5], np.float32))
        return self.universe, ev


# ---------------------------------------------------------------------------
# Brute-force oracle (the "Log" approach, §4.1) — ground truth for every test
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaterializedState:
    """A fully materialized graph state: dense masks + attribute matrices."""

    node_mask: np.ndarray   # bool[U_n]
    edge_mask: np.ndarray   # bool[U_e]
    node_attrs: np.ndarray  # float32[U_n, A_n]
    edge_attrs: np.ndarray  # float32[U_e, A_e]

    @staticmethod
    def empty(universe: GraphUniverse) -> "MaterializedState":
        return MaterializedState(
            np.zeros(universe.num_nodes, bool),
            np.zeros(universe.num_edges, bool),
            np.full((universe.num_nodes, universe.num_node_attrs), np.nan, np.float32),
            np.full((universe.num_edges, universe.num_edge_attrs), np.nan, np.float32))

    def copy(self) -> "MaterializedState":
        return MaterializedState(self.node_mask.copy(), self.edge_mask.copy(),
                                 self.node_attrs.copy(), self.edge_attrs.copy())

    def resized(self, universe: "GraphUniverse") -> "MaterializedState":
        """Grow to the universe's current size (live updates add slots §6)."""
        U_n, U_e = universe.num_nodes, universe.num_edges
        A_n, A_e = universe.num_node_attrs, universe.num_edge_attrs
        if (self.node_mask.size == U_n and self.edge_mask.size == U_e
                and self.node_attrs.shape == (U_n, A_n)
                and self.edge_attrs.shape == (U_e, A_e)):
            return self
        out = MaterializedState.empty(universe)
        out.node_mask[: self.node_mask.size] = self.node_mask
        out.edge_mask[: self.edge_mask.size] = self.edge_mask
        if self.node_attrs.size:
            out.node_attrs[: self.node_attrs.shape[0],
                           : self.node_attrs.shape[1]] = self.node_attrs
        if self.edge_attrs.size:
            out.edge_attrs[: self.edge_attrs.shape[0],
                           : self.edge_attrs.shape[1]] = self.edge_attrs
        return out

    def equal(self, other: "MaterializedState",
              check_attrs: bool = True) -> bool:
        if not (np.array_equal(self.node_mask, other.node_mask)
                and np.array_equal(self.edge_mask, other.edge_mask)):
            return False
        if not check_attrs:
            return True
        def attrs_eq(a, b, mask):
            a = np.where(mask[:, None], a, np.nan)
            b = np.where(mask[:, None], b, np.nan)
            return np.array_equal(a, b, equal_nan=True)
        return (attrs_eq(self.node_attrs, other.node_attrs, self.node_mask)
                and attrs_eq(self.edge_attrs, other.edge_attrs, self.edge_mask))


def apply_events(state: MaterializedState, ev: EventList,
                 forward: bool = True) -> MaterializedState:
    """Apply an eventlist to a state, in either direction of time (§3.1).

    Vectorized: membership via ±1 count accumulation (valid because element
    membership toggles alternate along any chronological event sequence);
    attributes via last-writer-wins per (slot, col).
    """
    out = state.copy()
    n = len(ev)
    if n == 0:
        return out
    if forward:
        add_n, del_n, add_e, del_e = EV_NEW_NODE, EV_DEL_NODE, EV_NEW_EDGE, EV_DEL_EDGE
        attr_val = ev.value
        order = np.arange(n)
    else:
        add_n, del_n, add_e, del_e = EV_DEL_NODE, EV_NEW_NODE, EV_DEL_EDGE, EV_NEW_EDGE
        attr_val = ev.old_value
        order = np.arange(n - 1, -1, -1)

    et, sl = ev.etype, ev.slot
    ncnt = out.node_mask.astype(np.int32)
    np.add.at(ncnt, sl[et == add_n], 1)
    np.add.at(ncnt, sl[et == del_n], -1)
    out.node_mask = ncnt > 0
    ecnt = out.edge_mask.astype(np.int32)
    np.add.at(ecnt, sl[et == add_e], 1)
    np.add.at(ecnt, sl[et == del_e], -1)
    out.edge_mask = ecnt > 0

    for code, attrs in ((EV_UPD_NODE_ATTR, out.node_attrs),
                        (EV_UPD_EDGE_ATTR, out.edge_attrs)):
        idx = order[et[order] == code]
        if idx.size:
            # last occurrence (in application order) wins
            attrs[ev.slot[idx], ev.attr_col[idx]] = attr_val[idx]
    return out


def replay(universe: GraphUniverse, events: EventList, t: int) -> MaterializedState:
    """Ground-truth snapshot as of time ``t``: apply every event with
    ``time <= t`` (``G_k = G_{k-1} + E``) to the empty graph.  Transient
    elements are excluded by definition (only interval queries see them)."""
    state = MaterializedState.empty(universe)
    hi = events.search_time(t, side="right")
    state = apply_events(state, events[:hi], forward=True)
    state.edge_mask &= ~universe.edge_transient[: state.edge_mask.size]
    state.node_mask &= ~universe.node_transient[: state.node_mask.size]
    return state
