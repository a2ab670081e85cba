"""Open an index that the JAX package built, from plain values only.

The counterpart of carrying weights across: the JAX package's slot
registries (:func:`universe_arrays`) and its store's ``{key: blob}`` items
after ``DeltaGraph.save_skeleton()`` are enough to rebuild the port's
:class:`GraphUniverse` and reopen the :class:`DeltaGraph` over a
:class:`MemKV` holding byte-identical blobs.  Nothing here imports the JAX
package: the inputs are numpy arrays, lists, dicts and bytes.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .core.deltagraph import DeltaGraph
from .core.events import EventList, GraphUniverse
from .storage.kv import MemKV

_EVENT_FIELDS = ("time", "etype", "slot", "attr_col", "value", "old_value")


def universe_arrays(universe) -> dict[str, Any]:
    """The slot registries of a ``GraphUniverse`` (either package's) as
    plain values: id lists, numpy flag/endpoint arrays, attribute-column
    maps and the string intern table."""
    return {
        "node_ids": list(universe.node_ids),
        "edge_ids": list(universe.edge_ids),
        "edge_src": np.asarray(universe.edge_src, np.int32),
        "edge_dst": np.asarray(universe.edge_dst, np.int32),
        "edge_directed": np.asarray(universe.edge_directed, bool),
        "edge_transient": np.asarray(universe.edge_transient, bool),
        "node_transient": np.asarray(universe.node_transient, bool),
        "node_attr_cols": dict(universe.node_attr_cols),
        "edge_attr_cols": dict(universe.edge_attr_cols),
        "strings": list(universe.strings._to_str),
    }


def event_arrays(events) -> dict[str, np.ndarray]:
    """An ``EventList`` (either package's) as its six numpy columns."""
    return {f: np.asarray(getattr(events, f)) for f in _EVENT_FIELDS}


def build_universe(arrays: Mapping[str, Any]) -> GraphUniverse:
    """A port :class:`GraphUniverse` with exactly the given registries."""
    uni = GraphUniverse()
    for i, ext in enumerate(arrays["node_ids"]):
        uni._node_of[ext] = i
        uni.node_ids.append(ext)
    for i, ext in enumerate(arrays["edge_ids"]):
        uni._edge_of[ext] = i
        uni.edge_ids.append(ext)
    uni._edge_src = [int(x) for x in arrays["edge_src"]]
    uni._edge_dst = [int(x) for x in arrays["edge_dst"]]
    uni._edge_directed = [bool(x) for x in arrays["edge_directed"]]
    uni._edge_transient = [bool(x) for x in arrays["edge_transient"]]
    uni._node_transient = [bool(x) for x in arrays["node_transient"]]
    uni.node_attr_cols = dict(arrays["node_attr_cols"])
    uni.edge_attr_cols = dict(arrays["edge_attr_cols"])
    for s in arrays["strings"]:
        uni.strings.code(s)
    return uni


def load_reference_index(universe_arrays: Mapping[str, Any],
                         kv_items: Mapping[Any, bytes],
                         recent: Mapping[str, np.ndarray] | None = None
                         ) -> tuple[GraphUniverse, DeltaGraph]:
    """Reopen an index saved by the JAX package.

    ``universe_arrays`` as :func:`universe_arrays` returns them;
    ``kv_items`` the store's ``{key: blob}`` items after
    ``save_skeleton()``; ``recent`` optionally the unindexed tail of events
    past the last leaf (:func:`event_arrays`), which the skeleton does not
    persist.  Returns ``(universe, deltagraph)``; the blobs are stored
    byte for byte, so the port answers queries over the very index the
    reference built.
    """
    uni = build_universe(universe_arrays)
    store = MemKV()
    for key, blob in kv_items.items():
        store.put(key, bytes(blob))
    dg = DeltaGraph.load_skeleton(uni, store)
    if recent is not None:
        dg.recent = EventList(*(np.asarray(recent[f]) for f in _EVENT_FIELDS))
    return uni, dg
