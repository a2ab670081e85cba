"""Carry state from the JAX package into the port, from plain values only.

* :func:`params_from_reference`: a language model's parameter tree (numpy
  leaves) as the port's tensors.
* :func:`load_reference_index`: the JAX package's slot
registries (:func:`universe_arrays`) and its store's ``{key: blob}`` items
after ``DeltaGraph.save_skeleton()`` are enough to rebuild the port's
:class:`GraphUniverse` and reopen the :class:`DeltaGraph` over a
:class:`MemKV` holding byte-identical blobs.  Nothing here imports the JAX
package: the inputs are numpy arrays, lists, dicts and bytes.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

import torch

from .core.deltagraph import DeltaGraph
from .core.events import EventList, GraphUniverse
from .kernels.policy import resolve_device
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


def _leaf_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype.  A JAX bf16 array comes
    out of ``np.asarray`` as an ``ml_dtypes`` bfloat16 array, which
    ``torch.from_numpy`` refuses: it is carried by its bits."""
    shape = np.shape(a)                 # ascontiguousarray makes 0-d 1-d
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(a.copy()).reshape(shape)


def params_from_reference(tree: Mapping[str, Any], cfg, device="cuda"
                          ) -> dict[str, Any]:
    """The port's LM parameters from the JAX package's tree.

    ``tree`` is the nested dict of ``init_params`` (or a checkpoint) with
    each leaf converted by ``np.asarray``; ``cfg`` the port's
    :class:`~repro_torch.models.transformer.TransformerConfig`.  Both
    packages keep the stacked ``group{gi}/<name> [L, ...]`` layout, so the
    carry is leaf for leaf; keys, shapes and dtypes are checked against
    the port's :func:`~repro_torch.models.transformer.param_defs`.  The
    tensors land on the card unless ``device="cpu"`` (the default raises
    without one)."""
    from .models.transformer import param_defs

    device = resolve_device(device)

    def carry(defs, sub, path):
        if set(defs) != set(sub):
            raise ValueError(f"parameter keys differ at {path or '/'}: "
                             f"{sorted(defs)} vs {sorted(sub)}")
        out = {}
        for key, d in defs.items():
            if isinstance(d, dict):
                out[key] = carry(d, sub[key], f"{path}{key}/")
                continue
            t = _leaf_tensor(np.asarray(sub[key]))
            if tuple(t.shape) != d.shape or t.dtype != d.dtype:
                raise ValueError(f"{path}{key}: {tuple(t.shape)} {t.dtype}, "
                                 f"expected {d.shape} {d.dtype}")
            out[key] = t.to(device)
        return out

    return carry(param_defs(cfg), tree, "")


_OPT_STATE_KEYS = ({"step", "m", "v", "master"}, {"step", "stats"},
                   {"step", "mom"})


def opt_state_from_reference(tree: Mapping[str, Any], device="cuda"
                             ) -> dict[str, Any]:
    """The port's optimizer state from the JAX package's: the state tree of
    ``repro.training.optim``'s ``adamw`` (``{"step", "m", "v", "master"}``),
    ``adafactor`` (``{"step", "stats"}``, ``{"vr", "vc"}`` or ``{"v"}`` per
    leaf) or ``sgd`` (``{"step", "mom"}``), each leaf converted by
    ``np.asarray``.  The port's optimizers (:mod:`repro_torch.training.optim`)
    keep the same keys, so the carry is leaf for leaf, dtypes kept (the
    int32 ``step`` too).  The tensors land on the card unless
    ``device="cpu"`` (the default raises without one)."""
    device = resolve_device(device)
    if set(tree) not in _OPT_STATE_KEYS:
        raise ValueError(f"not an optimizer state of the reference: keys "
                         f"{sorted(tree)}")

    def carry(sub):
        if isinstance(sub, Mapping):
            return {key: carry(val) for key, val in sub.items()}
        return _leaf_tensor(np.asarray(sub)).to(device)

    return carry(tree)
