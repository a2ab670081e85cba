"""Columnar (de)serialization of deltas and eventlists (paper §4.2).

Each delta is split into independently fetchable components so a
structure-only retrieval reads zero attribute bytes (paper fig 8d):

* ``struct``     — node_add / node_del / edge_add / edge_del index arrays
* ``nodeattr``   — (slot, col, new, old) quads
* ``edgeattr``   — (slot, col, new, old) quads

and each leaf-eventlist into:

* ``elist_struct``    — (time, etype, slot) of membership events
* ``elist_nodeattr``  — (time, slot, col, new, old) of UNA events
* ``elist_edgeattr``  — ... of UEA events
* ``elist_transient`` — (time, etype, slot) of transient events

The wire format is owned by :mod:`repro_torch.storage.codec`: a self-
describing array bundle, by default compressed + checksummed behind a
versioned header (``v2``), with the original raw bundle as the
always-decodable fallback.  ``pack_arrays``/``unpack_arrays`` are the
single (en|de)code chokepoint for every persisted payload — deltas,
eventlists, checkpoints, baselines, the skeleton.
"""
from __future__ import annotations

import numpy as np

from ..core.deltas import AttrDelta, Delta
from ..core.events import (EV_DEL_EDGE, EV_DEL_NODE, EV_NEW_EDGE, EV_NEW_NODE,
                           EV_TRANS_EDGE, EV_TRANS_NODE, EV_UPD_EDGE_ATTR,
                           EV_UPD_NODE_ATTR, EventList)
from . import codec

STRUCT = "struct"
NODEATTR = "nodeattr"
EDGEATTR = "edgeattr"
ELIST_STRUCT = "elist_struct"
ELIST_NODEATTR = "elist_nodeattr"
ELIST_EDGEATTR = "elist_edgeattr"
ELIST_TRANSIENT = "elist_transient"

DELTA_COMPONENTS = (STRUCT, NODEATTR, EDGEATTR)
ELIST_COMPONENTS = (ELIST_STRUCT, ELIST_NODEATTR, ELIST_EDGEATTR, ELIST_TRANSIENT)


# ---------------------------------------------------------------------------
# array-bundle wire format (delegates to the codec layer)
# ---------------------------------------------------------------------------

def pack_arrays(arrays: dict[str, np.ndarray]) -> bytes:
    """Encode an array bundle with the session's default codec
    (:func:`repro_torch.storage.codec.get_default_codec`)."""
    return codec.encode_blob(arrays)


def unpack_arrays(data: bytes) -> dict[str, np.ndarray]:
    """Decode any blob ever written — v2 by magic sniff, raw fallback.
    Raises :class:`repro_torch.storage.codec.CodecError` on corrupt input."""
    return codec.decode_blob(data)


def logical_nbytes(arrays: dict[str, np.ndarray]) -> int:
    """Decoded (in-memory) size of a bundle — the codec-independent half
    of the planner's stored-vs-logical cost split."""
    return int(sum(int(a.nbytes) for a in arrays.values()))


# ---------------------------------------------------------------------------
# delta components
# ---------------------------------------------------------------------------

def encode_delta_struct(d: Delta) -> bytes:
    return pack_arrays({"node_add": d.node_add, "node_del": d.node_del,
                        "edge_add": d.edge_add, "edge_del": d.edge_del})


def decode_delta_struct(b: bytes) -> dict[str, np.ndarray]:
    return unpack_arrays(b)


def encode_attr(a: AttrDelta) -> bytes:
    return pack_arrays({"slot": a.slot, "col": a.col, "new": a.new, "old": a.old})


def decode_attr(b: bytes) -> AttrDelta:
    d = unpack_arrays(b)
    return AttrDelta(d["slot"], d["col"], d["new"], d["old"])


def encode_delta(d: Delta) -> dict[str, bytes]:
    return {STRUCT: encode_delta_struct(d),
            NODEATTR: encode_attr(d.node_attr),
            EDGEATTR: encode_attr(d.edge_attr)}


def decode_delta(parts: dict[str, bytes]) -> Delta:
    s = decode_delta_struct(parts[STRUCT])
    na = decode_attr(parts[NODEATTR]) if NODEATTR in parts else AttrDelta.empty()
    ea = decode_attr(parts[EDGEATTR]) if EDGEATTR in parts else AttrDelta.empty()
    return Delta(s["node_add"], s["node_del"], s["edge_add"], s["edge_del"], na, ea)


# ---------------------------------------------------------------------------
# eventlist components
# ---------------------------------------------------------------------------

def eventlist_components(ev: EventList) -> dict[str, dict[str, np.ndarray]]:
    """Split a leaf-eventlist into its columnar component *arrays* (the
    pre-encode form: callers that re-key per attribute column slice these
    directly instead of decoding a just-encoded blob)."""
    et = ev.etype
    m_struct = np.isin(et, (EV_NEW_NODE, EV_DEL_NODE, EV_NEW_EDGE, EV_DEL_EDGE))
    m_na = et == EV_UPD_NODE_ATTR
    m_ea = et == EV_UPD_EDGE_ATTR
    m_tr = np.isin(et, (EV_TRANS_EDGE, EV_TRANS_NODE))
    # `pos` = index within the full leaf-eventlist, so arbitrary prefixes can
    # be replayed per-component without a global merge.
    pos = np.arange(len(ev), dtype=np.int32)

    def sub(mask, with_attr: bool) -> dict[str, np.ndarray]:
        arrays = {"pos": pos[mask], "time": ev.time[mask],
                  "etype": et[mask], "slot": ev.slot[mask]}
        if with_attr:
            arrays.update({"col": ev.attr_col[mask], "new": ev.value[mask],
                           "old": ev.old_value[mask]})
        return arrays

    return {ELIST_STRUCT: sub(m_struct, False),
            ELIST_NODEATTR: sub(m_na, True),
            ELIST_EDGEATTR: sub(m_ea, True),
            ELIST_TRANSIENT: sub(m_tr, False)}


def encode_eventlist(ev: EventList) -> dict[str, bytes]:
    return {name: pack_arrays(arrays)
            for name, arrays in eventlist_components(ev).items()}


def decode_eventlist(parts: dict[str, bytes]) -> dict[str, dict[str, np.ndarray]]:
    return {name: unpack_arrays(b) for name, b in parts.items()}
