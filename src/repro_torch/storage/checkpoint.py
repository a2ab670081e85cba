"""Fault-tolerant sharded checkpointing over the KV layer, in torch: the
port of ``repro/storage/checkpoint.py``.

Crash consistency as in the reference: every leaf lands in the store
first, the manifest (step, leaf names, dtypes and shapes, ``extra``) after
them, and the ``latest`` pointer last, then one ``flush``; a crash before
the pointer leaves the previous checkpoint the latest (a
:class:`~repro_torch.storage.kv.LogFileKV` truncates a torn tail on
recovery).  Keys are the reference's: ``(shard, step, "ckpt/<leaf>/<shard>")``,
``(0, step, "manifest")``, ``(0, -2, "latest")``, and
``(0, step, "pdelta/<leaf>")`` for parameter deltas.

Trees are flattened as ``jax.tree_util`` flattens them
(:mod:`repro_torch.tree_util`: dict keys sorted, sequences by index, names
joined by ``/``), and every leaf is written with the reference's dtype
name: a checkpoint that either package writes restores in the other.
torch's bf16 has no numpy dtype, so a bf16 leaf travels as its uint16 bits
under the dtype name ``bfloat16`` (``codec.encode_blob(bf16=...)``), which
the reference reads back as its ``ml_dtypes`` bfloat16.  Restored leaves
are tensors: on the device of the matching leaf of ``like``, or on the CPU.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..tree_util import flatten_with_paths, path_name, unflatten
from .columnar import pack_arrays, unpack_arrays
from .kv import KVStore

MANIFEST = "manifest"
BF16 = "bfloat16"


def _flatten_with_paths(tree) -> list[tuple[str, object]]:
    return [(path_name(path), leaf) for path, leaf in flatten_with_paths(tree)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and the reference's dtype name for it: bf16
    tensors as their uint16 bits, named ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _to_numpy(leaf.new_empty(0))[1]
    return str(np.asarray(leaf).dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A decoded array as a tensor of the manifest's ``dtype``: ``bfloat16``
    arrives as uint16 bits, or as an ``ml_dtypes`` array where that module
    is loaded; both are reinterpreted, never converted."""
    arr = np.ascontiguousarray(arr)
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=True))


def _pack(arr: np.ndarray, dtype: str) -> bytes:
    return pack_arrays({"a": arr}, bf16=("a",) if dtype == BF16 else ())


def save_checkpoint(store: KVStore, step: int, tree, *,
                    extra: dict | None = None, n_shards: int = 1) -> None:
    """Write all leaves (row-sharded into ``n_shards``), then the manifest,
    then the ``latest`` pointer."""
    names = []
    for name, leaf in _flatten_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        names.append({"name": name, "dtype": dtype, "shape": list(arr.shape)})
        if arr.ndim == 0 or n_shards == 1:
            store.put((0, step, f"ckpt/{name}/0"), _pack(arr, dtype))
        else:
            for p, part in enumerate(np.array_split(arr, n_shards, axis=0)):
                store.put((p, step, f"ckpt/{name}/{p}"), _pack(part, dtype))
    manifest = {"step": step, "leaves": names, "n_shards": n_shards,
                "extra": extra or {}}
    store.put((0, step, MANIFEST), json.dumps(manifest).encode())
    # commit marker: the "latest" pointer is the last thing written
    store.put((0, -2, "latest"), json.dumps({"step": step}).encode())
    store.flush()


def latest_step(store: KVStore) -> int | None:
    try:
        return json.loads(store.get((0, -2, "latest")))["step"]
    except KeyError:
        return None


def restore_checkpoint(store: KVStore, step: int | None = None, *,
                       like=None):
    """``(tree, extra, step)`` of checkpoint ``step`` (the latest if None).
    With ``like`` the tree has its structure and each leaf lands on the
    device of ``like``'s leaf of the same name; without, a dict of leaf
    name -> CPU tensor."""
    if step is None:
        step = latest_step(store)
        if step is None:
            raise FileNotFoundError("no checkpoint found")
    manifest = json.loads(store.get((0, step, MANIFEST)))
    tensors: dict[str, torch.Tensor] = {}
    for meta in manifest["leaves"]:
        name = meta["name"]
        parts = []
        for p in range(manifest["n_shards"]):
            key = (p, step, f"ckpt/{name}/{p}")
            if key in store:
                parts.append(unpack_arrays(store.get(key))["a"])
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        tensors[name] = _to_tensor(arr, meta["dtype"]).reshape(meta["shape"])
    if like is None:
        return tensors, manifest["extra"], step
    flat = _flatten_with_paths(like)
    leaves = [tensors[name].to(_device_of(leaf)) for name, leaf in flat]
    return unflatten(like, leaves), manifest["extra"], step


def _device_of(leaf) -> torch.device:
    return leaf.device if isinstance(leaf, torch.Tensor) else \
        torch.device("cpu")


# ---------------------------------------------------------------------------
# beyond-paper: parameter history as a delta chain (DeltaGraph-over-steps)
# ---------------------------------------------------------------------------

def _values(arr: np.ndarray, dtype: str) -> np.ndarray:
    """What the delta compares: bf16 bits as their f32 values."""
    if dtype == BF16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def save_param_delta(store: KVStore, step: int, prev_step: int | None,
                     tree, prev_tree=None, atol: float = 0.0) -> int:
    """Store params as a sparse delta against the previous checkpoint (the
    changed entries only; ``atol`` > 0 thresholds "changed", lossy but
    small).  Returns the bytes written."""
    written = 0
    flat = _flatten_with_paths(tree)
    prev = dict(_flatten_with_paths(prev_tree)) if prev_tree is not None \
        else {}
    for name, leaf in flat:
        arr, dtype = _to_numpy(leaf)
        bf16 = ("full", "val") if dtype == BF16 else ()
        if prev_tree is None or prev_step is None:
            payload = pack_arrays({"full": arr}, bf16=bf16)
        else:
            old, _ = _to_numpy(prev[name])
            if arr.shape != old.shape:
                payload = pack_arrays({"full": arr}, bf16=bf16)
            else:
                a, b = _values(arr, dtype).ravel(), _values(old, dtype).ravel()
                diff = np.nonzero(~np.isclose(a, b, atol=atol, rtol=0))[0]
                payload = pack_arrays({"idx": diff.astype(np.int64),
                                       "val": arr.ravel()[diff],
                                       "shape": np.asarray(arr.shape)},
                                      bf16=bf16)
        store.put((0, step, f"pdelta/{name}"), payload)
        written += len(payload)
    store.put((0, step, "pdelta/manifest"),
              json.dumps({"prev": prev_step,
                          "names": [n for n, _ in flat]}).encode())
    return written


def restore_param_history(store: KVStore, steps: list[int], like):
    """Parameters at each of ``steps`` (in chain order), rebuilt by walking
    the delta chain — "snapshot queries over training time" — each a tree
    of ``like``'s structure with leaves of ``like``'s dtypes on its
    devices."""
    out = {}
    cur: dict[str, np.ndarray] | None = None
    flat = _flatten_with_paths(like)
    dtypes = {name: _dtype_name(leaf) for name, leaf in flat}
    for step in steps:
        man = json.loads(store.get((0, step, "pdelta/manifest")))
        nxt: dict[str, np.ndarray] = {}
        for name in man["names"]:
            d = unpack_arrays(store.get((0, step, f"pdelta/{name}")))
            if "full" in d:
                nxt[name] = np.array(d["full"])
            else:
                base = cur[name].ravel().copy()
                base[d["idx"]] = d["val"]
                nxt[name] = base.reshape([int(x) for x in d["shape"]])
        cur = nxt
        out[step] = unflatten(like, [
            _to_tensor(cur[name], dtypes[name]).to(_device_of(leaf))
            for name, leaf in flat])
    return out
