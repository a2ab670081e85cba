"""Node-ID-space partitioning (paper §4.2, §4.6).

``partition_id = h_p(slot)``.  Two partitioners:

* ``word_cyclic`` — ``(slot >> 5) % P``: whole 32-bit bitmap *words* are
  assigned round-robin to partitions.  This is the TPU adaptation: every
  partition's membership bits pack into word-aligned shards (so a
  ``shard_map`` over partitions needs zero re-layout), while round-robin
  keeps load balanced for append-ordered slot ids.
* ``mod_hash``   — splitmix-style hash of the slot, the paper-faithful
  arbitrary hash (balanced, but not word-aligned; host engine only).

Both are stable pure functions of (slot, P) so storage written by one
deployment can be read by another with the same (name, P).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Partitioner = Callable[[np.ndarray, int], np.ndarray]


def word_cyclic(slots: np.ndarray, P: int) -> np.ndarray:
    s = np.asarray(slots, np.int64)
    return ((s >> 5) % P).astype(np.int32)


def mod_hash(slots: np.ndarray, P: int) -> np.ndarray:
    x = np.asarray(slots, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x % np.uint64(P)).astype(np.int32)


_PARTITIONERS: dict[str, Partitioner] = {
    "word_cyclic": word_cyclic,
    "mod_hash": mod_hash,
}


def get_partitioner(name: str) -> Partitioner:
    if name not in _PARTITIONERS:
        raise KeyError(f"unknown partitioner {name!r}; have {sorted(_PARTITIONERS)}")
    return _PARTITIONERS[name]


def partition_word_slices(num_words: int, P: int) -> list[np.ndarray]:
    """Word indices owned by each partition under ``word_cyclic``."""
    return [np.arange(p, num_words, P) for p in range(P)]
