"""Refcounted epoch registry for red/green index swaps (§6 live updates).

An *epoch* is one immutable version of the retrieval index: a
:class:`~repro_torch.core.deltagraph.DeltaGraph` whose skeleton, ``recent``
tail and bookkeeping are frozen from the reader's point of view.  The
ingest pipeline publishes a new epoch for every committed event group
(cheap shallow clone — only ``recent`` moved) and for every completed
leaf rollover (structural fork rebuilt on a worker thread).

Readers pin an epoch at query entry (``registry.acquire()``) so every
plan compiled within one query document resolves against one consistent
index version, even while the writer publishes newer epochs underneath.
The green→red switch is a single atomic pointer swap under the registry
lock; superseded resources (cap-delta payloads, pool pins, WAL records)
are reclaimed *deferred*: an epoch's reclaim callbacks run only once its
refcount has drained **and** every older retired epoch has drained too,
so a reader pinned three epochs back never loses a payload that a newer
publish retired.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable

__all__ = ["EpochData", "Epoch", "EpochPin", "EpochRegistry"]

# Sentinel watermark for an epoch that has seen no events yet.
NO_TIME = -(2 ** 62)


@dataclass(frozen=True)
class EpochData:
    """The immutable payload of one epoch.

    ``dg`` is the index version readers plan/execute against; ``n_events``
    the number of events folded *or* pending in it (a group-aligned prefix
    of the global stream — the replay oracle for this epoch); ``max_time``
    the watermark: every ingested event so far has ``time <= max_time``,
    so snapshot results at ``t < max_time`` are immutable under monotone
    ingest and cacheable across epochs.
    """
    dg: Any
    n_events: int = 0
    max_time: int = NO_TIME


class Epoch:
    """One published index version plus its lifecycle bookkeeping."""

    __slots__ = ("id", "data", "refs", "reclaims", "retired")

    def __init__(self, eid: int, data: EpochData,
                 reclaims: Iterable[Callable[[], None]] = ()) -> None:
        self.id = eid
        self.data = data
        self.refs = 0
        self.reclaims: list[Callable[[], None]] = list(reclaims)
        self.retired = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Epoch(id={self.id}, refs={self.refs}, "
                f"retired={self.retired}, n_events={self.data.n_events})")


class EpochPin:
    """Context-manager handle on one acquired epoch (``with`` or manual
    :meth:`release`; release is idempotent)."""

    __slots__ = ("_registry", "epoch", "_released")

    def __init__(self, registry: "EpochRegistry", epoch: Epoch) -> None:
        self._registry = registry
        self.epoch = epoch
        self._released = False

    @property
    def id(self) -> int:
        return self.epoch.id

    @property
    def data(self) -> EpochData:
        return self.epoch.data

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._registry.release(self.epoch)

    def __enter__(self) -> "EpochPin":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class EpochRegistry:
    """Monotonic epoch ids, atomic publish, ordered deferred reclamation.

    Invariants (property-tested in ``tests/test_hypothesis_core.py``):

    * ids are strictly monotonic; ``acquire`` always returns the epoch
      that was current at some single instant (never a torn mix);
    * a retired epoch's reclaim callbacks run exactly once, and only
      after its refcount is zero *and* all older retired epochs have
      already been reclaimed (readers pinned further back keep every
      resource the epochs after them may share);
    * the current epoch is never reclaimed.
    """

    def __init__(self, data: EpochData) -> None:
        self._lock = threading.Lock()
        self._current = Epoch(0, data)
        self._retired: deque[Epoch] = deque()
        self._reclaimed = 0
        self._subscribers: list[Callable[[int, EpochData], None]] = []

    # ------------------------------------------------------------ reads
    @property
    def current_id(self) -> int:
        return self._current.id

    @property
    def current_data(self) -> EpochData:
        return self._current.data

    def acquire(self) -> EpochPin:
        """Pin the current epoch; the caller must release (use ``with``)."""
        with self._lock:
            ep = self._current
            ep.refs += 1
        return EpochPin(self, ep)

    def release(self, epoch: Epoch) -> None:
        with self._lock:
            epoch.refs -= 1
            ready = self._drain_locked()
        self._run(ready)

    # ------------------------------------------------------------ writes
    def publish(self, data: EpochData,
                reclaims: Iterable[Callable[[], None]] = ()) -> int:
        """Atomically make ``data`` the current epoch.

        ``reclaims`` run once every reader of the *superseded* epoch (and
        all older ones) has released its pin — this is where cap-delta
        payload deletion and pool-pin release for the replaced index
        version belong.
        """
        with self._lock:
            old = self._current
            old.retired = True
            old.reclaims.extend(reclaims)
            self._retired.append(old)
            self._current = Epoch(old.id + 1, data)
            new_id = self._current.id
            ready = self._drain_locked()
            subs = list(self._subscribers)
        self._run(ready)
        # announcements run outside the lock (a subscriber may do I/O —
        # e.g. the process transport fanning the new id out to shard
        # caches); a reader racing ahead of a slow announcement is still
        # safe because fetches carry the pinned epoch id (``min_epoch``)
        for cb in subs:
            cb(new_id, data)
        return new_id

    # ---------------------------------------------------- subscriptions
    def subscribe(self, cb: Callable[[int, EpochData], None]) -> None:
        """Register ``cb(new_epoch_id, data)`` to run after every publish
        — the cache-invalidation fan-out hook (shard-local hot caches
        subscribe via their transport).  Callbacks run outside the
        registry lock, in publish order for any single publisher."""
        with self._lock:
            self._subscribers.append(cb)

    def unsubscribe(self, cb: Callable[[int, EpochData], None]) -> None:
        with self._lock:
            try:
                self._subscribers.remove(cb)
            except ValueError:
                pass

    # ------------------------------------------------------------ drain
    def _drain_locked(self) -> list[Callable[[], None]]:
        """Pop drained retired epochs in order; return their reclaims."""
        ready: list[Callable[[], None]] = []
        while self._retired and self._retired[0].refs == 0:
            ep = self._retired.popleft()
            ready.extend(ep.reclaims)
            ep.reclaims = []
            self._reclaimed += 1
        return ready

    @staticmethod
    def _run(callbacks: list[Callable[[], None]]) -> None:
        for cb in callbacks:
            cb()

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            return {"current_id": self._current.id,
                    "current_refs": self._current.refs,
                    "retired_pending": len(self._retired),
                    "reclaimed": self._reclaimed}
