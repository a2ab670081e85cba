"""Fault tolerance & straggler mitigation for 1000+-node deployments.

* :class:`HeartbeatTracker` — detects dead partitions/hosts from missed
  heartbeats (coordinator-side logic; transport is pluggable).
* :func:`elastic_replan` — when ``P`` storage partitions must be served by
  ``W < P`` (or ``> P``) surviving workers, reassigns partitions with
  consistent hashing so only the failed node's shard moves.
* :class:`StragglerMitigator` — the multipoint-retrieval scheduler:
  deficit-based work stealing over per-partition fetch queues, plus
  hedged ("backup") requests for the slowest percentile, the standard
  tail-latency defense.
* :func:`retry` — bounded exponential backoff for storage operations.

These are deliberately transport-agnostic (pure logic + callables) so unit
tests can drive them deterministically — the same structure a real
multi-host deployment would wire to its RPC layer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable


def default_retryable(e: BaseException) -> bool:
    """The standard transient-fault classification: local IO/timeout
    faults, plus any error that classifies *itself* via a ``retryable``
    attribute — the RPC layer's typed transport errors
    (:mod:`repro_torch.runtime.rpc`) mark connection resets and deadline expiry
    retryable but framing corruption and remote logic errors fatal."""
    return (isinstance(e, (IOError, TimeoutError))
            or getattr(e, "retryable", False) is True)


def retry(fn: Callable, *, attempts: int = 4, base_delay: float = 0.01,
          retryable=(IOError, TimeoutError),
          sleep: Callable = time.sleep):
    """Bounded exponential backoff.  ``retryable`` is either an exception
    class tuple or a predicate ``(exc) -> bool`` (pass
    :func:`default_retryable` to honor the RPC layer's own
    retryable/fatal classification).  ``KeyError`` is deliberately *not*
    retryable by default: a missing blob is a routing/consistency bug, not
    a transient fault, and backing off on it turns every such bug into a
    multi-attempt stall."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if callable(retryable) and not isinstance(retryable, type):
        pred = retryable
    else:
        pred = lambda e: isinstance(e, retryable)  # noqa: E731
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: PERF203
            if not pred(e):
                raise
            last = e
            if i + 1 < attempts:
                sleep(base_delay * (2 ** i))
    # re-raise the final attempt's exception with its original traceback
    # (the exception object carries __traceback__; `raise` appends here).
    # For RPC RemoteCallError the *remote* traceback string rides along in
    # the message, so the worker-side frames survive this local re-raise.
    raise last


class HeartbeatTracker:
    def __init__(self, workers: Iterable[str], timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.timeout = timeout
        self.clock = clock
        self.last_seen = {w: clock() for w in workers}

    def beat(self, worker: str) -> None:
        self.last_seen[worker] = self.clock()

    def mark_dead(self, worker: str) -> None:
        """Administratively expire a worker (fault injection, or a failed
        task observed out-of-band): it reads as dead from now on, until a
        fresh :meth:`beat`."""
        self.last_seen[worker] = float("-inf")

    def dead(self) -> list[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout]

    def alive(self) -> list[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t <= self.timeout]


def _hrw(s: str) -> int:
    import hashlib
    return int(hashlib.md5(s.encode()).hexdigest()[:8], 16)


def rendezvous_rank(partition: int, workers: list[str]) -> list[str]:
    """Workers ordered by descending rendezvous weight for ``partition``.
    ``rank[0]`` is :func:`elastic_replan`'s assignment; ``rank[1:]`` are
    the natural replica/failover candidates — removing any worker deletes
    its entry without reordering the rest, so replica sets move minimally
    on membership change (same hash, same guarantee)."""
    scored = sorted(((-_hrw(f"part{partition}@{w}"), i, w)
                     for i, w in enumerate(workers)))
    return [w for _, _, w in scored]


def elastic_replan(partitions: int, workers: list[str]) -> dict[int, str]:
    """Rendezvous (highest-random-weight) partition→worker assignment:
    partition ``p`` goes to the worker maximizing ``h(p, w)``.  When a
    worker dies only its partitions move — removing ``w`` cannot change
    any other partition's argmax — and each partition picks independently
    and uniformly, so the load is multinomial-balanced (the ring variant's
    arc-length skew made small fleets badly lopsided)."""
    return {p: rendezvous_rank(p, workers)[0] for p in range(partitions)}


@dataclasses.dataclass
class FetchTask:
    partition: int
    key: Any
    size_est: int


class StragglerMitigator:
    """Deficit-based scheduler over per-partition queues with hedging.

    ``assign(next_free_worker)`` hands out the task from the queue with the
    largest remaining byte deficit; when < ``hedge_frac`` of tasks remain,
    outstanding tasks are replicated to idle workers (first completion
    wins) — bounded duplicate work for a bounded tail.
    """

    def __init__(self, tasks: list[FetchTask], hedge_frac: float = 0.05,
                 max_duplicates: int = 1):
        self.queues: dict[int, list[FetchTask]] = {}
        for t in tasks:
            self.queues.setdefault(t.partition, []).append(t)
        self.total = sum(t.size_est for t in tasks)
        self.outstanding: dict[Any, FetchTask] = {}
        self.done: set[Any] = set()
        self.hedge_threshold = max(1, int(len(tasks) * hedge_frac))
        # per-task duplicate cap: N idle workers must not all pile onto
        # one outstanding key (unbounded duplicates defeat the point of
        # hedging — bounded extra work for a bounded tail)
        self.max_duplicates = max(0, int(max_duplicates))
        self.duplicates = 0
        self._assign_seq = 0
        self._seq: dict[Any, int] = {}      # key -> first-assignment order
        self._dups: dict[Any, int] = {}     # key -> duplicates handed out

    def remaining(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def assign(self) -> FetchTask | None:
        # largest-deficit queue first
        best = None
        for p, q in self.queues.items():
            if not q:
                continue
            deficit = sum(t.size_est for t in q)
            if best is None or deficit > best[0]:
                best = (deficit, p)
        if best is not None:
            task = self.queues[best[1]].pop(0)
            self.outstanding[task.key] = task
            self._seq[task.key] = self._assign_seq
            self._assign_seq += 1
            return task
        # hedge: replicate for an idle worker the *oldest-assigned*
        # outstanding task that still has duplicate budget — the task
        # most likely stuck on a straggler, each key at most
        # ``max_duplicates`` extra times
        if self.outstanding and len(self.outstanding) <= self.hedge_threshold:
            cands = [k for k in self.outstanding
                     if self._dups.get(k, 0) < self.max_duplicates]
            if cands:
                key = min(cands, key=lambda k: self._seq.get(k, 0))
                self._dups[key] = self._dups.get(key, 0) + 1
                self.duplicates += 1
                return self.outstanding[key]
        return None

    def complete(self, key: Any) -> bool:
        """Returns True if this completion is the first for the task."""
        self.outstanding.pop(key, None)
        self._seq.pop(key, None)
        self._dups.pop(key, None)
        if key in self.done:
            return False
        self.done.add(key)
        return True

    def fail(self, key: Any) -> bool:
        """A worker's attempt errored: drop its claim and requeue the task
        for another worker, unless some attempt already completed.  Returns
        True when the task was requeued."""
        task = self.outstanding.pop(key, None)
        self._seq.pop(key, None)
        self._dups.pop(key, None)
        if task is None or key in self.done:
            return False
        self.queues.setdefault(task.partition, []).append(task)
        return True

    def finished(self) -> bool:
        return not self.outstanding and self.remaining() == 0
