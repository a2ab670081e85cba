"""Spans and counters: the port's one record of where a request's time,
bytes and launches go.

**Spans** (:func:`span`) name a piece of work where it happens.  Each
record holds the span's name, a request id, its parent span (the span
that caused it), its start and end from ``time.time_ns()`` and optional
work counts (bytes, entries, a launch's shape).  A span opened with no
span open is a root and starts a new request; a nested span inherits the
request id and points to the span around it.  Work that runs after its
request's root has closed (``SnapshotAnalytics``' methods) names that
root as ``parent=`` and joins its request.

Spans record exactly while a ``torch.profiler`` window is recording: one
check a span (``torch.autograd._profiler_enabled``); otherwise nothing is
stored.  ``time.time_ns()`` is the clock the profiler stamps its host
events with (its ``trace_start_ns()`` plus an event's ``time_range`` in
microseconds), so the records line up with the window's kernels and
copies without adding an event to it: the program opens no
``record_function`` range and no NVTX range.  Finished records go into a
ring buffer of :data:`CAPACITY`; each record it pushes out adds one to
the ``spans_dropped`` counter.

**Counters** (:func:`count`) are always on: plain integer adds where the
work is done.  ``span_ns.<name>``: nanoseconds inside spans of that name
(a span inside one of its own name adds nothing); ``h2d_bytes``,
``d2h_bytes``: bytes copied to and from a CUDA device
(:mod:`repro_torch.transfer`); ``bucket_entries``: the padded entries that
``bucket_edges`` lays out; ``launch.<kernel>``: kernel launches
(``kernels.launch_counts()``); ``spans_dropped``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

# a traced 51-s window of the benchmark's churn cell on an H100: about 2,600
# requests of 35 spans each, past 90,000 records
CAPACITY = 1 << 18

_recording = torch.autograd._profiler_enabled
_counters: dict[str, int] = {}
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_request_ids = itertools.count(1)
_span_ids = itertools.count(1)
_local = threading.local()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """Every counter's value so far."""
    return dict(_counters)


def reset(*names: str) -> None:
    """Set the counters ``names`` back to 0."""
    for name in names:
        _counters[name] = 0


def records() -> list["Span"]:
    """The finished spans the ring buffer holds, oldest first."""
    return list(_records)


def clear() -> None:
    """Empty the ring buffer (counters keep their values)."""
    _records.clear()


class _Off:
    """What :func:`span` returns while no profiler records: does nothing,
    and is false."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def note(self, **work) -> None:
        pass


_OFF = _Off()


def _open() -> tuple[list, dict]:
    try:
        return _local.stack, _local.depth
    except AttributeError:
        _local.stack, _local.depth = [], {}
        return _local.stack, _local.depth


class Span:
    """One span's record: ``name``, ``rid`` (request id), ``sid`` (its own
    id), ``parent`` (its parent's ``sid``, 0 for a root), ``start`` and
    ``end`` (``time.time_ns()``) and ``work``."""
    __slots__ = ("name", "rid", "sid", "parent", "start", "end", "work",
                 "_cause", "_outer")

    def __init__(self, name: str, cause: "Span | None", work: dict):
        self.name, self.work, self._cause = name, work, cause

    def __enter__(self) -> "Span":
        stack, depth = _open()
        up = self._cause or (stack[-1] if stack else None)
        self.rid = up.rid if up is not None else next(_request_ids)
        self.parent = up.sid if up is not None else 0
        self.sid = next(_span_ids)
        self._outer = depth.get(self.name, 0) == 0
        depth[self.name] = depth.get(self.name, 0) + 1
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        stack, depth = _open()
        stack.pop()
        depth[self.name] -= 1
        if self._outer:
            count("span_ns." + self.name, self.end - self.start)
        if len(_records) == CAPACITY:
            count("spans_dropped")
        _records.append(self)
        return False

    def note(self, **work) -> None:
        """Add work counts known only once the span is open."""
        self.work.update(work)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, rid={self.rid}, sid={self.sid}, "
                f"parent={self.parent}, {self.end - self.start} ns, "
                f"{self.work})")


def span(name: str, parent: Span | _Off | None = None, **work):
    """A context manager that records one span while a profiler window
    records, and does nothing otherwise.  ``parent``: the span that caused
    this one when it is no longer open (else the innermost open span);
    ``work``: counts of the work done (bytes, entries, shapes)."""
    if not _recording():
        return _OFF
    return Span(name, parent or None, work)
