"""The traced run: spans around the program's functions, counters, and
one ``torch.profiler`` window read back into a :class:`Trace`.

Spans are ``record_function`` ranges named ``hgbench::<name>``, opened by
wrappers that replace a program function by attribute for the traced
window only (the program is not edited); the profiler puts them on the
same clock as the device's kernels and copies.  Each per-layer metric's
file names the functions it wraps (``WRAPS``) and the counters it reads
(``COUNTERS``); this module installs and removes them and hands every
reader the same :class:`Trace`.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib

import torch
from torch.autograd import DeviceType

PREFIX = "hgbench::"
REQUEST = "request"


@dataclasses.dataclass
class Trace:
    """What one traced window recorded.  Times in seconds on the
    profiler's clock."""
    requests: int                       # requests completed in the window
    window: tuple[float, float]         # first request start, last end
    spans: dict[str, list[tuple[float, float]]]
    calls: dict[str, list]              # per wrapped span: what the call got
    device: list[tuple[str, float, float]]   # (name, start, end), in window
    counters: dict[str, tuple[float, float]]  # (at start, at end)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def span_s(self, name: str) -> float:
        """Seconds covered by ``name``'s spans (nested calls once)."""
        return union_s(self.spans.get(name, ()))

    def device_s(self, match: str) -> float:
        """Device seconds of the operations whose name holds ``match``."""
        return sum(e - s for n, s, e in self.device if match in n)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return union_s((s, e) for _, s, e in self.device)


def union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


class Wraps:
    """Replace program functions by attribute with span-opening wrappers;
    :meth:`restore` puts every original back."""

    def __init__(self) -> None:
        self.calls: dict[str, list] = {}
        self._undo: list[tuple[object, str, object]] = []

    def wrap(self, module: str, attr: str, span: str, record=None) -> None:
        """Wrap ``module.attr``: every call opens the span ``span``; with
        ``record``, ``record(*args, **kwargs)`` is kept in
        ``calls[span]``."""
        owner = importlib.import_module(module)
        for part in attr.split(".")[:-1]:
            owner = getattr(owner, part)
        name = attr.split(".")[-1]
        orig = getattr(owner, name)
        calls = self.calls.setdefault(span, [])

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if record is not None:
                calls.append(record(*args, **kwargs))
            with torch.profiler.record_function(PREFIX + span):
                return orig(*args, **kwargs)

        setattr(owner, name, wrapper)
        self._undo.append((owner, name, orig))

    def restore(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)


def install(metrics, wraps: Wraps) -> None:
    """Every ``WRAPS`` entry of the metric modules: ``(module, attribute,
    span[, record])``."""
    for m in metrics:
        for module, attr, span, *record in getattr(m, "WRAPS", ()):
            wraps.wrap(module, attr, span, *record)


def read_counters(metrics, ctx) -> dict[str, float]:
    out = {}
    for m in metrics:
        for name, fn in getattr(m, "COUNTERS", {}).items():
            out[name] = float(fn(ctx))
    return out


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def collect(prof, calls: dict, counters: dict) -> Trace:
    """The :class:`Trace` of a finished profiler window."""
    spans: dict[str, list[tuple[float, float]]] = {}
    device = []
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(PREFIX):
            # the profiler mirrors each span onto the device's timeline
            # as an annotation: not an operation, so not kept there
            if e.device_type == DeviceType.CPU:
                spans.setdefault(e.name[len(PREFIX):], []).append((s, t))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, s, t))
    req = spans.get(REQUEST, [])
    window = ((min(s for s, _ in req), max(t for _, t in req)) if req
              else (0.0, 0.0))
    device = [(n, max(s, window[0]), min(t, window[1])) for n, s, t in device
              if t > window[0] and s < window[1]]
    return Trace(len(req), window, spans, calls, device, counters)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each labelled by the innermost ``hgbench`` span open at its
    middle (``client`` where none is: the harness between requests)."""
    by_op: dict[str, float] = {}
    for n, s, e in trace.device:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    t = trace.window[0]
    for _, s, e in sorted(trace.device, key=lambda d: d[1]):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.window[1] > t:
        gaps.append((t, trace.window[1]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for s, e in gaps:
        mid = (s + e) / 2
        best, width = "client", float("inf")
        for name, ivs in trace.spans.items():
            for a, b in ivs:
                if a <= mid <= b and b - a < width:
                    best, width = name, b - a
        labelled.append([best, e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": labelled}
