"""Mask unpacking time a request: the program's ``unpack`` spans
(``runtime/torch_exec.py``: the landed words turned into bool masks on
the host).

Read from the program's ``span_ns.unpack`` counter (nanoseconds inside
its ``unpack`` spans, which record while a profiler window does) at the
traced window's start and end, over the window's requests.  Nothing where
the program keeps no such counter, where no such span ran, or where its
span buffer overflowed (``spans_dropped`` moved)."""

SOURCE = "program_span"


def _counter(name):
    def value(ctx):
        try:
            from repro_torch import obs
        except ImportError:         # a program that keeps no such counters
            return float("nan")
        return obs.counters().get(name, 0)
    return value


COUNTERS = {"span_ns.unpack": _counter("span_ns.unpack"),
            "spans_dropped": _counter("spans_dropped")}


def read(trace):
    start, end = trace.counters["span_ns.unpack"]
    dropped = trace.counters["spans_dropped"]
    if not trace.requests or not end > start or dropped[0] != dropped[1]:
        return None
    return (end - start) / trace.requests / 1e6
