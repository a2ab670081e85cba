"""Host-to-device copy time a request: the program's ``stage`` spans
(``transfer.to_device``, the one copy of planes, weights and
``segment_sum``'s bucket arrays to a CUDA device; a CPU run makes none).

Read from the program's ``span_ns.stage`` counter (nanoseconds inside
its ``stage`` spans, which record while a profiler window does) at the
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


COUNTERS = {"span_ns.stage": _counter("span_ns.stage"),
            "spans_dropped": _counter("spans_dropped")}


def read(trace):
    start, end = trace.counters["span_ns.stage"]
    dropped = trace.counters["spans_dropped"]
    if not trace.requests or not end > start or dropped[0] != dropped[1]:
        return None
    return (end - start) / trace.requests / 1e6
