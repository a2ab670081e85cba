"""Host packing time a request: the program's ``pack`` spans
(``runtime/torch_exec.py``: an eventlist's rows turned into one chain
step's slot index lists, the base bitmaps packed from the current state,
and the chain's index lists stacked into packed ``(adds, dels)`` planes
with the transient step).

Read from the program's ``span_ns.pack`` counter (nanoseconds inside
its ``pack`` spans, which record while a profiler window does) at the
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


COUNTERS = {"span_ns.pack": _counter("span_ns.pack"),
            "spans_dropped": _counter("spans_dropped")}


def read(trace):
    start, end = trace.counters["span_ns.pack"]
    dropped = trace.counters["spans_dropped"]
    if not trace.requests or not end > start or dropped[0] != dropped[1]:
        return None
    return (end - start) / trace.requests / 1e6
