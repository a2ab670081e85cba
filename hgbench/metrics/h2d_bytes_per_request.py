"""Bytes copied from the host to the card a request: the program's
``h2d_bytes`` counter (``transfer.to_device``; a copy to the CPU is no
copy and counts nothing, so a CPU run reads nothing).

Read at the traced window's start and end, over the window's requests.
Nothing where the program keeps no such counter, where it did not move,
or where its span buffer overflowed (``spans_dropped`` moved)."""

SOURCE = "program_counter"


def _counter(name):
    def value(ctx):
        try:
            from repro_torch import obs
        except ImportError:         # a program that keeps no such counters
            return float("nan")
        return obs.counters().get(name, 0)
    return value


COUNTERS = {"h2d_bytes": _counter("h2d_bytes"),
            "spans_dropped": _counter("spans_dropped")}


def read(trace):
    start, end = trace.counters["h2d_bytes"]
    dropped = trace.counters["spans_dropped"]
    if not trace.requests or not end > start or dropped[0] != dropped[1]:
        return None
    return (end - start) / trace.requests
