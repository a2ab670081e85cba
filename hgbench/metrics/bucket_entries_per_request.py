"""Padded entries of ``segment_sum``'s bucket arrays built a request: the
program's ``bucket_entries`` counter (``kernels/segment_sum/ops.py::
bucket_edges`` adds NB x ME, buckets times the largest bucket, a call).

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


COUNTERS = {"bucket_entries": _counter("bucket_entries"),
            "spans_dropped": _counter("spans_dropped")}


def read(trace):
    start, end = trace.counters["bucket_entries"]
    dropped = trace.counters["spans_dropped"]
    if not trace.requests or not end > start or dropped[0] != dropped[1]:
        return None
    return (end - start) / trace.requests
