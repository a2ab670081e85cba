"""Host bucketing time a request: ``kernels/segment_sum/ops.py::
bucket_edges``, which sorts every edge slot by node before each segment
sum of ``degrees()`` (twice a request)."""

SOURCE = "program_span"
WRAPS = (("repro_torch.kernels.segment_sum.ops", "bucket_edges",
          "bucket_edges"),)


def read(trace):
    if not trace.requests or not trace.spans.get("bucket_edges"):
        return None
    return trace.span_s("bucket_edges") / trace.requests * 1e3
