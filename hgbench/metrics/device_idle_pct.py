"""The share of the traced window in which no operation runs on the
device (kernels, copies and fills from the profiler's trace, overlaps
counted once)."""

SOURCE = "device_trace"


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
