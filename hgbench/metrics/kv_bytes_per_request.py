"""Payload bytes read from the index's store a request: the store's own
``KVStats.bytes_read`` over the traced window, over its requests."""

SOURCE = "program_counter"
COUNTERS = {"kv_bytes_read": lambda ctx: ctx.store.stats.bytes_read}


def read(trace):
    start, end = trace.counters["kv_bytes_read"]
    if not trace.requests:
        return None
    return (end - start) / trace.requests
