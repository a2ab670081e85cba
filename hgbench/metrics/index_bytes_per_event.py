"""The index's size at rest a history event: ``KVStore.total_bytes()`` of
the manager's store after the build, over the events handed to it.  The
paper's trade of space against retrieval time: a change that buys speed
with a fatter index raises it, and the bigger index takes longer to build
and write, which is why it moves ``setup_s``."""

SOURCE = "program_counter"
COUNTERS = {"index_bytes": lambda ctx: ctx.store.total_bytes(),
            "history_events": lambda ctx: len(ctx.events)}


def read(trace):
    _, size = trace.counters["index_bytes"]
    _, events = trace.counters["history_events"]
    return size / events if events else None
