"""Planner time a request: ``DeltaGraph.plan_singlepoint`` (Dijkstra over
the skeleton), host seconds in its spans over the traced window, over the
requests completed in it."""

SOURCE = "program_span"
WRAPS = (("repro_torch.core.deltagraph", "DeltaGraph.plan_singlepoint",
          "plan"),)


def read(trace):
    if not trace.requests or not trace.spans.get("plan"):
        return None
    return trace.span_s("plan") / trace.requests * 1e3
