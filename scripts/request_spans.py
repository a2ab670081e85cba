"""One traced window of a benchmark cell, read through the program's own
spans (``repro_torch.obs``) on the profiler's clock.

    python3 scripts/request_spans.py --workload growing.point-analytics \\
        --seed 12345 --seconds 51 [--device cuda] [--out FILE.json]

Runs ``hgbench``'s traced run of the cell (``harness.run``, the same
window and per-layer metrics as ``hgbench/run.py --trace 1``), keeps the
profiler's events, and moves the program's span records onto the
profiler's clock with its ``trace_start_ns()``.  Prints, and writes to
``--out``:

* ``line``: the run's result line (per-layer metrics, breakdown, checks);
* ``split_ms``: each span name's time a request (its records' lengths
  over the window's requests), and the masks' share of ``readback`` and
  the planes' and weights' share of ``stage`` (the parts the benchmark's
  ``lower_ms`` covers), and ``pack`` by its work: ``pack.rows`` (an
  eventlist's rows into index lists), ``pack.base`` (the current
  state's base planes) and ``pack.planes`` (the chain's planes, or on the
  card the index lists concatenated for them);
* ``transfer``: the bytes copied each way a request (the program's
  ``h2d_bytes`` and ``d2h_bytes`` counters over the window) and the rate
  each direction's spans give them (``stage``, ``readback``; a
  ``readback`` holds the host's wait for the device as well, so its rate
  is what a request sees, not the link's);
* ``pack_indices_per_request``: the slot indices a request's planes were
  built from on the card (the program's ``pack_indices`` counter over the
  window);
* ``request_kinds``: the requests split by those indices (each request's
  ``launch.planes_from_indices`` span): ``large``, at least 1,000,000 (a
  chain holding one of the growing history's 1.12-1.26 M-index deltas),
  and ``small``; per kind the count, the mean indices, and the mean and
  median ms of the ``hgbench::request`` range, its ``retrieve`` span and
  its ``pack`` spans;
* ``coverage``: the share of each ``hgbench::request`` range that some
  program span covers (median, least);
* ``p50_ms``: the median ``hgbench::request`` length of the window;
* ``clock``: every ``delta_apply_fused`` kernel against its
  ``launch.delta_apply_fused`` span (the kernel must start after the
  span opened) and every device-to-host copy of a mask against its
  ``readback`` span (the copy must end before the span closed): the
  counts and the largest violation in microseconds (0: none); the
  kernel against its ``cudaLaunchKernel`` call, that call against the
  span, and the program's spans against the benchmark's own ranges
  around the same calls, to place a violation between two clocks;
* ``idle_gaps``: the ten longest stretches with nothing on the device,
  each labelled by the innermost program span open at its middle;
* ``span_cost_us``: one span's cost, no profiler (off) and inside a
  CPU profiler window (on), less the bare loop's cost.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from hgbench import catalog, harness, trace  # noqa: E402
from repro_torch import obs  # noqa: E402

MASK_COPY = "Memcpy DtoH"
LARGE = 1_000_000       # indices a request: one of growing's large deltas


def _union(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_cost_us(n: int = 100_000) -> dict:
    def loop(with_span: bool) -> float:
        t = time.perf_counter()
        if with_span:
            for _ in range(n):
                with obs.span("cost"):
                    pass
        else:
            for _ in range(n):
                pass
        return (time.perf_counter() - t) / n * 1e6

    bare = loop(False)
    off = loop(True) - bare
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = loop(True) - bare
    obs.clear()
    return {"off": off, "on": on, "bare_loop": bare, "n": n}


def _stats(xs) -> dict | None:
    if not xs:
        return None
    return {"n": len(xs), "min": min(xs), "median": statistics.median(xs),
            "max": max(xs)}


def _nested(ranges, spans) -> dict | None:
    """Each profiler range against the first program span that opens in
    it: (span open - range open, range close - span close) in us, and the
    first and last tenth's median open lead (a drift between the clocks
    shows there)."""
    spans = sorted(spans, key=lambda r: r.start)
    pairs, j = [], 0
    for a, b in sorted(ranges):
        while j < len(spans) and spans[j].start < a - 2_000_000:
            j += 1
        if j < len(spans) and spans[j].start <= b:
            pairs.append(((spans[j].start - a) / 1e3,
                          (b - spans[j].end) / 1e3))
            j += 1
    if not pairs:
        return None
    tenth = max(1, len(pairs) // 10)
    return {"open": _stats([p[0] for p in pairs]),
            "close": _stats([p[1] for p in pairs]),
            "open_first_tenth": statistics.median(p[0] for p in
                                                  pairs[:tenth]),
            "open_last_tenth": statistics.median(p[0] for p in
                                                 pairs[-tenth:])}


def _mean_median(xs) -> dict | None:
    if not xs:
        return None
    return {"mean": statistics.fmean(xs), "median": statistics.median(xs)}


def request_kinds(recs, host) -> dict | None:
    """Requests split by the indices their planes were built from (see the
    module's ``request_kinds``); None where no request built them on the
    card."""
    indices = {r.rid: r.work.get("indices", 0) for r in recs
               if r.name == "launch.planes_from_indices"}
    if not indices:
        return None
    roots = sorted((r for r in recs if r.name == "retrieve"),
                   key=lambda r: r.start)
    pack: dict[int, float] = {}
    for r in recs:
        if r.name == "pack":
            pack[r.rid] = pack.get(r.rid, 0.0) + (r.end - r.start) / 1e6
    latency, j = {}, 0
    for a, b in sorted(host):
        while j < len(roots) and roots[j].start < a - 2_000_000:
            j += 1
        if j < len(roots) and roots[j].start <= b:
            latency[roots[j].rid] = (b - a) / 1e6
            j += 1
    out = {}
    for kind, large in (("large", True), ("small", False)):
        rs = [r for r in roots if (indices.get(r.rid, 0) >= LARGE) == large]
        out[kind] = {
            "requests": len(rs),
            "indices_mean": (statistics.fmean(indices.get(r.rid, 0)
                                              for r in rs) if rs else None),
            "request_ms": _mean_median([latency[r.rid] for r in rs
                                        if r.rid in latency]),
            "retrieve_ms": _mean_median([(r.end - r.start) / 1e6
                                         for r in rs]),
            "pack_ms": _mean_median([pack.get(r.rid, 0.0) for r in rs])}
    return out


def _innermost(spans, t):
    best = None
    for s in spans:
        if s.start <= t <= s.end and (best is None
                                      or s.end - s.start
                                      < best.end - best.start):
            best = s
    return best.name if best is not None else "client"


def analyse(prof, recs, tr, window: tuple[dict, dict]) -> dict:
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges: dict[str, list] = {}
    device = []
    for e in prof.events():
        a = t0 + int(e.time_range.start * 1000)
        b = t0 + int(e.time_range.end * 1000)
        if e.name.startswith(trace.PREFIX):
            if e.device_type == DeviceType.CPU:
                ranges.setdefault(e.name[len(trace.PREFIX):], []).append(
                    (a, b))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, a, b))
    host = ranges.get(trace.REQUEST, [])
    host.sort()
    device.sort(key=lambda d: d[1])
    n = max(tr.requests, 1)
    dropped = tr.counters.get("spans_dropped", (0, 0))
    out: dict = {"requests": tr.requests, "records": len(recs),
                 "spans_dropped": dropped[1] - dropped[0]}

    spent: dict[str, float] = {}
    for r in recs:
        spent[r.name] = spent.get(r.name, 0.0) + (r.end - r.start) / n / 1e6
    by_sid = {r.sid: r for r in recs}
    under_retrieve = [r for r in recs
                      if r.parent and by_sid.get(r.parent) is not None
                      and by_sid[r.parent].name == "retrieve"]
    spent["readback.masks"] = sum(r.end - r.start for r in under_retrieve
                                  if r.name == "readback") / n / 1e6
    spent["stage.planes_weights"] = sum(
        r.end - r.start for r in under_retrieve if r.name == "stage") / n / 1e6
    for r in recs:
        if r.name == "pack":
            part = ("pack.rows" if "rows" in r.work else "pack.planes"
                    if by_sid.get(r.parent) is not None
                    and by_sid[r.parent].name == "retrieve" else "pack.base")
            spent[part] = spent.get(part, 0.0) + (r.end - r.start) / n / 1e6
    out["split_ms"] = dict(sorted(spent.items(), key=lambda kv: -kv[1]))

    out["transfer"] = {}
    for way, name in (("h2d", "stage"), ("d2h", "readback")):
        moved = (window[1].get(f"{way}_bytes", 0)
                 - window[0].get(f"{way}_bytes", 0)) / n
        ms = spent.get(name, 0.0)
        out["transfer"][f"{way}_bytes_per_request"] = moved
        out["transfer"][f"{name}_GB_per_s"] = (
            moved / ms / 1e6 if ms and moved else None)

    cover = []
    for a, b in host:
        inside = [(max(r.start, a), min(r.end, b)) for r in recs
                  if r.end > a and r.start < b]
        cover.append(_union(inside) / (b - a) if b > a else 0.0)
    out["pack_indices_per_request"] = (
        window[1].get("pack_indices", 0)
        - window[0].get("pack_indices", 0)) / n
    out["request_kinds"] = request_kinds(recs, host)
    out["coverage"] = ({"median": statistics.median(cover),
                        "least": min(cover)} if cover else None)
    out["p50_ms"] = (statistics.median((b - a) / 1e6 for a, b in host)
                     if host else None)

    launches = sorted((r for r in recs
                       if r.name == "launch.delta_apply_fused"),
                      key=lambda r: r.start)
    kernels = [d for d in device if "delta_apply_fused_kernel" in d[0]]
    lead = []                   # kernel start - its launch span's opening
    for ker in kernels:
        opened = [r for r in launches if r.start <= ker[1] + 1_000_000]
        if opened:
            lead.append((ker[1] - opened[-1].start) / 1e3)
    copies = [d for d in device if d[0].startswith(MASK_COPY)]
    masks = sorted((r for r in under_retrieve if r.name == "readback"),
                   key=lambda r: r.start)
    lag = []                    # readback span's close - its copy's end
    for r in masks:
        near = [c for c in copies if r.start - 1_000_000 <= c[1] <= r.end
                + 1_000_000]
        if near:
            c = min(near, key=lambda c: abs(c[1] - r.start))
            lag.append((r.end - c[2]) / 1e3)
    # each kernel against the host call that launched it, both stamped by
    # the profiler (joined by correlation id), and that call against the
    # program's span: where a kernel seems to start before its span
    # opened, this says which of the two clocks the gap lies between
    calls = {e.correlation_id(): e.start_ns()
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("cudaLaunchKernel")}
    after_call, call_after_open = [], []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA
                or "delta_apply_fused_kernel" not in e.name()
                or e.correlation_id() not in calls):
            continue
        c = calls[e.correlation_id()]
        after_call.append((e.start_ns() - c) / 1e3)
        opened = [r for r in launches if r.start <= c <= r.end]
        if opened:
            call_after_open.append((c - opened[-1].start) / 1e3)
    out["clock"] = {
        "fused_kernels": len(kernels), "launch_spans": len(launches),
        "kernel_after_launch_call_us": _stats(after_call),
        "launch_call_after_span_open_us": _stats(call_after_open),
        "kernel_after_span_open_us": _stats(lead),
        "kernel_before_span_us": max([0.0] + [-x for x in lead]),
        "mask_readbacks": len(masks), "matched_copies": len(lag),
        "copy_before_span_close_us": _stats(lag),
        "copy_after_span_us": max([0.0] + [-x for x in lag]),
        # the program's span inside the benchmark's own range around the
        # same call, both on the profiler's clock: (span open - range
        # open, range close - span close), negative where they disagree
        "nested_in_range_us": {
            f"{outer}/{inner}": _nested(ranges.get(outer, []),
                                        [r for r in recs if r.name == inner])
            for outer, inner in (("request", "retrieve"), ("plan", "plan"),
                                 ("launch.delta_apply_fused",
                                  "launch.delta_apply_fused"),
                                 ("bucket_edges", "bucket"))}}

    roots = sorted((r for r in recs if r.name == "retrieve"),
                   key=lambda r: r.start)
    if roots:
        mid = roots[len(roots) // 2]
        name_of = {r.sid: r.name for r in recs}
        out["one_request"] = [
            [r.name, name_of.get(r.parent, ""), (r.start - mid.start) / 1e6,
             (r.end - r.start) / 1e6, r.work]
            for r in sorted(recs, key=lambda r: r.start) if r.rid == mid.rid]

    t = host[0][0] if host else 0
    end = host[-1][1] if host else 0
    gaps = []
    for _, a, b in device:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    out["idle_gaps"] = [[_innermost(recs, (a + b) // 2), (b - a) / 1e9]
                        for a, b in gaps]
    return out


def run(cell, seed: int, seconds: float, device: str) -> dict:
    kept: dict = {}
    collect, read_counters = trace.collect, trace.read_counters
    window: list[dict] = []     # the program's counters at each end

    def read_and_keep(metrics, ctx):
        window.append(obs.counters())
        return read_counters(metrics, ctx)

    def keep(prof, calls, counters):
        kept.update(prof=prof, records=obs.records())
        tr = collect(prof, calls, counters)
        kept["trace"] = tr
        return tr

    trace.collect, trace.read_counters = keep, read_and_keep
    obs.clear()
    try:
        res = harness.run(cell, seed=seed, seconds=seconds, traced=True,
                          device=device)
    finally:
        trace.collect, trace.read_counters = collect, read_counters
    out = {"seed": seed, "correct": res.correct, "device": res.device,
           "line": res.line()}
    out.update(analyse(kept["prof"], kept["records"], kept["trace"],
                       (window[0], window[-1])))
    out["span_cost_us"] = span_cost_us()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = catalog.Benchmark(ROOT).cell(args.workload)
    out = {"workload": args.workload,
           **run(cell, args.seed, args.seconds, args.device)}
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
