"""One run of one cell: set-up, warm-up, the measured window, the traced
window's reading, and the comparison with the reference.

Set-up (all of it in ``setup_s``): the two retrieval sources built by
``nvcc`` where not yet built, the history generated from the seed, handed
to the program's builder and indexed, the driver's state, one warm-up
request.  The window is a closed loop with one client: the next request
goes out when the last one's results are on the host, until ``seconds``
have passed; the request that crosses the end finishes and counts.  After
the window the device's peak is read, the program's index is closed, and
every kept answer is compared with the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
import time
import traceback
from types import ModuleType

import numpy as np
import torch

from . import history, program, trace, traffic
from .catalog import Cell
from .reference import Replay

RETRIEVAL_SOURCES = ("delta_apply", "segment_sum")


@dataclasses.dataclass
class Context:
    """What the drivers and counters see of a run."""
    seed: int
    device: torch.device
    config: dict
    traffic: dict
    sampler: ModuleType
    hist: history.History
    universe: object
    events: object
    gm: object

    @property
    def dg(self):
        return self.gm.dg

    @property
    def store(self):
        return self.gm.store


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: list[tuple[str, float, float]]
    breakdown: dict | None = None
    build_s: dict | None = None
    setup_parts: dict | None = None

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = {n: {"value": v, "limit": lim}
                         for n, v, lim in self.checks}
        return out

    def check_lines(self) -> list[str]:
        return [f"check {n}: {v!r} (limit {lim!r})"
                for n, v, lim in self.checks]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p95(values: list[float]) -> float:
    """The 95th percentile of all values (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(values), 95))


E2E = {
    "snapshots_per_s": lambda w: w["snapshots"] / w["window_s"],
    "query_p50_ms": lambda w: statistics.median(w["latency_s"]) * 1e3,
    "query_p95_ms": lambda w: p95(w["latency_s"]) * 1e3,
    "setup_s": lambda w: w["setup_s"],
}


def setup(cell: Cell, seed: int, dev: torch.device, parts: dict) -> Context:
    """The history, the program's structures and its index; the seconds of
    each step go into ``parts``."""
    t = time.perf_counter()
    hist = cell.generator.generate(cell.config["history"], seed)
    parts["generate"], t = time.perf_counter() - t, time.perf_counter()
    universe, events = program.to_program(hist)
    parts["builder"], t = time.perf_counter() - t, time.perf_counter()
    gm = program.build_manager(cell.config, universe, events, dev)
    parts["index"] = time.perf_counter() - t
    return Context(seed, dev, cell.config, cell.traffic, cell.sampler, hist,
                   universe, events, gm)


def window(ctx: Context, driver, state, seconds: float, *, traced=False):
    """The closed loop: ``(latencies, snapshots, attempted, failed,
    window seconds)``."""
    span = (lambda: torch.profiler.record_function(
        trace.PREFIX + trace.REQUEST)) if traced else contextlib.nullcontext
    gen = traffic.requests(ctx.sampler, ctx.traffic, int(ctx.hist.time.max()),
                           ctx.seed)
    lat: list[float] = []
    snapshots = attempted = failed = 0
    start = time.perf_counter()
    while True:
        times = next(gen)
        a = time.perf_counter()
        answer = None
        try:
            with span():
                answer, n = driver.call(ctx, state, times)
                _sync(ctx.device)
        except Exception:                      # counted, reported, not hidden
            if not failed:
                traceback.print_exc()
            failed += 1
        b = time.perf_counter()
        if answer is not None:
            lat.append(b - a)
            snapshots += n
            driver.after(ctx, state, attempted, times, answer)
        attempted += 1
        if b - start >= seconds:
            return lat, snapshots, attempted, failed, b - start


def run(cell: Cell, *, seed: int, seconds: float, traced: bool,
        device="cuda", t0: float | None = None) -> Result:
    """One run of ``cell``; ``t0`` is the process's start on the same
    clock (``time.perf_counter``)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    build_s = None
    parts = {"start": time.perf_counter() - t0}
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        t = time.perf_counter()
        build_s = _build.build(RETRIEVAL_SOURCES)
        torch.cuda.reset_peak_memory_stats(dev)
        parts["build"] = time.perf_counter() - t
    ctx = setup(cell, seed, dev, parts)
    t = time.perf_counter()
    driver = cell.driver
    state = driver.prepare(ctx)
    warm = next(traffic.requests(ctx.sampler, ctx.traffic,
                                 int(ctx.hist.time.max()), seed,
                                 traffic.WARMUP))
    answer, _ = driver.call(ctx, state, warm)
    _sync(dev)
    driver.after(ctx, state, -1, warm, answer)
    parts["warm_up"] = time.perf_counter() - t

    metrics = [m for _, m in cell.per_layer] if traced else []
    wraps = trace.Wraps()
    prof = None
    if traced:
        trace.install(metrics, wraps)
        before = trace.read_counters(metrics, ctx)
        prof = trace.profiler(dev)
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    try:
        lat, snapshots, attempted, failed, window_s = window(
            ctx, driver, state, seconds, traced=traced)
    finally:
        if traced:
            prof.__exit__(None, None, None)
            wraps.restore()
    tr = None
    if traced:
        after = trace.read_counters(metrics, ctx)
        tr = trace.collect(prof, wraps.calls,
                           {k: (before[k], after[k]) for k in before})
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.gm.close()

    checks = driver.check(ctx, state, Replay(ctx.hist))
    correct = (failed == 0 and bool(lat)
               and all(v <= lim for _, v, lim in checks))
    out: dict = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if traced:
        for spec, module in cell.per_layer:
            v = module.read(tr)
            if v is not None:
                out[spec["name"]] = {"value": v, "unit": spec["unit"]}
    elif lat:
        w = {"snapshots": snapshots, "window_s": window_s,
             "latency_s": lat, "setup_s": setup_s}
        for name, unit in units.items():
            out[name] = {"value": E2E[name](w), "unit": unit}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
    return Result(correct, attempted, failed, out, dev_info, checks,
                  breakdown=trace.breakdown(tr) if traced else None,
                  build_s=build_s, setup_parts=parts)


def banned_modules(names=("jax", "jaxlib", "flax", "repro")) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``names``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in names})
