"""Snapshot server, in torch: serve batched historical-snapshot queries
arriving as declarative GraphQuery documents (the wire protocol) —
co-batched documents merge into one multipoint (Steiner) plan, results
land in the GraphPool overlay, with p50/p99 latency reporting and
straggler-aware fetch.  The same loop `serve.py --mode query` runs over
stdin.  The port of ``examples/snapshot_server.py``; it prints the same
lines but for the latency and qps figures.

Run:  PYTHONPATH=src python examples/pt_snapshot_server.py [--requests 200]
          [--device cpu]

``--device`` defaults to the card, which must be present; it is the
``GraphManager``'s (its temporal engine's) device.  Retrieval through the
query service runs on the host, as in the reference.  The request loop
and the fetch schedule are functions that take a ``GraphManager``, so
that another history can be served the same way.
"""
import argparse
import json
import time

import numpy as np

from repro_torch.api import GraphQuery
from repro_torch.core import GraphManager
from repro_torch.core.planir import Fetch
from repro_torch.core.query import NO_ATTRS
from repro_torch.data.generators import churn_network
from repro_torch.kernels.policy import resolve_device
from repro_torch.runtime.fault import FetchTask, StragglerMitigator


def build_history(device="cuda"):
    """The example's churn history and its partitioned ``GraphManager``;
    returns ``(gm, tmax)``."""
    uni, ev = churn_network(n_initial_edges=800, n_events=10_000, seed=9)
    gm = GraphManager(uni, ev, L=500, k=4, diff_fn="balanced",
                      num_partitions=4, device=device)
    return gm, int(ev.time[-1])


def serve(gm: GraphManager, tmax: int, requests: int, batch: int,
          seed: int = 0, on_batch=None) -> dict:
    """The simulated request stream: each client sends one snapshot
    *document* (recency-biased query times, g(t) §5.1); concurrent
    documents are co-batched by the service into ONE merged Steiner plan
    per group, landed in the pool, then released.  ``on_batch(times,
    results)`` sees each batch before its release.  Returns ``served``,
    ``wall_s``, ``kv_gets`` and the per-query latencies ``lat_ms``."""
    rng = np.random.default_rng(seed)
    svc = gm.query
    lat = []
    served = kv_gets = 0
    t_start = time.time()
    while served < requests:
        times = [int(tmax * (1 - rng.beta(1, 4))) for _ in range(batch)]
        wire = [json.dumps({"kind": "snapshot", "t": t}) for t in times]
        t0 = time.perf_counter()
        results = svc.run_batch([GraphQuery.from_json(s) for s in wire])
        gids = [gm.pool.insert_snapshot(r.value) for r in results]
        lat.append((time.perf_counter() - t0) / len(wire))
        kv_gets += results[0].stats["kv_gets"]
        if on_batch is not None:
            on_batch(times, results)
        for g in gids:   # client done → release + lazy clean
            gm.pool.release(g)
        gm.pool.cleaner()
        served += len(wire)
    return {"served": served, "wall_s": time.time() - t_start,
            "kv_gets": kv_gets, "lat_ms": np.asarray(lat) * 1000}


def report(gm: GraphManager, stats: dict, log=print) -> None:
    served, wall, lat_ms = stats["served"], stats["wall_s"], stats["lat_ms"]
    log(f"served {served} snapshot documents in {wall:.2f}s "
        f"({served/wall:.0f} qps, {stats['kv_gets']} KV gets)")
    log(f"per-query latency: p50={np.percentile(lat_ms,50):.2f}ms "
        f"p95={np.percentile(lat_ms,95):.2f}ms "
        f"p99={np.percentile(lat_ms,99):.2f}ms")
    log(f"pool holds {gm.pool.num_active()-1} graphs, "
        f"{gm.pool.memory_bytes()/1e6:.1f} MB")


def straggler_schedule(gm: GraphManager, tmax: int) -> tuple[int, int]:
    """The straggler-aware fetch schedule over the partitioned store for a
    16-point multipoint plan; the plan IR carries exactly one Fetch node
    per payload, so the task set is duplicate-free by construction.
    Returns ``(fetches, hedged)``."""
    plan = gm.dg.plan_multipoint([int(t) for t in
                                  np.linspace(0, tmax, 16)], NO_ATTRS)
    tasks = [FetchTask(p, (p, n.op.pid, "struct"), 1000)
             for n in plan.nodes if isinstance(n.op, Fetch)
             for p in range(gm.dg.P)]
    sm = StragglerMitigator(tasks, hedge_frac=0.1)
    n = 0
    while not sm.finished():
        t = sm.assign()
        if t is None:
            break
        sm.complete(t.key)
        n += 1
    return n, sm.duplicates


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--materialize", action="store_true",
                    help="fixed-depth §4.5 pinning (the manual policy)")
    ap.add_argument("--advise", action="store_true",
                    help="workload-aware advisor + budget (core/materialize)")
    ap.add_argument("--budget-mb", type=float, default=16.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a card must be present) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    print("building index ...")
    gm, tmax = build_history(dev)
    try:
        if args.materialize:
            gm.materialize_roots(depth=2)
        if args.advise:
            advice = gm.enable_advisor(
                budget_bytes=int(args.budget_mb * 2**20))
            print(f"advisor pinned {len(advice.chosen)} nodes, "
                  f"expected plan-byte saving "
                  f"{advice.expected_saved_bytes:.0f}")
        report(gm, serve(gm, tmax, args.requests, args.batch))
        n, hedged = straggler_schedule(gm, tmax)
        print(f"straggler scheduler: {n} fetches, {hedged} hedged")
    finally:
        gm.close()


if __name__ == "__main__":
    main()
