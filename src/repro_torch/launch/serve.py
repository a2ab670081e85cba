"""Serving in the port: LM prefill + greedy decode, evolutionary queries,
and the snapshot-retrieval front ends.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode model \\
        --arch gemma3-1b --reduced --device cpu     # reduced width, host
    PYTHONPATH=src python -m repro_torch.launch.serve --mode model \\
        --arch gemma3-1b --batch 8 --prompt 4096 --gen 32   # full, card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode evolve \\
        --events 20000 --intervals 8 --points 32 --op pagerank   # card
    echo '{"kind": "multipoint", "times": [50, 150]}' | \\
        PYTHONPATH=src python -m repro_torch.launch.serve --mode query \\
        --events 2000 --shard-procs 2 --replicas 2 --device cpu

``--mode model`` is the counterpart of ``repro/launch/serve.py::serve_lm``
for the five LM architectures (dense GQA, deepseek-v3's MLA + MoE,
arctic's dense ∥ MoE).  Weights are random, from a seeded
``torch.Generator``; the prompt is ``numpy.random.default_rng(seed)``
token ids.  The reference always runs the reduced config on its host;
here ``reduced=True`` selects it, and the card runs the full width (the
two MoE models at a depth one card holds: ``load_lm(cfg=...)``).

``--mode evolve`` is the counterpart of ``serve_evolve``: dense
evolutionary-query windows through the incremental temporal engine and
the per-snapshot recompute loop, with the fixpoint operators on
``--device``.

The retrieval front ends are the reference's, and every
``GraphManager`` they build takes ``--device``:

* ``--mode snapshots`` — recency-skewed snapshot traffic, cold against
  the materialization advisor and snapshot cache;
* ``--mode query`` — NDJSON :class:`~repro_torch.api.document.GraphQuery`
  documents in (stdin or ``--input``), JSON envelopes out, optionally
  through ``--shards`` in-thread shard workers or ``--shard-procs``
  ``repro_torch.launch.shardd`` processes with ``--replicas`` each;
* ``--mode server`` — the concurrent socket front end
  (:mod:`repro_torch.launch.server`): co-batching inside ``--window-ms``,
  admission control (``--admit-ms``), lease budgets (``--session-mb``);
* ``--mode ingest`` — a writer streaming events through the threaded
  ingest pipeline while readers query epoch-pinned views; the last line
  is ``INGEST_SUMMARY <json>``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_arch, reduced_config
from ..kernels.policy import resolve_device
from ..models.common import init_params
from ..models.transformer import model as tm


def load_lm(arch: str, *, reduced: bool = False, device="cuda",
            seed: int = 0, cfg=None):
    """``(config, params)``: the architecture at full width (or its
    reduced config), or ``cfg`` where given (a cut depth), with random
    weights on ``device``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = reduced_config(arch) if reduced else get_arch(arch)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return cfg, init_params(tm.param_defs(cfg), gen, dev)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """``[batch, prompt_len]`` token ids from ``default_rng(seed)``, on the
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, (batch, prompt_len))
    return torch.from_numpy(ids).to(dev)


def generate(params, cfg, tokens: torch.Tensor, gen: int) -> dict:
    """Prefill ``tokens`` into a cache of ``prompt_len + gen`` and decode
    ``gen`` greedy steps.  Returns the prefill's last-position logits, the
    generated ids ``[B, gen]`` and the host-clock times (each ending in a
    device synchronise on the card)."""
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    B, S = tokens.shape
    sync()
    t0 = time.perf_counter()
    last, cache = tm.prefill_step(params, tokens, cfg, max_len=S + gen)
    sync()
    prefill_s = time.perf_counter() - t0
    tok = last.argmax(-1, keepdim=True)
    out = []
    t0 = time.perf_counter()
    for i in range(gen):
        logits, cache = tm.decode_step(params, cache, tok, S + i, cfg)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    return {"prefill_logits": last,
            "tokens": (torch.cat(out, 1) if out else
                       tokens.new_zeros((B, 0))).cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s}


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """A copy of ``params`` with every tensor cast to ``dtype``."""
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) else
                cast_params(v, dtype)) for k, v in params.items()}


def tail_drift(params, cfg, tokens: torch.Tensor, tail: int = 16
               ) -> tuple[torch.Tensor, float]:
    """Prefill and decode against each other: a prefill of all but the
    last ``tail`` prompt tokens, then ``tail`` decode steps fed those
    tokens, against a prefill of the whole prompt.  Returns the whole
    prefill's last logits (f32) and max |Δlogit| / max |logit| (NaN if
    either side is not finite)."""
    S = tokens.shape[1]
    whole, _ = tm.prefill_step(params, tokens, cfg)
    _, cache = tm.prefill_step(params, tokens[:, :S - tail], cfg, max_len=S)
    for i in range(S - tail, S):
        last, cache = tm.decode_step(params, cache, tokens[:, i:i + 1], i,
                                     cfg)
    whole = whole.float()
    return whole, float((last.float() - whole).abs().max() /
                        whole.abs().max())


def serve_snapshots(n_events: int, budget_mb: float, queries: int,
                    zipf: float, seed: int = 0, batch: int = 1,
                    codec: str = "v2", kv: str = "mem",
                    kv_dir: str | None = None,
                    hot_mb: float = 8.0, device="cuda") -> None:
    """Drive a recency-skewed snapshot workload and report cold vs advised
    latency plus cache hit rate — the quickstart for the advisor.

    ``batch > 1`` groups concurrent queries into ``get_snapshots`` calls:
    one merged multipoint plan per group (shared prefixes fetch and apply
    once) executed with async KV prefetch — the serving configuration for
    a query *stream* rather than a query at a time.

    ``codec`` picks the payload wire format (``v2`` compressed+checksummed
    or legacy ``raw``); ``kv`` picks the store tier (``mem`` | ``logfile``
    | ``tiered`` = ``hot_mb`` in-memory blob cache over a log file under
    ``kv_dir``) — the storage-config quickstart in the README."""
    import os as _os

    from ..core import GraphManager
    from ..data.generators import churn_network
    from ..storage import codec as codec_mod
    from ..storage.kv import TieredKV, make_store

    codec_mod.set_default_codec(codec)
    uni, ev = churn_network(n_initial_edges=max(n_events // 12, 50),
                            n_events=n_events, seed=seed)
    tmax = int(ev.time[-1])
    rng = np.random.default_rng(seed)
    # zipf-ish recency skew over a modest set of distinct timepoints, the
    # shape real snapshot traffic has (hot recent dashboards + long tail)
    distinct = np.sort(rng.integers(0, tmax + 1, 256))
    ranks = rng.zipf(zipf, queries) if zipf > 1 else rng.integers(
        1, distinct.size, queries)
    ts = distinct[distinct.size - 1 - np.minimum(ranks, distinct.size - 1)]

    # explicitly-passed stores are not owned by the manager — close them
    # here so disk-backed tiers flush their log tail + index durably
    made_stores = []

    def _store(tag: str):
        if kv == "mem":
            s = make_store("mem")
        else:
            d = _os.path.join(kv_dir, tag) if kv_dir else None
            s = make_store(kv, directory=d, hot_bytes=int(hot_mb * 2**20))
        made_stores.append(s)
        return s

    with GraphManager(uni, ev, store=_store("cold"),
                      L=max(n_events // 40, 64), k=2,
                      diff_fn="intersection", cache_bytes=0,
                      device=device) as cold:
        t0 = time.perf_counter()
        for t in ts:
            cold.dg.get_snapshot(int(t), pool=cold.pool)
        cold_s = time.perf_counter() - t0

    gm = GraphManager(uni, ev, store=_store("advised"),
                      L=max(n_events // 40, 64), k=2,
                      diff_fn="intersection", device=device)
    advice = gm.enable_advisor(budget_bytes=int(budget_mb * 2**20),
                               replan_every=max(queries // 8, 32))
    t0 = time.perf_counter()
    if batch > 1:
        for i in range(0, len(ts), batch):
            gm.get_snapshots([int(t) for t in ts[i:i + batch]])
    else:
        for t in ts:
            gm.get_snapshot(int(t))
    adv_s = time.perf_counter() - t0

    q = len(ts)
    print(f"cold    : {cold_s / q * 1e6:8.1f} us/q  ({q / cold_s:8.0f} q/s)")
    print(f"advised : {adv_s / q * 1e6:8.1f} us/q  ({q / adv_s:8.0f} q/s)  "
          f"speedup x{cold_s / adv_s:.2f}")
    print(f"pins={len(gm.advisor.pinned)} "
          f"pool={gm.pool.memory_bytes() / 2**20:.2f} MiB "
          f"(budget {budget_mb} MiB)  "
          f"cache hits={gm.cache.hits}/{gm.cache.hits + gm.cache.misses} "
          f"({gm.cache.nbytes() / 2**20:.2f} MiB)")
    if advice is not None:
        print(f"warm-start expected saving: {advice.expected_saved_bytes:.0f}"
              f" / {advice.expected_cold_bytes:.0f} plan-cost units")
    sk = gm.dg.skeleton_stats()
    print(f"store   : codec={codec} kv={kv} "
          f"stored={sk['stored_total_bytes'] / 2**20:.2f} MiB "
          f"logical={sk['total_bytes'] / 2**20:.2f} MiB "
          f"(x{sk['compression_ratio']:.2f})")
    st = gm.store.stats
    if isinstance(gm.store, TieredKV):
        print(f"tier    : hot {gm.store.hot_bytes_used() / 2**20:.2f}"
              f"/{gm.store.hot_bytes / 2**20:.2f} MiB  "
              f"hits={st.hot_hits} misses={st.hot_misses} "
              f"evictions={gm.store.evictions} "
              f"cold gets={gm.store.cold.stats.gets}")
    print(f"kv      : {st.gets} gets, {st.bytes_read / 2**20:.2f} MiB read")
    gm.close()
    for s in made_stores:
        s.close()


def run_query_documents(gm, lines: Iterable[str], batch: int = 8,
                        scheduler=None) -> Iterator[str]:
    """The stdin wire loop: parse each NDJSON line into a GraphQuery,
    execute groups of up to ``batch`` documents as one scheduler wave
    (co-plannable documents share one merged Steiner plan), and yield one
    JSON envelope per input line, in input order.  A malformed line
    yields an error envelope; it never poisons its batch.

    This is the same :class:`~repro_torch.launch.server.SessionCore` code path
    the socket server (``--mode server``) drives per connection — one
    parse / control / lease / envelope implementation for both
    transports.  Pass ``scheduler`` to share a live server's scheduler;
    by default a private synchronous one is created and closed here."""
    from ..api.scheduler import BatchingScheduler
    from .server import SessionCore, run_session_lines

    sched = scheduler or BatchingScheduler(gm.query, window_ms=0.0,
                                           workers=1)
    core = SessionCore(gm, sched)
    try:
        yield from run_session_lines(core, lines, batch=batch)
    finally:
        core.release_all()
        if scheduler is None:
            sched.close()


def _build_query_gm(n_events: int, seed: int, codec: str, kv: str,
                    kv_dir: str | None, hot_mb: float, budget_mb: float,
                    shards: int, shard_procs: int = 0, replicas: int = 1,
                    device="cuda"):
    """Shared GraphManager construction for the query / server front
    ends: synthetic churn history, optional disk-backed store tier,
    advisor budget and shard workers.  ``shard_procs > 0`` serves
    retrievals through that many ``launch/shardd`` OS processes (the
    replicated RPC transport) instead of the in-thread pool; partitions
    then default to ``4 × shard_procs`` for balance unless ``--shards``
    pins a count."""
    import os as _os

    from ..core import GraphManager
    from ..data.generators import churn_network
    from ..storage import codec as codec_mod
    from ..storage.kv import make_store

    codec_mod.set_default_codec(codec)
    uni, ev = churn_network(n_initial_edges=max(n_events // 12, 50),
                            n_events=n_events, seed=seed)
    store = None
    if kv != "mem":
        d = _os.path.join(kv_dir, "query") if kv_dir else None
        store = make_store(kv, directory=d, hot_bytes=int(hot_mb * 2**20))
    P = shards if shards > 1 else (4 * shard_procs if shard_procs > 0 else 1)
    part_kw = {}
    if P > 1:
        part_kw = dict(num_partitions=P, partition_fn="mod_hash")
    gm = GraphManager(uni, ev, store=store,
                      L=max(n_events // 40, 64), k=2,
                      diff_fn="intersection", device=device, **part_kw)
    if budget_mb > 0:
        gm.enable_advisor(budget_bytes=int(budget_mb * 2**20))
    if shard_procs > 0:
        gm.enable_sharding(shard_procs, transport="proc",
                           replicas=replicas, hot_mb=hot_mb)
    elif shards > 1:
        gm.enable_sharding(shards)
    return gm, store, ev


def serve_query(n_events: int, batch: int, input_path: str | None,
                seed: int = 0, codec: str = "v2", kv: str = "mem",
                kv_dir: str | None = None, hot_mb: float = 8.0,
                budget_mb: float = 0.0, shards: int = 1,
                shard_procs: int = 0, replicas: int = 1,
                device="cuda") -> None:
    """Real request serving over stdin (the documented ``--port 0``
    fallback): NDJSON GraphQuery documents in, JSON QueryResult envelopes
    out (stdout stays pure NDJSON; the summary goes to stderr).
    ``--advisor-mb > 0`` also enables the materialization advisor under
    that GraphPool budget.  ``--shards N > 1`` stores the history in N
    mod_hash partitions and serves retrievals through N shard workers
    (scatter/gather with hedged fetches).  ``--shard-procs N`` upgrades
    the workers to N real shardd OS processes behind the RPC transport,
    each partition served by ``--replicas R`` rendezvous-ranked
    replicas."""
    gm, store, ev = _build_query_gm(n_events, seed, codec, kv, kv_dir,
                                    hot_mb, budget_mb, shards,
                                    shard_procs, replicas, device)
    print(f"ready: {n_events} events, tmax={int(ev.time[-1])}, "
          f"doc-batch={batch}"
          + (f", shards={shards}" if shards > 1 else "")
          + (f", shard-procs={shard_procs} replicas={replicas}"
             if shard_procs > 0 else ""),
          file=sys.stderr, flush=True)

    lines = (open(input_path) if input_path and input_path != "-"
             else sys.stdin)
    served = ok = 0
    t0 = time.perf_counter()
    try:
        for envelope in run_query_documents(gm, lines, batch=batch):
            print(envelope, flush=True)
            served += 1
            ok += '"ok": true' in envelope
    finally:
        if lines is not sys.stdin:
            lines.close()
        wall = time.perf_counter() - t0
        st = gm.store.stats
        shard_note = ""
        if gm.sharded is not None:
            shard_note = (f"  shards: {len(gm.sharded.workers)} "
                          f"{gm.sharded.transport.name} workers, "
                          f"{gm.sharded.hedges_total} hedges, "
                          f"{gm.sharded.requeues_total} requeues, "
                          f"{gm.sharded.failovers_total} failovers")
        print(f"served {served} documents ({ok} ok) in {wall:.2f}s "
              f"({served / max(wall, 1e-9):.0f} docs/s)  "
              f"kv: {st.gets} gets, {st.bytes_read / 2**20:.2f} MiB"
              + shard_note,
              file=sys.stderr, flush=True)
        gm.close()
        if store is not None:
            store.close()


def serve_server(n_events: int, port: int, seed: int = 0,
                 codec: str = "v2", kv: str = "mem",
                 kv_dir: str | None = None, hot_mb: float = 8.0,
                 budget_mb: float = 0.0, shards: int = 1,
                 window_ms: float = 2.0, workers: int = 4,
                 admit_ms: float = 250.0, session_mb: float | None = None,
                 serve_s: float = 0.0, shard_procs: int = 0,
                 replicas: int = 1, device="cuda") -> None:
    """The concurrent socket front end (``--mode server``): one
    :class:`~repro_torch.launch.server.QueryServer` accepting NDJSON sessions,
    co-batching co-plannable documents across clients inside a
    ``--window-ms`` batching window, with deadline admission control and
    lease-budget backpressure (see launch/server.py).  Prints one
    ``SERVER_READY host=... port=...`` line to stdout once bound (the
    subprocess-harness contract), serves until SIGINT or ``--serve-s``
    elapses, then prints ``SERVER_STATS <json>``."""
    import json as _json

    from .server import QueryServer

    gm, store, ev = _build_query_gm(n_events, seed, codec, kv, kv_dir,
                                    hot_mb, budget_mb, shards,
                                    shard_procs, replicas, device)
    srv = QueryServer(gm, port=port, window_ms=window_ms, workers=workers,
                      admit_horizon_ms=admit_ms,
                      session_lease_mb=session_mb)
    srv.start()
    print(f"ready: {n_events} events, tmax={int(ev.time[-1])}, "
          f"window={window_ms}ms workers={workers}",
          file=sys.stderr, flush=True)
    print(f"SERVER_READY host={srv.host} port={srv.port}", flush=True)
    try:
        if serve_s > 0:
            time.sleep(serve_s)
        else:
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        stats = srv.stats()
        srv.close()
        print("SERVER_STATS " + _json.dumps(stats, sort_keys=True),
              flush=True)
        gm.close()
        if store is not None:
            store.close()


def serve_ingest(n_events: int, duration_s: float, readers: int,
                 group: int, seed: int = 0, codec: str = "v2",
                 kv: str = "mem", kv_dir: str | None = None,
                 hot_mb: float = 8.0, device="cuda") -> None:
    """Mixed ingest + query serving: one writer streams the live tail of
    a synthetic history through the threaded ingest pipeline, paced to
    fill ``duration_s``, while ``readers`` threads issue ``Q.at`` /
    ``Q.between`` documents against epoch-pinned views.  Reports
    sustained events/s, freshness lag (append → visible), per-query
    latency under write pressure, and rollover/epoch counters; the last
    stdout line is ``INGEST_SUMMARY <json>`` for CI to parse."""
    import json
    import os as _os
    import threading
    from collections import deque

    from ..api.document import Q
    from ..core import GraphManager
    from ..core.ingest import IngestPipeline
    from ..data.generators import churn_network
    from ..storage import codec as codec_mod
    from ..storage.kv import make_store

    codec_mod.set_default_codec(codec)
    uni, ev = churn_network(n_initial_edges=max(n_events // 12, 50),
                            n_events=n_events, seed=seed)
    n_build = max(n_events // 5, 200)
    store = None
    if kv != "mem":
        d = _os.path.join(kv_dir, "ingest") if kv_dir else None
        store = make_store(kv, directory=d, hot_bytes=int(hot_mb * 2**20))
    gm = GraphManager(uni, ev[:n_build], store=store,
                      L=max(n_events // 40, 64), k=2,
                      diff_fn="intersection", device=device)
    pipe = IngestPipeline(gm, group_events=group, threaded=True)
    gm._ingest = pipe
    svc = gm.query
    print(f"ready: {n_build} built, {n_events - n_build} live events, "
          f"{readers} readers, {duration_s:.0f}s", file=sys.stderr,
          flush=True)

    stop = threading.Event()
    docs_served = [0] * max(readers, 1)
    doc_fail = [0] * max(readers, 1)
    lat: deque[float] = deque(maxlen=65536)

    def reader(idx: int) -> None:
        rng = np.random.default_rng(1000 + idx)
        while not stop.is_set():
            hi = max(int(gm.epochs.current_data.max_time), 1)
            docs = [Q.at(int(t)).attrs("+node:all").build()
                    for t in rng.integers(0, hi + 1, size=3)]
            a, b = sorted(int(t) for t in rng.integers(0, hi + 1, size=2))
            docs.append(Q.between(a, b + 1).build())
            t0 = time.perf_counter()
            for r in svc.run_batch(docs, on_error="envelope"):
                docs_served[idx] += 1
                doc_fail[idx] += not r.ok
            lat.append((time.perf_counter() - t0) / len(docs))

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(readers)]
    for th in threads:
        th.start()

    chunks = []
    i = n_build
    rng = np.random.default_rng(seed)
    while i < n_events:
        j = min(n_events, i + int(rng.integers(group // 2, group * 2)))
        chunks.append((i, j))
        i = j
    pace = duration_s / max(len(chunks), 1)
    t_start = time.perf_counter()
    for n, (i, j) in enumerate(chunks):
        pipe.submit(ev[i:j])
        sleep = t_start + (n + 1) * pace - time.perf_counter()
        if sleep > 0:
            time.sleep(sleep)
    pipe.drain(timeout=max(duration_s, 60.0))
    wall = time.perf_counter() - t_start
    stop.set()
    for th in threads:
        th.join(timeout=10)

    ps = pipe.stats()
    lats = sorted(lat)
    summary = {
        "events_per_s": round(ps["committed_events"] / max(wall, 1e-9), 1),
        "committed_events": ps["committed_events"],
        "groups": ps["groups_committed"],
        "rollovers": ps["rollovers"],
        "freshness_lag_p99_ms": (round(ps["freshness_lag_p99_ms"], 3)
                                 if ps["freshness_lag_p99_ms"] else None),
        "docs_served": sum(docs_served),
        "docs_failed": sum(doc_fail),
        "query_p50_ms": (round(1e3 * lats[len(lats) // 2], 3)
                         if lats else None),
        "query_p99_ms": (round(1e3 * lats[int(len(lats) * 0.99)], 3)
                         if lats else None),
        "epochs": ps["epochs"]["current_id"],
        "wall_s": round(wall, 2),
    }
    print(f"ingested {summary['committed_events']} events in {wall:.1f}s "
          f"({summary['events_per_s']:.0f} ev/s, "
          f"{summary['rollovers']} rollovers)  "
          f"queries: {summary['docs_served']} docs "
          f"({summary['docs_failed']} failed) "
          f"p99={summary['query_p99_ms']} ms  "
          f"freshness p99={summary['freshness_lag_p99_ms']} ms",
          file=sys.stderr, flush=True)
    print("INGEST_SUMMARY " + json.dumps(summary, sort_keys=True),
          flush=True)
    gm.close()
    if store is not None:
        store.close()


def serve_evolve(n_events: int, intervals: int, points: int, op: str, *,
                 seed: int = 0, window_frac: float = 0.05,
                 device="cuda") -> dict:
    """Drive an evolutionary-query workload — ``intervals`` dense
    ``points``-timepoint windows over a ``churn_network`` history —
    through the incremental temporal engine and the per-snapshot
    recompute loop on ``device``, print microseconds per point for each
    and the speedup, and return ``{engine: (wall_s, solver_iters)}``."""
    from ..core import GraphManager
    from ..data.generators import churn_network, dense_intervals

    dev = resolve_device(device)
    uni, ev = churn_network(n_initial_edges=max(n_events // 12, 50),
                            n_events=n_events, seed=seed)
    tmax = int(ev.time[-1])
    ivs = dense_intervals(tmax, intervals, points,
                          window_frac=window_frac, seed=seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with GraphManager(uni, ev, L=max(n_events // 40, 64), k=2,
                      diff_fn="intersection", cache_bytes=0,
                      device=dev) as gm:
        # warm both engines (first launches, lazily built kernels) so that
        # one-time costs are not charged to whichever engine runs first
        for engine_warm in (False, True):
            gm.evolve(ivs[0][:3], op, incremental=engine_warm)
        results = {}
        for engine in ("recompute", "incremental"):
            sync()
            t0 = time.perf_counter()
            iters = 0
            for iv in ivs:
                res = gm.evolve(iv, op,
                                incremental=(engine == "incremental"))
                if res.stats.get("solver_iters"):
                    iters += sum(res.stats["solver_iters"])
            sync()
            results[engine] = (time.perf_counter() - t0, iters)
    q = intervals * points
    for engine, (wall, iters) in results.items():
        print(f"{engine:12s}: {wall / q * 1e6:8.1f} us/point "
              f"({q / wall:8.0f} points/s, solver iters {iters})")
    print(f"speedup x{results['recompute'][0] / results['incremental'][0]:.2f}"
          f"  ({intervals} intervals x {points} points, op={op}, "
          f"device {dev})")
    return results


def serve_lm(arch: str, batch: int, prompt_len: int, gen: int, *,
             reduced: bool = False, device="cuda", seed: int = 0,
             cfg=None) -> dict:
    """Serve one batch: ``batch`` prompts of ``prompt_len`` tokens, ``gen``
    greedy decode steps; prints the times and a sample and returns
    :func:`generate`'s record with ``config``.  ``cfg`` as for
    :func:`load_lm`."""
    cfg, params = load_lm(arch, reduced=reduced, device=device, seed=seed,
                          cfg=cfg)
    tokens = prompt_tokens(cfg, batch, prompt_len, seed,
                           params["embed"].device)
    res = generate(params, cfg, tokens, gen)
    dt = res["decode_s"]
    per_step = dt / gen * 1000 if gen else 0.0
    rate = batch * gen / dt if gen and dt > 0 else 0.0
    print(f"prefill {batch}x{prompt_len}: {res['prefill_s'] * 1000:.3f} ms; "
          f"decode {gen} steps: {per_step:.3f} ms/step ({rate:.1f} tok/s)")
    print("sample:", res["tokens"][0][:16].tolist())
    return {**res, "config": cfg}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("model", "snapshots", "evolve",
                                       "query", "ingest", "server"),
                    default="model")
    ap.add_argument("--arch", default="gemma3-1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's smoke-test scale of --arch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", type=int, default=20_000,
                    help="retrieval modes: history length")
    ap.add_argument("--budget-mb", type=float, default=16.0,
                    help="snapshots mode: GraphPool memory budget")
    ap.add_argument("--queries", type=int, default=2_000)
    ap.add_argument("--zipf", type=float, default=1.3,
                    help="snapshots mode: recency skew (<=1 → uniform)")
    ap.add_argument("--multipoint-batch", type=int, default=1,
                    help="snapshots mode: merge this many concurrent "
                         "queries into one batched get_snapshots plan")
    ap.add_argument("--codec", choices=("v2", "raw"), default="v2",
                    help="payload codec: v2 (compressed+checksummed) or "
                         "legacy raw")
    ap.add_argument("--kv", choices=("mem", "logfile", "tiered"),
                    default="mem",
                    help="store tier (tiered = hot blob cache over a log "
                         "file)")
    ap.add_argument("--kv-dir", default=None,
                    help="directory for logfile/tiered stores "
                         "(default: fresh temp dir)")
    ap.add_argument("--hot-mb", type=float, default=8.0,
                    help="tiered store: hot-tier byte budget")
    ap.add_argument("--input", default=None,
                    help="query mode: NDJSON document file ('-' = stdin, "
                         "the default)")
    ap.add_argument("--doc-batch", type=int, default=8,
                    help="query mode: merge up to this many concurrent "
                         "documents into one co-batched Steiner plan")
    ap.add_argument("--advisor-mb", type=float, default=0.0,
                    help="query mode: enable the materialization advisor "
                         "under this GraphPool budget (0 = off)")
    ap.add_argument("--shards", type=int, default=1,
                    help="query mode: partition the history into this many "
                         "mod_hash shards and serve retrievals through a "
                         "shard-worker pool (1 = unsharded)")
    ap.add_argument("--shard-procs", type=int, default=0,
                    help="query/server mode: serve retrievals through this "
                         "many shardd OS processes behind the RPC "
                         "transport (0 = in-thread workers; implies "
                         "4*N partitions unless --shards is set)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="query/server mode: replicas per partition for "
                         "the proc transport — hedges and failover route "
                         "to a distinct replica")
    ap.add_argument("--port", type=int, default=0,
                    help="server mode: TCP port to bind (0 in query mode "
                         "= the stdin fallback; 0 in server mode = an "
                         "ephemeral port, read it from the SERVER_READY "
                         "line)")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="server mode: co-batching window — arrivals "
                         "within it merge into one cross-client plan")
    ap.add_argument("--server-workers", type=int, default=4,
                    help="server mode: scheduler execution threads")
    ap.add_argument("--admit-ms", type=float, default=250.0,
                    help="server mode: admission horizon — shed new work "
                         "when the queue drain estimate exceeds this")
    ap.add_argument("--session-mb", type=float, default=None,
                    help="server mode: per-session lease byte budget "
                         "(default: derived from pool/store budgets)")
    ap.add_argument("--serve-s", type=float, default=0.0,
                    help="server mode: serve for this many seconds then "
                         "exit (0 = until SIGINT)")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="ingest mode: seconds to pace the live event "
                         "stream over")
    ap.add_argument("--readers", type=int, default=2,
                    help="ingest mode: concurrent query reader threads")
    ap.add_argument("--group", type=int, default=256,
                    help="ingest mode: commit-group event target")
    ap.add_argument("--intervals", type=int, default=8,
                    help="evolve mode: number of evolutionary queries")
    ap.add_argument("--points", type=int, default=32,
                    help="evolve mode: timepoints per interval")
    ap.add_argument("--op", default="pagerank",
                    choices=("masks", "degree", "density", "pagerank",
                             "components"),
                    help="evolve mode: incremental operator")
    args = ap.parse_args()
    store_kw = dict(seed=args.seed, codec=args.codec, kv=args.kv,
                    kv_dir=args.kv_dir, hot_mb=args.hot_mb,
                    device=args.device)
    if args.mode == "server" or (args.mode == "query" and args.port > 0):
        serve_server(args.events, args.port, budget_mb=args.advisor_mb,
                     shards=args.shards, window_ms=args.window_ms,
                     workers=args.server_workers, admit_ms=args.admit_ms,
                     session_mb=args.session_mb, serve_s=args.serve_s,
                     shard_procs=args.shard_procs, replicas=args.replicas,
                     **store_kw)
    elif args.mode == "query":
        serve_query(args.events, args.doc_batch, args.input,
                    budget_mb=args.advisor_mb, shards=args.shards,
                    shard_procs=args.shard_procs, replicas=args.replicas,
                    **store_kw)
    elif args.mode == "snapshots":
        serve_snapshots(args.events, args.budget_mb, args.queries, args.zipf,
                        batch=args.multipoint_batch, **store_kw)
    elif args.mode == "ingest":
        serve_ingest(args.events, args.duration, args.readers, args.group,
                     **store_kw)
    elif args.mode == "evolve":
        serve_evolve(args.events, args.intervals, args.points, args.op,
                     seed=args.seed, device=args.device)
    else:
        serve_lm(args.arch, args.batch, args.prompt, args.gen,
                 reduced=args.reduced, device=args.device, seed=args.seed)

if __name__ == "__main__":
    main()
