"""Sharded multi-worker retrieval (paper §4.6: "single-site or parallel
processing").

One query, ``W`` shard servers: the graph's slot space is partitioned by
node-ID hash (``runtime/partition.py`` — the same registered partitioners
that route :class:`~repro_torch.storage.kv.PartitionedKV` and split every
persisted delta into per-partition sub-payloads), partitions are assigned
to servers with rendezvous hashing (:class:`~repro_torch.runtime.replica
.ReplicaManager` — killing a server moves only its partitions, each to
its next-ranked replica), and one plan IR is scattered into per-shard IRs
(:func:`~repro_torch.api.compiler.scatter_plans` /
:func:`~repro_torch.core.planir.scatter_ir`).

Each shard task executes the *same* step DAG, but its Fetch nodes pull
only the sub-payloads of the partitions it owns.  The partitioner
contract — events for slot ``s`` are stored only under partition
``h_p(s)`` — makes the shard's result exact on its owned slots; the
gather step stitches the owned slots of every shard into one state,
bit-identical to unsharded execution (``tests/test_sharded.py``
differences both against the replay oracle).

**Transports.**  Scheduling is transport-agnostic; what moves bytes is a
pluggable :class:`ShardTransport`:

* :class:`InThreadTransport` (default) — the legacy host pool: "servers"
  are names, fetches read the manager's own store.  Zero-copy, zero
  processes; differential-tested bit-identical against the oracle.
* :class:`ProcTransport` — real isolation: every server is a
  ``launch/shardd`` OS *process* answering batched fetch RPCs from a
  shard-local hot cache (origin read-through, epoch-invalidated); built
  by ``GraphManager.enable_sharding(transport="proc", replicas=R)`` /
  ``serve.py --shard-procs``.

Execution is scheduled through the fault layer: a
:class:`~repro_torch.runtime.fault.StragglerMitigator` hands shard tasks to a
thread pool, hedges the oldest outstanding task onto idle workers when
the tail is short (first completion wins, per-task duplicate cap),
requeues a failed task to a survivor, and marks the failing server dead
so the next attempt/query routes around it.  Every duplicate or requeued
attempt routes each partition to a replica **distinct from the servers
already tried** whenever one exists (``ReplicaManager.route``) — racing
the same store only re-queues behind the same straggler.  The device
backend's sharded layout lives in :mod:`repro_torch.runtime.torch_exec`;
this module is the host-side engine that serves ``serve.py --shards N``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np

from ..core.query import NO_ATTRS, AttrOptions
from .executor import HostExecutor
from .fault import (FetchTask, HeartbeatTracker, StragglerMitigator,
                    default_retryable, retry)
from .replica import ReplicaManager


class ShardExecutionError(RuntimeError):
    """A shard task failed on every attempt (primary, hedges, requeues)."""


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class ShardTransport:
    """How shard fetches move bytes; everything else (scatter, scheduling,
    hedging, gather) is transport-agnostic.

    * ``fetch(server, keys, min_epoch=..)`` → blob list (``None`` per
      missing key, the ``mget_optional`` protocol).  ``min_epoch`` is the
      coordinator's current epoch id: a caching server must not answer
      from hot bytes older than it.
    * ``health(server)`` → dict, raising on an unreachable server — the
      heartbeat RPC.  ``has_remote_health`` says whether that is a real
      liveness signal (process/remote transports) or a formality
      (in-thread servers cannot die separately from the coordinator).
    """

    name = "abstract"
    has_remote_health = False

    def servers(self) -> list[str]:
        raise NotImplementedError

    def fetch(self, server: str, keys: list, *, min_epoch: int = 0,
              deadline_s: float | None = None) -> list:
        raise NotImplementedError

    def health(self, server: str) -> dict:
        return {"ok": True}

    def stats(self) -> dict:
        return {}

    def close(self) -> None:
        pass


class InThreadTransport(ShardTransport):
    """Legacy transport: named logical servers, fetches served from the
    manager's own store on the calling thread.  Keeps the pre-process
    behavior bit-for-bit (same store object, same ``mget_optional``
    read path as ``DeltaGraph._mget``)."""

    name = "thread"

    def __init__(self, gm, servers: list[str]) -> None:
        self.gm = gm
        self._servers = list(servers)
        self.fetches = 0
        self._lock = threading.Lock()

    def servers(self) -> list[str]:
        return list(self._servers)

    def fetch(self, server: str, keys: list, *, min_epoch: int = 0,
              deadline_s: float | None = None) -> list:
        from ..storage.kv import mget_optional
        with self._lock:
            self.fetches += 1
        return mget_optional(self.gm.store, keys)

    def stats(self) -> dict:
        return {"fetches": self.fetches}


class ProcTransport(ShardTransport):
    """Process-isolated transport over :mod:`repro_torch.launch.shardd`.

    Spawns (or reuses from the pool) ``n`` shardd processes, stands up an
    origin RPC server over the coordinator's store for their cache
    read-through, configures each with its candidate-partition subset
    (the rendezvous ranks a server can legitimately serve: the ``R``
    replicas plus one spare rank so single-failure failover needs no
    reconfigure), and subscribes to the manager's
    :class:`~repro_torch.core.epoch.EpochRegistry` so every publish fans an
    ``announce`` out to the shard-local caches.

    Deeper failures (>1 server down) can route a partition beyond a
    survivor's configured ranks; its shardd rejects the fetch as a
    routing-config error (``UNOWNED_MSG``), and :meth:`fetch` reacts by
    widening that server's owned set (``set_owned`` RPC — cache kept)
    and retrying, so the origin's data stays reachable as long as any
    server is — ownership rejections never read as liveness failures.
    """

    name = "proc"
    has_remote_health = True

    def __init__(self, gm, n_procs: int = 2, *, replicas: int = 1,
                 hot_mb: float = 64.0) -> None:
        from ..launch.shardd import acquire_shard_procs, origin_server
        from .fault import rendezvous_rank
        self.gm = gm
        self.handles = acquire_shard_procs(max(1, int(n_procs)),
                                           hot_mb=hot_mb)
        self._names = [f"proc{i}" for i in range(len(self.handles))]
        self._by_name = dict(zip(self._names, self.handles))
        self.origin = origin_server(gm.store)
        self._epochs = getattr(gm, "epochs", None)
        epoch0 = self._epochs.current_id if self._epochs is not None else 0
        P = int(gm.dg.P)
        depth = min(len(self._names), max(1, int(replicas)) + 1)
        owned: dict[str, list[int]] = {n: [] for n in self._names}
        for p in range(P):
            for s in rendezvous_rank(p, self._names)[:depth]:
                owned[s].append(p)
        for name, h in self._by_name.items():
            h.client.call("configure", {
                "origin_host": self.origin.host,
                "origin_port": self.origin.port,
                "owned": owned[name],
                "hot_bytes": int(float(hot_mb) * 2**20),
                "epoch": epoch0,
            })
        self._owned = {n: set(ps) for n, ps in owned.items()}
        self._owned_lock = threading.Lock()
        self._sub = None
        if self._epochs is not None:
            self._sub = lambda eid, data: self.announce(eid)
            self._epochs.subscribe(self._sub)

    def servers(self) -> list[str]:
        return list(self._names)

    def fetch(self, server: str, keys: list, *, min_epoch: int = 0,
              deadline_s: float | None = None) -> list:
        from ..launch.shardd import UNOWNED_MSG, _encode_keys
        from .rpc import RemoteCallError

        def unowned(err: BaseException) -> bool:
            return (isinstance(err, RemoteCallError)
                    and err.remote_type == "ValueError"
                    and UNOWNED_MSG in err.remote_message)

        h = self._by_name[server]
        args = {"k": _encode_keys(keys), "min_epoch": int(min_epoch)}
        try:
            _, blobs = h.client.call("fetch", args, deadline_s=deadline_s)
        except RemoteCallError as e:
            if not unowned(e):
                raise
            # failover routed a partition beyond the server's configured
            # rendezvous ranks (>1 failure): a routing-config gap, not a
            # liveness failure — widen ownership (cache kept) and retry
            with self._owned_lock:
                owned = self._owned.setdefault(server, set())
                owned.update(k[0] for k in keys)
                widened = sorted(owned)
            try:
                h.client.call("set_owned", {"owned": widened},
                              deadline_s=5.0)
                _, blobs = h.client.call("fetch", args,
                                         deadline_s=deadline_s)
            except RemoteCallError as e2:
                if unowned(e2):     # still rejected: config bug, but the
                    e2.routing_error = True   # server is provably alive
                raise
        return blobs

    def health(self, server: str) -> dict:
        res, _ = self._by_name[server].client.call("health", deadline_s=1.0)
        return res

    def announce(self, epoch_id: int) -> None:
        """Fan the new epoch id out to every shard cache, best-effort: a
        dead replica misses the announcement but self-corrects through the
        fetch-time ``min_epoch`` gate once it (or its successor) serves
        again."""
        for h in self._by_name.values():
            try:
                h.client.call("announce", {"epoch": int(epoch_id)},
                              deadline_s=5.0)
            except Exception:
                pass

    def server_stats(self, server: str) -> dict:
        res, _ = self._by_name[server].client.call("stats", deadline_s=5.0)
        return res

    def inject_delay(self, server: str, ms: float, count: int = -1) -> None:
        self._by_name[server].client.call(
            "set_delay", {"ms": float(ms), "count": int(count)})

    def kill(self, server: str) -> int:
        """SIGKILL one shard process (chaos testing); returns its pid."""
        h = self._by_name[server]
        pid = h.pid
        h.kill()
        return pid

    def stats(self) -> dict:
        out: dict[str, Any] = {"procs": len(self._names)}
        for name in self._names:
            try:
                out[name] = self.server_stats(name)
            except Exception:
                out[name] = {"dead": True}
        return out

    def close(self) -> None:
        from ..launch.shardd import release_shard_procs
        if self._sub is not None and self._epochs is not None:
            self._epochs.unsubscribe(self._sub)
            self._sub = None
        release_shard_procs(list(self._by_name.values()))
        self._by_name = {}
        self.origin.close()


def make_transport(kind: str, gm, workers: list[str] | int, *,
                   replicas: int = 1, hot_mb: float = 64.0
                   ) -> ShardTransport:
    """``"thread"`` | ``"proc"`` — the ``REPRO_SHARD_TRANSPORT`` values."""
    kind = (kind or "thread").strip().lower()
    if kind in ("thread", "inproc", "local"):
        if isinstance(workers, int):
            workers = [f"shard{i}" for i in range(max(1, workers))]
        return InThreadTransport(gm, list(workers))
    if kind == "proc":
        n = workers if isinstance(workers, int) else len(workers)
        return ProcTransport(gm, n, replicas=replicas, hot_mb=hot_mb)
    raise ValueError(f"unknown shard transport {kind!r} (thread | proc)")


# ---------------------------------------------------------------------------
# retriever
# ---------------------------------------------------------------------------


class ShardedRetriever:
    """Scatter/execute/gather engine over a fleet of shard servers.

    * ``workers`` — worker count or explicit names (ignored when a
      ``transport`` instance is passed: its servers define the fleet).
    * ``transport`` — a :class:`ShardTransport` instance; default is the
      legacy :class:`InThreadTransport` over the manager's store.
    * ``replicas`` — candidate servers per partition (rendezvous-ranked);
      hedges and failover route to a *distinct* replica when one exists.
    * ``hedge_frac`` / ``max_hedges`` / ``hedge_delay_s`` — hedging
      policy: once remaining work is down to the outstanding tail, idle
      threads duplicate the oldest outstanding shard task (at most
      ``max_hedges`` duplicates per task, each issued only after the
      primary has been running ``hedge_delay_s``); first completion wins.
    * ``task_retries`` — how often a *failed* shard task is requeued
      before the query fails; the failing server is marked dead so later
      attempts and queries replan without it.
    * ``io_retries`` — bounded exponential backoff around each shard
      execution for transient faults (:func:`fault.retry` with the RPC
      layer's retryable/fatal classification).
    * ``health_interval_s`` — minimum spacing of the heartbeat-RPC probe
      that runs at query entry on transports with real liveness
      (``has_remote_health``); a SIGKILL'd process is excluded before any
      fetch is attempted.
    """

    def __init__(self, gm, workers: int | list[str] = 4, *,
                 transport: ShardTransport | str | None = None,
                 replicas: int = 1,
                 threads: int | None = None,
                 hedge_frac: float = 0.5, max_hedges: int = 1,
                 hedge_delay_s: float = 0.01, hedge_workers: int = 1,
                 task_retries: int = 1, io_retries: int = 2,
                 heartbeat_timeout: float = 10.0,
                 health_interval_s: float = 0.25,
                 use_prefetcher: bool = False,
                 poll_s: float = 0.002,
                 hot_mb: float = 64.0,
                 shard_hook: Callable[[str, tuple[int, ...]], None] | None
                 = None) -> None:
        self.gm = gm
        if isinstance(transport, str) or transport is None:
            transport = make_transport(transport or "thread", gm, workers,
                                       replicas=replicas, hot_mb=hot_mb)
        self.transport = transport
        self.workers = list(transport.servers())
        self.replicas = max(1, int(replicas))
        self.replica_mgr = ReplicaManager(self.workers, self.replicas)
        self.heartbeats = HeartbeatTracker(self.workers,
                                           timeout=heartbeat_timeout)
        self.hedge_frac = float(hedge_frac)
        self.max_hedges = int(max_hedges)
        self.hedge_delay_s = float(hedge_delay_s)
        self.hedge_workers = int(hedge_workers)
        self.task_retries = int(task_retries)
        self.io_retries = max(1, int(io_retries))
        self.health_interval_s = float(health_interval_s)
        self.use_prefetcher = bool(use_prefetcher)
        self.poll_s = float(poll_s)
        self.shard_hook = shard_hook
        n = len(self.workers) + self.hedge_workers
        self._pool = ThreadPoolExecutor(
            max_workers=threads if threads is not None else 4 * n,
            thread_name_prefix="shard")
        self._lock = threading.Lock()
        self._last_probe = 0.0
        self.hedges_total = 0
        self.requeues_total = 0
        self.failovers_total = 0
        self.last_stats: dict[str, Any] = {}

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self.transport.close()

    def __enter__(self) -> "ShardedRetriever":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- assignment
    def alive_workers(self) -> list[str]:
        alive = set(self.heartbeats.alive())
        out = [w for w in self.workers if w in alive]
        # a fully-dead fleet can't serve; fall back to every configured
        # worker rather than failing closed (their next success re-beats)
        return out or list(self.workers)

    def assignment(self, P: int) -> dict[str, tuple[int, ...]]:
        """Current ``server -> owned partitions`` map (primaries) over
        alive servers."""
        return self.replica_mgr.assignment(P, self.alive_workers())

    def probe_health(self, force: bool = False) -> None:
        """Heartbeat-RPC sweep: beat responders, expire the unreachable.
        Runs at query entry (rate-limited) on transports with real
        liveness, so a process SIGKILL'd at idle is excluded before the
        next query routes to it."""
        if not self.transport.has_remote_health:
            return
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_probe < self.health_interval_s:
                return
            self._last_probe = now
        for w in self.workers:
            try:
                self.transport.health(w)
                self.heartbeats.beat(w)
            except Exception:
                self.heartbeats.mark_dead(w)

    # ------------------------------------------------------------ execution
    def execute(self, dg, plan, options: AttrOptions = NO_ATTRS,
                pool=None) -> dict[Any, Any]:
        """Execute one plan IR sharded; returns states keyed by the plan's
        targets, bit-identical to ``dg.execute(plan, ...)``."""
        t_start = time.perf_counter()
        self.probe_health()
        parts_by_worker = self.assignment(dg.P)
        if len(parts_by_worker) <= 1 and not self.transport.has_remote_health:
            # one owner for every partition: in-thread sharded execution
            # degenerates to the plain host path (no scatter/gather
            # overhead); process transports still go through the routed
            # path so fetches hit the shard caches
            out = dg.execute(plan, options, pool=pool,
                             prefetch=self.gm.prefetcher
                             if self.use_prefetcher else None)
            self.last_stats = {"shards": 1, "hedges": 0, "requeues": 0,
                               "transport": self.transport.name}
            return out
        from ..api.compiler import scatter_plans
        shard_irs = scatter_plans([plan], parts_by_worker, dg.P)

        per_shard = self._run_scattered(dg, shard_irs, parts_by_worker,
                                        options, pool)
        out = self._gather(dg, per_shard, parts_by_worker)
        dg._record_workload(plan, options, t_start)
        return out

    def retrieve(self, times, options: AttrOptions = NO_ATTRS,
                 use_current: bool = True) -> dict[int, Any]:
        """Convenience: plan + execute one multipoint retrieval against the
        manager's current index."""
        dg = self.gm.dg
        times = [int(t) for t in dict.fromkeys(int(t) for t in times)]
        plan = dg.plan_multipoint(times, options, use_current)
        return self.execute(dg, plan, options, pool=self.gm.pool)

    # -- routed fetch --------------------------------------------------------
    def _routed_mget(self, route: dict[int, str], tried: frozenset,
                     min_epoch: int, keys: list) -> list:
        """Group a Fetch node's keys by each partition's chosen replica,
        one batched transport fetch per server, reassembled in key order.
        A failing fetch is tagged with the server that failed so the
        scheduler expires *that* replica, not the task's nominal owner."""
        alive = self.alive_workers()
        groups: dict[str, list[int]] = {}
        for i, k in enumerate(keys):
            s = route.get(k[0])
            if s is None:
                s = self.replica_mgr.route(k[0], alive, tried)
                route[k[0]] = s
            groups.setdefault(s, []).append(i)
        out: list = [None] * len(keys)
        for s, idxs in groups.items():
            try:
                blobs = self.transport.fetch(
                    s, [keys[i] for i in idxs], min_epoch=min_epoch)
            except Exception as e:
                e.failed_server = s
                raise
            for i, b in zip(idxs, blobs):
                out[i] = b
        return out

    # -- scheduling through the fault layer ---------------------------------
    def _run_scattered(self, dg, shard_irs: dict[str, Any],
                       parts_by_worker: dict[str, tuple[int, ...]],
                       options: AttrOptions, pool) -> dict[str, tuple]:
        prefetcher = self.gm.prefetcher if self.use_prefetcher else None
        epochs = getattr(self.gm, "epochs", None)
        min_epoch = epochs.current_id if epochs is not None else 0
        tasks = [FetchTask(partition=i, key=w,
                           size_est=max(1, len(parts_by_worker[w])))
                 for i, w in enumerate(shard_irs)]
        sm = StragglerMitigator(tasks, hedge_frac=self.hedge_frac,
                                max_duplicates=self.max_hedges)
        lock = threading.Lock()
        done_evt = threading.Event()
        started: dict[str, float] = {}
        fails: dict[str, int] = {}
        results: dict[str, Any] = {}
        errors: dict[str, BaseException] = {}
        # servers used by every issued attempt of a task: a duplicate or
        # requeued attempt must route to a server outside this set when a
        # replica exists (the hedging contract)
        used: dict[str, set[str]] = {}
        requeues = [0]
        failovers = [0]

        def run_one(worker: str, tried: frozenset):
            if self.shard_hook is not None:
                self.shard_hook(worker, parts_by_worker[worker])
            # plan the attempt's routing up front and record it into
            # ``used`` *before* fetching: a hedge issued while this
            # attempt is still in flight must already see its servers as
            # tried, or it would race the same replica
            route: dict[int, str] = self.replica_mgr.plan(
                parts_by_worker[worker], self.alive_workers(), tried)
            servers = set(route.values())
            with lock:
                used.setdefault(worker, set()).update(servers)
                if servers - {worker}:
                    failovers[0] += 1
            ex = HostExecutor(
                dg, prefetcher=prefetcher,
                mget=lambda keys: self._routed_mget(route, tried,
                                                    min_epoch, keys))
            try:
                res = ex.run(shard_irs[worker], options, pool)
            finally:
                with lock:
                    # lazily-routed keys (partitions outside the task's
                    # nominal set) may have widened the server set
                    used.setdefault(worker, set()).update(route.values())
            return res, set(route.values())

        def loop() -> None:
            while True:
                with lock:
                    if sm.finished():
                        done_evt.set()
                        return
                    task = sm.assign()
                    is_hedge = task is not None and task.key in started
                    if task is not None and not is_hedge:
                        started[task.key] = time.perf_counter()
                    tried = (frozenset(used.get(task.key, ()))
                             if task is not None else frozenset())
                if task is None:
                    time.sleep(self.poll_s)
                    continue
                if is_hedge and self.hedge_delay_s > 0:
                    wait = (started[task.key] + self.hedge_delay_s
                            - time.perf_counter())
                    if wait > 0:
                        time.sleep(wait)
                    with lock:
                        if task.key in sm.done:   # primary won meanwhile
                            continue
                        tried = frozenset(used.get(task.key, ()))
                # inner retries re-plan: each failed attempt adds the
                # server whose fetch failed to an attempt-local tried
                # set, so the next retry routes to a distinct replica
                # (when one exists) instead of hammering the same
                # unreachable server through the backoff schedule
                attempt_tried = set(tried)

                def attempt(key=task.key):
                    try:
                        return run_one(key, frozenset(attempt_tried))
                    except Exception as e:
                        failed = getattr(e, "failed_server", None)
                        if (failed is not None
                                and not getattr(e, "routing_error", False)):
                            attempt_tried.add(failed)
                            # and mark it dead right away so *other*
                            # tasks and lazily-routed keys also avoid
                            # the corpse; a transient blip is
                            # resurrected by the next health probe or
                            # by completing a later attempt
                            self.heartbeats.mark_dead(failed)
                        raise

                try:
                    res, served = retry(attempt,
                                        attempts=self.io_retries,
                                        retryable=default_retryable)
                except Exception as e:
                    failed = getattr(e, "failed_server", task.key)
                    with lock:
                        fails[task.key] = fails.get(task.key, 0) + 1
                        # the server whose fetch failed reads as dead
                        # until it completes something again: later
                        # attempts and the next query route around it —
                        # unless it rejected for ownership/routing
                        # reasons, which proves it alive
                        if not getattr(e, "routing_error", False):
                            self.heartbeats.mark_dead(failed)
                        if (fails[task.key] <= self.task_retries
                                and sm.fail(task.key)):
                            requeues[0] += 1
                            continue
                        errors.setdefault(task.key, e)
                        sm.complete(task.key)
                        if sm.finished():
                            done_evt.set()
                    continue
                with lock:
                    # beat the servers that actually served this attempt —
                    # the task's nominal owner may be a corpse the attempt
                    # routed around, and beating it would resurrect it
                    for s in served:
                        self.heartbeats.beat(s)
                    if sm.complete(task.key):
                        results[task.key] = res
                    if sm.finished():
                        done_evt.set()

        n_loops = len(tasks) + (self.hedge_workers if self.max_hedges else 0)
        for _ in range(n_loops):
            self._pool.submit(loop)
        # wait for the *task set*, not the threads: an abandoned attempt
        # whose hedge already won (first completion) keeps draining in the
        # persistent pool — joining it would hand the straggler's latency
        # right back to the query, defeating the hedge
        done_evt.wait()

        with self._lock:
            self.hedges_total += sm.duplicates
            self.requeues_total += requeues[0]
            self.failovers_total += failovers[0]
            self.last_stats = {"shards": len(tasks),
                               "hedges": sm.duplicates,
                               "requeues": requeues[0],
                               "failovers": failovers[0],
                               "transport": self.transport.name,
                               "replicas": self.replicas}
        if errors:
            worker, err = next(iter(errors.items()))
            detail = ""
            remote_tb = getattr(err, "remote_traceback", "")
            if remote_tb:
                detail = f"; remote traceback:\n{remote_tb.rstrip()}"
            raise ShardExecutionError(
                f"shard task for worker {worker!r} failed after "
                f"{fails.get(worker, 0)} attempt(s){detail}") from err
        return {w: (parts_by_worker[w], results[w]) for w in results}

    # ----------------------------------------------------------------- gather
    def _gather(self, dg, per_shard: dict[str, tuple],
                parts_by_worker: dict[str, tuple[int, ...]]) -> dict:
        """Union the per-shard states on their owned slots.

        Each shard's state is exact on the slots whose partition it owns
        and possibly stale elsewhere, and ownership tiles the slot space,
        so overwriting every shard's owned slots into one state
        reconstructs the unsharded result exactly."""
        items = list(per_shard.items())
        base_worker, (base_parts, base_states) = items[0]
        out = {}
        hp_cache: dict[int, np.ndarray] = {}

        def hp(size: int) -> np.ndarray:
            a = hp_cache.get(size)
            if a is None:
                a = dg._hp(np.arange(size, dtype=np.int64), dg.P)
                hp_cache[size] = a
            return a

        for tgt, st0 in base_states.items():
            combined = st0.copy()
            for worker, (parts, states) in items[1:]:
                st = states[tgt]
                pa = np.asarray(parts, np.int32)
                # sizes can differ only if a live ingest grew the universe
                # mid-execution; the overlap is the consistent region
                kn = min(combined.node_mask.size, st.node_mask.size)
                sel = np.isin(hp(kn), pa)
                combined.node_mask[:kn][sel] = st.node_mask[:kn][sel]
                if combined.node_attrs.size and st.node_attrs.size:
                    ka = min(kn, combined.node_attrs.shape[0],
                             st.node_attrs.shape[0])
                    combined.node_attrs[:ka][sel[:ka]] = \
                        st.node_attrs[:ka][sel[:ka]]
                ke = min(combined.edge_mask.size, st.edge_mask.size)
                sele = np.isin(hp(ke), pa)
                combined.edge_mask[:ke][sele] = st.edge_mask[:ke][sele]
                if combined.edge_attrs.size and st.edge_attrs.size:
                    ka = min(ke, combined.edge_attrs.shape[0],
                             st.edge_attrs.shape[0])
                    combined.edge_attrs[:ka][sele[:ka]] = \
                        st.edge_attrs[:ka][sele[:ka]]
            out[tgt] = combined
        return out
