"""GraphManager / HistoryManager / QueryManager composition (paper §3.2.2)
and the programmatic HistGraph API (§3.2.1).

* **HistoryManager** role — DeltaGraph construction, query planning, delta
  and eventlist reads → lives in :class:`repro_torch.core.deltagraph.DeltaGraph`.
* **GraphManager** role — GraphPool maintenance, overlaying, bit
  assignment, post-query clean-up → here.
* **QueryManager** role — external-id ↔ slot translation → the universe's
  lookup tables, surfaced through :class:`HistGraph` accessors.

The manager takes ``device=`` (default ``"cuda"``; a missing card raises
unless the caller passes ``"cpu"``) and hands it to the temporal engine:
its fixpoint operators and :class:`~repro_torch.core.temporal
.SnapshotBatchLoader` run there.  Snapshot retrieval through the query
service stays on the host, as in the reference, and so does sharded
retrieval (:meth:`GraphManager.enable_sharding`: shard servers in threads
or ``repro_torch.launch.shardd`` processes, replicas, hedged fetches).
"""
from __future__ import annotations

import threading
from typing import Any, Sequence

import numpy as np

from ..graph.csr import CSR, build_csr
from ..kernels.policy import resolve_device
from ..storage.kv import KVStore, MemKV, store_from_env
from .analysis import estimate_rates
from .deltagraph import DeltaGraph
from .events import EventList, GraphUniverse, MaterializedState, replay
from .graphpool import GraphPool
from .materialize import (Advice, AdvisorConfig, MaterializationAdvisor,
                          SnapshotCache, WorkloadStats)
from .query import AttrOptions, TimeExpression, parse_attr_options


class HistGraph:
    """A retrieved historical snapshot, overlaid in the GraphPool."""

    def __init__(self, mgr: "GraphManager", gid: int, t: int | None,
                 options: AttrOptions) -> None:
        self._mgr = mgr
        self.gid = gid
        self.time = t
        self.options = options
        self._csr: CSR | None = None

    # -- structure ------------------------------------------------------
    @property
    def node_mask(self) -> np.ndarray:
        return self._mgr.pool.get_node_mask(self.gid)

    @property
    def edge_mask(self) -> np.ndarray:
        return self._mgr.pool.get_edge_mask(self.gid)

    def num_nodes(self) -> int:
        return int(self.node_mask.sum())

    def num_edges(self) -> int:
        return int(self.edge_mask.sum())

    def get_nodes(self) -> list[Any]:
        u = self._mgr.universe
        return [u.node_ids[s] for s in np.nonzero(self.node_mask)[0]]

    def csr(self) -> CSR:
        if self._csr is None:
            u = self._mgr.universe
            self._csr = build_csr(u.edge_src, u.edge_dst, u.num_nodes,
                                  self.edge_mask, u.edge_directed)
        return self._csr

    def get_neighbors(self, node_id: Any) -> list[Any]:
        u = self._mgr.universe
        s = u.node_slot(node_id)
        return [u.node_ids[v] for v in self.csr().neighbors(s)]

    def get_edge_obj(self, u_id: Any, v_id: Any) -> int | None:
        u = self._mgr.universe
        su, sv = u.node_slot(u_id), u.node_slot(v_id)
        c = self.csr()
        for v, e in zip(c.neighbors(su), c.edge_slots(su)):
            if v == sv:
                return int(e)
        return None

    # -- attributes ------------------------------------------------------
    def node_attr(self, node_id: Any, name: str) -> float:
        u = self._mgr.universe
        col = u.attr_col("node", name)
        entry = self._mgr.pool.table[self.gid]
        vec = entry.node_attr_cols.get(col)
        if vec is None:
            raise KeyError(f"attribute {name!r} was not fetched "
                           f"(options {self.options})")
        return float(vec[u.node_slot(node_id)])

    def edge_attr_by_slot(self, edge_slot: int, name: str) -> float:
        u = self._mgr.universe
        col = u.attr_col("edge", name)
        vec = self._mgr.pool.table[self.gid].edge_attr_cols.get(col)
        if vec is None:
            raise KeyError(f"attribute {name!r} was not fetched")
        return float(vec[edge_slot])

    def to_state(self, with_attrs: bool = True) -> MaterializedState:
        return self._mgr.pool.get_state(self.gid, with_attrs=with_attrs)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Release this graph's GraphPool bits (idempotent); the pool
        cleaner reclaims the plane rows lazily."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self._mgr.pool.release(self.gid)
        self._mgr.pool.cleaner()

    def __enter__(self) -> "HistGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class GraphManager:
    """Top-level façade: owns the DeltaGraph index, the GraphPool, and the
    current graph; exposes the paper's retrieval calls."""

    def __init__(self, universe: GraphUniverse, events: EventList, *,
                 store: KVStore | None = None, L: int = 1000, k: int = 2,
                 diff_fn: str | Sequence[str] = "balanced",
                 diff_params: dict | Sequence[dict] | None = None,
                 num_partitions: int = 1,
                 partition_fn: str = "word_cyclic",
                 cache_bytes: int = 32 << 20,
                 cache_entries: int = 256,
                 prefetch_workers: int = 4, device="cuda") -> None:
        device = resolve_device(device)
        # default store honors REPRO_KV (mem | logfile | tiered) so every
        # entry point can run disk-resident without code changes; stores we
        # created are closed with the manager
        owns_store = store is None
        store = store if store is not None else (store_from_env() or MemKV())
        dg = DeltaGraph(universe, store, L=L, k=k, diff_fn=diff_fn,
                        diff_params=diff_params,
                        num_partitions=num_partitions,
                        partition_fn=partition_fn).build(events)
        current = replay(universe, events,
                         int(events.time[-1]) if len(events) else 0)
        self._wire(universe, dg, current, events, owns_store=owns_store,
                   cache_bytes=cache_bytes, cache_entries=cache_entries,
                   prefetch_workers=prefetch_workers, device=device)

    @classmethod
    def open(cls, universe: GraphUniverse, store: KVStore, *,
             cache_bytes: int = 32 << 20, cache_entries: int = 256,
             prefetch_workers: int = 4, device="cuda") -> "GraphManager":
        """Reopen a manager from a persisted skeleton + write-ahead log
        (crash recovery — ``core/ingest.py``): loads the last durable
        skeleton, replays the WAL tail past the folded prefix, and rebuilds
        the current graph.  Every group-committed event is present."""
        from .events import apply_events
        from .ingest import recover_index
        device = resolve_device(device)
        dg = recover_index(universe, store)
        current = apply_events(dg._last_leaf_state, dg.recent, forward=True)
        current.edge_mask &= ~universe.edge_transient[:current.edge_mask.size]
        current.node_mask &= ~universe.node_transient[:current.node_mask.size]
        gm = cls.__new__(cls)
        gm._wire(universe, dg, current, dg.recent, owns_store=False,
                 cache_bytes=cache_bytes, cache_entries=cache_entries,
                 prefetch_workers=prefetch_workers, device=device)
        return gm

    def _wire(self, universe: GraphUniverse, dg: DeltaGraph,
              current: MaterializedState, events: EventList, *,
              owns_store: bool, cache_bytes: int, cache_entries: int,
              prefetch_workers: int, device) -> None:
        """Common wiring shared by build (``__init__``) and recovery
        (:meth:`open`)."""
        from .epoch import EpochData, EpochRegistry
        from .epoch import NO_TIME
        self.universe = universe
        self.device = device
        self._owns_store = owns_store
        self.store = dg.store
        self.dg = dg
        self.pool = GraphPool(universe)
        self.pool.set_current(current)
        # workload-aware materialization + caching (core/materialize.py)
        self.workload = WorkloadStats()
        self.dg.workload = self.workload
        self.rates = estimate_rates(events)
        self.cache = (SnapshotCache(cache_bytes, cache_entries)
                      if cache_bytes > 0 else None)
        self.advisor: MaterializationAdvisor | None = None
        # async KV prefetch for batched retrieval (runtime/executor.py);
        # threads spin up lazily on first batched query
        if prefetch_workers > 0:
            from ..runtime.executor import Prefetcher
            self.prefetcher = Prefetcher(self.store, workers=prefetch_workers)
        else:
            self.prefetcher = None
        self._temporal = None
        self._query_service = None
        # sharded multi-worker retrieval (runtime/shard.py); off by default,
        # enabled via enable_sharding() / serve.py --shards N
        self.sharded = None
        # concurrent retrievals are supported (cache and workload counters
        # are internally locked); advisor *replans* mutate the pool and the
        # skeleton's materialization marks, so they are serialized here —
        # see ARCHITECTURE.md "Concurrency" for what is and isn't safe
        self._advisor_lock = threading.Lock()
        # epoch-versioned index (§6 / core/epoch.py): readers pin the
        # current epoch at query entry; the ingest pipeline publishes a new
        # one per commit group and per rollover swap
        n_recent = len(dg.recent)
        max_t = (int(dg.recent.time[-1]) if n_recent
                 else (dg.leaf_time[-1] if dg.leaf_pos[-1] > 0 else NO_TIME))
        self.epochs = EpochRegistry(EpochData(dg, dg._total_events, max_t))
        self._ingest = None
        self._closed = False

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Shut down every worker this manager owns — the ingest pipeline,
        the shard-worker pool, the prefetch thread pool — and any store it
        created itself (flushes disk-backed tiers).  Idempotent: a second
        close is a no-op, and retrievals issued after close degrade to the
        synchronous unprefetched path instead of respawning threads."""
        if self._closed:
            return
        self._closed = True
        if self._ingest is not None:
            self._ingest.close()
            self._ingest = None
        if self.sharded is not None:
            self.sharded.close()
            self.sharded = None
        if self.prefetcher is not None:
            # drain in-flight fetches before the store's handles go away
            self.prefetcher.close(wait=self._owns_store)
            self.prefetcher = None
        if self._owns_store:
            self.store.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "GraphManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- retrieval
    #
    # Every retrieval/analytics entry point below is a thin shim over the
    # declarative query service (repro/api): it builds the equivalent
    # GraphQuery document and runs it through ``self.query``.  The service
    # owns the single implementation of cached + advised + batched
    # retrieval, so the legacy surface and the wire protocol are
    # bit-identical by construction (tests/test_query_service.py).
    def _parse_opts(self, attr_options: str | AttrOptions) -> AttrOptions:
        return (attr_options if isinstance(attr_options, AttrOptions)
                else parse_attr_options(attr_options, self.universe))

    @property
    def query(self):
        """The :class:`~repro_torch.api.service.QueryService` bound to this
        manager — the declarative entry point (``gm.query.run(doc)``)."""
        if self._query_service is None:
            from ..api.service import QueryService
            self._query_service = QueryService(self)
        return self._query_service

    def get_snapshot(self, t: int, attr_options: str | AttrOptions = "",
                     use_current: bool = True) -> MaterializedState:
        """Singlepoint retrieval through the snapshot cache (exact-timepoint
        LRU) with the advisor's online replan hook.  Results are always
        bit-identical to a cold ``DeltaGraph.get_snapshot``.
        ≡ ``Q.at(t).attrs(...).build()``."""
        from ..api.document import GraphQuery
        doc = GraphQuery(kind="snapshot", t=int(t), attrs=attr_options,
                         use_current=bool(use_current))
        return self.query.run(doc).value

    def get_snapshots(self, times: Sequence[int],
                      attr_options: str | AttrOptions = "",
                      use_current: bool = True
                      ) -> dict[int, MaterializedState]:
        """Batched multipoint retrieval (§4.4): cache hits are split off,
        the misses become **one** Steiner plan whose shared prefixes fetch
        and apply once, executed with async KV prefetch.
        ≡ ``Q.at(times).attrs(...).build()``."""
        from ..api.document import GraphQuery
        times = tuple(int(t) for t in times)
        if not times:     # wire documents reject this; the legacy
            return {}     # contract is an empty result
        doc = GraphQuery(kind="multipoint", times=times,
                         attrs=attr_options, use_current=bool(use_current))
        return self.query.run(doc).value

    def get_hist_graph(self, t: int, attr_options: str = "",
                       use_current: bool = True) -> HistGraph:
        opts = self._parse_opts(attr_options)
        st = self.get_snapshot(t, opts, use_current=use_current)
        gid = self.pool.insert_snapshot(st)
        return HistGraph(self, gid, t, opts)

    def get_hist_graphs(self, times: Sequence[int],
                        attr_options: str = "",
                        use_current: bool = True) -> list[HistGraph]:
        """Batched retrieval + one batched GraphPool overlay pass.
        ``use_current`` is threaded through to the planner, same as the
        singlepoint entry."""
        opts = self._parse_opts(attr_options)
        states = self.get_snapshots(list(times), opts,
                                    use_current=use_current)
        gids = self.pool.insert_snapshots([states[int(t)] for t in times])
        return [HistGraph(self, gid, int(t), opts)
                for gid, t in zip(gids, times)]

    def get_hist_graph_expr(self, tex: TimeExpression,
                            attr_options: str = "") -> HistGraph:
        """Hypothetical graph for a Boolean TimeExpression (§3.2.1): the
        element set satisfying the expression; attributes come from the
        latest queried time point at which the element exists.  Returns a
        GraphPool-overlaid :class:`HistGraph` (like every other
        ``get_hist_graph*`` entry); use :meth:`HistGraph.to_state` for
        the raw :class:`MaterializedState`.
        ≡ ``Q.expr(tex.to_infix(), tex.times).build()``."""
        from ..api.document import GraphQuery
        opts = self._parse_opts(attr_options)
        doc = GraphQuery(kind="expr", expr=tex.to_infix(),
                         times=tuple(int(t) for t in tex.times),
                         attrs=opts)
        st = self.query.run(doc).value
        gid = self.pool.insert_snapshot(st)
        return HistGraph(self, gid, None, opts)

    def get_hist_graph_interval(self, ts: int, te: int) -> dict[str, np.ndarray]:
        """≡ ``Q.between(ts, te).build()``."""
        from ..api.document import GraphQuery
        doc = GraphQuery(kind="interval", ts=int(ts), te=int(te))
        return self.query.run(doc).value

    # ------------------------------------------------------ temporal analytics
    def evolve(self, times: "Sequence[int] | TimeExpression",
               op: Any = "masks", *, attr_options: str | AttrOptions = "",
               use_current: bool = True, incremental: bool = True,
               **op_kwargs):
        """Evolutionary query over an interval of timepoints
        (:mod:`repro_torch.core.temporal`): retrieve the *first* snapshot through
        the plan IR, then advance incrementally by the inter-snapshot
        event slices — incremental degree/density, warm-started PageRank,
        re-union-only connected components, or a generic Pregel fold.

        ``times`` is a sequence of timepoints or a
        :class:`~repro_torch.core.query.TimeExpression` (its timepoints are
        used); ``op`` is an operator name (``"masks"``, ``"degree"``,
        ``"density"``, ``"pagerank"``, ``"components"``), an
        :class:`~repro_torch.core.temporal.EvolveOp` instance (e.g.
        :class:`~repro_torch.core.temporal.PregelFold`), or a plain fold
        callable ``f(prev_value, state, delta, t)``.
        ``incremental=False`` runs the per-snapshot recompute baseline.
        Returns an :class:`~repro_torch.core.temporal.EvolveResult`.
        ≡ ``Q.evolve(times, op, **kwargs).build()`` (named operators
        serialize; EvolveOp instances/callables are programmatic-only)."""
        from ..api.document import GraphQuery
        if isinstance(times, TimeExpression):
            times = list(times.times)
        doc = GraphQuery(kind="evolve",
                         times=tuple(int(t) for t in times),
                         op=op, op_kwargs=dict(op_kwargs),
                         attrs=attr_options, use_current=bool(use_current),
                         incremental=bool(incremental))
        return self.query.run(doc).value

    # ------------------------------------------------------------- updates
    @property
    def ingest(self):
        """The :class:`~repro_torch.core.ingest.IngestPipeline` bound to this
        manager (created lazily, synchronous mode).  For threaded
        production-rate ingest construct one explicitly:
        ``IngestPipeline(gm, threaded=True)``."""
        if self._ingest is None:
            from .ingest import IngestPipeline
            self._ingest = IngestPipeline(self)
        return self._ingest

    def update(self, ev: EventList) -> None:
        """Live update path (§6), shimmed onto the ingest pipeline: the
        batch commits as one group (WAL append + one durability barrier),
        publishes a new epoch, and folds full leaves red/green — readers
        that pinned an epoch mid-query are unaffected."""
        self.ingest.append(ev)

    # ------------------------------------------------------------- sharding
    def enable_sharding(self, workers: int | Sequence[str] | None = None,
                        *, transport: "Any" = None,
                        replicas: int | None = None,
                        **kwargs) -> "Any":
        """Turn on sharded multi-worker retrieval
        (:class:`~repro_torch.runtime.shard.ShardedRetriever`): every cache-miss
        retrieval through the query service scatters its plan across a
        fleet of shard servers (partitions assigned by rendezvous hashing)
        and gathers the per-shard slot results.  ``workers`` defaults to
        one worker per storage partition.  Results stay bit-identical to
        unsharded execution.

        ``transport`` selects how shard fetches move bytes: ``"thread"``
        (default — the legacy in-process pool), ``"proc"`` (one
        ``launch/shardd`` OS process per worker with epoch-invalidated
        shard-local caches), or a ready :class:`~repro_torch.runtime.shard
        .ShardTransport` instance (tests inject instrumented ones).
        ``replicas`` is the candidate-server count per partition —
        hedges/failover then route to distinct replicas.  Both default
        from the environment (``REPRO_SHARD_TRANSPORT``,
        ``REPRO_REPLICAS``) so the differential CI suite can re-run the
        whole tier-1 battery over the process transport unchanged.
        Re-enabling replaces the previous retriever; extra kwargs go to
        the retriever (hedging/retry policy)."""
        import os

        from ..runtime.shard import ShardedRetriever
        self.disable_sharding()
        if workers is None:
            workers = max(1, self.dg.P)
        if transport is None:
            transport = os.environ.get("REPRO_SHARD_TRANSPORT") or None
        if replicas is None:
            replicas = int(os.environ.get("REPRO_REPLICAS", "1"))
        self.sharded = ShardedRetriever(self, workers, transport=transport,
                                        replicas=replicas, **kwargs)
        return self.sharded

    def disable_sharding(self) -> None:
        if self.sharded is not None:
            self.sharded.close()
            self.sharded = None

    # -------------------------------------------------------- materialization
    def enable_advisor(self, budget_bytes: int = 64 << 20, *,
                       replan_every: int = 64, drift_threshold: float = 0.25,
                       max_candidates: int = 256,
                       warm_start: bool = True) -> Advice | None:
        """Turn on workload-aware materialization (§4.5 made adaptive).

        The advisor re-plans every ``replan_every`` retrievals (or earlier
        under workload drift), pinning/evicting DeltaGraph nodes in the
        GraphPool so that ``pool.memory_bytes()`` stays under
        ``budget_bytes``.  ``warm_start`` runs one plan immediately (with
        the uniform / analytical prior if no queries were recorded yet).
        Re-enabling evicts the previous advisor's pins first."""
        with self._advisor_lock:
            self._disable_advisor_locked()
            cfg = AdvisorConfig(budget_bytes=budget_bytes,
                                replan_every=replan_every,
                                drift_threshold=drift_threshold,
                                max_candidates=max_candidates)
            self.advisor = MaterializationAdvisor(self.dg, self.pool,
                                                  self.workload, cfg,
                                                  rates=self.rates)
            self.advisor.on_evict = self._on_advisor_evict
            return self.advisor.replan() if warm_start else None

    def _on_advisor_evict(self, nids: list[int]) -> None:
        """A replan evicted pins: cache entries whose plans routed through
        them hold stale ``materialized_as`` sources — drop them."""
        if self.cache is not None and nids:
            self.cache.invalidate_deps(nids)

    def disable_advisor(self) -> None:
        """Evict every advisor pin and stop re-planning."""
        with self._advisor_lock:
            self._disable_advisor_locked()

    def _disable_advisor_locked(self) -> None:
        if self.advisor is None:
            return
        evicted = list(self.advisor.pinned)
        for nid in evicted:
            self.dg.unmaterialize(nid, self.pool)
        self.pool.cleaner(force=True)
        self._on_advisor_evict(evicted)
        self.advisor = None

    def materialize_roots(self, depth: int = 1) -> list[int]:
        """Materialize the top `depth` interior levels (§4.5)."""
        out = []
        frontier = self.dg.root_nids()
        for _ in range(depth):
            nxt = []
            for nid in frontier:
                if self.dg.nodes[nid].materialized_as is None:
                    out.append(self.dg.materialize(nid, self.pool))
                for eid in self.dg.adj[nid]:
                    e = self.dg.edges[eid]
                    if e.src == nid and e.kind == "delta":
                        nxt.append(e.dst)
            frontier = nxt
        return out

    def total_materialization(self) -> list[int]:
        """Materialize every leaf — DeltaGraph degenerates to Copy+Log with
        overlaid in-memory copies (§4.5)."""
        return [self.dg.materialize(nid, self.pool)
                for nid in self.dg.leaf_nids
                if self.dg.nodes[nid].materialized_as is None]
