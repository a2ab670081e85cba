"""Workload-aware memory materialization (paper §4.5) + snapshot caching.

The paper stubs "strategies for materializing portions of the historical
graph state in memory"; ``GraphManager.materialize_roots(depth)`` is the
fixed-depth by-hand version.  This module makes the policy *adaptive*:

* :class:`WorkloadStats` — an online, exponentially-decayed histogram of
  query traffic over the time axis, bucketed by DeltaGraph leaf.  Recorded
  automatically by :meth:`DeltaGraph.execute` (every retrieval, whatever
  entry point) so the advisor sees the true workload, including multipoint
  plans.

* :class:`MaterializationAdvisor` — chooses which skeleton nodes to pin
  into the :class:`~repro_torch.core.graphpool.GraphPool` under a byte budget
  (``GraphPool.memory_bytes()`` is the meter).  The benefit of pinning node
  ``c`` for queries landing at leaf ``ℓ`` is the Dijkstra-distance saving
  ``max(0, d_cur(ℓ) − d_c(ℓ))`` in the planner's decode-aware cost units
  (α·stored + β·decoded bytes, :meth:`EdgeInfo.weight`) — exactly the
  quantity the planner minimizes, so advised pins shorten real plans by
  construction; the budget side stays in resident logical bytes (pins live
  decoded in the pool)
  (materialized nodes become distance-0 sources in ``_sources``).  Weights
  come from the workload histogram, with the §5 analytical models
  (:func:`~repro_torch.core.analysis.estimate_rates` → uniform expected path
  weight) as the cold-start prior before any query has been seen.
  Selection is greedy benefit/cost knapsack — the classic submodular
  ratio rule; per-candidate distances are computed once (the skeleton is
  static between appends) and only the running minimum changes per pick.
  Re-planning (:meth:`MaterializationAdvisor.replan`) diffs the ideal set
  against the currently-pinned one and *evicts* drifted-out pins via
  ``DeltaGraph.unmaterialize`` + ``GraphPool.release``.

* :class:`SnapshotCache` — an LRU of fully-materialized states keyed by
  ``(t, attr-cols, use_current)`` for exact-timepoint repeat hits, size-
  bounded in bytes, invalidated from the first appended timestamp onward
  on live updates (§6).

``GraphManager`` wires all three together; see
:meth:`repro_torch.core.manager.GraphManager.enable_advisor`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Any, Iterable

import numpy as np

from .analysis import Rates, expected_singlepoint_bytes
from .deltagraph import SUPERROOT
from .query import NO_ATTRS, AttrOptions

if TYPE_CHECKING:  # pragma: no cover
    from .deltagraph import DeltaGraph
    from .events import MaterializedState
    from .graphpool import GraphPool


# ---------------------------------------------------------------------------
# workload histogram
# ---------------------------------------------------------------------------


class WorkloadStats:
    """Decayed per-leaf query-traffic histogram plus running latency stats.

    ``decay`` is applied per recorded query, so the histogram tracks a
    moving window of roughly ``1/(1-decay)`` queries — drifted-away
    workload fades out and the advisor's replan follows it.
    """

    def __init__(self, decay: float = 0.995) -> None:
        self.decay = float(decay)
        # raw counts are amplified by a running boost (1/decay per record)
        # so decay is O(1) per query; effective weight = raw / boost
        self._raw: dict[int, float] = {}
        self._raw_nodes: dict[int, float] = {}
        self._boost = 1.0
        self.opt_count: dict[tuple, int] = {}
        self.num_queries = 0
        self.cache_hits = 0
        self.total_plan_bytes = 0.0
        self.total_wall_s = 0.0
        # interval-analytics traffic (core/temporal.py): endpoint leaves
        # and per-(lo, hi) counts, so the advisor learns where evolutionary
        # queries anchor their (single) planned retrieval
        self.interval_count = 0
        self.interval_points = 0
        self.interval_wall_s = 0.0
        self.interval_hist: dict[tuple[int, int], int] = {}
        # recording is read-modify-write on plain dicts; concurrent
        # retrievals (executor threads, 16-way serving) must not lose or
        # corrupt increments
        self._lock = threading.Lock()

    @property
    def leaf_weight(self) -> dict[int, float]:
        with self._lock:
            return {k: v / self._boost for k, v in self._raw.items()}

    @property
    def node_hits(self) -> dict[int, float]:
        """Decayed per-IR-node hit counts: how often each skeleton node
        appeared in an executed plan DAG.  The advisor ranks its candidate
        pool by these — a node the planner actually routes through is a
        better pin than one merely high in the hierarchy."""
        with self._lock:
            return {k: v / self._boost for k, v in self._raw_nodes.items()}

    # -- recording -----------------------------------------------------------
    def _tick(self) -> None:
        """Advance the decay boost (callers hold ``_lock``)."""
        self._boost /= self.decay
        if self._boost > 1e12:  # renormalize before float64 overflow
            for k in self._raw:
                self._raw[k] /= self._boost
            for k in self._raw_nodes:
                self._raw_nodes[k] /= self._boost
            self._boost = 1.0

    def record(self, leaf_index: int, plan_bytes: float,
               options: AttrOptions = NO_ATTRS,
               wall_s: float = 0.0) -> None:
        with self._lock:
            self._tick()
            self._raw[leaf_index] = self._raw.get(leaf_index, 0.0) + self._boost
            key = (options.node_cols, options.edge_cols)
            self.opt_count[key] = self.opt_count.get(key, 0) + 1
            self.num_queries += 1
            self.total_plan_bytes += float(plan_bytes)
            self.total_wall_s += float(wall_s)

    def record_cache_hit(self) -> None:
        with self._lock:
            self.cache_hits += 1

    def record_nodes(self, nids: Iterable[int]) -> None:
        """Record the skeleton nodes one executed plan DAG routed through
        (called by :meth:`DeltaGraph.execute`, once per plan)."""
        with self._lock:
            for nid in nids:
                self._raw_nodes[nid] = (self._raw_nodes.get(nid, 0.0)
                                        + self._boost)

    def record_interval(self, leaf_lo: int, leaf_hi: int, n_points: int,
                        wall_s: float = 0.0) -> None:
        """Record one evolutionary query over ``n_points`` timepoints whose
        planned retrieval landed at leaf ``leaf_lo`` (that retrieval is
        recorded by :meth:`DeltaGraph.execute` as usual — not double
        counted here; ``wall_s`` covers the whole evolve and goes to the
        separate ``interval_wall_s`` aggregate for the same reason).  The
        *end* leaf additionally gains histogram weight: interval
        workloads walk forward through history, so the next evolve call
        tends to anchor near where the last one ended — pinning there
        shortens the upcoming plans."""
        with self._lock:
            self.interval_count += 1
            self.interval_points += int(n_points)
            key = (int(leaf_lo), int(leaf_hi))
            self.interval_hist[key] = self.interval_hist.get(key, 0) + 1
            self.interval_wall_s += float(wall_s)
            if leaf_hi != leaf_lo:
                self._tick()
                self._raw[leaf_hi] = (self._raw.get(leaf_hi, 0.0)
                                      + self._boost)

    # -- reads ---------------------------------------------------------------
    def weights(self, num_leaves: int) -> np.ndarray:
        """Per-leaf weight vector; uniform prior when nothing was recorded."""
        w = np.zeros(max(num_leaves, 1))
        for li, v in self.leaf_weight.items():
            if 0 <= li < num_leaves:
                w[li] += v
        if w.sum() <= 0:
            w[:] = 1.0
        return w

    def dominant_options(self) -> AttrOptions:
        """The attribute selection most queries asked for — pins must carry
        at least these columns to be usable as plan sources."""
        if not self.opt_count:
            return NO_ATTRS
        key = max(self.opt_count.items(), key=lambda kv: kv[1])[0]
        return AttrOptions(key[0], key[1])

    def drift(self, other: dict[int, float]) -> float:
        """Total-variation distance between this histogram and a snapshot of
        an earlier one (both L1-normalized); 0 = identical, 1 = disjoint."""
        keys = set(self.leaf_weight) | set(other)
        a = np.array([self.leaf_weight.get(k, 0.0) for k in keys])
        b = np.array([other.get(k, 0.0) for k in keys])
        if a.sum() <= 0 or b.sum() <= 0:
            return 0.0
        return float(0.5 * np.abs(a / a.sum() - b / b.sum()).sum())

    def snapshot(self) -> dict[int, float]:
        return dict(self.leaf_weight)


# ---------------------------------------------------------------------------
# snapshot LRU cache
# ---------------------------------------------------------------------------


def _state_nbytes(st: "MaterializedState") -> int:
    return (st.node_mask.nbytes + st.edge_mask.nbytes
            + st.node_attrs.nbytes + st.edge_attrs.nbytes)


class SnapshotCache:
    """Byte-bounded LRU of retrieved :class:`MaterializedState`s.

    Keys are ``(t, node_cols, edge_cols, use_current, epoch_tag)``.  The
    epoch tag scopes an entry's validity under live ingest
    (``core/epoch.py``): ``"s"`` marks a *stable* result — ``t`` lies
    strictly below the ingest watermark, so chronological appends can
    never change it and it serves hits across epochs — while a volatile
    result (``t`` at/past the watermark, where the plan crossed CURRENT
    or the unfolded ``recent`` tail) is tagged with the integer epoch id
    it was computed at and can only be hit by queries pinned to that same
    epoch.  Values are defensive copies both ways: the cache never
    aliases caller state, so a hit is bit-identical to a cold retrieval
    (tested property).
    """

    STABLE = "s"

    def __init__(self, max_bytes: int = 32 << 20, max_entries: int = 256) -> None:
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self._d: OrderedDict[tuple, "MaterializedState"] = OrderedDict()
        self._deps: dict[tuple, frozenset] = {}   # key -> skeleton nids used
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        # concurrent serving threads hit one shared cache; eviction is a
        # multi-step pop/accounting sequence, so every entry point locks
        self._lock = threading.RLock()

    @staticmethod
    def key(t: int, options: AttrOptions, use_current: bool,
            epoch_tag: "str | int" = STABLE) -> tuple:
        return (int(t), options.node_cols, options.edge_cols,
                bool(use_current), epoch_tag)

    def get(self, key: tuple) -> "MaterializedState | None":
        with self._lock:
            st = self._d.get(key)
            if st is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return st.copy()

    def put(self, key: tuple, st: "MaterializedState",
            deps: "frozenset | set | None" = None) -> None:
        """``deps`` are the materialized skeleton nids the producing plan
        routed through; :meth:`invalidate_deps` drops the entry when one of
        them is evicted (its ``materialized_as`` id goes stale)."""
        nb = _state_nbytes(st)
        if nb > self.max_bytes:
            return
        with self._lock:
            if key in self._d:
                self._evict_key(key)
            self._d[key] = st.copy()
            if deps:
                self._deps[key] = frozenset(deps)
            self._bytes += nb
            while self._d and (self._bytes > self.max_bytes
                               or len(self._d) > self.max_entries):
                self._evict_key(next(iter(self._d)))

    def _evict_key(self, key: tuple) -> None:
        st = self._d.pop(key)
        self._deps.pop(key, None)
        self._bytes -= _state_nbytes(st)

    def invalidate_deps(self, nids) -> int:
        """Drop entries whose plan routed through any of the given skeleton
        nodes (called when the advisor evicts pins: the recorded
        ``materialized_as`` sources no longer exist)."""
        nids = set(nids)
        with self._lock:
            dead = [k for k, deps in self._deps.items() if deps & nids]
            for k in dead:
                self._evict_key(k)
            return len(dead)

    def invalidate_from(self, t: int) -> int:
        """Drop entries at or after time ``t`` — the only ones an append
        of events with ``min(time) == t`` can change.  Entries below ``t``
        survive even if their plan crossed the current graph: under
        chronological ingest a snapshot at an earlier time is a function
        of history the new events don't touch (the coarse
        use_current-flush this replaces is regression-pinned in
        tests/test_materialize.py)."""
        with self._lock:
            dead = [k for k in self._d if k[0] >= t]
            for k in dead:
                self._evict_key(k)
            return len(dead)

    def invalidate_epochs_before(self, eid: int) -> int:
        """Reclaim volatile entries tagged with a superseded epoch id —
        they can never be hit again (queries pin the current epoch), this
        just frees the bytes early."""
        with self._lock:
            dead = [k for k in self._d
                    if k[4] != self.STABLE and k[4] < eid]
            for k in dead:
                self._evict_key(k)
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._deps.clear()
            self._bytes = 0

    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._d)

    def dep_keys(self) -> dict[tuple, frozenset]:
        """Snapshot of the entry → dependency-nid map (stress tests assert
        no surviving entry references an evicted pin)."""
        with self._lock:
            return dict(self._deps)


# ---------------------------------------------------------------------------
# the advisor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdvisorConfig:
    budget_bytes: int = 64 << 20   # GraphPool.memory_bytes() ceiling
    replan_every: int = 64         # queries between replan checks
    drift_threshold: float = 0.25  # TV distance that forces a replan
    max_candidates: int = 256      # interior nodes considered per plan
    min_benefit_bytes: float = 1.0 # absolute marginal-gain floor
    min_benefit_frac: float = 0.002  # ... and relative to the cold cost


@dataclasses.dataclass
class Advice:
    """One planning round's outcome.

    ``expected_*`` are in the planner's decode-aware cost units
    (``α·stored + β·logical`` bytes — :meth:`EdgeInfo.weight`), so the
    benefit side of the knapsack automatically credits compression: a pin
    saves what its subtree's queries would have *fetched and decoded*.
    The cost side (``pool_bytes_*``, the budget meter) stays in resident
    logical bytes — pinned states live decoded in the GraphPool."""
    chosen: list[int]                  # skeleton nids to pin (final set)
    added: list[int]
    evicted: list[int]
    expected_saved_bytes: float        # Σ weight·(d_cold − d_advised)
    expected_cold_bytes: float         # Σ weight·d_cold
    pool_bytes_before: int = 0
    pool_bytes_after: int = 0
    cost_model: dict | None = None     # {"alpha_stored": α, "beta_decode": β}


class MaterializationAdvisor:
    """Greedy workload-weighted knapsack over DeltaGraph skeleton nodes."""

    def __init__(self, dg: "DeltaGraph", pool: "GraphPool",
                 stats: WorkloadStats,
                 config: AdvisorConfig | None = None,
                 rates: Rates | None = None) -> None:
        self.dg = dg
        self.pool = pool
        self.stats = stats
        self.rates = rates
        self.config = config or AdvisorConfig()
        self.pinned: dict[int, int] = {}      # nid -> pool gid (advisor-owned)
        # called with the list of evicted nids after every apply();
        # GraphManager wires this to SnapshotCache.invalidate_deps so cache
        # entries whose plans routed through an evicted pin are dropped
        self.on_evict = None
        self.last_advice: Advice | None = None
        self._hist_at_plan: dict[int, float] = {}
        self._since_replan = 0
        # per-candidate leaf distances survive replans — the skeleton only
        # changes on appends, which bump the version key
        self._dist_cache: dict[int, np.ndarray] = {}
        self._dist_ver: tuple | None = None

    # -- cost/benefit models -------------------------------------------------
    def _attr_bytes_per_pin(self, options: AttrOptions) -> int:
        """Upper bound on float32 attribute-column bytes one pin stores."""
        return (len(options.node_cols) * self.dg.universe.num_nodes
                + len(options.edge_cols) * self.dg.universe.num_edges) * 4

    def _pinned_attr_bytes(self) -> int:
        return sum(self.pool.entry_attr_bytes(gid)
                   for gid in self.pinned.values()
                   if gid in self.pool.table)

    def _leaf_weights(self) -> np.ndarray:
        return self.stats.weights(len(self.dg.leaf_nids))

    def _cold_prior_bytes(self) -> float:
        """§5 analytical expected singlepoint path weight (events ≈ bytes up
        to a constant) — used for reporting when no queries were seen."""
        if self.rates is None:
            return 0.0
        return expected_singlepoint_bytes(self.rates, self.dg.L, self.dg.k,
                                          self.dg.diff_names[0])

    def _distances_from(self, starts: Iterable[Any],
                        options: AttrOptions) -> dict[Any, float]:
        dist, _ = self.dg._dijkstra({s: 0.0 for s in starts}, options, {},
                                    use_current=False)
        return dist

    def _candidates(self) -> list[int]:
        """Interior skeleton nodes ranked by observed per-IR-node traffic
        (nodes real plans route through first), level as tie-break (biggest
        fan-out shadow); capped at ``max_candidates``."""
        hits = self.stats.node_hits
        cand = [nid for nid, info in self.dg.nodes.items()
                if info.kind == "interior"]
        cand.sort(key=lambda nid: (-hits.get(nid, 0.0),
                                   -self.dg.nodes[nid].level))
        return cand[: self.config.max_candidates]

    # -- planning ------------------------------------------------------------
    def plan(self, budget_bytes: int | None = None) -> Advice:
        """Choose the ideal pin set under the budget.  Does not touch the
        pool — :meth:`apply` (or :meth:`replan`) does."""
        cfg = self.config
        budget = cfg.budget_bytes if budget_bytes is None else int(budget_bytes)
        options = self.stats.dominant_options()
        leaves = self.dg.leaf_nids
        w = self._leaf_weights()

        # cold distances: sources as they would be with *no* advisor pins —
        # user pins (materialize_roots etc.) count only if their stored
        # columns cover the options, mirroring DeltaGraph._sources()
        base_sources = [SUPERROOT] + [
            nid for nid, info in self.dg.nodes.items()
            if info.materialized_as is not None and nid not in self.pinned
            and set(options.node_cols) <= set(info.mat_node_cols or ())
            and set(options.edge_cols) <= set(info.mat_edge_cols or ())]
        d0 = self._distances_from(base_sources, options)
        cur = np.array([d0.get(l, np.inf) for l in leaves])
        cur[~np.isfinite(cur)] = 0.0
        cold_cost = float((w * cur).sum())

        cand = [c for c in self._candidates() if c not in base_sources]
        # per-candidate leaf distances are independent of what else is
        # pinned — one Dijkstra each, cached until the skeleton changes
        ver = (len(self.dg.nodes), len(self.dg.leaf_nids),
               options.node_cols, options.edge_cols)
        if ver != self._dist_ver:
            self._dist_cache.clear()
            self._dist_ver = ver

        def leafdist(c: int) -> np.ndarray:
            dv = self._dist_cache.get(c)
            if dv is None:
                d = self._distances_from([c], options)
                dv = np.array([d.get(l, np.inf) for l in leaves])
                self._dist_cache[c] = dv
            return dv

        attr_per_pin = self._attr_bytes_per_pin(options)
        pinned_attr_now = self._pinned_attr_bytes()
        chosen: list[int] = []
        spent_pool = self.pool.memory_bytes()
        saved = 0.0
        while cand:
            best = None
            for c in cand:
                gain = float((w * np.maximum(cur - leafdist(c), 0.0)).sum())
                if best is None or gain > best[0]:
                    best = (gain, c)
            gain, c = best
            if gain < max(cfg.min_benefit_bytes,
                          cfg.min_benefit_frac * cold_cost):
                break
            # evicted pins recycle their plane bits and free their attr
            # columns, so the projection is relative to the *final* set
            k = len(chosen) + 1
            projected = self.pool.projected_bytes(
                extra_bits=max(0, k - len(self.pinned)),
                extra_attr_bytes=k * attr_per_pin - pinned_attr_now)
            if projected > budget:
                break
            chosen.append(c)
            cand.remove(c)
            cur = np.minimum(cur, leafdist(c))
            saved += gain

        added = [c for c in chosen if c not in self.pinned]
        evicted = [c for c in self.pinned if c not in chosen]
        from .deltagraph import COST_ALPHA_STORED, COST_BETA_DECODE
        return Advice(chosen, added, evicted,
                      expected_saved_bytes=saved,
                      expected_cold_bytes=cold_cost or self._cold_prior_bytes(),
                      pool_bytes_before=spent_pool,
                      cost_model={"alpha_stored": COST_ALPHA_STORED,
                                  "beta_decode": COST_BETA_DECODE})

    def apply(self, advice: Advice,
              budget_bytes: int | None = None) -> Advice:
        """Evict drifted-out pins, materialize the new ones, enforce the
        budget against the *actual* meter after each pin."""
        budget = (self.config.budget_bytes if budget_bytes is None
                  else int(budget_bytes))
        options = self.stats.dominant_options()
        evicted_now: list[int] = []
        for nid in advice.evicted:
            self.dg.unmaterialize(nid, self.pool)
            self.pinned.pop(nid, None)
            evicted_now.append(nid)
        # kept pins whose stored columns no longer cover the dominant
        # options are useless as plan sources — re-pin with fresh columns
        for nid in advice.chosen:
            if nid in self.pinned and nid not in advice.added:
                info = self.dg.nodes[nid]
                if not (set(options.node_cols) <= set(info.mat_node_cols or ())
                        and set(options.edge_cols)
                        <= set(info.mat_edge_cols or ())):
                    self.dg.unmaterialize(nid, self.pool)
                    self.pinned.pop(nid, None)
                    evicted_now.append(nid)
                    advice.added.append(nid)
        self.pool.cleaner(force=True)
        for nid in advice.added:
            if self.dg.nodes[nid].materialized_as is not None:
                # adopting a stale/uncovered pin: release its old plane
                self.dg.unmaterialize(nid, self.pool)
            gid = self.dg.materialize(nid, self.pool, options)
            self.pinned[nid] = gid
            if self.pool.memory_bytes() > budget:
                # over the meter (plane growth granularity) — roll back
                self.dg.unmaterialize(nid, self.pool)
                self.pool.cleaner(force=True)
                self.pinned.pop(nid, None)
                evicted_now.append(nid)
                break
        # chosen reports what actually got pinned (rollback may truncate)
        advice.chosen = [c for c in advice.chosen if c in self.pinned]
        advice.added = [c for c in advice.added if c in self.pinned]
        advice.pool_bytes_after = self.pool.memory_bytes()
        if self.on_evict is not None and evicted_now:
            self.on_evict([n for n in evicted_now if n not in self.pinned])
        self.last_advice = advice
        self._hist_at_plan = self.stats.snapshot()
        self._since_replan = 0
        return advice

    def replan(self, budget_bytes: int | None = None) -> Advice:
        return self.apply(self.plan(budget_bytes), budget_bytes)

    # -- online hook ---------------------------------------------------------
    def on_query(self, n: int = 1) -> Advice | None:
        """Called by GraphManager after each retrieval; replans every
        ``replan_every`` queries, or immediately when the histogram has
        drifted past ``drift_threshold`` since the last plan.  Batched
        retrievals pass ``n`` = number of queries served so the replan
        cadence is per-query, not per-batch."""
        self._since_replan += int(n)
        if self._since_replan < self.config.replan_every:
            if (self.pinned
                    and self.stats.drift(self._hist_at_plan)
                    > self.config.drift_threshold
                    and self._since_replan >= 8):
                return self.replan()
            return None
        return self.replan()


