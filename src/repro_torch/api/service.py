"""QueryService: execute GraphQuery documents with a uniform result
envelope.

``run(doc)`` compiles and executes one document; ``run_batch(docs)``
additionally *merges* co-batched point documents (snapshot / multipoint /
expr sharing attr options + consistency hints) into **one** Steiner plan,
the multi-query optimization ``GraphManager.get_snapshots`` applies to a
plain time batch — here applied across whole documents arriving on the
wire.

Every execution returns a :class:`QueryResult` carrying the payload plus
execution stats: KV gets/bytes (store-counter deltas — exact single-
threaded, best-effort attribution under concurrent serving), planner cost
(decode-aware ``α·stored + β·logical`` units), snapshot-cache hits, and
wall time.  ``to_dict()``/``to_json()`` render the JSON wire envelope::

    {"v": 1, "ok": true, "kind": "multipoint",
     "result": {"points": [{"t": 50, "nodes": 132, "edges": 410,
                            "node_crc": 2186839876, ...}]},
     "stats": {"wall_s": 0.003, "kv_gets": 12, "kv_bytes": 18944,
               "plan_cost": 25310.0, "cache_hits": 0, "merged_docs": 2}}

Errors become ``{"ok": false, "error": {"kind": ..., "message": ...,
"position": ...}}`` envelopes via the typed taxonomy
(:mod:`repro_torch.core.errors`).

The retrieval core (:meth:`QueryService.retrieve_points`) is the single
implementation of cached + advised + batched snapshot retrieval; the
legacy ``GraphManager.get_snapshot(s)`` entry points are thin shims over
it, so results stay bit-identical across the old and new surfaces
(``tests/test_query_service.py``).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

from ..core.errors import ExecutionError, QueryError
from ..core.materialize import SnapshotCache
from ..core.query import AttrOptions
from .compiler import CompiledQuery, QueryCompiler
from .document import GraphQuery

if TYPE_CHECKING:  # pragma: no cover
    from ..core.events import MaterializedState
    from ..core.manager import GraphManager
    from ..core.temporal import EvolveResult, TemporalEngine


# ---------------------------------------------------------------------------
# result envelope
# ---------------------------------------------------------------------------


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _state_payload(st: "MaterializedState", full: bool,
                   with_attrs: bool = False) -> dict:
    """Wire form of a MaterializedState: counts + CRCs (summary) or live
    slot lists (full) — full bitmaps don't belong in a JSON envelope.
    ``attr_crc`` is computed only when the document fetched attributes
    (hashing all-NaN padding would cost more than the whole retrieval)."""
    out = {"nodes": int(st.node_mask.sum()),
           "edges": int(st.edge_mask.sum()),
           "node_crc": _crc(np.packbits(st.node_mask)),
           "edge_crc": _crc(np.packbits(st.edge_mask))}
    if with_attrs:
        out["attr_crc"] = _crc(st.node_attrs) ^ _crc(st.edge_attrs)
    if full:
        out["node_slots"] = np.nonzero(st.node_mask)[0].tolist()
        out["edge_slots"] = np.nonzero(st.edge_mask)[0].tolist()
    return out


def _jsonable(v: Any, full: bool) -> Any:
    """Best-effort JSON projection of an operator value: arrays summarize
    to size+CRC unless ``full``."""
    if isinstance(v, np.ndarray):
        if full:
            return v.tolist()
        return {"size": int(v.size), "dtype": str(v.dtype), "crc": _crc(v)}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x, full) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x, full) for x in v]
    return v


@dataclasses.dataclass
class QueryResult:
    """Uniform result envelope: payload + execution stats (+ error)."""

    kind: str | None
    ok: bool
    value: Any
    stats: dict
    error: QueryError | None = None
    query: GraphQuery | None = None

    def _payload(self, full: bool) -> Any:
        v = self.value
        q = self.query
        wa = bool(q is not None and (q.attrs.wants_attrs
                                     if isinstance(q.attrs, AttrOptions)
                                     else q.attrs))
        if self.kind == "snapshot":
            return dict(t=q.t if q else None, **_state_payload(v, full, wa))
        if self.kind == "multipoint":
            return {"points": [dict(t=int(t), **_state_payload(st, full, wa))
                               for t, st in v.items()]}
        if self.kind == "expr":
            return dict(expr=q.expr if q else None,
                        times=list(q.times) if q else None,
                        **_state_payload(v, full, wa))
        if self.kind == "interval":
            return {k: np.asarray(a).tolist() for k, a in v.items()}
        if self.kind == "evolve":
            return {"times": [int(t) for t in v.times],
                    "incremental": bool(v.stats.get("incremental", True)),
                    "values": [_jsonable(x, full) for x in v.values],
                    "engine_stats": _jsonable(v.stats, False)}
        return _jsonable(v, full)

    def to_dict(self) -> dict:
        if not self.ok:
            out = {"v": 1, "ok": False, "kind": self.kind,
                   "error": self.error.to_dict()}
        else:
            full = bool(self.query is not None
                        and self.query.reply == "full")
            out = {"v": 1, "ok": True, "kind": self.kind,
                   "result": self._payload(full),
                   "stats": _jsonable(self.stats, False)}
        # correlation id echo (cross-wiring oracle under concurrent
        # serving): every envelope names the request it answers
        if self.query is not None and self.query.id is not None:
            out["id"] = self.query.id
        return out

    def to_json(self) -> str:
        import json
        return json.dumps(self.to_dict(), sort_keys=True)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


class _StatClock:
    """Wall + KV-counter delta around one execution (best-effort under
    concurrency: store counters are process-global)."""

    def __init__(self, store) -> None:
        self._store = store
        self.g0 = store.stats.gets
        self.b0 = store.stats.bytes_read
        self.t0 = time.perf_counter()

    def done(self) -> dict:
        return {"wall_s": time.perf_counter() - self.t0,
                "kv_gets": self._store.stats.gets - self.g0,
                "kv_bytes": self._store.stats.bytes_read - self.b0}


class QueryService:
    """Runs GraphQuery documents against one :class:`GraphManager`."""

    def __init__(self, gm: "GraphManager") -> None:
        self.gm = gm
        self.compiler = QueryCompiler(gm.universe)

    # -- engines ------------------------------------------------------------
    def temporal_engine(self) -> "TemporalEngine":
        if self.gm._temporal is None:
            from ..core.temporal import TemporalEngine
            self.gm._temporal = TemporalEngine(self.gm)
        return self.gm._temporal

    # -- the single snapshot-retrieval implementation ------------------------
    def retrieve_points(self, times: Sequence[int], options: AttrOptions,
                        use_current: bool = True, no_cache: bool = False,
                        pin=None,
                        ) -> tuple[dict[int, "MaterializedState"], dict]:
        """Cached + advised + batched retrieval of ``times``: cache hits
        split off, misses become one merged Steiner plan executed with
        async KV prefetch.  Returns ``(states, stats)``; results are
        bit-identical to a cold ``DeltaGraph.get_snapshot`` per point.

        The whole call resolves against one epoch-pinned index version
        (``core/epoch.py``): the caller's ``pin`` if given (so a document
        retrieves and finishes on the same version), else one acquired
        here.  Cache keys carry an epoch tag — results at times below the
        ingest watermark are stable across epochs, results at/past it
        (plans crossing CURRENT / the unfolded tail) only hit within the
        epoch that produced them."""
        gm = self.gm
        times = [int(t) for t in dict.fromkeys(int(t) for t in times)]
        own_pin = pin is None
        if own_pin:
            pin = gm.epochs.acquire()
        try:
            dg = pin.data.dg
            watermark = pin.data.max_time

            def key_for(t: int) -> tuple:
                tag = (SnapshotCache.STABLE if t < watermark else pin.id)
                return SnapshotCache.key(t, options, use_current, tag)

            out: dict[int, "MaterializedState"] = {}
            stats = {"cache_hits": 0, "plan_cost": 0.0, "payload_fetches": 0,
                     "plan_steps": 0, "epoch": pin.id,
                     "epoch_events": pin.data.n_events}
            misses: list[int] = []
            for t in times:
                if gm.cache is not None and not no_cache:
                    hit = gm.cache.get(key_for(t))
                    if hit is not None:
                        gm.workload.record_cache_hit()
                        stats["cache_hits"] += 1
                        # live ingest may have grown the slot universe
                        # since the entry was cached
                        out[t] = hit.resized(gm.universe)
                        continue
                misses.append(t)
            if misses:
                plan = dg.plan_multipoint(misses, options, use_current)
                if gm.sharded is not None:
                    # sharded multi-worker path (runtime/shard.py): scatter
                    # the merged plan across the shard-executor pool and
                    # gather the per-shard slot results — bit-identical to
                    # the unsharded execution below
                    states = gm.sharded.execute(dg, plan, options,
                                                pool=gm.pool)
                    stats.update({f"shard_{k}": v for k, v in
                                  gm.sharded.last_stats.items()})
                else:
                    # prefetch for batch-shaped queries (even when cache
                    # hits leave a single miss) — legacy ``get_snapshots``
                    # parity; a lone singlepoint query stays synchronous
                    # (``get_snapshot`` parity: thread-queue latency beats
                    # overlap on fast stores)
                    pf = gm.prefetcher if len(times) > 1 else None
                    states = dg.execute(plan, options, pool=gm.pool,
                                        prefetch=pf)
                # per-target deps: only the pins on a target's own branch
                # invalidate its entry, not every pin the batch touched
                deps = plan.per_target_source_nids()
                for t in misses:
                    out[t] = states[t]
                    if gm.cache is not None:
                        gm.cache.put(key_for(t), states[t], deps=deps.get(t))
                cs = plan.cost_summary()
                stats["plan_cost"] += cs["plan_cost"]
                stats["payload_fetches"] += cs["payload_fetches"]
                stats["plan_steps"] += cs["plan_steps"]
                if gm.advisor is not None:
                    with gm._advisor_lock:
                        if gm.advisor is not None:
                            gm.advisor.on_query(n=len(misses))
            return out, stats
        finally:
            if own_pin:
                pin.release()

    # -- execution ----------------------------------------------------------
    def _execute(self, cq: CompiledQuery) -> QueryResult:
        clock = _StatClock(self.gm.store)
        pts = cq.point_times
        # one pin for the whole document: retrieval and finish() (interval /
        # evolve engine calls included) resolve against one index version
        with self.gm.epochs.acquire() as pin:
            if pts:
                states, rstats = self.retrieve_points(
                    pts, cq.options, cq.doc.use_current, cq.doc.no_cache,
                    pin=pin)
                value = cq.finish(self, states, dg=pin.data.dg)
            else:
                rstats = {"epoch": pin.id, "epoch_events": pin.data.n_events}
                value = cq.finish(self, None, dg=pin.data.dg)
        stats = {**clock.done(), **rstats, "targets": len(pts)}
        return QueryResult(cq.kind, True, value, stats, query=cq.doc)

    def run(self, doc: GraphQuery) -> QueryResult:
        """Compile + execute one document.  Raises typed
        :class:`~repro_torch.core.errors.QueryError` subclasses on bad
        documents; execution exceptions propagate unchanged (the legacy
        shims depend on that).  Use :meth:`run_safe` /
        ``run_batch(on_error="envelope")`` for wire serving."""
        return self._execute(self.compiler.compile(doc))

    def run_safe(self, doc: GraphQuery) -> QueryResult:
        """Like :meth:`run` but never raises: any failure becomes an
        error envelope (non-QueryError exceptions wrapped as
        :class:`~repro_torch.core.errors.ExecutionError`)."""
        try:
            return self.run(doc)
        except Exception as e:
            return self._error_result(doc, e)

    @staticmethod
    def _error_result(doc: Any, e: Exception) -> QueryResult:
        err = e if isinstance(e, QueryError) else ExecutionError(
            f"{type(e).__name__}: {e}")
        if not isinstance(e, QueryError):
            err.__cause__ = e
        kind = getattr(doc, "kind", None)
        q = doc if isinstance(doc, GraphQuery) else None
        return QueryResult(kind, False, None, {}, error=err, query=q)

    def run_group(self, compiled: Sequence[CompiledQuery], *,
                  on_error: str = "envelope") -> list[QueryResult]:
        """Execute co-plannable compiled documents (same
        :attr:`CompiledQuery.point_group`) as **one** merged retrieval:
        their timepoints union into one Steiner plan, then each document
        finishes from the shared states.  Response ordering is pinned to
        input order.  Failure isolation: a retrieval failure fails every
        member (the plan was shared), but a ``finish`` failure — one
        poisoned document — yields an error envelope for that document
        *only*, without dropping its groupmates' results.  Group stats are
        shared (``merged_docs`` / union ``targets``); each envelope also
        carries its own ``doc_targets`` attribution."""
        times = list(dict.fromkeys(
            t for cq in compiled for t in cq.point_times))
        try:
            clock = _StatClock(self.gm.store)
            cq0 = compiled[0]
            with self.gm.epochs.acquire() as pin:
                states, rstats = self.retrieve_points(
                    times, cq0.options, cq0.doc.use_current,
                    cq0.doc.no_cache, pin=pin)
                stats = {**clock.done(), **rstats,
                         "targets": len(times),
                         "merged_docs": len(compiled)}
                results: list[QueryResult] = []
                for cq in compiled:
                    try:
                        value = cq.finish(self, states, dg=pin.data.dg)
                    except Exception as e:
                        if on_error == "raise":
                            raise
                        results.append(self._error_result(cq.doc, e))
                        continue
                    results.append(QueryResult(
                        cq.kind, True, value,
                        dict(stats,
                             doc_targets=len(cq.point_times)),
                        query=cq.doc))
                return results
        except Exception as e:
            if on_error == "raise":
                raise
            return [self._error_result(cq.doc, e) for cq in compiled]

    def run_batch(self, docs: Sequence[GraphQuery], *,
                  on_error: str = "raise") -> list[QueryResult]:
        """Execute a batch of documents, merging co-plannable point
        documents (same attr options / ``use_current`` / ``no_cache``)
        into one Steiner plan per group.  Results come back in input
        order; grouped documents share the group's stats (tagged with
        ``merged_docs``).  ``on_error="envelope"`` turns per-document
        failures into error envelopes instead of raising (a bad document
        never poisons the rest of the batch)."""
        if on_error not in ("raise", "envelope"):
            raise ValueError(f"on_error must be 'raise' or 'envelope', "
                             f"got {on_error!r}")
        results: list[QueryResult | None] = [None] * len(docs)
        compiled: dict[int, CompiledQuery] = {}
        for i, doc in enumerate(docs):
            try:
                compiled[i] = self.compiler.compile(doc)
            except Exception as e:
                if on_error == "raise":
                    raise
                results[i] = self._error_result(doc, e)
        groups: dict[tuple, list[int]] = {}
        solo: list[int] = []
        for i, cq in compiled.items():
            key = cq.point_group
            if key is None:
                solo.append(i)
            else:
                groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            group_res = self.run_group([compiled[i] for i in idxs],
                                       on_error=on_error)
            for i, res in zip(idxs, group_res):
                results[i] = res
        for i in solo:
            try:
                results[i] = self._execute(compiled[i])
            except Exception as e:
                if on_error == "raise":
                    raise
                results[i] = self._error_result(docs[i], e)
        return results  # type: ignore[return-value]
