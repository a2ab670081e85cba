"""BatchingScheduler: cross-client co-batching with SLO admission control.

The socket server (:mod:`repro_torch.launch.server`) accepts one NDJSON session
per connection; every parsed :class:`~repro_torch.api.document.GraphQuery`
lands here.  The scheduler holds arriving documents in a small *batching
window* (``window_ms``, ~2ms), groups co-plannable documents **across
clients** by the same compatibility key ``run_batch`` uses for a
single-client chunk (attr columns / ``use_current`` / ``no_cache``), and
dispatches each group as **one** merged Steiner plan on a worker pool —
so the multi-query optimization that gives batched multipoint retrieval
its win (BENCH_retrieval.json) is realized over *concurrent clients*,
not just documents that happen to share a stdin chunk.  Responses are
demultiplexed back through per-request futures, so each session writes
its own envelopes in its own request order.

SLO machinery, layered in dispatch order:

* **Admission control** (at ``submit``): when queued work — queue depth x
  estimated plan cost, converted to seconds through an EWMA of the
  observed cost-units-per-second execution rate — exceeds the configured
  drain horizon (``admit_horizon_ms``), the request is shed immediately
  with a typed ``overloaded`` envelope.  Shedding keeps the p99 of
  *admitted* requests bounded as offered load passes capacity
  (the shed-vs-meltdown gate in BENCH_server.json).

* **Deadline control** (at dispatch): a request carrying ``deadline_ms``
  is checked against the planner's decode-aware cost model *before*
  execution — the group's timepoints are planned (pure index work, no KV
  traffic) and a request whose estimated execution time already exceeds
  its remaining budget is rejected with a ``deadline`` envelope instead
  of executed and discarded.  Requests that expired while queued are
  rejected the same way.  Deadline-rejected requests consume **no** KV
  gets (gated in BENCH_server.json).

* **Backpressure** is session-level (lease bytes against the GraphPool
  budget) and lives in :mod:`repro_torch.launch.server`.

``window_ms=0`` disables cross-client merging: every request dispatches
as its own single-document group (the honest baseline the co-batching
gate compares against).  ``run_wave(docs)`` is the synchronous entry the
stdin fallback uses: one chunk of lines = one arrival wave, grouped and
executed inline — the stdin loop and the socket server share this one
code path.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Sequence

from ..core.errors import DeadlineError, OverloadedError
from .document import GraphQuery

if TYPE_CHECKING:  # pragma: no cover
    from .compiler import CompiledQuery
    from .service import QueryResult, QueryService


class _Request:
    """One in-flight document: compiled form + resolution future."""

    __slots__ = ("doc", "compiled", "future", "arrival", "cost_est")

    def __init__(self, doc: GraphQuery, compiled: "CompiledQuery | None",
                 arrival: float) -> None:
        self.doc = doc
        self.compiled = compiled
        self.future: Future = Future()
        self.arrival = arrival          # perf_counter at enqueue
        self.cost_est: float | None = None


class _Ewma:
    """Thread-safe exponential moving average with a sane prior."""

    def __init__(self, prior: float, alpha: float = 0.2) -> None:
        self.value = float(prior)
        self.alpha = float(alpha)
        self._lock = threading.Lock()

    def update(self, x: float) -> None:
        with self._lock:
            self.value += self.alpha * (float(x) - self.value)


class BatchingScheduler:
    """Co-batching dispatch queue in front of one
    :class:`~repro_torch.api.service.QueryService` (see module docstring).

    * ``window_ms`` — batching window: how long arrivals accumulate
      before a dispatch wave (0 = no cross-client merging).
    * ``workers`` — executor pool size for dispatched groups.
    * ``admit_horizon_ms`` — admission control: shed when the queue's
      estimated drain time exceeds this.  ``<= 0`` disables shedding.
    * ``max_queue`` — hard queue-depth backstop regardless of cost.
    """

    def __init__(self, service: "QueryService", *, window_ms: float = 2.0,
                 workers: int = 4, admit_horizon_ms: float = 250.0,
                 max_queue: int = 4096) -> None:
        self.service = service
        self.window_ms = float(window_ms)
        self.admit_horizon_ms = float(admit_horizon_ms)
        self.max_queue = int(max_queue)
        self._queue: deque[_Request] = deque()
        self._queued_cost = 0.0
        # cost dispatched to the worker pool but not yet executed —
        # admission must see the pool's backlog too, or everything past
        # the window looks like an empty queue and the drain-horizon
        # bound silently stops holding
        self._inflight_cost = 0.0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(workers)),
            thread_name_prefix="query-sched")
        self._dispatcher: threading.Thread | None = None
        # cost-units-per-second execution rate (decode-aware plan-cost
        # units, core/planir EdgeInfo.weight) and per-point cost priors;
        # both learned online from executed groups
        self.cost_rate = _Ewma(5e6)
        self.point_cost = _Ewma(1e3)
        self.solo_s = _Ewma(5e-3)       # non-point docs (interval/evolve)
        self.stats_lock = threading.Lock()
        self.counters = {"submitted": 0, "executed": 0, "groups": 0,
                         "co_batched_docs": 0, "shed_overload": 0,
                         "shed_deadline": 0, "max_group": 0}

    # ------------------------------------------------------------ lifecycle
    def _ensure_dispatcher(self) -> None:
        if self._dispatcher is None or not self._dispatcher.is_alive():
            with self._lock:
                if self._dispatcher is None or \
                        not self._dispatcher.is_alive():
                    self._dispatcher = threading.Thread(
                        target=self._dispatch_loop,
                        name="query-sched-dispatch", daemon=True)
                    self._dispatcher.start()

    def close(self) -> None:
        """Stop the dispatcher, fail queued requests with ``overloaded``
        envelopes, and join the worker pool (idempotent)."""
        self._stop.set()
        self._wake.set()
        d = self._dispatcher
        if d is not None:
            d.join(timeout=10)
            self._dispatcher = None
        with self._lock:
            drained = list(self._queue)
            self._queue.clear()
            self._queued_cost = 0.0
        for req in drained:
            self._resolve_error(req, OverloadedError(
                "server shutting down"))
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "BatchingScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ admission
    def _estimate_cost(self, cq: "CompiledQuery | None") -> float:
        """Queue-time cost estimate in plan-cost units (cheap: EWMA'd
        per-point prior, no planning on the submit path)."""
        if cq is None:
            return 0.0
        n = len(cq.point_times)
        if n == 0:   # interval/evolve: convert the time prior to units
            return self.solo_s.value * self.cost_rate.value
        return n * self.point_cost.value

    def submit(self, doc: GraphQuery,
               compiled: "CompiledQuery | None" = None) -> Future:
        """Enqueue one document; returns a Future resolving to a
        :class:`~repro_torch.api.service.QueryResult` (never raises — compile
        failures, sheds and deadline misses resolve to error envelopes).
        """
        arrival = time.perf_counter()
        with self.stats_lock:
            self.counters["submitted"] += 1
        if self._stop.is_set():
            req = _Request(doc, None, arrival)
            self._resolve_error(req, OverloadedError("scheduler closed"))
            return req.future
        if compiled is None:
            try:
                compiled = self.service.compiler.compile(doc)
            except Exception as e:
                req = _Request(doc, None, arrival)
                self._resolve_error(req, e)
                return req.future
        req = _Request(doc, compiled, arrival)
        req.cost_est = self._estimate_cost(compiled)
        with self._lock:
            over = (len(self._queue) >= self.max_queue
                    or (self.admit_horizon_ms > 0
                        and self._queued_cost + self._inflight_cost
                        + req.cost_est
                        > self.cost_rate.value
                        * self.admit_horizon_ms / 1e3))
            if not over:
                self._queue.append(req)
                self._queued_cost += req.cost_est
        if over:
            with self.stats_lock:
                self.counters["shed_overload"] += 1
            self._resolve_error(req, OverloadedError(
                f"admission control: queued work exceeds the "
                f"{self.admit_horizon_ms:.0f}ms drain horizon"))
            return req.future
        self._wake.set()
        self._ensure_dispatcher()
        return req.future

    # ------------------------------------------------------------- dispatch
    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            if not self._wake.wait(timeout=0.2):
                continue
            self._wake.clear()
            if self.window_ms > 0:
                # the batching window: let concurrent arrivals accumulate
                time.sleep(self.window_ms / 1e3)
            with self._lock:
                wave = list(self._queue)
                self._queue.clear()
                self._queued_cost = 0.0
            if wave:
                self._dispatch_wave(wave)

    def _dispatch_wave(self, wave: list[_Request]) -> None:
        """Group a wave by co-batching key and hand each group to the
        worker pool.  ``window_ms=0`` ⇒ every request is its own group."""
        units: list[list[_Request]] = []
        if self.window_ms <= 0:
            units = [[r] for r in wave]
        else:
            groups: dict[tuple, list[_Request]] = {}
            solo: list[list[_Request]] = []
            for r in wave:
                key = r.compiled.point_group
                if key is None:
                    solo.append([r])
                else:
                    groups.setdefault(key, []).append(r)
            units = list(groups.values()) + solo
        for unit in units:
            cost = sum(r.cost_est or 0.0 for r in unit)
            with self._lock:
                self._inflight_cost += cost
            self._pool.submit(self._run_unit, unit, cost)

    # ------------------------------------------------------------ execution
    def _plan_cost(self, cq: "CompiledQuery") -> float:
        """The planner's decode-aware cost of this document's own
        retrieval (``α·stored + β·logical`` units) — pure index work
        against the pinned epoch, no KV traffic."""
        gm = self.service.gm
        with gm.epochs.acquire() as pin:
            ir = pin.data.dg.plan_multipoint(
                list(cq.point_times), cq.options, cq.doc.use_current)
            return float(ir.total_weight)

    def _check_deadline(self, req: _Request, now: float) -> bool:
        """True if the request may execute; False ⇒ resolved with a
        ``deadline`` error envelope (no KV gets were performed)."""
        d = req.doc.deadline_ms
        if d is None:
            return True
        remaining = d / 1e3 - (now - req.arrival)
        if remaining <= 0:
            self._reject_deadline(req, f"deadline_ms={d:g} expired in "
                                       f"queue")
            return False
        if req.compiled is not None and req.compiled.point_times:
            cost = self._plan_cost(req.compiled)
            est = cost / max(self.cost_rate.value, 1e-9)
            if est > remaining:
                self._reject_deadline(
                    req, f"plan cost {cost:.0f} units "
                         f"(~{est * 1e3:.1f}ms at the current rate) "
                         f"exceeds remaining budget "
                         f"{remaining * 1e3:.1f}ms of deadline_ms={d:g}")
                return False
        return True

    def _reject_deadline(self, req: _Request, msg: str) -> None:
        with self.stats_lock:
            self.counters["shed_deadline"] += 1
        self._resolve_error(req, DeadlineError(msg))

    def _run_unit(self, unit: list[_Request],
                  inflight_cost: float = 0.0) -> None:
        try:
            self._run_unit_inner(unit)
        finally:
            if inflight_cost:
                with self._lock:
                    self._inflight_cost = max(
                        0.0, self._inflight_cost - inflight_cost)

    def _run_unit_inner(self, unit: list[_Request]) -> None:
        try:
            now = time.perf_counter()
            live = [r for r in unit if self._check_deadline(r, now)]
            if not live:
                return
            t0 = time.perf_counter()
            results = self._execute(live)
            wall = time.perf_counter() - t0
            self._learn(live, results, wall)
            for req, res in zip(live, results):
                if not req.future.done():
                    req.future.set_result(res)
            with self.stats_lock:
                self.counters["executed"] += len(live)
                self.counters["groups"] += 1
                if len(live) > 1:
                    self.counters["co_batched_docs"] += len(live)
                self.counters["max_group"] = max(
                    self.counters["max_group"], len(live))
        except Exception as e:  # pragma: no cover - defensive backstop
            for req in unit:
                self._resolve_error(req, e)

    def _execute(self, live: list[_Request]) -> "list[QueryResult]":
        svc = self.service
        groupable = [r for r in live if r.compiled.point_group is not None]
        if len(groupable) == len(live) and len(live) > 1:
            return svc.run_group([r.compiled for r in live],
                                 on_error="envelope")
        out = []
        for r in live:
            try:
                out.append(svc._execute(r.compiled))
            except Exception as e:
                out.append(svc._error_result(r.doc, e))
        return out

    def _learn(self, live: list[_Request],
               results: "list[QueryResult]", wall: float) -> None:
        """Update the cost model from an executed unit."""
        cost = 0.0
        points = 0
        for req, res in zip(live, results):
            if res.ok:
                cost += float(res.stats.get("plan_cost", 0.0) or 0.0)
                points += len(req.compiled.point_times)
        if wall <= 0:
            return
        if cost > 0:
            self.cost_rate.update(cost / wall)
            if points:
                self.point_cost.update(cost / points)
        elif points == 0 and live:
            self.solo_s.update(wall / len(live))

    # ------------------------------------------------------- synchronous path
    def run_wave(self, items: Sequence[Any]) -> "list[QueryResult]":
        """Synchronously execute one arrival wave — the stdin fallback's
        chunk loop.  ``items`` are :class:`GraphQuery` documents or
        already-made :class:`QueryResult` error envelopes (malformed
        lines); results come back in input order.  Grouping matches the
        async dispatcher's (and ``run_batch``'s) co-batching key."""
        from .service import QueryResult
        results: list[Any] = [None] * len(items)
        reqs: list[tuple[int, _Request]] = []
        arrival = time.perf_counter()
        for i, item in enumerate(items):
            if isinstance(item, QueryResult):
                results[i] = item
                continue
            try:
                cq = self.service.compiler.compile(item)
            except Exception as e:
                results[i] = self.service._error_result(item, e)
                continue
            reqs.append((i, _Request(item, cq, arrival)))
        groups: dict[tuple, list[tuple[int, _Request]]] = {}
        solos: list[tuple[int, _Request]] = []
        for i, r in reqs:
            key = r.compiled.point_group
            if key is None:
                solos.append((i, r))
            else:
                groups.setdefault(key, []).append((i, r))
        now = time.perf_counter()
        for unit in list(groups.values()) + [[s] for s in solos]:
            live = [(i, r) for i, r in unit
                    if self._check_deadline(r, now)]
            for i, r in unit:
                if r.future.done():     # deadline-rejected above
                    results[i] = r.future.result()
            if not live:
                continue
            t0 = time.perf_counter()
            res = self._execute([r for _, r in live])
            self._learn([r for _, r in live], res,
                        time.perf_counter() - t0)
            for (i, _), rr in zip(live, res):
                results[i] = rr
        return results

    # ---------------------------------------------------------------- stats
    def snapshot_stats(self) -> dict:
        with self.stats_lock:
            out = dict(self.counters)
        out["cost_rate_units_per_s"] = self.cost_rate.value
        out["point_cost_units"] = self.point_cost.value
        with self._lock:
            out["queue_depth"] = len(self._queue)
            out["inflight_cost"] = self._inflight_cost
        return out

    # ---------------------------------------------------------------- errors
    def _resolve_error(self, req: _Request, e: Exception) -> None:
        if not req.future.done():
            req.future.set_result(
                self.service._error_result(req.doc, e))
