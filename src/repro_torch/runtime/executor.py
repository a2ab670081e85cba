"""Plan-IR execution engine: host backend, async KV prefetch, batching.

Three pieces, all consuming the unified :mod:`repro_torch.core.planir` DAG:

* :class:`Prefetcher` — a thread pool that overlaps ``storage/kv.py`` gets
  with delta/bitmap application.  The executor submits every Fetch node's
  key list up front (the pool's queue preserves plan order, so the fetch
  for step *i+1* streams in while step *i* applies — double-buffering
  payload components along the plan's critical path), then blocks only
  when an apply actually needs its payload.

* :class:`HostExecutor` — the numpy/state backend (attribute-carrying
  retrievals, materialization).  Walks the DAG in topological order;
  Fork nodes alias their parent state (every apply copies-on-write, so
  sibling branches cannot corrupt each other).

* :class:`BatchScheduler` — merges concurrent ``get_snapshot`` /
  multipoint requests into **one** DAG via
  :func:`repro_torch.core.planir.merge_irs`, executes it once, and splits the
  results back per request.  Common subpaths — the skeleton prefix two
  queries share — fetch and apply exactly once for the whole batch.

The device bitmap backend for the same IR lives in
:mod:`repro_torch.runtime.torch_exec` (``execute_ir_torch``); host and device
execution are two backends of one plan representation.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

from ..core.deltas import apply_delta
from ..core.events import MaterializedState, apply_events
from ..core.planir import (ApplyDelta, ApplyElist, ApplyRecent, Fetch, Fork,
                           Materialize, Noop, PlanIR, Source, merge_irs)
from ..core.query import NO_ATTRS, AttrOptions

if TYPE_CHECKING:  # pragma: no cover
    from ..core.deltagraph import DeltaGraph


# ---------------------------------------------------------------------------
# async KV prefetch
# ---------------------------------------------------------------------------


class Prefetcher:
    """Thread-pooled async multi-get (+ decode) over a KV store.

    ``submit(keys)`` returns a future resolving to the blob list (``None``
    for missing components, matching ``DeltaGraph._mget``); with a
    ``decode`` callable the worker thread also runs the codec-layer
    decompression/deserialization, so the future resolves straight to the
    decoded payload and the apply thread never touches raw blobs.  The
    store's stats counters are lock-protected (``storage.kv.KVStats``), so
    concurrent prefetch threads account bytes correctly.
    """

    def __init__(self, store, workers: int = 4) -> None:
        self.store = store
        self.workers = int(workers)
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="kv-prefetch")
            return self._pool

    def submit(self, keys: list, decode=None) -> "Future":
        from ..storage.kv import mget_optional
        store = self.store

        def _work():
            self._install_nice()
            blobs = mget_optional(store, keys)
            return decode(blobs) if decode is not None else blobs

        return self._ensure_pool().submit(_work)

    def submit_fn(self, fn, *args) -> "Future":
        """Run an arbitrary callable on a prefetch worker (with the
        cooperative decode-yield installed).  The device pipeline uses this
        to build the *next* host-side plane chunk while the current chunk's
        kernels run."""
        def _work():
            self._install_nice()
            return fn(*args)

        return self._ensure_pool().submit(_work)

    @staticmethod
    def _install_nice() -> None:
        # Idempotent per worker thread: between-array decode yields keep
        # codec work from monopolizing the GIL against the apply thread.
        from ..storage import codec
        import time
        codec.set_decode_nice(lambda: time.sleep(0))

    def close(self, wait: bool = False) -> None:
        """``wait=True`` drains in-flight fetches first — required before
        closing the underlying store (a worker mid-get would otherwise
        read from closed file handles)."""
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown(wait=wait)
                self._pool = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# host backend
# ---------------------------------------------------------------------------


class HostExecutor:
    """Execute a :class:`PlanIR` on the host (numpy states, full attribute
    support).  Semantically identical to the pre-IR ``DeltaGraph.execute``;
    additionally fetches each payload once per plan and can overlap fetches
    with application through a :class:`Prefetcher`."""

    def __init__(self, dg: "DeltaGraph", prefetcher: Prefetcher | None = None,
                 mget=None) -> None:
        self.dg = dg
        self.prefetcher = prefetcher
        # pluggable payload fetch (``keys -> list[bytes|None]``): the
        # sharded transports route each Fetch to the replica serving its
        # partitions; None keeps the direct store path (``dg._mget``)
        self.mget = mget if mget is not None else dg._mget
        self._routed = mget is not None

    # -- payload fetch plumbing --------------------------------------------
    def _fetch_keys(self, op: Fetch, options: AttrOptions):
        # a scattered (per-shard) plan restricts each Fetch to the
        # partitions the shard owns; unsharded plans carry parts=None
        if op.kind == "delta":
            keys, na, ea = self.dg._delta_keys(op.pid, options,
                                               parts=op.parts)
            return keys + na + ea, (len(keys), len(na))
        return self.dg._elist_keys(op.pid, options, parts=op.parts), None

    def _decode(self, op: Fetch, keys: list, meta, blobs: list):
        if op.kind == "delta":
            n_struct, n_na = meta
            return self.dg._decode_delta(blobs, n_struct, n_na)
        return self.dg._decode_elist(keys, blobs)

    # -- main walk ----------------------------------------------------------
    def run(self, ir: PlanIR, options: AttrOptions = NO_ATTRS,
            pool=None) -> dict[Any, MaterializedState]:
        dg = self.dg
        uni = dg.universe
        byid = {n.nid: n for n in ir.nodes}

        # fetches are issued a bounded window ahead of the apply cursor
        # (plan order == application order): enough in flight to overlap
        # every store get *and decode* with application, without ever
        # holding more than ~window payloads resident.  Decoded payloads
        # are dropped after their last consumer, so peak memory stays a
        # window deep — not the whole merged plan's KV traffic.
        pending: dict[int, tuple] = {}     # fetch nid -> (keys, meta)
        futures: dict[int, Any] = {}       # fetch nid -> in-flight future
        consumers: dict[int, int] = {}
        fetch_order: list[int] = []
        for n in ir.nodes:
            if isinstance(n.op, Fetch):
                pending[n.nid] = self._fetch_keys(n.op, options)
                fetch_order.append(n.nid)
            else:
                for d in n.deps:
                    if d in pending:
                        consumers[d] = consumers.get(d, 0) + 1

        window = (max(2 * self.prefetcher.workers, 4)
                  if self.prefetcher is not None else 0)
        next_submit = 0

        def top_up() -> None:
            nonlocal next_submit
            while (next_submit < len(fetch_order)
                   and len(futures) < window):
                nid = fetch_order[next_submit]
                next_submit += 1
                if nid in pending:      # not consumed out of order yet
                    keys, meta = pending[nid]
                    op = byid[nid].op
                    # decode runs inside the prefetch worker: the future
                    # resolves to arrays, not raw blobs
                    if self._routed:
                        # routed fetch: the worker thread calls the
                        # transport's mget, not the store directly
                        futures[nid] = self.prefetcher.submit_fn(
                            lambda op=op, keys=keys, meta=meta:
                                self._decode(op, keys, meta,
                                             self.mget(keys)))
                    else:
                        futures[nid] = self.prefetcher.submit(
                            keys,
                            decode=lambda blobs, op=op, keys=keys, meta=meta:
                                self._decode(op, keys, meta, blobs))

        if window:
            top_up()

        payloads: dict[int, Any] = {}

        def payload(nid: int):
            if nid not in payloads:
                keys, meta = pending.pop(nid)
                fut = futures.pop(nid, None)
                if fut is not None:
                    payloads[nid] = fut.result()   # decoded off-thread
                else:
                    payloads[nid] = self._decode(byid[nid].op, keys, meta,
                                                 self.mget(keys))
                if window:
                    top_up()
            out = payloads[nid]
            consumers[nid] -= 1
            if consumers[nid] <= 0:
                del payloads[nid]
            return out

        states: dict[int, MaterializedState] = {}
        out: dict[Any, MaterializedState] = {}
        for n in ir.nodes:
            op = n.op
            if isinstance(op, Fetch):
                continue
            if isinstance(op, Source):
                if op.kind == "empty":
                    st = MaterializedState.empty(uni)
                elif op.kind == "mat":
                    assert pool is not None, \
                        "materialized plan needs a GraphPool"
                    st = pool.get_state(op.gid,
                                        with_attrs=options.wants_attrs)
                else:  # current
                    base = dg._last_leaf_state.resized(uni).copy()
                    st = apply_events(base, dg.recent, forward=True)
            elif isinstance(op, Fork):
                st = states[n.deps[0]]          # alias; applies copy
            elif isinstance(op, Noop):
                st = states[self._state_dep(byid, n)].copy()
            elif isinstance(op, ApplyDelta):
                d = payload(self._fetch_dep(byid, n))
                st = apply_delta(
                    states[self._state_dep(byid, n)].resized(uni),
                    d, forward=op.forward)
            elif isinstance(op, ApplyElist):
                comps = payload(self._fetch_dep(byid, n))
                st = dg._apply_elist(
                    states[self._state_dep(byid, n)].resized(uni),
                    comps, op.forward, op.rng, options)
            elif isinstance(op, ApplyRecent):
                base = states[self._state_dep(byid, n)].resized(uni)
                ev = dg.recent
                if op.rng is not None:
                    lo, hi = op.rng
                    a = ev.search_time(lo, side="right")
                    b = ev.search_time(hi, side="right")
                    ev = ev[a:b]
                st = apply_events(base, ev, forward=op.forward)
            elif isinstance(op, Materialize):
                st = states[n.deps[0]].copy()
                st.node_mask &= ~uni.node_transient[: st.node_mask.size]
                st.edge_mask &= ~uni.edge_transient[: st.edge_mask.size]
                out[op.target] = st
                continue
            else:  # pragma: no cover
                raise ValueError(f"unknown IR op {op}")
            states[n.nid] = st
        return out

    @staticmethod
    def _state_dep(byid: dict, n) -> int:
        for d in n.deps:
            if not isinstance(byid[d].op, Fetch):
                return d
        raise ValueError(f"apply node {n.nid} has no state dependency")

    @staticmethod
    def _fetch_dep(byid: dict, n) -> int:
        for d in n.deps:
            if isinstance(byid[d].op, Fetch):
                return d
        raise ValueError(f"apply node {n.nid} has no fetch dependency")


# ---------------------------------------------------------------------------
# batch scheduling
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RetrievalRequest:
    """One logical query in a batch: a set of timepoints (singlepoint is a
    1-element set) under shared attr options."""
    times: Sequence[int]
    use_current: bool = True


class BatchScheduler:
    """Shared-prefix batch execution of concurrent retrieval requests.

    Plans each request, merges the plan DAGs (structural dedup — shared
    subpaths collapse), executes the merged DAG once on the host backend,
    and returns per-request result dicts.  The merged plan's weight is the
    true bytes-to-fetch for the whole batch; the sum of the individual
    plans' weights is what a query-at-a-time engine would have fetched.
    """

    def __init__(self, dg: "DeltaGraph", pool=None,
                 prefetcher: Prefetcher | None = None) -> None:
        self.dg = dg
        self.pool = pool
        self.prefetcher = prefetcher
        self.last_merged: PlanIR | None = None
        self.last_individual_weight = 0.0

    def run(self, requests: Sequence[RetrievalRequest],
            options: AttrOptions = NO_ATTRS
            ) -> list[dict[int, MaterializedState]]:
        irs = []
        for i, r in enumerate(requests):
            times = list(dict.fromkeys(int(t) for t in r.times))
            if not times:
                raise ValueError(f"request #{i} has no timepoints")
            irs.append(self.dg.plan_multipoint(times, options, r.use_current)
                       if len(times) > 1 else
                       self.dg.plan_singlepoint(times[0], options,
                                                r.use_current))
        self.last_individual_weight = sum(ir.total_weight for ir in irs)
        merged = merge_irs(irs)
        self.last_merged = merged
        all_states = self.dg.execute(merged, options, self.pool,
                                     prefetch=self.prefetcher)
        return [{int(t): all_states[int(t)] for t in r.times}
                for r in requests]
