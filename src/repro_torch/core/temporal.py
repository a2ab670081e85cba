"""Incremental temporal analytics over snapshot intervals (paper §1/§4:
"support for temporal and evolutionary queries and analysis").

A per-snapshot analytics loop retrieves *every* timepoint through the
planner and re-runs each algorithm from scratch — O(points) full plans
and O(points) cold solves.  This engine exploits that consecutive
interval timepoints differ by a small slice of the eventlist:

1. only the **first** snapshot of the interval is retrieved through the
   plan IR (cache, advisor, prefetch — the whole PR-2 stack applies);
2. every subsequent timepoint advances the running state by the
   inter-snapshot event slice ``(t_prev, t_cur]`` pulled from the leaf
   eventlists already persisted in the KV store — each covering leaf
   payload is fetched **once per evolve call** (and prefetched
   asynchronously), however many timepoints it spans;
3. analytic state advances *incrementally*: degrees/density update in
   O(|delta|), PageRank warm-starts from the previous ranks with the
   delta-touched frontier reset, connected components re-union only
   affected components, and a generic fold warm-starts
   :func:`repro_torch.graph.pregel.run_pregel_until` supersteps.

Incremental results match a per-snapshot recompute: masks are
bit-identical (same event algebra), fixpoint solvers agree within their
convergence tolerance (``tests/test_differential_exec.py``).

The batched-device counterpart (B intervals at once, batched prefix
bitmap chains) is :func:`repro_torch.runtime.torch_exec.evolve_intervals_torch`.

Device: the engine runs on its manager's ``device`` (``GraphManager
(device=...)``): the fixpoint operators solve there, and
:class:`SnapshotBatchLoader` yields tensors there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np

from ..storage import columnar as col
from .events import (EV_DEL_EDGE, EV_DEL_NODE, EV_NEW_EDGE, EV_NEW_NODE,
                     MaterializedState, apply_events)
from .query import NO_ATTRS, AttrOptions, TimeExpression

# ---------------------------------------------------------------------------
# inter-snapshot event slices
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepDelta:
    """Net structural change over one inter-snapshot slice ``(lo, hi]``.

    ``*_add``/``*_del`` are **net** slot sets computed by ±1 count
    accumulation per slot — an element added *and* deleted inside the
    slice appears in neither (this is what makes the arrays safe for
    incremental operators: a net-zero toggle must not touch degrees)."""
    lo: int
    hi: int
    node_add: np.ndarray
    node_del: np.ndarray
    edge_add: np.ndarray
    edge_del: np.ndarray

    def touched_nodes(self, edge_src: np.ndarray,
                      edge_dst: np.ndarray) -> np.ndarray:
        """Every node whose neighborhood changed — the frontier reset set
        for warm-started solvers."""
        parts = [self.node_add, self.node_del]
        for e in (self.edge_add, self.edge_del):
            if e.size:
                parts.append(edge_src[e])
                parts.append(edge_dst[e])
        return (np.unique(np.concatenate(parts)).astype(np.int64)
                if parts else np.zeros(0, np.int64))

    @property
    def n_changes(self) -> int:
        return (self.node_add.size + self.node_del.size
                + self.edge_add.size + self.edge_del.size)


def _net_quad(etype: np.ndarray, slot: np.ndarray
              ) -> tuple[np.ndarray, ...]:
    """±1-count net membership change per slot (handles slots toggled
    multiple times inside one slice, unlike a plain set difference)."""
    out = []
    for add_code, del_code in ((EV_NEW_NODE, EV_DEL_NODE),
                               (EV_NEW_EDGE, EV_DEL_EDGE)):
        a = slot[etype == add_code]
        d = slot[etype == del_code]
        if a.size == 0 and d.size == 0:
            out.append(np.zeros(0, np.int32))
            out.append(np.zeros(0, np.int32))
            continue
        slots, inv = np.unique(np.concatenate([a, d]), return_inverse=True)
        net = np.zeros(slots.size, np.int64)
        np.add.at(net, inv[: a.size], 1)
        np.add.at(net, inv[a.size:], -1)
        out.append(slots[net > 0].astype(np.int32))
        out.append(slots[net < 0].astype(np.int32))
    return tuple(out)


class IntervalSlicer:
    """Streams ``(lo, hi]`` slices of the history to the engine.

    Fetches each covering leaf-eventlist payload at most once per slicer
    lifetime (an interval whose timepoints fall inside one leaf touches
    the KV store once, not once per point) and, when a
    :class:`~repro_torch.runtime.executor.Prefetcher` is supplied, submits the
    whole interval's payload key lists up front so store gets overlap the
    per-point analytics."""

    def __init__(self, dg, options: AttrOptions = NO_ATTRS,
                 prefetcher=None) -> None:
        self.dg = dg
        self.options = options
        self.prefetcher = prefetcher
        self._comps: dict[int, dict] = {}      # leaf index -> decoded comps
        self._futs: dict[int, object] = {}     # leaf index -> decode future

    def prefetch_interval(self, lo: int, hi: int) -> None:
        if self.prefetcher is None:
            return
        for i in self.dg.elists_covering(lo, hi):
            if i in self._comps or i in self._futs:
                continue
            e = self.dg.edges[self.dg._leaf_elist_eid(i)]
            keys = self.dg._elist_keys(e.payload_id, self.options)
            # fetch *and* decode in the worker thread — the per-point
            # analytics loop consumes ready component arrays
            self._futs[i] = self.prefetcher.submit(
                keys, decode=lambda blobs, keys=keys:
                    self.dg._decode_elist(keys, blobs))

    def _leaf_comps(self, i: int) -> dict:
        comps = self._comps.get(i)
        if comps is None:
            fut = self._futs.pop(i, None)
            if fut is not None:
                comps = fut.result()
            else:
                e = self.dg.edges[self.dg._leaf_elist_eid(i)]
                comps = self.dg._fetch_elist(e.payload_id, self.options)
            self._comps[i] = comps
        return comps

    def quad(self, lo: int, hi: int) -> StepDelta:
        """Net structural delta of the slice ``(lo, hi]`` (no state
        advance — the device path applies it as bitmap planes instead)."""
        dg = self.dg
        ets, sls = [], []
        for i in dg.elists_covering(lo, hi):
            s = self._leaf_comps(i)[col.ELIST_STRUCT]
            m = (s["time"] > lo) & (s["time"] <= hi)
            ets.append(s["etype"][m])
            sls.append(s["slot"][m])
        rec = dg.recent
        if len(rec):
            a = rec.search_time(lo, side="right")
            b = rec.search_time(hi, side="right")
            if b > a:
                ets.append(rec.etype[a:b])
                sls.append(rec.slot[a:b])
        et = np.concatenate(ets) if ets else np.zeros(0, np.int8)
        sl = np.concatenate(sls) if sls else np.zeros(0, np.int32)
        na, nd, ea, ed = _net_quad(et, sl)
        return StepDelta(lo, hi, na, nd, ea, ed)

    def advance(self, state: MaterializedState, lo: int, hi: int
                ) -> tuple[MaterializedState, StepDelta]:
        """Advance ``state`` (a snapshot at ``lo``) to the snapshot at
        ``hi`` and return it with the slice's net structural delta.
        Each covering leaf's rows are filtered once, feeding both the
        state advance and the quad."""
        dg = self.dg
        ets, sls = [], []
        for i in dg.elists_covering(lo, hi):
            comps = self._leaf_comps(i)
            state = dg._apply_elist(state, comps, True, (lo, hi),
                                    self.options)
            s = comps[col.ELIST_STRUCT]
            m = (s["time"] > lo) & (s["time"] <= hi)
            ets.append(s["etype"][m])
            sls.append(s["slot"][m])
        rec = dg.recent
        if len(rec):
            a = rec.search_time(lo, side="right")
            b = rec.search_time(hi, side="right")
            if b > a:
                state = apply_events(state, rec[a:b], forward=True)
                ets.append(rec.etype[a:b])
                sls.append(rec.slot[a:b])
        et = np.concatenate(ets) if ets else np.zeros(0, np.int8)
        sl = np.concatenate(sls) if sls else np.zeros(0, np.int32)
        na, nd, ea, ed = _net_quad(et, sl)
        return state, StepDelta(lo, hi, na, nd, ea, ed)


# ---------------------------------------------------------------------------
# incremental operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvolveContext:
    """Shared per-evolve state handed to operators."""
    universe: Any
    edge_src: np.ndarray
    edge_dst: np.ndarray
    kwargs: dict
    device: Any = "cuda"
    _device_edges: tuple | None = None

    def device_edges(self) -> tuple:
        """``(edge_src, edge_dst)`` as int64 tensors on ``device``, copied
        once per evolve call."""
        if self._device_edges is None:
            import torch
            self._device_edges = tuple(
                torch.from_numpy(np.asarray(a, np.int64)).to(self.device)
                for a in (self.edge_src, self.edge_dst))
        return self._device_edges


class EvolveOp:
    """Operator contract: ``init`` computes the value at the interval's
    first snapshot (cold); ``step`` advances it by one
    :class:`StepDelta`.  The invariant every operator must keep —
    enforced by the differential harness — is

        step(init(S_{t0}), delta_{t0→t1}, S_{t1}) == init(S_{t1})

    up to the operator's stated tolerance (exact for counting operators,
    convergence-tol for fixpoint solvers).  ``iters`` (when set) reports
    the last solve's iteration count, the quantity the warm start
    shrinks."""

    iters: int | None = None

    def init(self, ctx: EvolveContext, state: MaterializedState,
             t: int) -> Any:
        raise NotImplementedError

    def step(self, ctx: EvolveContext, state: MaterializedState,
             delta: StepDelta, t: int) -> Any:
        raise NotImplementedError


class MasksOp(EvolveOp):
    """The raw evolving snapshot: ``(node_mask, edge_mask)`` per point —
    the backend surface the differential harness compares bit-for-bit."""

    def init(self, ctx, state, t):
        return state.node_mask.copy(), state.edge_mask.copy()

    def step(self, ctx, state, delta, t):
        return state.node_mask.copy(), state.edge_mask.copy()


class DegreeOp(EvolveOp):
    """O(|delta|) degree maintenance (both endpoints of live edges)."""

    def __init__(self) -> None:
        self.deg: np.ndarray | None = None

    def init(self, ctx, state, t):
        deg = np.zeros(ctx.universe.num_nodes, np.int64)
        live = np.nonzero(state.edge_mask)[0]
        np.add.at(deg, ctx.edge_src[live], 1)
        np.add.at(deg, ctx.edge_dst[live], 1)
        self.deg = deg
        return deg.copy()

    def step(self, ctx, state, delta, t):
        from ..graph.algorithms import incremental_degrees
        self.deg = incremental_degrees(self.deg, delta.edge_add,
                                       delta.edge_del, ctx.edge_src,
                                       ctx.edge_dst)
        return self.deg.copy()


class DensityOp(EvolveOp):
    """Live element counts + graph density in O(|delta|)."""

    def __init__(self) -> None:
        self.n = 0
        self.e = 0

    @staticmethod
    def _pack(n: int, e: int) -> dict:
        return {"nodes": n, "edges": e,
                "density": (2.0 * e / (n * (n - 1))) if n > 1 else 0.0}

    def init(self, ctx, state, t):
        self.n = int(state.node_mask.sum())
        self.e = int(state.edge_mask.sum())
        return self._pack(self.n, self.e)

    def step(self, ctx, state, delta, t):
        self.n += delta.node_add.size - delta.node_del.size
        self.e += delta.edge_add.size - delta.edge_del.size
        return self._pack(self.n, self.e)


class PageRankOp(EvolveOp):
    """Warm-started masked PageRank: the previous point's ranks seed the
    solver with the delta-touched frontier reset to the uniform
    baseline, so iterations scale with how much the graph moved."""

    def __init__(self, damping: float = 0.85, tol: float = 1e-6,
                 max_iters: int = 200) -> None:
        # tol below ~1e-7 chases float32 segment-sum noise and saturates
        # max_iters on both the warm and cold paths
        self.damping = float(damping)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.pr: np.ndarray | None = None

    def _solve(self, ctx, state, pr0) -> np.ndarray:
        from ..graph.algorithms import pagerank_fixpoint
        from . import bitmaps as bm
        pr, iters = pagerank_fixpoint(
            ctx.edge_src, ctx.edge_dst, bm.np_pack(state.edge_mask),
            bm.np_pack(state.node_mask), pr0,
            num_nodes=ctx.universe.num_nodes, max_iters=self.max_iters,
            damping=self.damping, tol=self.tol, device=ctx.device)
        self.iters = iters
        self.pr = pr
        return self.pr.copy()

    def init(self, ctx, state, t):
        n_live = max(int(state.node_mask.sum()), 1)
        pr0 = state.node_mask.astype(np.float32) / n_live
        return self._solve(ctx, state, pr0)

    def step(self, ctx, state, delta, t):
        from ..graph.algorithms import pagerank_warm_start
        pr0 = pagerank_warm_start(
            self.pr, state.node_mask,
            delta.touched_nodes(ctx.edge_src, ctx.edge_dst))
        return self._solve(ctx, state, pr0)


class ComponentsOp(EvolveOp):
    """Incremental connected components: components untouched by the
    slice keep their converged labels; components that lost an element
    are reset and re-flooded; components merged by added edges are
    pre-unioned on the host so a merge costs O(1) HashMin sweeps."""

    def __init__(self, max_iters: int = 4096) -> None:
        self.max_iters = int(max_iters)
        self.labels: np.ndarray | None = None

    def _solve(self, ctx, state, labels0) -> np.ndarray:
        from ..graph.algorithms import connected_components_fixpoint
        from . import bitmaps as bm
        labels, iters = connected_components_fixpoint(
            ctx.edge_src, ctx.edge_dst, bm.np_pack(state.edge_mask),
            bm.np_pack(state.node_mask), labels0,
            num_nodes=ctx.universe.num_nodes, max_iters=self.max_iters,
            device=ctx.device)
        self.iters = iters
        self.labels = labels
        return self.labels.copy()

    def init(self, ctx, state, t):
        return self._solve(ctx, state,
                           np.arange(ctx.universe.num_nodes, dtype=np.int32))

    def step(self, ctx, state, delta, t):
        from ..graph.algorithms import cc_warm_labels
        labels0 = cc_warm_labels(self.labels, state.node_mask,
                                 (delta.node_add, delta.node_del),
                                 (delta.edge_add, delta.edge_del),
                                 ctx.edge_src, ctx.edge_dst)
        return self._solve(ctx, state, labels0)


class PregelFold(EvolveOp):
    """Generic fold over :func:`repro_torch.graph.pregel.run_pregel_until`:
    the user's vertex program re-converges at every timepoint from the
    previous timepoint's state (``init_fn`` builds the cold state for the
    first snapshot; ``reseed_fn``, if given, may reset the touched
    frontier before each warm solve).  ``msg_fn`` and ``update_fn`` are
    torch callables (:mod:`repro_torch.graph.pregel`); ``init_fn`` and
    ``reseed_fn`` return arrays or tensors, and each point's value comes
    back as numpy."""

    def __init__(self, init_fn: Callable, msg_fn: Callable,
                 update_fn: Callable, *, max_supersteps: int = 64,
                 tol: float = 0.0, bidirectional: bool = True,
                 reseed_fn: Callable | None = None) -> None:
        self.init_fn = init_fn
        self.msg_fn = msg_fn
        self.update_fn = update_fn
        self.max_supersteps = int(max_supersteps)
        self.tol = float(tol)
        self.bidirectional = bool(bidirectional)
        self.reseed_fn = reseed_fn
        self.state = None

    def _solve(self, ctx, snap, state0):
        from ..graph.pregel import run_pregel_until
        from . import bitmaps as bm
        es, ed = ctx.device_edges()
        out, steps = run_pregel_until(
            state0, es, ed, bm.np_pack(snap.edge_mask),
            self.msg_fn, self.update_fn,
            max_supersteps=self.max_supersteps,
            num_nodes=ctx.universe.num_nodes, tol=self.tol,
            bidirectional=self.bidirectional, device=ctx.device)
        self.iters = int(steps)
        self.state = out.cpu().numpy()
        return self.state.copy()

    def init(self, ctx, state, t):
        return self._solve(ctx, state, self.init_fn(ctx, state, t))

    def step(self, ctx, state, delta, t):
        s0 = self.state
        if self.reseed_fn is not None:
            s0 = self.reseed_fn(ctx, state, delta, s0)
        return self._solve(ctx, state, s0)


_OPS: dict[str, Callable[..., EvolveOp]] = {
    "masks": MasksOp,
    "degree": DegreeOp,
    "density": DensityOp,
    "pagerank": PageRankOp,
    "components": ComponentsOp,
}


def resolve_op(op: str | EvolveOp | Callable, kwargs: dict) -> EvolveOp:
    if isinstance(op, str):
        if op not in _OPS:
            from .errors import UnknownOperatorError
            raise UnknownOperatorError(f"unknown evolve op {op!r}; "
                                       f"choose from {sorted(_OPS)}")
        return _OPS[op](**kwargs)
    # an instance or callable carries its own configuration — keyword
    # arguments would be silently dead, so reject them loudly
    if kwargs:
        raise TypeError(f"op_kwargs {sorted(kwargs)} only apply to named "
                        f"operators; configure {op!r} directly")
    if isinstance(op, EvolveOp):
        return op
    if callable(op):
        return _CallableFold(op)
    raise TypeError(f"op must be a name, EvolveOp or callable, got {op!r}")


class _CallableFold(EvolveOp):
    """Wraps a plain callable ``f(prev_value, state, delta, t)``; at the
    first snapshot it is called with ``prev_value=None, delta=None``."""

    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self.value = None

    def init(self, ctx, state, t):
        self.value = self.fn(None, state, None, t)
        return self.value

    def step(self, ctx, state, delta, t):
        self.value = self.fn(self.value, state, delta, t)
        return self.value


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvolveResult:
    times: list[int]
    values: list[Any]
    stats: dict

    def __iter__(self):
        return iter(zip(self.times, self.values))


class TemporalEngine:
    """Evolutionary-query engine bound to a
    :class:`~repro_torch.core.manager.GraphManager`."""

    def __init__(self, gm) -> None:
        self.gm = gm

    def evolve(self, times: Sequence[int] | TimeExpression,
               op: str | EvolveOp | Callable = "masks", *,
               attr_options: str | AttrOptions = "",
               use_current: bool = True, incremental: bool = True,
               dg=None, **op_kwargs) -> EvolveResult:
        gm = self.gm
        if isinstance(times, TimeExpression):
            times = list(times.times)
        times = sorted(dict.fromkeys(int(t) for t in times))
        if not times:
            raise ValueError("evolve needs at least one timepoint")
        opts = gm._parse_opts(attr_options)
        operator = resolve_op(op, op_kwargs)
        uni = gm.universe
        ctx = EvolveContext(uni, uni.edge_src, uni.edge_dst, dict(op_kwargs),
                            device=gm.device)

        t_start = time.perf_counter()
        if not incremental:
            return self._recompute(times, operator, ctx, opts, use_current,
                                   t_start)

        # dg is the epoch-pinned index version when the service threads one
        # through (api/compiler.py) — every slice and the first snapshot
        # then resolve against one consistent version under live ingest
        pinned = dg is not None
        dg = dg if pinned else gm.dg
        slicer = IntervalSlicer(dg, opts, prefetcher=gm.prefetcher)
        slicer.prefetch_interval(times[0], times[-1])
        if pinned:
            state = dg.get_snapshot(times[0], opts, pool=gm.pool,
                                    use_current=use_current)
        else:
            state = gm.get_snapshot(times[0], opts, use_current=use_current)
        state = state.resized(uni).copy()
        values = [operator.init(ctx, state, times[0])]
        iters = [operator.iters]
        changes = 0
        for lo, hi in zip(times, times[1:]):
            state, delta = slicer.advance(state, lo, hi)
            changes += delta.n_changes
            values.append(operator.step(ctx, state, delta, hi))
            iters.append(operator.iters)
        wall = time.perf_counter() - t_start
        gm.workload.record_interval(dg._leaf_for_time(times[0]),
                                    dg._leaf_for_time(times[-1]),
                                    len(times), wall_s=wall)
        stats = {"points": len(times), "incremental": True,
                 "elists_fetched": len(slicer._comps),
                 "net_changes": changes, "wall_s": wall,
                 "solver_iters": iters if iters[0] is not None else None}
        return EvolveResult(times, values, stats)

    def _recompute(self, times, operator, ctx, opts, use_current,
                   t_start) -> EvolveResult:
        """Per-snapshot recompute baseline: every timepoint is planned,
        retrieved and solved cold — the engine the incremental path is
        benchmarked against (``BENCH_temporal.json``)."""
        gm = self.gm
        values = []
        iters = []
        for t in times:
            state = gm.get_snapshot(t, opts, use_current=use_current)
            state = state.resized(gm.universe)
            values.append(operator.init(ctx, state, t))
            iters.append(operator.iters)
        wall = time.perf_counter() - t_start
        stats = {"points": len(times), "incremental": False,
                 "wall_s": wall,
                 "solver_iters": iters if iters[0] is not None else None}
        return EvolveResult(list(times), values, stats)


# ---------------------------------------------------------------------------
# snapshot batch streaming (training workloads)
# ---------------------------------------------------------------------------


class SnapshotBatchLoader:
    """Streams windows of interval snapshots as model-ready batches.

    Each batch covers ``batch_size`` consecutive timepoints of ``times``.
    The masks come from the batched device path
    (:func:`repro_torch.runtime.torch_exec.evolve_intervals_torch`: one
    Steiner retrieval for the window start, then the double-buffered
    prefix-chain sweep), and per-node degree features come from the fused
    analytics kernel — the unpacked live-edge indicator it emits is reduced
    by the segment_sum kernel, so features never take a numpy scatter pass.

    Batch dict (tensors on ``device``, static shapes across batches):

    * ``x           [T, N, d_in] f32`` — degree features (random
      projection of degree + raw degree, matching the GNN example),
    * ``edge_index  [2, 2E] i32``     — every universe edge, both
      directions (liveness is carried by the mask, not by selection),
    * ``edge_mask   [T, 2E] f32``,
    * ``label_mask  [T, N]  f32``     — live nodes at each timepoint,
    * ``labels      [T, N]  i32``     — degree growth at
      ``t + label_horizon`` (only with a horizon),
    * ``num_edges   [T]     i32``     — fused popcount totals,
    * ``times       list[int]``.

    The last window is dropped if shorter than ``batch_size`` (static
    shapes); with ``label_horizon`` the horizon snapshots retrieve in the
    same batched device call as the window itself.  ``device`` defaults to
    the manager's (``"cuda"`` unless it was built with ``"cpu"``).
    """

    def __init__(self, gm, times: Sequence[int], *, batch_size: int = 4,
                 label_horizon: int | None = None, d_in: int = 16,
                 seed: int = 0, device=None) -> None:
        from ..kernels.policy import resolve_device
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.gm = gm
        self.times = sorted(dict.fromkeys(int(t) for t in times))
        self.batch_size = int(batch_size)
        self.label_horizon = (None if label_horizon is None
                              else int(label_horizon))
        self.d_in = int(d_in)
        self.device = resolve_device(gm.device if device is None else device)
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((1, self.d_in - 1)).astype(
            np.float32)
        uni = gm.universe
        E = uni.num_edges
        src, dst = uni.edge_src[:E], uni.edge_dst[:E]
        self._edge_index = np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int32)

    def __len__(self) -> int:
        return len(self.times) // self.batch_size

    def _degrees(self, edge_masks: list[np.ndarray]):
        """Fused-kernel analytics over the window's edge planes: one K=0
        batched fused call lands popcounts + the live indicator, then the
        segment_sum kernel reduces per-node degrees on device."""
        import torch
        from .bitmaps import np_pack
        from ..kernels import delta_apply_fused_batched, segment_sum
        from ..runtime.staging import host_tensor
        uni = self.gm.universe
        E, N = uni.num_edges, uni.num_nodes
        bases = host_tensor(np.stack([np_pack(em) for em in edge_masks]))
        T, W = bases.shape
        empty = torch.zeros((T, 0, W), dtype=torch.int32, device=self.device)
        fe = delta_apply_fused_batched(bases.to(self.device), empty, empty)
        src, dst = uni.edge_src[:E], uni.edge_dst[:E]
        deg = np.stack([
            (segment_sum(fe.live[t, :E][:, None], src, N)
             + segment_sum(fe.live[t, :E][:, None], dst, N)
             ).reshape(-1).cpu().numpy()
            for t in range(T)])
        return deg.astype(np.float32), fe.live_count().astype(np.int32)

    def __iter__(self):
        import torch
        from ..runtime.torch_exec import evolve_intervals_torch
        gm, bs, hz = self.gm, self.batch_size, self.label_horizon

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        for i in range(len(self)):
            window = self.times[i * bs:(i + 1) * bs]
            intervals = [window]
            if hz is not None:
                intervals.append(sorted({t + hz for t in window}))
            res = evolve_intervals_torch(gm.dg, intervals,
                                         device=self.device, pool=gm.pool,
                                         prefetch=gm.prefetcher)
            masks = res[0]
            node_masks = [masks[t][0] for t in window]
            deg, num_edges = self._degrees([masks[t][1] for t in window])
            x = np.concatenate(
                [deg[:, :, None] * self._proj[None] * 0.1,
                 deg[:, :, None]], axis=2)
            # edge liveness, both directions (edge_index order)
            live = np.stack([masks[t][1].astype(np.float32)
                             for t in window])
            em = np.concatenate([live, live], axis=1)
            batch = {
                "x": put(x),
                "edge_index": put(self._edge_index),
                "edge_mask": put(em),
                "label_mask": put(np.stack(node_masks).astype(np.float32)),
                "num_edges": put(num_edges),
                "times": list(window),
            }
            if hz is not None:
                fmasks = res[1]
                fdeg, _ = self._degrees(
                    [fmasks[t + hz][1] for t in window])
                batch["labels"] = put((fdeg > deg).astype(np.int32))
            yield batch
