"""Graph analytics over GraphPool bitmap planes, in torch.

Every algorithm takes the union graph's edge list plus a *packed edge
bitmap* (one GraphPool plane) and runs on the masked subgraph — this is
the paper's "execute analyses against overlaid snapshots" path (§6,
bitmap-penalty experiment).  A leading batch axis over stacked planes
evaluates many snapshots at once (multipoint analytics).

Inputs may be numpy arrays or tensors; packed words are ``uint32`` arrays
or their ``int32`` tensor views.  Every function takes ``device=``
(default ``"cuda"``; a missing card raises unless the caller passes
``"cpu"``) and runs there.  Segment sums are ``index_add_`` and segment
minima ``scatter_reduce(..., "amin")``: the reference computes them with
XLA scatters, outside any Pallas kernel.  The fixpoint solvers iterate on
the device in blocks of :data:`FIXPOINT_BLOCK` steps, keeping every step's
change on the device, and read the changes back once a block: they return
the *first* iterate whose change meets the stopping rule, with its
iteration count, exactly as the reference's ``while_loop`` stops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import bitmaps as bm
from ..kernels.policy import resolve_device
from ..runtime.staging import host_tensor

# steps run between two reads of the convergence flags (one host sync)
FIXPOINT_BLOCK = 8
_BIG = int(np.iinfo(np.int32).max)


def _tensor(a, dev: torch.device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``dev``; packed ``uint32`` words
    become their ``int32`` view."""
    if not isinstance(a, torch.Tensor):
        a = host_tensor(a)
    return a.to(device=dev, dtype=dtype)


def _segment_sum(data: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Sum of ``data [..., E]`` by ``ids [E]`` along the last axis."""
    out = data.new_zeros((*data.shape[:-1], num_segments))
    return out.index_add_(data.dim() - 1, ids, data)


def _segment_min(data: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Minimum of int32 ``data [E]`` by ``ids [E]``; empty segments give
    the int32 maximum, as ``jax.ops.segment_min`` does."""
    out = torch.full((num_segments,), _BIG, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, ids, data, "amin")


def edge_mask_from_plane(plane, num_edges: int, *,
                         device="cuda") -> torch.Tensor:
    return bm.unpack(_tensor(plane, resolve_device(device)), num_edges)


def _pagerank_planes(es, ed, edge_planes, node_planes, num_nodes, iters,
                     damping):
    """Fixed-step masked PageRank over ``[G, W]`` planes -> ``[G, N]``."""
    E = es.shape[0]
    emask = bm.unpack(edge_planes, E).float()
    nmask = bm.unpack(node_planes, num_nodes).float()
    deg = (_segment_sum(emask, es, num_nodes)
           + _segment_sum(emask, ed, num_nodes))
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0)
    n_live = nmask.sum(-1, keepdim=True).clamp(min=1.0)
    d = torch.tensor(damping, dtype=torch.float32, device=es.device)
    pr = nmask / n_live
    for _ in range(iters):
        contrib = pr * inv_deg
        agg = (_segment_sum(contrib[:, es] * emask, ed, num_nodes)
               + _segment_sum(contrib[:, ed] * emask, es, num_nodes))
        dangling = (pr * (deg == 0)).sum(-1, keepdim=True)
        pr = nmask * ((1 - d) / n_live + d * (agg + dangling / n_live))
    return pr


def pagerank(edge_src, edge_dst, edge_plane, node_plane, *, num_nodes: int,
             iters: int = 20, damping: float = 0.85,
             device="cuda") -> torch.Tensor:
    """Masked PageRank treating undirected edges as both directions."""
    dev = resolve_device(device)
    es = _tensor(edge_src, dev, torch.int64)
    ed = _tensor(edge_dst, dev, torch.int64)
    return _pagerank_planes(es, ed, _tensor(edge_plane, dev)[None],
                            _tensor(node_plane, dev)[None], num_nodes,
                            iters, damping)[0]


def degrees_masked(edge_src, edge_dst, edge_plane, *, num_nodes: int,
                   device="cuda") -> torch.Tensor:
    dev = resolve_device(device)
    es = _tensor(edge_src, dev, torch.int64)
    ed = _tensor(edge_dst, dev, torch.int64)
    emask = bm.unpack(_tensor(edge_plane, dev), es.shape[0]).int()
    return (_segment_sum(emask, es, num_nodes)
            + _segment_sum(emask, ed, num_nodes))


def _hashmin_sweep(lab, es, ed, emask, nmask, num_nodes):
    big = torch.tensor(_BIG, dtype=torch.int32, device=lab.device)
    src_l = torch.where(emask, lab[es], big)
    dst_l = torch.where(emask, lab[ed], big)
    m1 = _segment_min(src_l, ed, num_nodes)
    m2 = _segment_min(dst_l, es, num_nodes)
    new = torch.minimum(lab, torch.minimum(m1, m2))
    return torch.where(nmask, new, big)


def connected_components(edge_src, edge_dst, edge_plane, node_plane, *,
                         num_nodes: int, iters: int = 50,
                         device="cuda") -> torch.Tensor:
    """Label propagation: min-label flooding (HashMin), masked."""
    dev = resolve_device(device)
    es = _tensor(edge_src, dev, torch.int64)
    ed = _tensor(edge_dst, dev, torch.int64)
    emask = bm.unpack(_tensor(edge_plane, dev), es.shape[0])
    nmask = bm.unpack(_tensor(node_plane, dev), num_nodes)
    labels = torch.where(
        nmask, torch.arange(num_nodes, dtype=torch.int32, device=dev), _BIG)
    for _ in range(iters):
        labels = _hashmin_sweep(labels, es, ed, emask, nmask, num_nodes)
    return labels


def triangle_count(edge_src: np.ndarray, edge_dst: np.ndarray,
                   edge_mask: np.ndarray, num_nodes: int) -> int:
    """Host-side exact triangle count on the masked subgraph (numpy;
    used by evolution analyses — 'how many new triangles this year')."""
    eid = np.nonzero(edge_mask)[0]
    s, d = edge_src[eid], edge_dst[eid]
    lo, hi = np.minimum(s, d), np.maximum(s, d)
    keep = lo != hi
    pairs = np.unique(np.stack([lo[keep], hi[keep]], 1), axis=0)
    adj: dict[int, set] = {}
    for a, b in pairs:
        adj.setdefault(int(a), set()).add(int(b))
    count = 0
    for a, nbrs in adj.items():
        for b in nbrs:
            count += len(nbrs & adj.get(b, set()))
    return count // 1  # each triangle counted once: a<b<c ordering


def multi_snapshot_pagerank(edge_src, edge_dst, edge_planes, node_planes, *,
                            num_nodes: int, iters: int = 20,
                            device="cuda") -> torch.Tensor:
    """PageRank for G snapshots in one shot: ``edge_planes [G, W_e]``,
    ``node_planes [G, W_n]`` -> ``[G, N]`` (the batch axis takes the
    reference's ``vmap``)."""
    dev = resolve_device(device)
    es = _tensor(edge_src, dev, torch.int64)
    ed = _tensor(edge_dst, dev, torch.int64)
    return _pagerank_planes(es, ed, _tensor(edge_planes, dev),
                            _tensor(node_planes, dev), num_nodes, iters,
                            0.85)


# ---------------------------------------------------------------------------
# incremental / warm-started variants (temporal analytics, core/temporal.py)
# ---------------------------------------------------------------------------
#
# The fixpoint solvers below iterate to a *convergence criterion* instead of
# a fixed step count, so a warm start (the previous timepoint's result with
# only the delta-touched frontier reset) buys real iterations: between two
# nearby snapshots the solution barely moves, and the solver exits after a
# couple of sweeps instead of re-running the full cold schedule.  Cold and
# warm starts converge to the same fixpoint, so incremental results match a
# per-snapshot recompute up to the tolerance.


def _edge_bucket(n: int) -> int:
    """Compact live-edge arrays are padded up to a multiple of 512, as the
    reference pads them to keep its jit cache hot; padding rows carry zero
    mass, so results do not depend on it."""
    return max(512, -(-n // 512) * 512)


def _compact_edges(edge_src: np.ndarray, edge_dst: np.ndarray,
                   edge_mask: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop masked-out edge slots before solving: after churn, live edges
    are a small fraction of the slot universe, and scatter cost scales
    with the number of *scattered elements*, masked or not.  Padding rows
    are (0, 0) with live=0 — segment-summed with zero mass, exactly like a
    masked slot."""
    live = np.nonzero(edge_mask)[0]
    Ec = _edge_bucket(live.size)
    es = np.zeros(Ec, np.int32)
    ed = np.zeros(Ec, np.int32)
    lv = np.zeros(Ec, np.float32)
    es[: live.size] = edge_src[live]
    ed[: live.size] = edge_dst[live]
    lv[: live.size] = 1.0
    return es, ed, lv


def _fixpoint(x0, step, stopped, max_iters: int):
    """Iterate ``step`` from ``x0`` until ``stopped(new, old)`` (a device
    bool) holds or ``max_iters`` steps ran; returns ``(x, steps)``.

    Steps run in blocks of :data:`FIXPOINT_BLOCK`; each step's flag stays
    on the device, and one read per block finds the first step that
    stopped.  The result is that step's iterate (later steps of the block
    are discarded), so it equals a check after every step."""
    x, i = x0, 0
    while i < max_iters:
        m = min(FIXPOINT_BLOCK, max_iters - i)
        xs, flags = [], []
        for _ in range(m):
            new = step(x, i + len(xs))
            flags.append(stopped(new, x))
            xs.append(new)
            x = new
        hit = torch.stack(flags).cpu().numpy()
        first = int(np.argmax(hit)) if hit.any() else m - 1
        x = xs[first]
        i += first + 1
        if hit.any():
            break
    return x, i


def _start_on_simplex(pr0, nmask, n_live):
    """Project a start vector onto the live-node simplex (masks may have
    changed since it was computed)."""
    pr0 = pr0.clamp(min=0.0) * nmask
    s0 = pr0.sum()
    return torch.where(s0 > 0, pr0 / s0.clamp(min=1e-30), nmask / n_live)


def _pagerank_fixpoint_segment(es, ed, lv, nmask, pr0, d, tol, max_iters):
    num_nodes = nmask.shape[0]
    deg = _segment_sum(lv, es, num_nodes) + _segment_sum(lv, ed, num_nodes)
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0)
    n_live = nmask.sum().clamp(min=1.0)
    dangling_mask = deg == 0

    def step(pr, _):
        contrib = pr * inv_deg
        agg = (_segment_sum(contrib[es] * lv, ed, num_nodes)
               + _segment_sum(contrib[ed] * lv, es, num_nodes))
        dangling = (pr * dangling_mask).sum()
        return nmask * ((1 - d) / n_live + d * (agg + dangling / n_live))

    return _fixpoint(_start_on_simplex(pr0, nmask, n_live), step,
                     lambda new, old: ~((new - old).abs().sum() > tol),
                     max_iters)


def _pagerank_fixpoint_dense(A, nmask, pr0, d, tol, max_iters):
    """Dense-adjacency variant of the same iteration: ``agg = A @
    (pr/deg)`` with ``A[i, j]`` = live-edge multiplicity — identical math
    to the segment formulation, a matrix-vector product instead of
    scatters (cheaper for small N)."""
    deg = A.sum(1)
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0)
    n_live = nmask.sum().clamp(min=1.0)
    dangling_mask = deg == 0

    def step(pr, _):
        agg = A @ (pr * inv_deg)
        dangling = (pr * dangling_mask).sum()
        return nmask * ((1 - d) / n_live + d * (agg + dangling / n_live))

    return _fixpoint(_start_on_simplex(pr0, nmask, n_live), step,
                     lambda new, old: ~((new - old).abs().sum() > tol),
                     max_iters)


# above this node count the dense [N, N] adjacency (4·N² bytes) stops
# paying for itself and the compact segment kernel takes over
DENSE_PAGERANK_MAX_NODES = 1024


def pagerank_fixpoint(edge_src, edge_dst, edge_plane, node_plane, pr0, *,
                      num_nodes: int, max_iters: int = 200,
                      damping: float = 0.85, tol: float = 1e-6,
                      force_impl: str | None = None, device="cuda"
                      ) -> tuple[np.ndarray, int]:
    """Masked PageRank iterated until the L1 step change drops under
    ``tol`` (or ``max_iters``).  ``pr0`` is the starting vector — pass the
    previous snapshot's ranks (with the touched frontier reset) for the
    incremental path, or a uniform vector for a cold solve.  Returns
    ``(pr, iters_used)`` with ``pr`` as numpy; the fixpoint is unique, so
    the result does not depend on ``pr0`` beyond the tolerance.

    Compacts the edge list to the live slots on the host and picks the
    dense form for small node universes (``DENSE_PAGERANK_MAX_NODES``) or
    the segment form above it — same semantics as solving over the full
    masked slot universe, at live-edge cost.  ``force_impl`` ("dense" |
    "segment") pins the form, for the equivalence tests."""
    dev = resolve_device(device)
    edge_src = np.asarray(edge_src)
    edge_dst = np.asarray(edge_dst)
    E = edge_src.shape[0]
    emask = bm.np_unpack(np.asarray(edge_plane), E)
    impl = force_impl or ("dense" if num_nodes <= DENSE_PAGERANK_MAX_NODES
                          else "segment")
    nmask = _tensor(bm.np_unpack(np.asarray(node_plane), num_nodes
                                 ).astype(np.float32), dev)
    pr0 = _tensor(np.asarray(pr0, np.float32), dev)
    d = torch.tensor(damping, dtype=torch.float32, device=dev)
    if impl == "dense":
        live = np.nonzero(emask)[0]
        A = np.zeros((num_nodes, num_nodes), np.float32)
        np.add.at(A, (edge_src[live], edge_dst[live]), 1.0)
        np.add.at(A, (edge_dst[live], edge_src[live]), 1.0)
        pr, iters = _pagerank_fixpoint_dense(_tensor(A, dev), nmask, pr0, d,
                                             tol, max_iters)
    else:
        es, ed, lv = _compact_edges(edge_src, edge_dst, emask)
        pr, iters = _pagerank_fixpoint_segment(
            _tensor(es, dev, torch.int64), _tensor(ed, dev, torch.int64),
            _tensor(lv, dev), nmask, pr0, d, tol, max_iters)
    return pr.cpu().numpy(), iters


def pagerank_warm_start(prev_pr: np.ndarray, node_mask: np.ndarray,
                        touched: np.ndarray) -> np.ndarray:
    """Build a warm-start vector from the previous ranks: delta-touched
    nodes (endpoints of changed edges, added/removed nodes) are reset to
    the uniform baseline so stale mass does not slow convergence; every
    other live node keeps its rank."""
    n_live = max(int(node_mask.sum()), 1)
    pr0 = np.where(node_mask, np.maximum(prev_pr, 0.0), 0.0).astype(np.float32)
    if touched.size:
        t = touched[touched < pr0.size]
        pr0[t] = 1.0 / n_live
    pr0 *= node_mask
    s = pr0.sum()
    return (pr0 / s if s > 0
            else node_mask.astype(np.float32) / n_live)


def connected_components_fixpoint(edge_src, edge_dst, edge_plane, node_plane,
                                  labels0, *, num_nodes: int,
                                  max_iters: int = 4096, device="cuda"
                                  ) -> tuple[np.ndarray, int]:
    """HashMin label flooding run to its fixpoint (no label changes).

    Starting labels must satisfy the warm-start contract: within every
    component the minimum starting label equals the component's true label
    (the min live node id), and no node starts below its component's true
    label.  ``arange`` (cold) and the incremental reset of
    :func:`cc_warm_labels` both satisfy it, and then the fixpoint is
    exactly the cold answer.  Returns ``(labels, iters_used)``, labels as
    numpy.  Compacts to live edges, like :func:`pagerank_fixpoint`."""
    dev = resolve_device(device)
    E = np.asarray(edge_src).shape[0]
    emask = bm.np_unpack(np.asarray(edge_plane), E)
    es, ed, lv = _compact_edges(np.asarray(edge_src), np.asarray(edge_dst),
                                emask)
    es, ed = _tensor(es, dev, torch.int64), _tensor(ed, dev, torch.int64)
    live = _tensor(lv, dev) > 0
    nmask = bm.unpack(_tensor(node_plane, dev), num_nodes)
    labels0 = torch.where(nmask, _tensor(labels0, dev, torch.int32), _BIG)
    labels, iters = _fixpoint(
        labels0, lambda lab, _: _hashmin_sweep(lab, es, ed, live, nmask,
                                               num_nodes),
        lambda new, old: ~torch.any(new != old), max_iters)
    return labels.cpu().numpy(), iters


def cc_warm_labels(prev_labels: np.ndarray, node_mask: np.ndarray,
                   quad_nodes: tuple[np.ndarray, np.ndarray],
                   quad_edges: tuple[np.ndarray, np.ndarray],
                   edge_src: np.ndarray, edge_dst: np.ndarray) -> np.ndarray:
    """Incremental starting labels for :func:`connected_components_fixpoint`.

    Only *affected* components are re-unioned: components that lost an edge
    or a node are reset to per-node singleton labels (a deletion may have
    split them, and their old minimum id may even be the deleted node's);
    components touched solely by additions keep their labels — added edges
    are pre-merged with a host union-find so a merge costs O(1) flooding
    sweeps instead of O(diameter).  Untouched components keep their
    converged labels and contribute nothing to the remaining sweeps."""
    node_add, node_del = quad_nodes
    edge_add, edge_del = quad_edges
    big = np.iinfo(np.int32).max
    labels = np.where(node_mask, prev_labels.astype(np.int64), big).copy()

    # 1. reset components affected by deletions (splits) to singletons
    affected = set()
    for e in np.asarray(edge_del, np.int64):
        for end in (edge_src[e], edge_dst[e]):
            if prev_labels[end] != big:
                affected.add(int(prev_labels[end]))
    for s in np.asarray(node_del, np.int64):
        if prev_labels[s] != big:
            affected.add(int(prev_labels[s]))
    if affected:
        reset = np.isin(prev_labels, list(affected)) & node_mask
        labels[reset] = np.nonzero(reset)[0]

    # 2. new nodes start as singletons
    na = np.asarray(node_add, np.int64)
    na = na[na < labels.size]
    labels[na[node_mask[na]]] = na[node_mask[na]]

    # 3. pre-merge added edges with a tiny union-find over labels
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        r = x
        while parent.get(r, r) != r:
            r = parent[r]
        while parent.get(x, x) != x:
            parent[x], x = r, parent[x]
        return r

    merged = False
    for e in np.asarray(edge_add, np.int64):
        u, v = int(edge_src[e]), int(edge_dst[e])
        if not (node_mask[u] and node_mask[v]):
            continue
        ra, rb = find(int(labels[u])), find(int(labels[v]))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
            merged = True
    if merged:
        touched = np.fromiter(parent.keys(), np.int64)
        roots = np.array([find(int(t)) for t in touched], np.int64)
        remap = dict(zip(touched.tolist(), roots.tolist()))
        uniq, inv = np.unique(labels, return_inverse=True)
        uniq = np.array([remap.get(int(u), int(u)) for u in uniq], np.int64)
        labels = uniq[inv]

    labels = np.where(node_mask, labels, big)
    return np.clip(labels, None, big).astype(np.int32)


def incremental_degrees(deg: np.ndarray, edge_add: np.ndarray,
                        edge_del: np.ndarray, edge_src: np.ndarray,
                        edge_dst: np.ndarray) -> np.ndarray:
    """Advance a dense degree vector by a net inter-snapshot edge delta
    (``edge_add``/``edge_del`` are *net* slot sets — an edge added and
    deleted inside the slice appears in neither).  O(|delta|), matching
    :func:`degrees_masked`'s convention (live edges count both endpoints,
    node mask not consulted)."""
    out = deg.copy()
    for slots, sign in ((np.asarray(edge_add, np.int64), 1),
                       (np.asarray(edge_del, np.int64), -1)):
        if slots.size:
            np.add.at(out, edge_src[slots], sign)
            np.add.at(out, edge_dst[slots], sign)
    return out
