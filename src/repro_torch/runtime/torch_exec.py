"""Device snapshot retrieval: DeltaGraph plans on packed bitmaps, in torch.

The host planner (Dijkstra / Steiner on the skeleton) stays as-is; this
module replaces the *apply* phase with device work:

1. every plan step — delta edge (either direction) or partial eventlist —
   collapses to one ``(adds, dels)`` bitmap pair (exact because element ids
   are never reused, §3.1, so membership toggles at most add→del once);
2. a singlepoint plan is therefore a K-step chain, landed by the
   delta-apply kernels in **one pass** over the bitmap (K+2 instead of 3K
   words of device-memory traffic), optionally with the analytics fused in;
3. a multipoint plan runs wave by wave, all sibling branches of a wave in
   one batched chain launch, and can land its results in ``GraphPool``;
4. sharded retrieval lays each bitmap out word-cyclically as ``[P, Wp]``
   (word ``w`` at row ``w % P``, column ``w // P``) and lands all P rows
   as the batch of one chain launch per plane: the rows never exchange a
   word, as the reference's ``shard_map`` over P devices never issues a
   collective; under ``torch.distributed`` each rank lowers and lands only
   its own rows (:func:`execute_singlepoint_sharded_rank`).

Every entry point takes ``device=`` (default ``"cuda"``): CUDA tensors go
through the hand-written kernels, ``device="cpu"`` through their plain
PyTorch versions; a missing card raises.  Packed words travel as ``int32``
tensors; results come back as numpy bool masks.  A point retrieval on the
card stages its chain's slot index lists and builds the packed planes
there (:func:`_chain_planes`); the batched and sharded paths pack their
planes on the host.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .staging import DeviceStager, stream_chunk_k
from .. import obs
from ..core import bitmaps as bmod
from ..core import planir
from ..core.deltagraph import DeltaGraph, Plan
from ..core.events import (EV_DEL_EDGE, EV_DEL_NODE, EV_NEW_EDGE, EV_NEW_NODE)
from ..core.query import NO_ATTRS
from ..kernels import (FusedOut, delta_apply_chain, delta_apply_chain_batched,
                       delta_apply_chain_prefix_batched,
                       delta_apply_fused_pair, planes_from_indices,
                       segment_sum)
from ..kernels.policy import resolve_device
from ..storage import columnar as col
from ..transfer import to_device, to_host


# ---------------------------------------------------------------------------
# plan → (adds, dels) index pairs
# ---------------------------------------------------------------------------

_fit_words = bmod.np_fit_words


def _rows_pair(times: np.ndarray, etype: np.ndarray, slot: np.ndarray,
               forward: bool, rng) -> tuple[np.ndarray, ...]:
    """An eventlist's rows with ``rng[0] < time <= rng[1]`` (all of them
    when ``rng`` is None) as one chain step's ``(na, nd, ea, ed)`` slot
    index lists, applied ``forward`` or backward: host lowering, the
    first half of the step's ``pack`` (the planes' words are the second)."""
    with obs.span("pack", rows=len(times)):
        m = (np.ones(times.shape, bool) if rng is None
             else (times > rng[0]) & (times <= rng[1]))
        et, sl = etype[m], slot[m]

        def pair(new_code, del_code):
            new_s = sl[et == new_code]
            del_s = sl[et == del_code]
            if forward:
                adds = np.setdiff1d(new_s, del_s)   # add-then-del nets to del
                dels = del_s
            else:
                adds = np.setdiff1d(del_s, new_s)   # un-delete revives
                dels = new_s
            return adds.astype(np.int32), dels.astype(np.int32)

        na, nd = pair(EV_NEW_NODE, EV_DEL_NODE)
        ea, ed = pair(EV_NEW_EDGE, EV_DEL_EDGE)
        return na, nd, ea, ed


def _elist_pair(comps, forward: bool, rng) -> tuple[np.ndarray, ...]:
    s = comps[col.ELIST_STRUCT]
    return _rows_pair(s["time"], s["etype"], s["slot"], forward, rng)


def _recent_pair(dg: DeltaGraph, forward: bool, rng) -> tuple[np.ndarray, ...]:
    ev = dg.recent
    return _rows_pair(ev.time, ev.etype, ev.slot, forward, rng)


def _plan_base(dg: DeltaGraph, plan: Plan, pool
               ) -> tuple[tuple[np.ndarray, np.ndarray], list[tuple]]:
    """A singlepoint plan's source: its base bitmaps, and the recent
    events as a first chain step when it starts from the current graph."""
    assert len(plan.targets) == 1, "use per-branch lowering for multipoint"
    src = plan.steps[0]
    U_n, U_e = dg.universe.num_nodes, dg.universe.num_edges
    if src.action[0] == "empty":
        return (np.zeros(bmod.num_words(U_n), np.uint32),
                np.zeros(bmod.num_words(U_e), np.uint32)), []
    if src.action[0] == "mat":
        base_n, base_e = pool._resolve_masks(src.action[1])
        return (_fit_words(base_n, bmod.num_words(U_n)),
                _fit_words(base_e, bmod.num_words(U_e))), []
    if src.action[0] == "current":
        st = dg._last_leaf_state.resized(dg.universe)
        with obs.span("pack", words=bmod.num_words(U_n) + bmod.num_words(U_e)):
            base = bmod.np_pack(st.node_mask), bmod.np_pack(st.edge_mask)
        return base, [_recent_pair(dg, True, None)]
    raise ValueError(src.action)  # pragma: no cover


def plan_to_chain(dg: DeltaGraph, plan: Plan, pool=None
                  ) -> tuple[tuple[np.ndarray, np.ndarray], list[tuple]]:
    """Lower a *singlepoint* plan into (base bitmaps, [(na,nd,ea,ed), ...])."""
    with obs.span("lower") as sp:
        (base_n, base_e), chain = _plan_base(dg, plan, pool)
        for st in plan.steps[1:]:
            kind = st.action[0]
            if kind == "delta":
                d = dg._fetch_delta(st.action[1], NO_ATTRS)
                if st.action[2]:
                    chain.append((d.node_add, d.node_del, d.edge_add,
                                  d.edge_del))
                else:
                    chain.append((d.node_del, d.node_add, d.edge_del,
                                  d.edge_add))
            elif kind == "elist":
                comps = dg._fetch_elist(st.action[1], NO_ATTRS)
                chain.append(_elist_pair(comps, st.action[2], st.action[3]))
            elif kind == "recent":
                chain.append(_recent_pair(dg, st.action[2], st.action[3]))
            elif kind == "noop":
                pass
            else:  # pragma: no cover
                raise ValueError(st.action)
        sp.note(K=len(chain))
        return (base_n, base_e), chain


# ---------------------------------------------------------------------------
# single-device execution
# ---------------------------------------------------------------------------

def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device(a, device)


def _index_lists(chain: list[tuple], tail: tuple, W_n: int, W_e: int
                 ) -> tuple[np.ndarray, int]:
    """The host half of building a chain's planes on the card: one int32
    array of the 4·K row offsets of the chain's slot index lists (node
    adds, node dels, edge adds, edge dels, steps 0..K-1 each), the
    ``tail`` rows' words (the transient dels, or nothing) and the lists
    themselves, concatenated unsorted; and where the lists start.  Raises
    ``IndexError`` for an index outside its plane's ``32·W`` slots."""
    K = len(chain)
    lists = [c[i] for i in range(4) for c in chain]
    offsets = np.zeros(4 * K + 1, np.int64)
    np.cumsum(np.fromiter(map(len, lists), np.int64, 4 * K), out=offsets[1:])
    buf = np.concatenate([offsets, *(t.view(np.int32) for t in tail), *lists],
                         dtype=np.int32)
    head = buf.size - int(offsets[-1])
    split = head + int(offsets[2 * K])          # node lists, then edge lists
    for part, W in ((buf[head:split], W_n), (buf[split:], W_e)):
        # a negative index reads as 2**31 or more
        if part.size and int(part.view(np.uint32).max()) >= 32 * W:
            raise IndexError(f"slot index outside [0, {32 * W})")
    return buf, head


def _chain_planes(chain: list[tuple], U_n: int, U_e: int,
                  device: torch.device, dg: DeltaGraph | None = None
                  ) -> tuple[torch.Tensor, ...]:
    """A chain's ``(na, nd, ea, ed)`` slot index lists as its four stacks of
    packed planes on ``device``: node adds, node dels ``[rows, W_n]``, edge
    adds, edge dels ``[rows, W_e]``, int32 words, one row a step; with
    ``dg``, one more row: zero adds, and ``dg``'s transient slots as dels
    (:func:`_transient_step`).  The host's work is one ``pack`` span, its
    work the planes' words.

    CPU data is packed on the host, one ``bmod.np_from_indices`` a list.
    For CUDA data the host concatenates the lists (:func:`_index_lists`;
    ``pack_indices`` counts their indices), stages them once, and the card
    builds the planes in one ``planes_from_indices`` launch.  Both routes
    refuse an index outside its plane's ``32·W`` slots with
    ``IndexError``."""
    K = len(chain)
    W_n, W_e = bmod.num_words(U_n), bmod.num_words(U_e)
    rows = K + (dg is not None)
    cuda = device.type == "cuda"
    with obs.span("pack", words=2 * rows * (W_n + W_e)):
        tail = () if dg is None else _transient_step(dg, U_n, U_e)
        if cuda:
            buf, head = _index_lists(chain, tail, W_n, W_e)
            obs.count("pack_indices", buf.size - head)
        else:
            planes = []
            for i, U in enumerate((U_n, U_n, U_e, U_e)):
                out = np.zeros((rows, bmod.num_words(U)), np.uint32)
                for k, c in enumerate(chain):
                    out[k] = bmod.np_from_indices(c[i], U)
                if tail and i % 2:
                    out[K] = tail[i // 2]
                planes.append(out)
    if not cuda:
        return tuple(_to_device(p, device) for p in planes)
    staged = _to_device(buf, device)
    an, dn, ae, de = planes_from_indices(staged[head:], staged[:4 * K + 1],
                                         rows, W_n, W_e)
    if tail:
        at = 4 * K + 1
        dn[K].copy_(staged[at:at + W_n])
        de[K].copy_(staged[at + W_n:head])
    return an, dn, ae, de


def execute_singlepoint_torch(dg: DeltaGraph, t: int, *, device="cuda",
                              pool=None, use_current: bool = True
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (node_mask, edge_mask) bool arrays, computed on ``device``."""
    dev = resolve_device(device)
    plan = dg.plan_singlepoint(t, NO_ATTRS, use_current)
    (base_n, base_e), chain = plan_to_chain(dg, plan, pool)
    U_n, U_e = dg.universe.num_nodes, dg.universe.num_edges
    n_adds, n_dels, e_adds, e_dels = _chain_planes(chain, U_n, U_e, dev)
    out_n = delta_apply_chain(_to_device(base_n, dev), n_adds, n_dels)
    out_e = delta_apply_chain(_to_device(base_e, dev), e_adds, e_dels)
    nm = bmod.np_unpack(bmod.to_numpy_words(out_n), U_n)
    em = bmod.np_unpack(bmod.to_numpy_words(out_e), U_e)
    em &= ~dg.universe.edge_transient[:U_e]
    nm &= ~dg.universe.node_transient[:U_n]
    return nm, em


# ---------------------------------------------------------------------------
# fused retrieval + analytics (single pass over the landed bitmaps)
# ---------------------------------------------------------------------------


class _Landed(FusedOut):
    """One plane's :class:`FusedOut` as :class:`SnapshotAnalytics` holds
    it: its readbacks are spans of the retrieval that landed it
    (``retrieval``, the ``retrieve`` span)."""

    def live_count(self):
        with obs.span("analytics.counts", parent=self.retrieval):
            return super().live_count()

    def weighted_total(self):
        with obs.span("analytics.weighted_total", parent=self.retrieval):
            return super().weighted_total()


def _landed(out: FusedOut, retrieval) -> _Landed:
    plane = _Landed(*out)
    plane.retrieval = retrieval
    return plane


class SnapshotAnalytics:
    """Push-style analytics emitted by the fused delta-apply kernel: the
    node/edge :class:`FusedOut` partials from the same pass that landed the
    chain.  ``node.live_count()`` / ``edge.live_count()`` are the snapshot
    order and size; ``edge.live`` feeds :func:`degrees` (per-node degree via
    the segment_sum kernel); ``node.weighted_total()`` is the PageRank push
    mass when per-slot contributions were supplied.  Each of these calls is
    a span of the retrieval (``retrieval``: its ``retrieve`` span), made
    after that span has closed."""

    def __init__(self, node: FusedOut, edge: FusedOut, dg: DeltaGraph,
                 retrieval=None):
        self.node = _landed(node, retrieval)
        self.edge = _landed(edge, retrieval)
        self._dg = dg
        self._retrieval = retrieval

    def num_nodes(self) -> int:
        return int(self.node.live_count())

    def num_edges(self) -> int:
        return int(self.edge.live_count())

    def degrees(self) -> np.ndarray:
        """Per-node degree (both endpoints of live edges) reduced from the
        fused kernel's unpacked edge indicator by the segment_sum kernel —
        no host round-trip between apply and reduction."""
        with obs.span("analytics.degrees", parent=self._retrieval):
            uni = self._dg.universe
            E, N = uni.num_edges, uni.num_nodes
            live = self.edge.live[:E][:, None]
            deg = (segment_sum(live, uni.edge_src[:E], N)
                   + segment_sum(live, uni.edge_dst[:E], N))
            return to_host(deg.reshape(-1))


def _transient_step(dg: DeltaGraph, U_n: int, U_e: int):
    """Transient slots cleared as one more chain step (zero adds, packed
    transient dels) — fused analytics then see exactly the returned masks."""
    return (bmod.np_pack(dg.universe.node_transient[:U_n]),
            bmod.np_pack(dg.universe.edge_transient[:U_e]))


def execute_singlepoint_fused(dg: DeltaGraph, t: int, *,
                              node_weights=None, device="cuda",
                              pool=None, use_current: bool = True
                              ) -> tuple[np.ndarray, np.ndarray,
                                         SnapshotAnalytics]:
    """Single-point retrieval with analytics fused into the apply pass.

    Same plan and chain lowering as :func:`execute_singlepoint_torch`, but
    landed by the fused kernel, node and edge planes in one launch: while
    each thread holds its word's landed chain state in registers it also
    emits popcount/degree partials and (optionally, via ``node_weights
    [num_nodes] f32``) a PageRank-style push accumulator — the separate
    analytics sweep over the mask is gone.
    Transient-slot clearing folds into the chain as a final delete step, so
    analytics and the returned bool masks agree bit-for-bit.

    The call is one ``retrieve`` span (:mod:`repro_torch.obs`); the
    analytics' calls join its request.
    """
    dev = resolve_device(device)
    with obs.span("retrieve", t=t) as retrieval:
        plan = dg.plan_singlepoint(t, NO_ATTRS, use_current)
        (base_n, base_e), chain = plan_to_chain(dg, plan, pool)
        U_n, U_e = dg.universe.num_nodes, dg.universe.num_edges
        n_adds, n_dels, e_adds, e_dels = _chain_planes(chain, U_n, U_e, dev,
                                                       dg)
        w = None
        if node_weights is not None:
            w = _to_device(np.asarray(node_weights, np.float32).reshape(-1),
                           dev)
        fn, fe = delta_apply_fused_pair(
            _to_device(base_n, dev), n_adds, n_dels,
            _to_device(base_e, dev), e_adds, e_dels, w)
        words_n = bmod.to_numpy_words(fn.mask)
        words_e = bmod.to_numpy_words(fe.mask)
        with obs.span("unpack", bits=U_n + U_e):
            nm = bmod.np_unpack(words_n, U_n)
            em = bmod.np_unpack(words_e, U_e)
    return nm, em, SnapshotAnalytics(fn, fe, dg, retrieval)


# ---------------------------------------------------------------------------
# IR DAG execution: batched multi-snapshot apply
# ---------------------------------------------------------------------------

_EMPTY_PAIR = (np.zeros(0, np.int32),) * 4


def _node_pair(dg: DeltaGraph, op, get_payload) -> tuple[np.ndarray, ...]:
    """Lower one apply op to an ``(n_add, n_del, e_add, e_del)`` index
    quadruple; payloads come through ``get_payload`` (memoized per pid,
    possibly prefetched)."""
    if isinstance(op, planir.ApplyDelta):
        d = get_payload("delta", op.pid)
        if op.forward:
            return d.node_add, d.node_del, d.edge_add, d.edge_del
        return d.node_del, d.node_add, d.edge_del, d.edge_add
    if isinstance(op, planir.ApplyElist):
        return _elist_pair(get_payload("elist", op.pid), op.forward, op.rng)
    if isinstance(op, planir.ApplyRecent):
        return _recent_pair(dg, op.forward, op.rng)
    if isinstance(op, planir.Noop):
        return _EMPTY_PAIR
    raise ValueError(f"not an apply op: {op}")  # pragma: no cover


def _make_payload_resolver(dg: DeltaGraph, ir: Plan, prefetch):
    """Memoized payload access for the structure-only backend; with a
    Prefetcher, every Fetch node's (small, struct-component) key list is
    submitted up front — the worker threads fetch *and decode* the blobs,
    so store gets and codec decompression both overlap kernel execution
    and the host-fetch path consumes ready arrays."""
    futs: dict[tuple, Any] = {}
    if prefetch is not None:
        for n in ir.nodes:
            if not isinstance(n.op, planir.Fetch):
                continue
            fk = (n.op.kind, n.op.pid)
            if fk in futs:
                continue
            if n.op.kind == "delta":
                keys, na, ea = dg._delta_keys(n.op.pid, NO_ATTRS)
                allk, meta = keys + na + ea, (len(keys), len(na))
                decode = (lambda blobs, meta=meta:
                          dg._decode_delta(blobs, *meta))
            else:
                allk = dg._elist_keys(n.op.pid, NO_ATTRS)
                decode = (lambda blobs, allk=allk:
                          dg._decode_elist(allk, blobs))
            futs[fk] = prefetch.submit(allk, decode=decode)
    payloads: dict[tuple, Any] = {}

    def get_payload(kind: str, pid: int):
        fk = (kind, pid)
        if fk not in payloads:
            fut = futs.pop(fk, None)
            if fut is not None:
                payloads[fk] = fut.result()   # decoded in the worker
            else:
                payloads[fk] = (dg._fetch_delta(pid, NO_ATTRS)
                                if kind == "delta"
                                else dg._fetch_elist(pid, NO_ATTRS))
        return payloads[fk]

    return get_payload


def _np_apply_pair(bn: np.ndarray, be: np.ndarray, pair, U_n: int, U_e: int):
    na, nd, ea, ed = pair
    bn = (bn & ~bmod.np_from_indices(nd, U_n)) | bmod.np_from_indices(na, U_n)
    be = (be & ~bmod.np_from_indices(ed, U_e)) | bmod.np_from_indices(ea, U_e)
    return bn, be


def _apply_chains_streamed(bases_n: torch.Tensor, bases_e: torch.Tensor,
                           chains, U_n: int, U_e: int, *,
                           device: torch.device, prefetch=None,
                           stager: DeviceStager | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Land B index-quad chains over the node+edge planes ``bases_n [B,
    W_n]`` / ``bases_e [B, W_e]`` (device words), double-buffered.

    ``chains[i]`` is a list of ``(na, nd, ea, ed)`` slot-index quads.  When
    the common chain length exceeds the stream chunk
    (``REPRO_STREAM_CHUNK``, default 8) the ``[B, K, W]`` plane stacks are
    never materialized whole: the :class:`DeviceStager` builds (codec
    indices → packed planes) and copies chunk *i+1* while chunk *i*'s
    kernels run.  The chain is a left fold of bitwise steps, so the
    chunked landing is bit-identical to the monolithic call."""
    W_n, W_e = bmod.num_words(U_n), bmod.num_words(U_e)
    B = len(chains)
    K = max(len(c) for c in chains)
    if K == 0:
        return bases_n, bases_e

    def build(lo: int, hi: int):
        k = hi - lo
        an = np.zeros((B, k, W_n), np.uint32)
        dn = np.zeros((B, k, W_n), np.uint32)
        ae = np.zeros((B, k, W_e), np.uint32)
        de = np.zeros((B, k, W_e), np.uint32)
        for i, chain in enumerate(chains):
            for j in range(lo, min(hi, len(chain))):
                na, nd, ea, ed = chain[j]
                an[i, j - lo] = bmod.np_from_indices(na, U_n)
                dn[i, j - lo] = bmod.np_from_indices(nd, U_n)
                ae[i, j - lo] = bmod.np_from_indices(ea, U_e)
                de[i, j - lo] = bmod.np_from_indices(ed, U_e)
        return an, dn, ae, de

    ck = stream_chunk_k()
    if ck < 1 or K <= ck:
        an, dn, ae, de = (_to_device(a, device) for a in build(0, K))
        return (delta_apply_chain_batched(bases_n, an, dn),
                delta_apply_chain_batched(bases_e, ae, de))

    if stager is None:
        stager = DeviceStager(prefetcher=prefetch, device=device)
    nch = -(-K // ck)

    def apply_chunk(carry, dev):
        bn, be = carry
        an, dn, ae, de = dev
        return (delta_apply_chain_batched(bn, an, dn),
                delta_apply_chain_batched(be, ae, de))

    return stager.stream(
        nch, lambda i: build(i * ck, min((i + 1) * ck, K)), apply_chunk,
        (bases_n, bases_e))


def execute_ir_torch(dg: DeltaGraph, ir: Plan, *, device="cuda",
                     pool=None, prefetch=None,
                     stager: DeviceStager | None = None
                     ) -> dict[Any, tuple[np.ndarray, np.ndarray]]:
    """Execute a plan IR (structure-only) on the device bitmap backend.

    The DAG is decomposed into maximal linear **segments** between
    boundaries (sources, Fork nodes, targets); every wave batches all
    ready segments — sibling branches after a Fork in particular — into a
    single batched ``delta_apply_chain`` launch over stacked bit-planes, so
    B branches cost one pass instead of B sequential chains.  Intermediate
    states stay on the device between waves.

    Returns ``{target: (node_mask, edge_mask)}`` bool arrays.
    """
    dev = resolve_device(device)
    U_n, U_e = dg.universe.num_nodes, dg.universe.num_edges
    W_n, W_e = bmod.num_words(U_n), bmod.num_words(U_e)
    byid = {n.nid: n for n in ir.nodes}
    get_payload = _make_payload_resolver(dg, ir, prefetch)

    # state topology: apply children per state node; forks pass through
    children: dict[int, list[int]] = {}
    fork_child: dict[int, int] = {}
    for n in ir.nodes:
        if isinstance(n.op, planir.APPLY_OPS):
            for d in n.deps:
                if not isinstance(byid[d].op, planir.Fetch):
                    children.setdefault(d, []).append(n.nid)
        elif isinstance(n.op, planir.Fork):
            fork_child[n.deps[0]] = n.nid

    target_nids = set(ir.targets.values())

    def is_boundary(nid: int) -> bool:
        return (nid in target_nids or nid in fork_child
                or len(children.get(nid, ())) != 1)

    # source values (built on the host — one packed bitmap each)
    vals: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
    frontier: list[int] = []
    for n in ir.nodes:
        op = n.op
        if isinstance(op, planir.Source):
            if op.kind == "empty":
                v = (np.zeros(W_n, np.uint32), np.zeros(W_e, np.uint32))
            elif op.kind == "mat":
                assert pool is not None, "materialized plan needs a GraphPool"
                pn, pe = pool._resolve_masks(op.gid)
                v = (_fit_words(pn, W_n), _fit_words(pe, W_e))
            else:  # current = last leaf + recent events
                st = dg._last_leaf_state.resized(dg.universe)
                v = _np_apply_pair(bmod.np_pack(st.node_mask),
                                   bmod.np_pack(st.edge_mask),
                                   _recent_pair(dg, True, None), U_n, U_e)
            vals[n.nid] = (_to_device(v[0], dev), _to_device(v[1], dev))
            frontier.append(n.nid)

    def expand(nid: int) -> None:
        """Fork nodes inherit their parent's value and join the frontier."""
        if nid in fork_child:
            f = fork_child[nid]
            vals[f] = vals[nid]
            frontier.append(f)

    for nid in list(vals):
        expand(nid)

    while frontier:
        # collect every ready segment in this wave
        segments: list[tuple[int, list[int]]] = []   # (parent, [apply nids])
        wave, frontier = frontier, []
        for pnid in wave:
            for c in children.get(pnid, ()):
                seg = [c]
                while not is_boundary(seg[-1]):
                    seg.append(children[seg[-1]][0])
                segments.append((pnid, seg))
        if not segments:
            break
        chains = [[_node_pair(dg, byid[s].op, get_payload) for s in seg]
                  for _, seg in segments]
        bases_n = torch.stack([vals[p][0] for p, _ in segments])
        bases_e = torch.stack([vals[p][1] for p, _ in segments])
        out_n, out_e = _apply_chains_streamed(
            bases_n, bases_e, chains, U_n, U_e, device=dev,
            prefetch=prefetch, stager=stager)
        for i, (_, seg) in enumerate(segments):
            end = seg[-1]
            vals[end] = (out_n[i], out_e[i])
            frontier.append(end)
            expand(end)

    out: dict[Any, tuple[np.ndarray, np.ndarray]] = {}
    for tgt, nid in ir.targets.items():
        nm = bmod.np_unpack(bmod.to_numpy_words(vals[nid][0]), U_n)
        em = bmod.np_unpack(bmod.to_numpy_words(vals[nid][1]), U_e)
        nm &= ~dg.universe.node_transient[:U_n]
        em &= ~dg.universe.edge_transient[:U_e]
        out[tgt] = (nm, em)
    return out


def execute_multipoint_torch(dg: DeltaGraph, times, *, device="cuda",
                             pool=None, use_current: bool = True,
                             land_in_pool: bool = False, prefetch=None,
                             stager: DeviceStager | None = None):
    """Batched multipoint retrieval on the device backend: one Steiner
    plan, sibling branches batched, store gets optionally prefetched.
    Returns ``{t: (node_mask, edge_mask)}``, or ``{t: pool gid}`` when
    ``land_in_pool`` — the masks are then overlaid into GraphPool bit
    pairs in a single batched insert."""
    ir = dg.plan_multipoint([int(t) for t in times], NO_ATTRS, use_current)
    masks = execute_ir_torch(dg, ir, device=device, pool=pool,
                             prefetch=prefetch, stager=stager)
    if not land_in_pool:
        return masks
    assert pool is not None, "land_in_pool needs a GraphPool"
    order = list(masks)
    gids = pool.insert_snapshots_packed(
        [(bmod.np_pack(masks[t][0]), bmod.np_pack(masks[t][1]))
         for t in order])
    return dict(zip(order, gids))


# ---------------------------------------------------------------------------
# batched multi-interval temporal analytics
# ---------------------------------------------------------------------------

def evolve_intervals_torch(dg: DeltaGraph, intervals, *, device="cuda",
                           pool=None, use_current: bool = True,
                           prefetch=None,
                           stager: DeviceStager | None = None
                           ) -> list[dict[int, tuple[np.ndarray, np.ndarray]]]:
    """Per-timepoint (node_mask, edge_mask) for **B intervals at once**.

    The B interval *start* snapshots retrieve as one Steiner plan on the
    batched IR backend (:func:`execute_ir_torch` — sibling branches run as
    one ``delta_apply_chain_batched`` launch); the starts then become the
    base planes of a ``[B, K-1, W]`` stack of inter-snapshot delta bitmaps
    (net event slices from :class:`repro_torch.core.temporal.IntervalSlicer`,
    each covering leaf eventlist fetched once per call) swept by the
    batched prefix chain — every prefix **is** one interval timepoint's
    membership bitmap.  Past ``stream_chunk_k()`` steps the sweep streams
    through a :class:`DeviceStager`, each chunk's last prefix seeding the
    next.

    Returns one ``{t: (node_mask, edge_mask)}`` dict per interval,
    bit-identical to the reference's ``evolve_intervals_jax`` and to the
    host engine.
    """
    from ..core.temporal import IntervalSlicer
    dev = resolve_device(device)
    ivs = [sorted(dict.fromkeys(int(t) for t in iv)) for iv in intervals]
    if not ivs or any(not iv for iv in ivs):
        raise ValueError("every interval needs at least one timepoint")
    U_n, U_e = dg.universe.num_nodes, dg.universe.num_edges
    W_n, W_e = bmod.num_words(U_n), bmod.num_words(U_e)

    # 1. batched retrieval of the B start snapshots (deduped by the plan)
    ir = dg.plan_multipoint([iv[0] for iv in ivs], NO_ATTRS, use_current)
    start_masks = execute_ir_torch(dg, ir, device=dev, pool=pool,
                                   prefetch=prefetch)

    # 2. one slicer for the whole batch: overlapping intervals share leaf
    #    eventlist fetches, and quads are exactly the temporal engine's
    slicer = IntervalSlicer(dg, NO_ATTRS, prefetcher=prefetch)
    for iv in ivs:
        slicer.prefetch_interval(iv[0], iv[-1])
    quads = [[slicer.quad(lo, hi) for lo, hi in zip(iv, iv[1:])]
             for iv in ivs]

    # 3. batched prefix sweep (zero-padded rows are identity steps)
    B = len(ivs)
    Kmax = max(len(q) for q in quads)
    out: list[dict[int, tuple[np.ndarray, np.ndarray]]] = [
        {iv[0]: start_masks[iv[0]]} for iv in ivs]
    if Kmax == 0:
        return out
    bases_n = _to_device(np.stack([bmod.np_pack(start_masks[iv[0]][0])
                                   for iv in ivs]), dev)
    bases_e = _to_device(np.stack([bmod.np_pack(start_masks[iv[0]][1])
                                   for iv in ivs]), dev)

    def build(lo: int, hi: int):
        k = hi - lo
        an = np.zeros((B, k, W_n), np.uint32)
        dn = np.zeros((B, k, W_n), np.uint32)
        ae = np.zeros((B, k, W_e), np.uint32)
        de = np.zeros((B, k, W_e), np.uint32)
        for b, qs in enumerate(quads):
            for j in range(lo, min(hi, len(qs))):
                q = qs[j]
                an[b, j - lo] = bmod.np_from_indices(q.node_add, U_n)
                dn[b, j - lo] = bmod.np_from_indices(q.node_del, U_n)
                ae[b, j - lo] = bmod.np_from_indices(q.edge_add, U_e)
                de[b, j - lo] = bmod.np_from_indices(q.edge_del, U_e)
        return an, dn, ae, de

    ck = stream_chunk_k()
    if ck < 1 or Kmax <= ck:
        an, dn, ae, de = (_to_device(a, dev) for a in build(0, Kmax))
        pref_n = delta_apply_chain_prefix_batched(bases_n, an, dn)
        pref_e = delta_apply_chain_prefix_batched(bases_e, ae, de)
    else:
        # streamed prefix sweep: each chunk's last prefix seeds the next
        # chunk's base, so chunked prefixes concatenate bit-identically
        if stager is None:
            stager = DeviceStager(prefetcher=prefetch, device=dev)
        parts: list[tuple] = []

        def apply_chunk(carry, chunk):
            bn, be = carry
            an, dn, ae, de = chunk
            pn = delta_apply_chain_prefix_batched(bn, an, dn)
            pe = delta_apply_chain_prefix_batched(be, ae, de)
            parts.append((pn, pe))
            return pn[:, -1].contiguous(), pe[:, -1].contiguous()

        stager.stream(-(-Kmax // ck),
                      lambda i: build(i * ck, min((i + 1) * ck, Kmax)),
                      apply_chunk, (bases_n, bases_e))
        pref_n = torch.cat([p[0] for p in parts], dim=1)
        pref_e = torch.cat([p[1] for p in parts], dim=1)
    pref_n = bmod.to_numpy_words(pref_n)
    pref_e = bmod.to_numpy_words(pref_e)
    for b, iv in enumerate(ivs):
        for j, t in enumerate(iv[1:]):
            nm = bmod.np_unpack(pref_n[b, j], U_n)
            em = bmod.np_unpack(pref_e[b, j], U_e)
            nm &= ~dg.universe.node_transient[:U_n]
            em &= ~dg.universe.edge_transient[:U_e]
            out[b][t] = (nm, em)
    return out


# ---------------------------------------------------------------------------
# sharded device layout: the word-cyclic [P, Wp] rows as the batch
# ---------------------------------------------------------------------------

def _to_sharded_layout(idx: np.ndarray, Pn: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Slot → (partition row, local bit) under word_cyclic: word w lives at
    row ``w % P``, column ``w // P``; the local flat bit index is
    ``(w // P) * 32 + (slot & 31)``."""
    w = idx >> 5
    return (w % Pn).astype(np.int64), ((w // Pn) * 32 + (idx & 31)).astype(np.int64)


def _scatter_rows(out_pw: np.ndarray, ix, Pn: int, rows: range | None = None
                  ) -> None:
    """OR slot indices spanning every partition into a ``[P, Wp]`` plane;
    with ``rows``, into the plane of those rows alone (``[len(rows), Wp]``),
    dropping the slots of every other row."""
    ix = np.asarray(ix, np.int64)
    if ix.size == 0:
        return
    row, lbit = _to_sharded_layout(ix, Pn)
    if rows is not None:
        keep = (row >= rows.start) & (row < rows.stop)
        row, lbit = row[keep] - rows.start, lbit[keep]
    np.bitwise_or.at(out_pw, (row, lbit >> 5),
                     np.uint32(1) << (lbit & 31).astype(np.uint32))


def _stack_sharded(chain_idx: list[np.ndarray], U: int, Pn: int,
                   rows: range | None = None) -> np.ndarray:
    """K slot-index sets → ``[P, K, Wp]`` packed words: the reference's
    ``[K, P, Wp]`` stack with the partition axis first, so that the P rows
    are the chain kernel's contiguous batch (with ``rows``, those rows
    alone)."""
    Wp = -(-bmod.num_words(U) // Pn)
    n = Pn if rows is None else len(rows)
    out = np.zeros((n, len(chain_idx), Wp), np.uint32)
    for k, ix in enumerate(chain_idx):
        _scatter_rows(out[:, k], ix, Pn, rows)
    return out


def sharded_base(words: torch.Tensor, Pn: int) -> torch.Tensor:
    """Re-lay a packed bitmap ``[W]`` into the ``[P, Wp]`` word-cyclic
    layout: the words padded to ``P·Wp``, viewed ``[Wp, P]`` and
    transposed (a view, not contiguous)."""
    W = words.shape[0]
    Wp = -(-W // Pn)
    padded = words.new_zeros(Pn * Wp)
    padded[:W] = words
    return padded.view(Wp, Pn).t()


def unshard(words_pw: torch.Tensor, W: int) -> torch.Tensor:
    """The ``[P, Wp]`` word-cyclic layout back to a packed bitmap ``[W]``."""
    return words_pw.t().reshape(-1)[:W]


def _scatter_row(out_kp: np.ndarray, ix: np.ndarray, Pn: int) -> None:
    """OR slot indices into one partition row [Wp] of the word_cyclic
    layout (the caller guarantees every slot belongs to that row)."""
    ix = np.asarray(ix, np.int64)
    if ix.size == 0:
        return
    lbit = ((ix >> 5) // Pn) * 32 + (ix & 31)
    np.bitwise_or.at(out_kp, lbit >> 5,
                     np.uint32(1) << (lbit & 31).astype(np.uint32))


def plan_to_chain_sharded(dg: DeltaGraph, plan: Plan, Pn: int, pool=None,
                          rows: range | None = None
                          ) -> tuple[tuple[np.ndarray, np.ndarray],
                                     tuple[np.ndarray, ...]]:
    """Lower a *singlepoint* plan into base bitmaps plus per-partition
    ``[P, K, Wp]`` add/del stacks (node adds, node dels, edge adds, edge
    dels), fetching each storage partition's sub-payloads **separately** —
    the fetch pattern of the aligned deployment, where partition ``p``
    pulls only its own keys from the store and fills exactly its own
    layout row.

    Requires ``dg.P == Pn`` under the ``word_cyclic`` partitioner, so a
    delta/eventlist sub-payload's slots land entirely in row ``p``.
    In-memory steps (recent events, which are not yet partitioned into
    storage) carry slots from every partition and are scattered across
    rows like the dense path does.

    With ``rows`` (a rank's contiguous share of the P rows) only those
    partitions' sub-payloads are fetched and the stacks are ``[len(rows),
    K, Wp]``, equal to those rows of the whole stacks."""
    if dg.P != Pn or dg.partition_fn_name != "word_cyclic":
        raise ValueError(
            f"aligned sharded lowering needs dg.P == {Pn} storage "
            f"partitions under word_cyclic; have P={dg.P} "
            f"fn={dg.partition_fn_name}")
    rows = range(Pn) if rows is None else rows
    (base_n, base_e), full = _plan_base(dg, plan, pool)
    entries: list[tuple[str, Any]] = [("full", pair) for pair in full]
    for st in plan.steps[1:]:
        kind = st.action[0]
        if kind == "delta":
            per = []
            for p in rows:
                d = dg._fetch_delta(st.action[1], NO_ATTRS, parts=(p,))
                if st.action[2]:
                    per.append((d.node_add, d.node_del,
                                d.edge_add, d.edge_del))
                else:
                    per.append((d.node_del, d.node_add,
                                d.edge_del, d.edge_add))
            entries.append(("parts", per))
        elif kind == "elist":
            per = []
            for p in rows:
                comps = dg._fetch_elist(st.action[1], NO_ATTRS,
                                        parts=(p,))
                per.append(_elist_pair(comps, st.action[2], st.action[3])
                           if col.ELIST_STRUCT in comps else _EMPTY_PAIR)
            entries.append(("parts", per))
        elif kind == "recent":
            entries.append(("full", _recent_pair(dg, st.action[2],
                                                 st.action[3])))
        elif kind == "noop":
            pass
        else:  # pragma: no cover
            raise ValueError(st.action)
    K = len(entries)
    U_n, U_e = dg.universe.num_nodes, dg.universe.num_edges
    stacks = tuple(np.zeros((len(rows), K, -(-bmod.num_words(U) // Pn)),
                            np.uint32) for U in (U_n, U_n, U_e, U_e))
    for k, (tag, data) in enumerate(entries):
        if tag == "parts":
            for r, pair in enumerate(data):
                for st_arr, ix in zip(stacks, pair):
                    _scatter_row(st_arr[r, k], ix, Pn)
        else:  # full-state step: slots span partitions
            for st_arr, ix in zip(stacks, data):
                _scatter_rows(st_arr[:, k], ix, Pn, rows)
    return (base_n, base_e), stacks


def lower_singlepoint_sharded(dg: DeltaGraph, t: int, *, partitions: int,
                              device="cuda", pool=None,
                              use_current: bool = True,
                              rows: range | None = None) -> list[tuple]:
    """The host half of sharded retrieval: plan, lower and stage.  Returns
    one ``(base [P, Wp], adds [P, K, Wp], dels [P, K, Wp], U)`` per plane
    (nodes, edges), the words on ``device``; with ``rows`` (a contiguous
    range of the P rows) those rows alone, ``[len(rows), ...]``.

    With ``dg.P == partitions`` under ``word_cyclic`` (the aligned
    deployment) every partition's sub-payloads are fetched separately and
    fill exactly their own row (with ``rows``, only those partitions' are
    fetched); otherwise the dense chain is re-laid into the sharded
    layout."""
    dev = resolve_device(device)
    Pn = int(partitions)
    if Pn < 1:
        raise ValueError(f"partitions must be >= 1, got {partitions}")
    plan = dg.plan_singlepoint(t, NO_ATTRS, use_current)
    U_n, U_e = dg.universe.num_nodes, dg.universe.num_edges
    if dg.P == Pn and dg.partition_fn_name == "word_cyclic":
        (base_n, base_e), stacks = plan_to_chain_sharded(dg, plan, Pn, pool,
                                                         rows)
    else:
        (base_n, base_e), chain = plan_to_chain(dg, plan, pool)
        stacks = tuple(_stack_sharded([c[i] for c in chain], U, Pn, rows)
                       for i, U in enumerate((U_n, U_n, U_e, U_e)))
    an, dn, ae, de = (_to_device(a, dev) for a in stacks)
    sel = slice(None) if rows is None else slice(rows.start, rows.stop)
    return [(sharded_base(_to_device(base, dev), Pn)[sel].contiguous(), a, d,
             U)
            for base, a, d, U in ((base_n, an, dn, U_n),
                                  (base_e, ae, de, U_e))]


def execute_singlepoint_sharded_torch(dg: DeltaGraph, t: int, *,
                                      partitions: int, device="cuda",
                                      pool=None, use_current: bool = True
                                      ) -> tuple[np.ndarray, np.ndarray]:
    """Sharded retrieval on one device: ``partitions`` word-cyclic rows
    land as the batch of one ``delta_apply_chain_batched`` launch per
    plane (the reference's ``execute_singlepoint_sharded`` runs one row
    per device of a mesh).  Returns (node_mask, edge_mask) bool arrays,
    bit-identical to :func:`execute_singlepoint_torch`."""
    outs = []
    for base, adds, dels, U in lower_singlepoint_sharded(
            dg, t, partitions=partitions, device=device, pool=pool,
            use_current=use_current):
        out = delta_apply_chain_batched(base, adds, dels)
        words = bmod.to_numpy_words(unshard(out, bmod.num_words(U)))
        outs.append(bmod.np_unpack(words, U))
    nm, em = outs
    em &= ~dg.universe.edge_transient[:em.size]
    nm &= ~dg.universe.node_transient[:nm.size]
    return nm, em


def rank_rows(partitions: int, rank: int, world: int) -> range:
    """The contiguous rows of the ``[P, Wp]`` layout that ``rank`` of
    ``world`` owns: ``P / world`` of them (``world`` must divide P)."""
    if world < 1 or partitions % world:
        raise ValueError(f"the world size ({world}) must divide the "
                         f"partitions ({partitions})")
    n = partitions // world
    return range(rank * n, (rank + 1) * n)


def execute_singlepoint_sharded_rank(dg: DeltaGraph, t: int, *,
                                     partitions: int, device="cuda",
                                     pool=None, use_current: bool = True,
                                     group=None
                                     ) -> tuple[np.ndarray, np.ndarray]:
    """Sharded retrieval under ``torch.distributed``, one rank's share on
    its own ``device``: the rank-local form of the reference's
    ``execute_singlepoint_sharded``, whose ``shard_map`` gives each device
    of a ``retrieval_mesh`` one row of the ``[P, Wp]`` word-cyclic layout.

    Each of the ``world`` ranks of ``group`` (the default group if None;
    ``world`` must divide ``partitions``) plans the timepoint, lowers only
    its own rows (:func:`rank_rows`; in the aligned deployment it fetches
    only its own partitions' sub-payloads), and lands them as the batch of
    one ``delta_apply_chain_batched`` launch per plane.  No collective runs
    between lowering and the kernel.  The rows then reach every rank
    through one host gather (``all_gather_object`` of the numpy words), as
    the reference's caller reads ``shard_map``'s output back to the host;
    the group's backend carries host objects (``gloo``).  Returns (node_mask,
    edge_mask) bool arrays on every rank, bit-identical to
    :func:`execute_singlepoint_sharded_torch`."""
    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    rows = rank_rows(int(partitions), rank, world)
    mine = []
    for base, adds, dels, U in lower_singlepoint_sharded(
            dg, t, partitions=partitions, device=device, pool=pool,
            use_current=use_current, rows=rows):
        mine.append(delta_apply_chain_batched(base, adds, dels).cpu()
                    .numpy())
    gathered: list = [None] * world
    dist.all_gather_object(gathered, mine, group=group)
    outs = []
    for plane, U in enumerate((dg.universe.num_nodes,
                               dg.universe.num_edges)):
        words_pw = torch.from_numpy(np.concatenate(
            [g[plane] for g in gathered]))
        words = bmod.to_numpy_words(unshard(words_pw, bmod.num_words(U)))
        outs.append(bmod.np_unpack(words, U))
    nm, em = outs
    em &= ~dg.universe.edge_transient[:em.size]
    nm &= ~dg.universe.node_transient[:nm.size]
    return nm, em
