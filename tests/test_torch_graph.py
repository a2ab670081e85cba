"""The port's graph algorithms and Pregel runner against the JAX package's.

A seeded churn history from the JAX package's generator, carried into the
port through ``interop``, gives the snapshot planes; on
the CPU (``device="cpu"``) every function of
``repro_torch.graph.algorithms`` and ``repro_torch.graph.pregel`` is held
against its ``repro.graph`` counterpart: labels, degrees, counts and host
helpers exactly, PageRank (fixed-step, batched, and both fixpoint forms)
within 1e-5 with fixpoint iteration counts within 2.  The fixpoint's
block-of-steps convergence check must stop at the same iterate as a check
after every step.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data.generators import churn_network as j_churn_network
from repro.graph import algorithms as jalg
from repro.graph import pregel as jpregel

from repro_torch.core import bitmaps as bm
from repro_torch.core import EventList, replay
from repro_torch.core.temporal import IntervalSlicer
from repro_torch.core.deltagraph import DeltaGraph
from repro_torch.interop import build_universe, event_arrays, universe_arrays
from repro_torch.graph import algorithms as alg
from repro_torch.graph import pregel
from repro_torch.storage.kv import MemKV

CPU = "cpu"


@pytest.fixture(scope="module")
def snaps():
    """``(uni, ev, states)``: the churn history in the port and three
    replayed snapshots."""
    juni, jev = j_churn_network(n_initial_edges=120, n_events=900, seed=11)
    uni = build_universe(universe_arrays(juni))
    ev = EventList(**event_arrays(jev))
    states = [replay(uni, ev, int(ev.time[i])) for i in (300, 600, 899)]
    return uni, ev, states


def _planes(st):
    return bm.np_pack(st.edge_mask), bm.np_pack(st.node_mask)


def _j(a):
    return jnp.asarray(a)


def test_pagerank_fixed_steps(snaps):
    uni, _, states = snaps
    for st in states:
        ep, npl = _planes(st)
        for iters in (1, 20, 60):
            got = alg.pagerank(uni.edge_src, uni.edge_dst, ep, npl,
                               num_nodes=uni.num_nodes, iters=iters,
                               device=CPU)
            want = jalg.pagerank(_j(uni.edge_src), _j(uni.edge_dst), _j(ep),
                                 _j(npl), num_nodes=uni.num_nodes,
                                 iters=iters)
            assert got.dtype == torch.float32
            assert np.allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_multi_snapshot_pagerank(snaps):
    uni, _, states = snaps
    eps = np.stack([_planes(st)[0] for st in states])
    nps = np.stack([_planes(st)[1] for st in states])
    got = alg.multi_snapshot_pagerank(uni.edge_src, uni.edge_dst, eps, nps,
                                      num_nodes=uni.num_nodes, device=CPU)
    want = jalg.multi_snapshot_pagerank(_j(uni.edge_src), _j(uni.edge_dst),
                                        eps, nps, num_nodes=uni.num_nodes)
    assert got.shape == (len(states), uni.num_nodes)
    assert np.allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for g, st in zip(got, states):       # a batch row is one snapshot
        one = alg.pagerank(uni.edge_src, uni.edge_dst, *_planes(st),
                           num_nodes=uni.num_nodes, device=CPU)
        assert torch.equal(g, one)


def test_degrees_components_triangles(snaps):
    uni, _, states = snaps
    for st in states:
        ep, npl = _planes(st)
        deg = alg.degrees_masked(uni.edge_src, uni.edge_dst, ep,
                                 num_nodes=uni.num_nodes, device=CPU)
        jdeg = jalg.degrees_masked(_j(uni.edge_src), _j(uni.edge_dst), _j(ep),
                                   num_nodes=uni.num_nodes)
        assert deg.dtype == torch.int32
        assert np.array_equal(deg.numpy(), np.asarray(jdeg))
        for iters in (3, 50):
            cc = alg.connected_components(uni.edge_src, uni.edge_dst, ep, npl,
                                          num_nodes=uni.num_nodes,
                                          iters=iters, device=CPU)
            jcc = jalg.connected_components(
                _j(uni.edge_src), _j(uni.edge_dst), _j(ep), _j(npl),
                num_nodes=uni.num_nodes, iters=iters)
            assert np.array_equal(cc.numpy(), np.asarray(jcc))
        assert (alg.triangle_count(uni.edge_src, uni.edge_dst, st.edge_mask,
                                   uni.num_nodes)
                == jalg.triangle_count(uni.edge_src, uni.edge_dst,
                                       st.edge_mask, uni.num_nodes))
        got = alg.edge_mask_from_plane(ep, uni.num_edges, device=CPU)
        assert np.array_equal(got.numpy(), st.edge_mask)


def test_compaction_helpers(snaps):
    uni, _, states = snaps
    for n in (0, 1, 511, 512, 513, 5000):
        assert alg._edge_bucket(n) == jalg._edge_bucket(n)
    for st in states:
        for g, w in zip(alg._compact_edges(uni.edge_src, uni.edge_dst,
                                           st.edge_mask),
                        jalg._compact_edges(uni.edge_src, uni.edge_dst,
                                            st.edge_mask)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _pr_fixpoint_pair(uni, st, pr0, impl, **kw):
    ep, npl = _planes(st)
    args = (uni.edge_src, uni.edge_dst, ep, npl, pr0)
    kw = dict(num_nodes=uni.num_nodes, force_impl=impl, **kw)
    return (alg.pagerank_fixpoint(*args, device=CPU, **kw),
            jalg.pagerank_fixpoint(*args, **kw))


@pytest.mark.parametrize("impl", ["dense", "segment"])
@pytest.mark.parametrize("tol", [1e-4, 1e-6])
def test_pagerank_fixpoint(snaps, impl, tol):
    uni, _, states = snaps
    for st in states:
        pr0 = st.node_mask.astype(np.float32) / max(st.node_mask.sum(), 1)
        (pr, it), (jpr, jit) = _pr_fixpoint_pair(uni, st, pr0, impl, tol=tol)
        assert isinstance(pr, np.ndarray) and pr.dtype == np.float32
        assert np.allclose(pr, jpr, atol=1e-5)
        assert abs(it - jit) <= 2, (it, jit)
    # max_iters caps both, and a cap of 0 returns the projected start
    (pr, it), (jpr, jit) = _pr_fixpoint_pair(uni, states[0], pr0, impl,
                                             tol=0.0, max_iters=5)
    assert it == jit == 5 and np.allclose(pr, jpr, atol=1e-6)
    (pr, it), (jpr, jit) = _pr_fixpoint_pair(uni, states[0], pr0, impl,
                                             max_iters=0)
    assert it == jit == 0 and np.allclose(pr, jpr, atol=1e-7)


def test_pagerank_dense_and_segment_agree(snaps):
    uni, _, states = snaps
    st = states[1]
    pr0 = st.node_mask.astype(np.float32) / max(st.node_mask.sum(), 1)
    (dn, di), _ = _pr_fixpoint_pair(uni, st, pr0, "dense")
    (sg, si), _ = _pr_fixpoint_pair(uni, st, pr0, "segment")
    assert np.allclose(dn, sg, atol=1e-6) and abs(di - si) <= 1


def test_warm_starts_and_incremental_degrees(snaps):
    """The host helpers of the incremental operators, on real slices."""
    uni, ev, states = snaps
    dg = DeltaGraph(uni, MemKV(), L=64, k=2).build(ev)
    slicer = IntervalSlicer(dg)
    t0, t1 = int(ev.time[300]), int(ev.time[600])
    q = slicer.quad(t0, t1)
    st0, st1 = states[0], states[1]
    touched = q.touched_nodes(uni.edge_src, uni.edge_dst)
    rng = np.random.default_rng(0)
    prev = rng.random(uni.num_nodes).astype(np.float32)
    assert np.array_equal(
        alg.pagerank_warm_start(prev, st1.node_mask, touched),
        jalg.pagerank_warm_start(prev, st1.node_mask, touched))
    labels0, _ = alg.connected_components_fixpoint(
        uni.edge_src, uni.edge_dst, *_planes(st0),
        np.arange(uni.num_nodes, dtype=np.int32), num_nodes=uni.num_nodes,
        device=CPU)
    args = (labels0, st1.node_mask, (q.node_add, q.node_del),
            (q.edge_add, q.edge_del), uni.edge_src, uni.edge_dst)
    warm = alg.cc_warm_labels(*args)
    assert np.array_equal(warm, jalg.cc_warm_labels(*args))
    deg0 = np.zeros(uni.num_nodes, np.int64)
    live = np.nonzero(st0.edge_mask)[0]
    np.add.at(deg0, uni.edge_src[live], 1)
    np.add.at(deg0, uni.edge_dst[live], 1)
    args = (deg0, q.edge_add, q.edge_del, uni.edge_src, uni.edge_dst)
    assert np.array_equal(alg.incremental_degrees(*args),
                          jalg.incremental_degrees(*args))


@pytest.mark.parametrize("warm", [False, True])
def test_components_fixpoint(snaps, warm):
    uni, ev, states = snaps
    for st in states:
        ep, npl = _planes(st)
        labels0 = np.arange(uni.num_nodes, dtype=np.int32)
        if warm:     # a warm start from the previous snapshot's labels
            prev, _ = jalg.connected_components_fixpoint(
                uni.edge_src, uni.edge_dst, *_planes(states[0]), labels0,
                num_nodes=uni.num_nodes)
            labels0 = np.where(st.node_mask, np.minimum(
                np.asarray(prev), labels0), labels0).astype(np.int32)
        got, it = alg.connected_components_fixpoint(
            uni.edge_src, uni.edge_dst, ep, npl, labels0,
            num_nodes=uni.num_nodes, device=CPU)
        want, jit = jalg.connected_components_fixpoint(
            uni.edge_src, uni.edge_dst, ep, npl, labels0,
            num_nodes=uni.num_nodes)
        assert np.array_equal(got, np.asarray(want)) and it == jit


def test_fixpoint_stops_at_the_first_converged_iterate(snaps, monkeypatch):
    """The block-of-steps rule returns what a check after every step
    would: the same iterate, bit for bit, and the same count."""
    calls = []

    def step(x, i):
        calls.append(i)
        return x + 1

    for cap in (3, 11, 64):
        for block in (1, 3, 8):
            monkeypatch.setattr(alg, "FIXPOINT_BLOCK", block)
            x, it = alg._fixpoint(torch.tensor(0), step,
                                  lambda new, old: new >= 5, cap)
            assert (int(x), it) == ((5, 5) if cap >= 5 else (cap, cap))
    uni, _, states = snaps
    st = states[2]
    pr0 = st.node_mask.astype(np.float32) / max(st.node_mask.sum(), 1)
    out = {}
    for block in (1, 8):
        monkeypatch.setattr(alg, "FIXPOINT_BLOCK", block)
        out[block] = (
            alg.pagerank_fixpoint(uni.edge_src, uni.edge_dst, *_planes(st),
                                  pr0, num_nodes=uni.num_nodes,
                                  force_impl="segment", device=CPU),
            alg.connected_components_fixpoint(
                uni.edge_src, uni.edge_dst, *_planes(st),
                np.arange(uni.num_nodes, dtype=np.int32),
                num_nodes=uni.num_nodes, device=CPU))
    (p1, i1), (c1, k1) = out[1]
    (p8, i8), (c8, k8) = out[8]
    assert i1 == i8 and i1 % 8 != 0 and np.array_equal(p1, p8)
    assert k1 == k8 and np.array_equal(c1, c8)


def test_run_pregel_matches_jax(snaps):
    uni, _, states = snaps
    st = states[1]
    ep = _planes(st)[0]
    N = uni.num_nodes
    state0 = np.random.default_rng(1).random((N, 3)).astype(np.float32)

    def upd_t(state, agg, step):
        return 0.5 * state + 0.1 * agg + 0.01 * step

    def upd_j(state, agg, step):
        return 0.5 * state + 0.1 * agg + 0.01 * step

    def msg_t(s, d, live):
        return (s - d) * live[:, None]

    def msg_j(s, d, live):
        return (s - d) * live[:, None]

    for bidir in (True, False):
        got = pregel.run_pregel(state0, uni.edge_src, uni.edge_dst, ep,
                                msg_t, upd_t, num_supersteps=6, num_nodes=N,
                                bidirectional=bidir, device=CPU)
        want = jpregel.run_pregel(_j(state0), _j(uni.edge_src),
                                  _j(uni.edge_dst), _j(ep), msg_j, upd_j,
                                  num_supersteps=6, num_nodes=N,
                                  bidirectional=bidir)
        assert np.allclose(got.numpy(), np.asarray(want), atol=1e-5)
        got, steps = pregel.run_pregel_until(
            state0, uni.edge_src, uni.edge_dst, ep, msg_t,
            lambda s, a, i: 0.5 * s + 0.1 * a, max_supersteps=50,
            num_nodes=N, tol=1e-3, bidirectional=bidir, device=CPU)
        want, jsteps = jpregel.run_pregel_until(
            _j(state0), _j(uni.edge_src), _j(uni.edge_dst), _j(ep), msg_j,
            lambda s, a, i: 0.5 * s + 0.1 * a, max_supersteps=50,
            num_nodes=N, tol=1e-3, bidirectional=bidir)
        assert isinstance(steps, int) and abs(steps - int(jsteps)) <= 2
        assert np.allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_pregel_degree_is_exact(snaps):
    """Counting messages: exact against the JAX runner and the degrees."""
    uni, _, states = snaps
    st = states[0]
    ep = _planes(st)[0]
    N = uni.num_nodes
    got = pregel.run_pregel(np.zeros(N, np.float32), uni.edge_src,
                            uni.edge_dst, ep,
                            lambda s, d, live: live.to(torch.float32),
                            lambda s, a, i: a, num_supersteps=1,
                            num_nodes=N, device=CPU)
    want = jpregel.run_pregel(jnp.zeros(N, jnp.float32), _j(uni.edge_src),
                              _j(uni.edge_dst), _j(ep),
                              lambda s, d, live: live.astype(jnp.float32),
                              lambda s, a, i: a, num_supersteps=1,
                              num_nodes=N)
    assert np.array_equal(got.numpy(), np.asarray(want))
    deg = alg.degrees_masked(uni.edge_src, uni.edge_dst, ep, num_nodes=N,
                             device=CPU)
    assert np.array_equal(got.numpy().astype(np.int32), deg.numpy())


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.mark.parametrize("name", ["pagerank", "degrees_masked",
                                  "connected_components",
                                  "multi_snapshot_pagerank",
                                  "pagerank_fixpoint",
                                  "connected_components_fixpoint",
                                  "run_pregel", "run_pregel_until"])
def test_graph_entry_points_default_to_the_card(no_card, snaps, name):
    uni, _, states = snaps
    ep, npl = _planes(states[0])
    N = uni.num_nodes
    es, ed = uni.edge_src, uni.edge_dst
    calls = {
        "pagerank": lambda **kw: alg.pagerank(es, ed, ep, npl, num_nodes=N,
                                              **kw),
        "degrees_masked": lambda **kw: alg.degrees_masked(
            es, ed, ep, num_nodes=N, **kw),
        "connected_components": lambda **kw: alg.connected_components(
            es, ed, ep, npl, num_nodes=N, **kw),
        "multi_snapshot_pagerank": lambda **kw: alg.multi_snapshot_pagerank(
            es, ed, ep[None], npl[None], num_nodes=N, **kw),
        "pagerank_fixpoint": lambda **kw: alg.pagerank_fixpoint(
            es, ed, ep, npl, np.ones(N, np.float32), num_nodes=N, **kw),
        "connected_components_fixpoint":
            lambda **kw: alg.connected_components_fixpoint(
                es, ed, ep, npl, np.arange(N, dtype=np.int32), num_nodes=N,
                **kw),
        "run_pregel": lambda **kw: pregel.run_pregel(
            np.zeros(N, np.float32), es, ed, ep, lambda s, d, m: m.float(),
            lambda s, a, i: a, num_supersteps=1, num_nodes=N, **kw),
        "run_pregel_until": lambda **kw: pregel.run_pregel_until(
            np.zeros(N, np.float32), es, ed, ep, lambda s, d, m: m.float(),
            lambda s, a, i: a, max_supersteps=2, num_nodes=N, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()
    assert calls[name](device=CPU) is not None
