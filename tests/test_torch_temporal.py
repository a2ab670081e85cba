"""The port's temporal engine against the JAX package's, on the CPU.

Both packages build a ``GraphManager`` over the same seeded history, made
by the JAX package's generator and carried into the port through
``interop.universe_arrays`` / ``build_universe`` / ``event_arrays``.  Held against the
reference and the ``replay`` oracle:

* ``delta_apply_chain_prefix(_batched)`` and ``evolve_intervals_torch``,
  monolithic and streamed: bit for bit;
* every named operator, incremental and recompute: masks, degree, density
  and components exactly, PageRank within 1e-5 (the reference suite's
  bound, ``tests/test_differential_exec.py``) with solver iteration counts
  within 2 of the reference's (f32 sums differ in order);
* ``PregelFold`` (torch callables on the port's side) and the callable
  fold;
* ``SnapshotBatchLoader`` batches key by key, ``x`` exactly;
* the validation errors of ``tests/test_temporal.py``, the default device
  and the unported sharding.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import GraphManager as JGraphManager
from repro.core import PregelFold as JPregelFold
from repro.core import SnapshotBatchLoader as JSnapshotBatchLoader
from repro.data.generators import churn_network as j_churn_network
from repro.data.generators import random_history as j_random_history
from repro.kernels.delta_apply.ops import (
    delta_apply_chain_prefix as j_prefix,
    delta_apply_chain_prefix_batched as j_prefix_batched)
from repro.runtime.jax_exec import evolve_intervals_jax

from repro_torch.core import (EventList, GraphManager, PregelFold,
                              SnapshotBatchLoader, TimeExpression, replay)
from repro_torch.core.temporal import PageRankOp
from repro_torch.data.generators import random_history
from repro_torch.interop import build_universe, event_arrays, universe_arrays
from repro_torch.kernels import (delta_apply_chain_prefix,
                                 delta_apply_chain_prefix_batched)
from repro_torch.launch import serve
from repro_torch.runtime.torch_exec import evolve_intervals_torch

CPU = "cpu"


def carry(juni, jev):
    """A JAX-package history as the port's universe and events."""
    return (build_universe(universe_arrays(juni)),
            EventList(**event_arrays(jev)))


def _churn(**args):
    """``((uni, ev), (juni, jev))``: one churn history in both packages."""
    juni, jev = j_churn_network(**args)
    return carry(juni, jev), (juni, jev)


@pytest.fixture(scope="module")
def both():
    """``(uni, ev, gm, jgm, times)`` over one churn history."""
    (uni, ev), (juni, jev) = _churn(n_initial_edges=80, n_events=1200,
                                    seed=4)
    gm = GraphManager(uni, ev, L=64, k=2, device=CPU)
    jgm = JGraphManager(juni, jev, L=64, k=2)
    tmax = int(ev.time[-1])
    times = [int(t) for t in np.linspace(tmax // 4, tmax, 12)]
    yield uni, ev, gm, jgm, times
    gm.close()
    jgm.close()


# ---------------------------------------------------------------------------
# prefix chains and the batched interval sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,K,W", [(1, 1, 1), (3, 5, 37), (2, 0, 9),
                                   (4, 9, 300)])
def test_prefix_chain_bit_identical(B, K, W):
    rng = np.random.default_rng(B * 100 + K * 10 + W)
    bases = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint32)
    adds = rng.integers(0, 2 ** 32, (B, K, W), dtype=np.uint32)
    dels = rng.integers(0, 2 ** 32, (B, K, W), dtype=np.uint32)

    def t(a):
        return torch.from_numpy(a.view(np.int32))

    got = delta_apply_chain_prefix_batched(t(bases), t(adds), t(dels))
    want = np.asarray(j_prefix_batched(jnp.asarray(bases), jnp.asarray(adds),
                                       jnp.asarray(dels)))
    assert got.shape == (B, K, W)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    one = delta_apply_chain_prefix(t(bases[0]), t(adds[0]), t(dels[0]))
    want1 = np.asarray(j_prefix(jnp.asarray(bases[0]), jnp.asarray(adds[0]),
                                jnp.asarray(dels[0])))
    assert np.array_equal(one.numpy().view(np.uint32), want1)


def _histories(kind):
    if kind == "churn":
        return _churn(n_initial_edges=60, n_events=900, seed=7)
    juni, jev = j_random_history(300, 5, max_time_step=2)
    return carry(juni, jev), (juni, jev)


@pytest.mark.parametrize("kind", ["churn", "random"])
@pytest.mark.parametrize("chunk", ["0", "2"])
def test_evolve_intervals_bit_identical(monkeypatch, kind, chunk):
    """Monolithic (chunk 0) and streamed (chunk 2) sweeps of overlapping
    intervals equal the reference's and replay, transient slots masked."""
    (uni, ev), (juni, jev) = _histories(kind)
    gm = GraphManager(uni, ev, L=48, k=2, device=CPU)
    jgm = JGraphManager(juni, jev, L=48, k=2)
    tmax = int(ev.time[-1])
    ivs = [list(range(0, tmax + 3, max(1, tmax // 13))),
           list(range(tmax // 3, tmax // 2, 3)), [tmax // 2]]
    monkeypatch.setenv("REPRO_STREAM_CHUNK", chunk)
    got = evolve_intervals_torch(gm.dg, ivs, device=CPU, pool=gm.pool,
                                 prefetch=gm.prefetcher)
    want = evolve_intervals_jax(jgm.dg, ivs, pool=jgm.pool,
                                prefetch=jgm.prefetcher)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for t in g:
            assert np.array_equal(g[t][0], w[t][0]), t
            assert np.array_equal(g[t][1], w[t][1]), t
            truth = replay(uni, ev, t)
            assert np.array_equal(g[t][0], truth.node_mask), t
            assert np.array_equal(g[t][1], truth.edge_mask), t
    gm.close()
    jgm.close()


def test_evolve_intervals_validation():
    uni, ev = random_history(60, 0)
    gm = GraphManager(uni, ev, L=16, k=2, device=CPU)
    with pytest.raises(ValueError):
        evolve_intervals_torch(gm.dg, [], device=CPU)
    with pytest.raises(ValueError):
        evolve_intervals_torch(gm.dg, [[1], []], device=CPU)
    # single-point interval degenerates to plain retrieval
    t = int(ev.time[-1]) // 2
    (out,) = evolve_intervals_torch(gm.dg, [[t]], device=CPU, pool=gm.pool)
    truth = replay(uni, ev, t)
    assert np.array_equal(out[t][0], truth.node_mask)
    assert np.array_equal(out[t][1], truth.edge_mask)
    gm.close()


# ---------------------------------------------------------------------------
# operators through GraphManager.evolve
# ---------------------------------------------------------------------------


def _assert_value_equal(got, want, msg):
    if isinstance(want, dict):
        assert got == want, msg
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            assert np.array_equal(g, w), msg
    else:
        assert got.dtype == want.dtype, msg
        assert np.array_equal(got, want), msg


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("op", ["masks", "degree", "density", "components"])
def test_counting_ops_exact(both, op, incremental):
    uni, ev, gm, jgm, times = both
    got = gm.evolve(times, op, incremental=incremental)
    want = jgm.evolve(times, op, incremental=incremental)
    assert got.times == want.times
    for t, g, w in zip(got.times, got.values, want.values):
        _assert_value_equal(g, np.asarray(w) if isinstance(w, np.ndarray)
                            else w, f"{op} t={t}")
    assert got.stats["solver_iters"] == want.stats["solver_iters"]
    if incremental:
        assert (got.stats["elists_fetched"] == want.stats["elists_fetched"]
                and got.stats["net_changes"] == want.stats["net_changes"])


@pytest.mark.parametrize("incremental", [True, False])
def test_pagerank_op_within_tolerance(both, incremental):
    uni, ev, gm, jgm, times = both
    got = gm.evolve(times, "pagerank", tol=1e-6, incremental=incremental)
    want = jgm.evolve(times, "pagerank", tol=1e-6, incremental=incremental)
    for t, g, w in zip(got.times, got.values, want.values):
        assert g.dtype == np.float32
        assert np.allclose(g, w, atol=1e-5), t
    for gi, wi in zip(got.stats["solver_iters"], want.stats["solver_iters"]):
        assert abs(gi - wi) <= 2, (got.stats["solver_iters"],
                                   want.stats["solver_iters"])


def test_components_incremental_equals_recompute(both):
    uni, ev, gm, jgm, times = both
    inc = gm.evolve(times, "components")
    rec = gm.evolve(times, "components", incremental=False)
    for a, b in zip(inc.values, rec.values):
        assert np.array_equal(a, b)
    assert sum(inc.stats["solver_iters"]) <= sum(rec.stats["solver_iters"])


def test_pregel_fold_matches_jax(both):
    """Masked degree as a Pregel vertex program, warm-started across
    timepoints; the port's callables are torch, the reference's jnp."""
    uni, ev, gm, jgm, times = both
    N = uni.num_nodes
    fold = PregelFold(
        init_fn=lambda ctx, state, t: np.zeros(N, np.float32),
        msg_fn=lambda s_src, s_dst, live: live.to(torch.float32),
        update_fn=lambda state, agg, step: agg,
        max_supersteps=2, tol=0.0, bidirectional=True)
    jfold = JPregelFold(
        init_fn=lambda ctx, state, t: np.zeros(N, np.float32),
        msg_fn=lambda s_src, s_dst, live: live.astype(jnp.float32),
        update_fn=lambda state, agg, step: agg,
        max_supersteps=2, tol=0.0, bidirectional=True)
    got = gm.evolve(times[:5], fold)
    want = jgm.evolve(times[:5], jfold)
    deg = gm.evolve(times[:5], "degree")
    for g, w, d in zip(got.values, want.values, deg.values):
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g.astype(np.int64), d)
    assert got.stats["solver_iters"] == want.stats["solver_iters"]


def test_pregel_fold_with_tolerance_matches_jax(both):
    """A damped averaging program that converges under ``tol``: states
    within 1e-5 and the same superstep counts within 2."""
    uni, ev, gm, jgm, times = both
    N = uni.num_nodes

    def update_t(state, agg, step):
        return 0.5 * state + 0.5 * agg / (1.0 + agg.abs().max())

    def update_j(state, agg, step):
        return 0.5 * state + 0.5 * agg / (1.0 + jnp.abs(agg).max())

    kw = dict(init_fn=lambda ctx, state, t: np.ones(N, np.float32),
              update_fn=None, max_supersteps=40, tol=1e-4)
    fold = PregelFold(msg_fn=lambda a, b, live: a * live,
                      **{**kw, "update_fn": update_t})
    jfold = JPregelFold(msg_fn=lambda a, b, live: a * live,
                        **{**kw, "update_fn": update_j})
    got = gm.evolve(times[:4], fold)
    want = jgm.evolve(times[:4], jfold)
    for g, w in zip(got.values, want.values):
        assert np.allclose(g, np.asarray(w), atol=1e-5)
    for gi, wi in zip(got.stats["solver_iters"], want.stats["solver_iters"]):
        assert abs(gi - wi) <= 2


def test_callable_fold_and_time_expression(both):
    uni, ev, gm, jgm, times = both

    def peak_edges(prev, state, delta, t):
        e = int(state.edge_mask.sum())
        return e if prev is None else max(prev, e)

    got = gm.evolve(times, peak_edges)
    assert got.values == jgm.evolve(times, peak_edges).values
    want = max(int(replay(uni, ev, t).edge_mask.sum()) for t in got.times)
    assert got.values[-1] == want
    tex = TimeExpression.parse("t0 & ~t1", times[:2])
    assert gm.evolve(tex, "masks").times == sorted(times[:2])


def test_evolve_errors(both):
    uni, ev, gm, jgm, times = both
    with pytest.raises(ValueError):
        gm.evolve([], "masks")
    with pytest.raises(ValueError):
        gm.evolve(times[:2], "no-such-op")
    with pytest.raises(TypeError):
        gm.evolve(times[:2], 123)
    # kwargs configure *named* ops only — dead kwargs must not pass silently
    with pytest.raises(TypeError):
        gm.evolve(times[:2], PageRankOp(), tol=1e-3)


def test_evolve_records_interval_workload(both):
    uni, ev, gm, jgm, times = both
    before = gm.workload.interval_count
    key = (gm.dg._leaf_for_time(times[0]), gm.dg._leaf_for_time(times[-1]))
    hist_before = gm.workload.interval_hist.get(key, 0)
    res = gm.evolve(times, "density")
    assert gm.workload.interval_count == before + 1
    assert gm.workload.interval_hist[key] == hist_before + 1
    assert gm.workload.interval_points >= len(res.times)


# ---------------------------------------------------------------------------
# SnapshotBatchLoader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("horizon", [None, 4])
def test_snapshot_batch_loader_matches_jax(horizon):
    """Batches equal the reference's key by key (``x`` exactly: the same
    numpy ops on equal degrees), and the replay oracle."""
    (uni, ev), (juni, jev) = _churn(n_initial_edges=50, n_events=500,
                                    seed=11)
    gm = GraphManager(uni, ev, L=48, k=2, device=CPU)
    jgm = JGraphManager(juni, jev, L=48, k=2)
    tmax = int(ev.time[-1])
    times = list(range(0, tmax, max(1, tmax // 10)))
    loader = SnapshotBatchLoader(gm, times, batch_size=3,
                                 label_horizon=horizon, d_in=8)
    jloader = JSnapshotBatchLoader(jgm, times, batch_size=3,
                                   label_horizon=horizon, d_in=8)
    N, E = uni.num_nodes, uni.num_edges
    n = 0
    for batch, jbatch in zip(loader, jloader):
        assert set(batch) == set(jbatch)
        assert batch["times"] == jbatch["times"]
        for key, val in batch.items():
            if key == "times":
                continue
            want = np.asarray(jbatch[key])
            assert val.device.type == CPU
            got = val.numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert np.array_equal(got, want), key
        T = len(batch["times"])
        assert batch["x"].shape == (T, N, 8)
        assert batch["edge_index"].shape == (2, 2 * E)
        for j, t in enumerate(batch["times"]):
            truth = replay(uni, ev, t)
            assert np.array_equal(batch["label_mask"][j].numpy() > 0,
                                  truth.node_mask)
            assert np.array_equal(batch["edge_mask"][j, :E].numpy() > 0,
                                  truth.edge_mask)
            rd = np.zeros(N, np.float32)
            eid = np.nonzero(truth.edge_mask)[0]
            np.add.at(rd, uni.edge_src[eid], 1)
            np.add.at(rd, uni.edge_dst[eid], 1)
            assert np.array_equal(batch["x"][j, :, -1].numpy(), rd)
            assert int(batch["num_edges"][j]) == eid.size
        n += 1
    assert n == len(loader) == len(jloader) == len(times) // 3
    with pytest.raises(ValueError):
        SnapshotBatchLoader(gm, [0], batch_size=0)
    gm.close()
    jgm.close()


# ---------------------------------------------------------------------------
# device default and the unported sharding
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_manager_and_loader_default_to_the_card(no_card):
    uni, ev = random_history(60, 0, max_time_step=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphManager(uni, ev, L=16, k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphManager.open(uni, None)
    gm = GraphManager(uni, ev, L=16, k=2, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnapshotBatchLoader(gm, [0, 1], batch_size=2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evolve_intervals_torch(gm.dg, [[0, 1]])
    assert SnapshotBatchLoader(gm, [0, 1], batch_size=2).device.type == CPU
    gm.close()


def test_serve_evolve_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_evolve(400, 1, 4, "pagerank")
    res = serve.serve_evolve(400, 1, 4, "components", device=CPU)
    assert set(res) == {"recompute", "incremental"}
    assert res["incremental"][1] <= res["recompute"][1]
