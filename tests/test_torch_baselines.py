"""The port's storage baselines, auxiliary indexes and neighbor sampler
against the JAX package's, on the CPU.

A seeded history from the JAX package's generator is carried into the port
(``interop``); both packages build the same structure over it and are
asked the same questions.  Held equal, exactly:

* ``LogStore``, ``CopyLogStore`` and ``IntervalTreeStore``: the snapshot
  at every probed t, against each other and the ``replay`` oracle, and
  ``storage_bytes`` / ``memory_bytes``;
* ``AuxHistoryIndex`` over ``DegreeHistogramIndex`` and
  ``LabelPathIndex``: ``snapshot_at``, ``query_point``,
  ``query_interval``, ``query_whole_history``, and the ``save`` /
  ``load_snaps`` round trip through the graph's store;
* ``sample_blocks`` / ``pad_blocks`` / ``sampled_shapes`` for one CSR and
  seed.

Mirrors ``tests/test_{baselines,auxiliary}.py`` and the sampler case of
``tests/test_graph_algorithms.py``.
"""
import collections

import numpy as np
import pytest

from repro.core import GraphManager as JGraphManager
from repro.core import auxiliary as jaux
from repro.core import baselines as jbase
from repro.data.generators import churn_network as j_churn_network
from repro.data.generators import growing_network as j_growing_network
from repro.graph import sampler as jsampler
from repro.graph.csr import build_csr as j_build_csr

from repro_torch.core import EventList, GraphManager, replay
from repro_torch.core import auxiliary as aux
from repro_torch.core import baselines as base
from repro_torch.graph import sampler
from repro_torch.graph.csr import build_csr
from repro_torch.interop import build_universe, event_arrays, universe_arrays

CPU = "cpu"


def carry(juni, jev):
    """A JAX-package history as the port's universe and events."""
    return (build_universe(universe_arrays(juni)),
            EventList(**event_arrays(jev)))


def _probes(ev, seed=3, n=10):
    tmax = int(ev.time[-1])
    rng = np.random.default_rng(seed)
    return [-1, 0, tmax] + [int(x) for x in rng.integers(0, tmax, n)]


def _same_state(a, b):
    return (np.array_equal(a.node_mask, b.node_mask)
            and np.array_equal(a.edge_mask, b.edge_mask))


@pytest.fixture(scope="module")
def churn():
    juni, jev = j_churn_network(n_initial_edges=150, n_events=1200, seed=1)
    return carry(juni, jev), (juni, jev)


@pytest.mark.parametrize("gen,seed", [("churn", 5), ("growing", 7)])
def test_interval_tree_matches_reference(gen, seed):
    if gen == "churn":
        juni, jev = j_churn_network(n_initial_edges=120, n_events=900,
                                    seed=seed)
    else:
        juni, jev = j_growing_network(n_events=900, seed=seed)
    uni, ev = carry(juni, jev)
    it, jit = base.IntervalTreeStore(uni, ev), jbase.IntervalTreeStore(juni,
                                                                        jev)
    assert it.memory_bytes() == jit.memory_bytes()
    for t in _probes(ev):
        got = it.get_snapshot(t)
        assert _same_state(got, jit.get_snapshot(t)), t
        assert _same_state(got, replay(uni, ev, t)), t


@pytest.mark.parametrize("L", [37, 100])
def test_copylog_matches_reference(churn, L):
    (uni, ev), (juni, jev) = churn
    cl, jcl = base.CopyLogStore(uni, ev, L=L), jbase.CopyLogStore(juni, jev,
                                                                  L=L)
    assert cl.storage_bytes() == jcl.storage_bytes()
    for t in _probes(ev):
        got = cl.get_snapshot(t)
        assert _same_state(got, jcl.get_snapshot(t)), t
        assert _same_state(got, replay(uni, ev, t)), t


def test_log_store_matches_reference(churn):
    (uni, ev), (juni, jev) = churn
    lg, jlg = base.LogStore(uni, ev), jbase.LogStore(juni, jev)
    assert lg.storage_bytes() == jlg.storage_bytes()
    for t in _probes(ev, n=4):
        got = lg.get_snapshot(t)
        assert _same_state(got, jlg.get_snapshot(t)), t
        assert _same_state(got, replay(uni, ev, t)), t


# ---------------------------------------------------------------------------
# auxiliary indexes (paper §4.7)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aux_pair():
    juni, jev = j_churn_network(n_initial_edges=40, n_events=200, seed=3,
                                p_attr_update=0.0, p_transient=0.0)
    uni, ev = carry(juni, jev)
    gm = GraphManager(uni, ev, L=32, k=2, device=CPU)
    jgm = JGraphManager(juni, jev, L=32, k=2)
    yield uni, ev, gm, jgm, jev
    gm.close()
    jgm.close()


def _labels(n):
    return (["A", "B"] * (n // 2 + 1))[:n]


@pytest.fixture(scope="module")
def aux_indexes(aux_pair):
    uni, ev, gm, jgm, jev = aux_pair
    labels = _labels(uni.num_nodes)
    return {
        "deghist": (
            aux.AuxHistoryIndex(aux.DegreeHistogramIndex(), gm.dg, ev),
            jaux.AuxHistoryIndex(jaux.DegreeHistogramIndex(), jgm.dg, jev)),
        "labelpath": (
            aux.AuxHistoryIndex(aux.LabelPathIndex(labels, plen=3), gm.dg,
                                ev),
            jaux.AuxHistoryIndex(jaux.LabelPathIndex(labels, plen=3),
                                 jgm.dg, jev)),
    }


@pytest.mark.parametrize("kind", ["deghist", "labelpath"])
def test_aux_snapshots_match_reference(aux_pair, aux_indexes, kind):
    uni, ev, gm, jgm, _ = aux_pair
    ai, jai = aux_indexes[kind]
    assert ai._leaf_snaps == jai._leaf_snaps
    for i in (0, 50, 60, 150, len(ev) - 1):
        t = int(ev.time[i])
        snap = ai.snapshot_at(t)
        assert snap == jai.snapshot_at(t), t
        for key in sorted(snap)[:3] + ["deg1", "A|B|A", "absent"]:
            assert ai.query_point(t, key) == jai.query_point(t, key)
            assert (ai.query_interval(int(ev.time[10]), t, key)
                    == jai.query_interval(int(ev.time[10]), t, key))
    for key in ("deg1", "deg2", "deg3", "A|B|A", "B|A|B", "absent"):
        assert ai.query_whole_history(key) == jai.query_whole_history(key)


def test_degree_histogram_matches_bruteforce(aux_pair, aux_indexes):
    uni, ev, gm, jgm, _ = aux_pair
    ai, _ = aux_indexes["deghist"]
    for t in (int(ev.time[50]), int(ev.time[150]), int(ev.time[-1])):
        truth = replay(uni, ev, t)
        deg = np.zeros(uni.num_nodes, np.int64)
        eidx = np.nonzero(truth.edge_mask)[0]
        np.add.at(deg, uni.edge_src[eidx], 1)
        np.add.at(deg, uni.edge_dst[eidx], 1)
        exp = collections.Counter(int(d) for d in deg[deg > 0])
        got = {int(k[3:]): v for k, v in ai.snapshot_at(t).items()}
        assert got == dict(exp), t


def test_label_paths_match_bruteforce(aux_pair, aux_indexes):
    uni, ev, gm, jgm, _ = aux_pair
    ai, _ = aux_indexes["labelpath"]
    labels = _labels(uni.num_nodes)
    for t in (int(ev.time[60]), int(ev.time[-1])):
        truth = replay(uni, ev, t)
        csr = build_csr(uni.edge_src, uni.edge_dst, uni.num_nodes,
                        truth.edge_mask, uni.edge_directed)
        cnt = collections.Counter()
        for a in range(uni.num_nodes):
            for b in csr.neighbors(a):
                for c in csr.neighbors(int(b)):
                    if c != a:
                        cnt["|".join(labels[x] for x in (a, int(b),
                                                         int(c)))] += 1
        assert dict(ai.snapshot_at(t)) == dict(cnt), t


@pytest.mark.parametrize("kind", ["deghist", "labelpath"])
def test_aux_save_load_matches_reference(aux_pair, aux_indexes, kind):
    uni, ev, gm, jgm, _ = aux_pair
    ai, jai = aux_indexes[kind]
    nbytes, jnbytes = ai.save(), jai.save()
    assert nbytes == jnbytes > 0
    name = ai.aux.name
    key = (0, aux.AuxHistoryIndex._AUX_PID, f"aux.{name}")
    assert key in gm.dg.store
    assert gm.dg.store.get(key) == jgm.dg.store.get(key)
    snaps = aux.AuxHistoryIndex.load_snaps(gm.dg.store, name)
    assert snaps == jaux.AuxHistoryIndex.load_snaps(jgm.dg.store, name)
    # JSON turns tuples into lists; the decoded snapshots equal the built
    # ones for these string-keyed integer payloads
    assert snaps == ai._leaf_snaps


# ---------------------------------------------------------------------------
# neighbor sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanouts", [[3, 2], [5], [2, 2, 2]])
def test_sampler_matches_reference(fanouts):
    juni, jev = j_churn_network(n_initial_edges=120, n_events=600, seed=11,
                                p_transient=0.0, p_attr_update=0.0)
    uni, ev = carry(juni, jev)
    t = int(ev.time[400])
    truth = replay(uni, ev, t)
    csr = build_csr(uni.edge_src, uni.edge_dst, uni.num_nodes,
                    truth.edge_mask, uni.edge_directed)
    jcsr = j_build_csr(juni.edge_src, juni.edge_dst, juni.num_nodes,
                       truth.edge_mask, juni.edge_directed)
    seeds = np.nonzero(truth.node_mask)[0][:8]
    b = sampler.sample_blocks(csr, seeds, fanouts, np.random.default_rng(0))
    jb = jsampler.sample_blocks(jcsr, seeds, fanouts,
                                np.random.default_rng(0))
    n_pad, e_pad = sampler.sampled_shapes(len(seeds), fanouts)
    assert (n_pad, e_pad) == jsampler.sampled_shapes(len(seeds), fanouts)
    for got, exp in ((b, jb), (sampler.pad_blocks(b, n_pad, e_pad),
                               jsampler.pad_blocks(jb, n_pad, e_pad))):
        assert got.n_seeds == exp.n_seeds == len(seeds)
        for f in ("nodes", "edge_index", "edge_mask", "node_mask"):
            a, e = getattr(got, f), getattr(exp, f)
            assert a.dtype == e.dtype and np.array_equal(a, e), f
    # every sampled edge is a real edge of the snapshot
    gsrc, gdst = b.nodes[b.edge_index[0]], b.nodes[b.edge_index[1]]
    for s, d, ok in zip(gsrc, gdst, b.edge_mask):
        if ok:
            assert d in csr.neighbors(int(s)) or s in csr.neighbors(int(d))
