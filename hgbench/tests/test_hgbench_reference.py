"""The program (its plain PyTorch versions on the CPU) against the
benchmark's reference, through a whole run of every cell at a small size,
on two seeds (one past 32 bits, as a run's --seed may be)."""
import numpy as np
import pytest

from hgbench import harness, history, program
from hgbench.reference import Replay
from hgbench.tests import small


@pytest.mark.parametrize("seed", [small.SEED, 7])
@pytest.mark.parametrize("name", small.CELLS)
def test_cell_agrees_with_reference(name, seed):
    res = harness.run(small.cell(name), seed=seed, seconds=0.3,
                      traced=False, device="cpu")
    assert res.failed == 0 and res.attempted >= 1
    assert res.checks and all(v == 0 for n, v, _ in res.checks
                              if n != "weighted_total_rel_gap")
    assert res.correct, res.checks
    assert set(res.metrics) == {"snapshots_per_s", "query_p50_ms",
                                "query_p95_ms", "setup_s"}


@pytest.mark.parametrize("gen", ["growing", "churn"])
def test_replay_matches_program_replay(gen):
    """Slot numbering, masks and degrees of the reference equal the
    program's own brute-force replay of the builder's events."""
    from repro_torch.core.events import replay
    hist = (small.generator("growing").growing(3000, 7) if gen == "growing"
            else small.generator("churn").churn(250, 3000, 7))
    uni, ev = program.to_program(hist)
    ref = Replay(hist)
    assert (ref.num_nodes, ref.num_edges) == (uni.num_nodes, uni.num_edges)
    tmax = int(hist.time.max())
    for t in np.linspace(0, tmax, 7).astype(int):
        truth = replay(uni, ev, int(t))
        nm, em = ref.masks(int(t))
        assert np.array_equal(nm, truth.node_mask)
        assert np.array_equal(em, truth.edge_mask)
        want = np.zeros(uni.num_nodes, np.int64)
        live = np.nonzero(truth.edge_mask)[0]
        np.add.at(want, uni.edge_src[live], 1)
        np.add.at(want, uni.edge_dst[live], 1)
        assert np.array_equal(ref.degrees(em), want)


def test_generators_are_seeded_and_sized():
    churn = small.generator("churn").churn
    growing = small.generator("growing").growing
    a, b = churn(500, 4000, 11), churn(500, 4000, 11)
    assert all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
               for f in ("time", "kind", "a", "b", "value"))
    main = np.isin(a.kind, (history.ADD_EDGE, history.DEL_EDGE,
                            history.TRANSIENT_EDGE, history.SET_NODE_ATTR))
    assert int((a.time[main] >= 2).sum()) == 4000   # the churn phase's n
    assert np.all(np.diff(a.time) >= 0)
    g = growing(5000, 3)
    assert len(g) == 5000 and np.all(np.diff(g.time) >= 0)
    assert not np.array_equal(g.a, growing(5000, 4).a)
