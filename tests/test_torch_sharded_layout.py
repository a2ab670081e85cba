"""The port's sharded device layout against the JAX package's, on the CPU.

Sharded retrieval lays every packed bitmap out word-cyclically as
``[P, Wp]`` (word ``w`` at row ``w % P``, column ``w // P``).  The
reference runs one row per device of a mesh (``shard_map`` over an XLA
scan); the port lands all P rows as the batch of one
``delta_apply_chain_batched`` call per plane.  Held here:

* ``sharded_base``, ``unshard``, ``_stack_sharded`` and
  ``plan_to_chain_sharded`` are bit-identical to the reference's numpy
  functions (the port's stacks are ``[P, K, Wp]``, the reference's
  ``[K, P, Wp]``);
* ``execute_singlepoint_sharded_torch(device="cpu")`` equals ``replay``
  and the unsharded ``execute_singlepoint_torch``, on the aligned branch
  (``word_cyclic`` with ``dg.P == partitions``) and the other one, with
  two chain calls per timepoint, each with the P rows as its batch;
* the rows are independent: no ``torch.distributed`` call is made, and
  flipping bits in one row's adds changes that row of the output only;
* (slow) the masks equal the reference's ``execute_singlepoint_sharded``
  on an 8-device mesh, run in a subprocess as ``tests/test_distributed.py``
  runs it.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import GraphManager as JGraphManager
from repro.core.query import NO_ATTRS as J_NO_ATTRS
from repro.data.generators import churn_network as j_churn_network
from repro.runtime import jax_exec as jx

from repro_torch.core import EventList, GraphManager, replay
from repro_torch.core.query import NO_ATTRS
from repro_torch.interop import build_universe, event_arrays, universe_arrays
from repro_torch.kernels import delta_apply_chain_batched
from repro_torch.runtime import torch_exec as tx

CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def carry(juni, jev):
    """A JAX-package history as the port's universe and events."""
    return (build_universe(universe_arrays(juni)),
            EventList(**event_arrays(jev)))


def _history(seed=43, n_events=900):
    juni, jev = j_churn_network(n_initial_edges=150, n_events=n_events,
                                seed=seed)
    return carry(juni, jev), (juni, jev)


def _times(ev, seed=2, n=5):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, int(ev.time[-1]) + 3, n)]


@pytest.fixture(scope="module")
def aligned():
    """Both packages' managers over one history, 8 word_cyclic storage
    partitions (the aligned deployment of the reference's mesh test)."""
    (uni, ev), (juni, jev) = _history()
    kw = dict(L=80, k=2, num_partitions=8, partition_fn="word_cyclic")
    gm = GraphManager(uni, ev, device=CPU, **kw)
    jgm = JGraphManager(juni, jev, **kw)
    yield uni, ev, gm, jgm
    gm.close()
    jgm.close()


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("Pn", [1, 3, 8])
@pytest.mark.parametrize("W", [1, 37, 64, 1001])
def test_base_and_unshard_match_reference(Pn, W):
    words = np.random.default_rng(W * Pn).integers(0, 2 ** 32, W,
                                                   dtype=np.uint32)
    got = tx.sharded_base(_words(words), Pn)
    assert np.array_equal(_u32(got), jx.sharded_base(words, Pn))
    back = tx.unshard(got, W)
    assert np.array_equal(_u32(back), jx.unshard(jx.sharded_base(words, Pn),
                                                 W))
    assert np.array_equal(_u32(back), words)


@pytest.mark.parametrize("Pn", [1, 3, 8])
def test_stack_matches_reference(Pn):
    rng = np.random.default_rng(Pn)
    U = 5000
    chain = [rng.choice(U, size, replace=False)
             for size in (0, 1, 40, 700, 0, 3)]
    got = tx._stack_sharded(chain, U, Pn)
    want = jx._stack_sharded(chain, U, Pn)
    assert got.shape == (Pn, len(chain), want.shape[2])
    assert np.array_equal(got, want.transpose(1, 0, 2))


@pytest.mark.parametrize("use_current", [True, False])
def test_plan_to_chain_sharded_matches_reference(aligned, use_current):
    uni, ev, gm, jgm = aligned
    for t in _times(ev) + [int(ev.time[-1])]:
        plan = gm.dg.plan_singlepoint(t, NO_ATTRS, use_current)
        jplan = jgm.dg.plan_singlepoint(t, J_NO_ATTRS, use_current)
        (bn, be), stacks = tx.plan_to_chain_sharded(gm.dg, plan, 8, gm.pool)
        (jbn, jbe), jstacks = jx.plan_to_chain_sharded(jgm.dg, jplan, 8,
                                                       jgm.pool)
        assert np.array_equal(bn, jbn) and np.array_equal(be, jbe), t
        for got, want in zip(stacks, jstacks):
            assert np.array_equal(got, want.transpose(1, 0, 2)), t


def test_aligned_lowering_needs_word_cyclic_at_p(aligned):
    uni, ev, gm, jgm = aligned
    plan = gm.dg.plan_singlepoint(int(ev.time[-1]), NO_ATTRS, True)
    with pytest.raises(ValueError, match="word_cyclic"):
        tx.plan_to_chain_sharded(gm.dg, plan, 4, gm.pool)
    with pytest.raises(ValueError, match="partitions"):
        tx.execute_singlepoint_sharded_torch(gm.dg, 0, partitions=0,
                                             device=CPU)


@pytest.fixture
def chain_calls(monkeypatch):
    """Every ``delta_apply_chain_batched`` call of the sharded path, as
    the shapes of its ``adds``."""
    calls = []

    def spy(bases, adds, dels):
        calls.append(tuple(adds.shape))
        return delta_apply_chain_batched(bases, adds, dels)
    monkeypatch.setattr(tx, "delta_apply_chain_batched", spy)
    return calls


@pytest.mark.parametrize("fn,P,partitions", [
    ("word_cyclic", 8, 8),     # aligned: per-partition fetches
    ("word_cyclic", 4, 8),     # re-laid dense chain
    ("mod_hash", 4, 8),
    ("mod_hash", 1, 3),
    ("word_cyclic", 1, 1),
])
@pytest.mark.parametrize("use_current", [True, False])
def test_sharded_execute_matches_replay_and_unsharded(chain_calls, fn, P,
                                                      partitions,
                                                      use_current):
    (uni, ev), _ = _history(seed=7, n_events=700)
    with GraphManager(uni, ev, L=60, k=2, num_partitions=P,
                      partition_fn=fn, device=CPU) as gm:
        times = _times(ev, seed=P) + [-1, int(ev.time[-1])]
        for t in times:
            del chain_calls[:]
            nm, em = tx.execute_singlepoint_sharded_torch(
                gm.dg, t, partitions=partitions, device=CPU,
                pool=gm.pool, use_current=use_current)
            assert [c[0] for c in chain_calls] == [partitions] * 2, t
            truth = replay(uni, ev, t)
            assert np.array_equal(nm, truth.node_mask), t
            assert np.array_equal(em, truth.edge_mask), t
            unm, uem = tx.execute_singlepoint_torch(
                gm.dg, t, device=CPU, pool=gm.pool, use_current=use_current)
            assert np.array_equal(nm, unm) and np.array_equal(em, uem), t


_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
                "all_to_all_single", "broadcast", "reduce", "gather",
                "scatter", "send", "recv", "isend", "irecv", "barrier")


def test_rows_are_independent(aligned, monkeypatch):
    """The one-device form of the reference's zero-collective check: no
    ``torch.distributed`` call is made, and a bit flipped in one row's
    adds reaches that row of the output and no other."""
    uni, ev, gm, jgm = aligned

    def refuse(*a, **k):
        raise AssertionError("sharded retrieval issued a collective")
    for name in _COLLECTIVES:
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, refuse)
    t = int(ev.time[len(ev) // 2])
    nm, em = tx.execute_singlepoint_sharded_torch(gm.dg, t, partitions=8,
                                                  device=CPU, pool=gm.pool)
    truth = replay(uni, ev, t)
    assert np.array_equal(nm, truth.node_mask)
    assert np.array_equal(em, truth.edge_mask)
    for base, adds, dels, U in tx.lower_singlepoint_sharded(
            gm.dg, t, partitions=8, device=CPU, pool=gm.pool):
        assert adds.shape[0] == 8 and adds.shape[1] >= 1
        out = delta_apply_chain_batched(base, adds, dels)
        # a row can only change where its output still has a zero bit
        rows = [r for r in range(8) if bool((out[r] != -1).any())]
        assert rows
        for row in rows:
            flipped = adds.clone()
            flipped[row, -1] |= ~out[row]   # add every bit it lacks
            got = delta_apply_chain_batched(base, flipped, dels)
            changed = (got != out).any(dim=1)
            assert changed[row] and int(changed.sum()) == 1, row


def test_sharded_entry_defaults_to_the_card(aligned):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    uni, ev, gm, jgm = aligned
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tx.execute_singlepoint_sharded_torch(gm.dg, 0, partitions=8)


@pytest.mark.slow
def test_matches_reference_eight_device_run(aligned, tmp_path):
    """The reference's ``execute_singlepoint_sharded`` on 8 virtual
    devices (a subprocess: XLA_FLAGS must be set before JAX starts) and
    the port's one batched call give the same masks, bit for bit."""
    uni, ev, gm, jgm = aligned
    times = _times(ev)
    out_path = tmp_path / "ref.npz"
    code = f"""
        import numpy as np
        from repro.core import GraphManager
        from repro.data.generators import churn_network
        from repro.runtime import compat
        from repro.runtime.jax_exec import execute_singlepoint_sharded
        uni, ev = churn_network(n_initial_edges=150, n_events=900, seed=43)
        gm = GraphManager(uni, ev, L=80, k=2, num_partitions=8,
                          partition_fn="word_cyclic")
        mesh = compat.make_mesh((8,), ("data",))
        out = {{}}
        for t in {times!r}:
            nm, em = execute_singlepoint_sharded(gm.dg, t, mesh,
                                                 pool=gm.pool)
            out[f"n{{t}}"], out[f"e{{t}}"] = nm, em
        np.savez({str(out_path)!r}, **out)
        print("OK")
    """
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(out_path)
    for t in times:
        nm, em = tx.execute_singlepoint_sharded_torch(
            gm.dg, t, partitions=8, device=CPU, pool=gm.pool)
        assert np.array_equal(nm, ref[f"n{t}"]), t
        assert np.array_equal(em, ref[f"e{t}"]), t
