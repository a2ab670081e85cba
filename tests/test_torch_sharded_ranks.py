"""Rank-local sharded retrieval under ``torch.distributed``, on the CPU.

``execute_singlepoint_sharded_rank`` is the port's form of the reference's
``execute_singlepoint_sharded``: there each device of an 8-device
``retrieval_mesh`` holds one row of the ``[P, Wp]`` word-cyclic layout
under ``shard_map``; here each of 8 ``gloo`` ranks (processes,
``device="cpu"``) lowers and applies only its own row, as one chain call
per plane, and the rows meet in one host gather.  Held here:

* on every rank, the masks equal ``replay``, the one-launch
  ``execute_singlepoint_sharded_torch`` and the reference's 8-device run,
  bit for bit, on the aligned deployment (8 ``word_cyclic`` storage
  partitions) and on the re-laid dense chain (``mod_hash`` at 4);
* row independence across ranks: each rank's lowered base, adds and dels
  are exactly its row of the one-launch lowering; in the aligned
  deployment it fetches only its own partition; no collective runs
  before its last chain call, and the one after it is the host gather;
* ``rank_rows`` and the ``rows`` lowering for several rows a rank, in
  one process.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.core import GraphManager, replay
from repro_torch.data.generators import churn_network
from repro_torch.runtime import torch_exec as tx

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 8
TIMES_SEED = 2

_RANK = r"""
import json, sys
import numpy as np
import torch.distributed as dist

from repro_torch.core import GraphManager, replay
from repro_torch.data.generators import churn_network
from repro_torch.kernels import delta_apply_chain_batched
from repro_torch.runtime import torch_exec as tx

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
times = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
uni, ev = churn_network(n_initial_edges=150, n_events=900, seed=43)
calls = []
for name in ("all_reduce", "all_gather", "all_gather_object", "broadcast",
             "broadcast_object_list", "gather", "scatter", "reduce",
             "all_to_all", "send", "recv", "barrier"):
    real = getattr(dist, name)
    def spy(*a, _n=name, _f=real, **k):
        calls.append(_n)
        return _f(*a, **k)
    setattr(dist, name, spy)
real_chain = tx.delta_apply_chain_batched
def chain(b, a, d):
    calls.append("chain")
    return real_chain(b, a, d)
tx.delta_apply_chain_batched = chain
res = {}
for label, P, fn in (("aligned", 8, "word_cyclic"), ("relaid", 4, "mod_hash")):
    gm = GraphManager(uni, ev, L=80, k=2, num_partitions=P, partition_fn=fn,
                      device="cpu")
    dg = gm.dg
    fetched = []
    for attr in ("_fetch_delta", "_fetch_elist"):
        real_f = getattr(dg, attr)
        def f(pid, opts, parts=None, _f=real_f, **k):
            fetched.append(None if parts is None else list(parts))
            return _f(pid, opts, parts=parts, **k)
        setattr(dg, attr, f)
    rows = tx.rank_rows(8, rank, world)
    for t in times:
        del calls[:]
        del fetched[:]
        nm, em = tx.execute_singlepoint_sharded_rank(dg, t, partitions=8,
                                                     device="cpu",
                                                     pool=gm.pool)
        rank_calls, rank_fetched = list(calls), list(fetched)
        key = f"{label}/{t}"
        truth = replay(uni, ev, t)
        one_n, one_e = tx.execute_singlepoint_sharded_torch(
            dg, t, partitions=8, device="cpu", pool=gm.pool)
        whole = tx.lower_singlepoint_sharded(dg, t, partitions=8,
                                             device="cpu", pool=gm.pool)
        mine = tx.lower_singlepoint_sharded(dg, t, partitions=8,
                                            device="cpu", pool=gm.pool,
                                            rows=rows)
        same_rows = all(
            all(bool((x == y[rows.start:rows.stop]).all())
                for x, y in zip(m[:3], w[:3]))
            for m, w in zip(mine, whole))
        res[key] = {
            "replay": bool(np.array_equal(nm, truth.node_mask) and
                           np.array_equal(em, truth.edge_mask)),
            "one_launch": bool(np.array_equal(nm, one_n) and
                               np.array_equal(em, one_e)),
            "calls": rank_calls,
            "fetched": sorted({p for parts in rank_fetched if parts
                               for p in parts}),
            "fetch_all": any(parts is None for parts in rank_fetched),
            "same_rows": same_rows,
        }
        np.save(f"{out}/{label}_{t}_{rank}_n.npy", nm)
        np.save(f"{out}/{label}_{t}_{rank}_e.npy", em)
        # a bit added to this rank's row changes that row alone
        flipped = []
        for base, adds, dels, U in mine:
            got = delta_apply_chain_batched(base, adds, dels)
            f2 = adds.clone()
            f2[0, -1] |= ~got[0]
            flipped.append(bool((delta_apply_chain_batched(base, f2, dels)
                                 != got).any()) or bool((got[0] == -1).all()))
        res[key]["flip_changes_row"] = all(flipped)
    gm.close()
with open(f"{out}/rank{rank}.json", "w") as fh:
    json.dump(res, fh)
dist.destroy_process_group()
"""

_REFERENCE = r"""
import sys
import numpy as np
from repro.core import GraphManager
from repro.data.generators import churn_network
from repro.runtime import compat
from repro.runtime.jax_exec import execute_singlepoint_sharded
times, out = [int(t) for t in sys.argv[1].split(",")], sys.argv[2]
uni, ev = churn_network(n_initial_edges=150, n_events=900, seed=43)
gm = GraphManager(uni, ev, L=80, k=2, num_partitions=8,
                  partition_fn="word_cyclic")
mesh = compat.make_mesh((8,), ("data",))
res = {}
for t in times:
    nm, em = execute_singlepoint_sharded(gm.dg, t, mesh, pool=gm.pool)
    res[f"n{t}"], res[f"e{t}"] = nm, em
np.savez(out, **res)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _times():
    uni, ev = churn_network(n_initial_edges=150, n_events=900, seed=43)
    rng = np.random.default_rng(TIMES_SEED)
    return [int(t) for t in rng.integers(0, int(ev.time[-1]) + 3, 4)] + [
        -1, int(ev.time[-1])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """8 gloo ranks and the reference's 8-device run, started together."""
    out = tmp_path_factory.mktemp("ranks")
    times = _times()
    env = {**os.environ, "PYTHONPATH": SRC}
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         ",".join(map(str, times)), str(out / "ref.npz")],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(WORLD), str(port),
         str(out), json.dumps(times)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs + [ref]:
            _, err = p.communicate(timeout=300)
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs + [ref]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in errs:
        assert rc == 0, err
    results = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return out, times, results


def test_ranks_match_replay_and_one_launch(ranks):
    out, times, results = ranks
    for r, res in enumerate(results):
        for key, got in res.items():
            assert got["replay"] and got["one_launch"], (r, key)


def test_ranks_match_reference_eight_device_run(ranks):
    out, times, results = ranks
    ref = np.load(out / "ref.npz")
    for t in times:
        for r in range(WORLD):
            nm = np.load(out / f"aligned_{t}_{r}_n.npy")
            em = np.load(out / f"aligned_{t}_{r}_e.npy")
            assert np.array_equal(nm, ref[f"n{t}"]), (r, t)
            assert np.array_equal(em, ref[f"e{t}"]), (r, t)
            for label in ("relaid",):
                assert np.array_equal(
                    np.load(out / f"{label}_{t}_{r}_n.npy"), ref[f"n{t}"])


def test_ranks_are_independent(ranks):
    """Each rank's lowering is its row of the one-launch lowering; the
    aligned ranks fetch their own partition alone; no collective runs
    before the rank's two chain calls, and the host gather follows."""
    out, times, results = ranks
    for r, res in enumerate(results):
        for key, got in res.items():
            assert got["same_rows"] and got["flip_changes_row"], (r, key)
            assert got["calls"] == ["chain", "chain", "all_gather_object"], \
                (r, key, got["calls"])
            if key.startswith("aligned/"):
                assert not got["fetch_all"], (r, key)
                assert set(got["fetched"]) <= {r}, (r, key)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_rows_lowering_is_the_rows_of_the_whole(world):
    """``rows`` lowering (a rank's share, several rows when world < P)
    equals those rows of the whole lowering, aligned and re-laid."""
    uni, ev = churn_network(n_initial_edges=150, n_events=900, seed=43)
    for P, fn in ((8, "word_cyclic"), (4, "mod_hash")):
        with GraphManager(uni, ev, L=80, k=2, num_partitions=P,
                          partition_fn=fn, device="cpu") as gm:
            for t in _times()[:3]:
                whole = tx.lower_singlepoint_sharded(
                    gm.dg, t, partitions=8, device="cpu", pool=gm.pool)
                for rank in range(world):
                    rows = tx.rank_rows(8, rank, world)
                    assert len(rows) == 8 // world
                    mine = tx.lower_singlepoint_sharded(
                        gm.dg, t, partitions=8, device="cpu", pool=gm.pool,
                        rows=rows)
                    for m, w in zip(mine, whole):
                        for x, y in zip(m[:3], w[:3]):
                            assert (x == y[rows.start:rows.stop]).all()
                        assert m[3] == w[3]
            truth = replay(uni, ev, _times()[0])
            assert truth.node_mask.any()


def test_rank_rows_needs_a_divisor():
    assert tx.rank_rows(8, 3, 4) == range(6, 8)
    with pytest.raises(ValueError, match="divide"):
        tx.rank_rows(8, 0, 3)
