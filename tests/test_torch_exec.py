"""The port's device retrieval path against the JAX package's, end to end.

The same random histories are indexed by both packages; on the CPU the
port's ``torch_exec`` entry points (``device="cpu"``: the kernels' plain
versions) must give the masks of ``repro.runtime.jax_exec`` and of the
``replay`` oracle, fused analytics partials bit for bit and degrees
exactly — also over an index carried across by
``interop.load_reference_index``.  The ``DeviceStager`` ordering and depth
contracts are mirrored from ``tests/test_device_pipeline.py``.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.deltagraph import DeltaGraph as JDeltaGraph
from repro.core.graphpool import GraphPool as JGraphPool
from repro.data.generators import random_history as j_random_history
from repro.runtime import jax_exec
from repro.storage.kv import MemKV as JMemKV

from repro_torch.core import DeltaGraph, GraphPool, replay
from repro_torch.data.generators import random_history
from repro_torch.interop import (event_arrays, load_reference_index,
                                 universe_arrays)
from repro_torch.runtime.executor import Prefetcher
from repro_torch.runtime.staging import (DeviceStager, PinnedPut,
                                         stream_chunk_k)
from repro_torch.core import bitmaps as bmod
from repro_torch.kernels import planes_from_indices
from repro_torch.runtime import torch_exec
from repro_torch.runtime.torch_exec import (execute_ir_torch,
                                            execute_multipoint_torch,
                                            execute_singlepoint_fused,
                                            execute_singlepoint_torch)
from repro_torch.storage.kv import MemKV
from repro_torch.core.query import NO_ATTRS

CPU = "cpu"


def _build(seed, n_events=150, L=8, k=2):
    """Both packages' index and pool over the same random history."""
    juni, jev = j_random_history(n_events, seed, max_time_step=2)
    uni, ev = random_history(n_events, seed, max_time_step=2)
    jdg = JDeltaGraph(juni, JMemKV(), L=L, k=k).build(jev)
    dg = DeltaGraph(uni, MemKV(), L=L, k=k).build(ev)
    return (juni, jev, jdg, JGraphPool(juni)), (uni, ev, dg, GraphPool(uni))


def _times(ev, dg, rng) -> list[int]:
    """Random draws plus leaf boundaries plus the recent region."""
    tmax = int(ev.time[-1])
    times = [int(t) for t in rng.integers(-1, tmax + 2, 4)]
    li = int(rng.integers(1, len(dg.leaf_time)))
    times += [int(dg.leaf_time[li]), int(dg.leaf_time[li]) + 1, tmax]
    return sorted(dict.fromkeys(times))


def _assert_masks(got, want, msg=""):
    assert np.array_equal(got[0], want[0]), f"nodes {msg}"
    assert np.array_equal(got[1], want[1]), f"edges {msg}"


def _assert_replay(uni, ev, t, nm, em):
    truth = replay(uni, ev, t)
    assert np.array_equal(nm, truth.node_mask), t
    assert np.array_equal(em, truth.edge_mask), t


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint32)


def _assert_fused_equal(got, want, msg=""):
    for field in ("mask", "pop", "accw", "live"):
        g, r = getattr(got, field), getattr(want, field)
        if r is None:
            assert g is None, (field, msg)
        else:
            assert np.array_equal(_bits(g), _bits(r)), (field, msg)


# ---------------------------------------------------------------------------
# multipoint / IR execution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_multipoint_matches_jax_and_replay(seed):
    (juni, jev, jdg, jpool), (uni, ev, dg, pool) = _build(seed)
    times = _times(ev, dg, np.random.default_rng(seed))
    ref = jax_exec.execute_multipoint_jax(jdg, times, pool=jpool)
    got = execute_multipoint_torch(dg, times, device=CPU, pool=pool)
    assert got.keys() == ref.keys()
    for t in times:
        _assert_masks(got[t], ref[t], t)
        _assert_replay(uni, ev, t, *got[t])


@pytest.mark.parametrize("use_current", [True, False])
def test_multipoint_land_in_pool(use_current):
    (juni, jev, jdg, jpool), (uni, ev, dg, pool) = _build(5, n_events=200)
    times = _times(ev, dg, np.random.default_rng(5))
    jgids = jax_exec.execute_multipoint_jax(
        jdg, times, pool=jpool, use_current=use_current, land_in_pool=True)
    gids = execute_multipoint_torch(dg, times, device=CPU, pool=pool,
                                    use_current=use_current,
                                    land_in_pool=True)
    assert sorted(gids) == sorted(jgids)
    for t in times:
        got = (pool.get_node_mask(gids[t]), pool.get_edge_mask(gids[t]))
        _assert_masks(got, (jpool.get_node_mask(jgids[t]),
                            jpool.get_edge_mask(jgids[t])), t)
        _assert_replay(uni, ev, t, *got)


def test_streamed_ir_bit_identical(monkeypatch):
    (_, _, jdg, jpool), (uni, ev, dg, pool) = _build(3)
    tmax = int(ev.time[-1])
    times = sorted({0, tmax // 3, tmax // 2, tmax})
    ir = dg.plan_multipoint(times, NO_ATTRS, True)
    mono = execute_ir_torch(dg, ir, device=CPU, pool=pool)
    monkeypatch.setenv("REPRO_STREAM_CHUNK", "1")   # force max chunking
    stager = DeviceStager(device=CPU)
    streamed = execute_ir_torch(dg, ir, device=CPU, pool=pool, stager=stager)
    assert any(k == "apply" for k, _ in stager.events)  # streaming engaged
    ref = jax_exec.execute_multipoint_jax(jdg, times, pool=jpool)
    for t in times:
        _assert_masks(streamed[t], mono[t], t)
        _assert_masks(streamed[t], ref[t], t)
        _assert_replay(uni, ev, t, *streamed[t])


def test_streamed_with_prefetcher(monkeypatch):
    _, (uni, ev, dg, pool) = _build(4)
    tmax = int(ev.time[-1])
    times = [0, tmax // 4, tmax // 2, tmax]
    monkeypatch.setenv("REPRO_STREAM_CHUNK", "2")
    pf = Prefetcher(dg.store, workers=2)
    try:
        got = execute_multipoint_torch(dg, times, device=CPU, pool=pool,
                                       prefetch=pf)
    finally:
        pf.close(wait=True)
    for t in times:
        _assert_replay(uni, ev, t, *got[t])


@pytest.mark.parametrize("seed", [0, 7])
def test_singlepoint_matches_jax_and_replay(seed):
    (_, jev, jdg, jpool), (uni, ev, dg, pool) = _build(seed, n_events=100)
    tmax = int(ev.time[-1])
    for t in (0, tmax // 2, tmax):
        got = execute_singlepoint_torch(dg, t, device=CPU, pool=pool)
        _assert_masks(got, jax_exec.execute_singlepoint_jax(jdg, t,
                                                            pool=jpool), t)
        _assert_replay(uni, ev, t, *got)


# ---------------------------------------------------------------------------
# fused singlepoint retrieval + analytics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,impl", [(0, "xla"), (7, "xla"),
                                       (2, "pallas")])
def test_fused_singlepoint_matches_jax(seed, impl):
    (_, jev, jdg, jpool), (uni, ev, dg, pool) = _build(seed, n_events=100)
    rng = np.random.default_rng(seed)
    tmax = int(ev.time[-1])
    for t in (0, tmax // 2, tmax):
        w = rng.random(uni.num_nodes, dtype=np.float32)
        nm, em, an = execute_singlepoint_fused(dg, t, node_weights=w,
                                               device=CPU, pool=pool)
        jnm, jem, jan = jax_exec.execute_singlepoint_fused(
            jdg, t, node_weights=w, impl=impl, pool=jpool)
        _assert_masks((nm, em), (jnm, jem), t)
        _assert_replay(uni, ev, t, nm, em)
        _assert_fused_equal(an.node, jan.node, ("node", t))
        _assert_fused_equal(an.edge, jan.edge, ("edge", t))
        assert an.num_nodes() == jan.num_nodes()
        assert an.num_edges() == jan.num_edges()
        assert _bits(np.float32(an.node.weighted_total())) == _bits(
            np.float32(jan.node.weighted_total()))
        deg = an.degrees()
        assert deg.dtype == np.float32
        assert np.array_equal(deg, jan.degrees(impl=impl)), t
        rd = np.zeros(uni.num_nodes, np.float32)
        live = np.nonzero(em)[0]
        np.add.at(rd, uni.edge_src[live], 1)
        np.add.at(rd, uni.edge_dst[live], 1)
        assert np.array_equal(deg, rd), t


# ---------------------------------------------------------------------------
# an index the JAX package built, reopened by the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("transient", [True, False])
def test_index_lists_give_the_host_planes(seed, transient):
    """The card's route to a chain's planes, its device half run by the
    plain version: the staged int32 array (row offsets, the transient
    row's words, the lists) gives exactly the host route's four stacks,
    ``np_from_indices`` a list, at every timepoint of a random history."""
    _, (uni, ev, dg, pool) = _build(seed)
    U_n, U_e = uni.num_nodes, uni.num_edges
    W_n, W_e = bmod.num_words(U_n), bmod.num_words(U_e)
    tail_of = dg if transient else None
    for t in _times(ev, dg, np.random.default_rng(seed)):
        plan = dg.plan_singlepoint(t, NO_ATTRS, True)
        _, chain = torch_exec.plan_to_chain(dg, plan, pool)
        K = len(chain)
        host = torch_exec._chain_planes(chain, U_n, U_e, torch.device(CPU),
                                        tail_of)
        tail = (torch_exec._transient_step(dg, U_n, U_e) if transient
                else ())
        buf, head = torch_exec._index_lists(chain, tail, W_n, W_e)
        assert buf.dtype == np.int32
        assert buf.size - head == sum(len(ix) for c in chain for ix in c)
        staged = torch.from_numpy(buf)
        got = planes_from_indices(staged[head:], staged[:4 * K + 1],
                                  K + transient, W_n, W_e)
        if transient:
            got[1][K] = staged[4 * K + 1:4 * K + 1 + W_n]
            got[3][K] = staged[4 * K + 1 + W_n:head]
        for g, h in zip(got, host):
            assert torch.equal(g, h), t


@pytest.mark.parametrize("plane", range(4))
def test_index_lists_refuse_slots_past_their_plane(plane):
    W_n, W_e = 3, 7
    chain = [tuple(np.array([1, 2], np.int32) for _ in range(4))] * 2
    chain[1] = tuple(np.array([32 * (W_n, W_n, W_e, W_e)[plane]
                               if i == plane else 0], np.int32)
                     for i in range(4))
    with pytest.raises(IndexError):
        torch_exec._index_lists(chain, (), W_n, W_e)
    chain[1] = tuple(np.array([-1 if i == plane else 0], np.int32)
                     for i in range(4))
    with pytest.raises(IndexError):
        torch_exec._index_lists(chain, (), W_n, W_e)
    chain[1] = tuple(np.array([32 * (W_n, W_n, W_e, W_e)[i] - 1], np.int32)
                     for i in range(4))
    buf, head = torch_exec._index_lists(chain, (), W_n, W_e)
    assert buf.size - head == 12


@pytest.mark.parametrize("seed", [0, 6])
def test_interop_loaded_index(seed):
    juni, jev = j_random_history(200, seed, max_time_step=2)
    jdg = JDeltaGraph(juni, JMemKV(), L=16, k=3).build(jev)
    jdg.save_skeleton()
    uni, dg = load_reference_index(
        universe_arrays(juni), {k: jdg.store.get(k) for k in jdg.store.keys()},
        recent=event_arrays(jdg.recent))
    assert sorted(dg.store.keys(), key=repr) == sorted(jdg.store.keys(),
                                                       key=repr)
    # the reference reopened the same way
    jdg2 = JDeltaGraph.load_skeleton(juni, jdg.store)
    jdg2.recent = jdg.recent
    times = _times(jev, jdg, np.random.default_rng(seed))
    ref = jax_exec.execute_multipoint_jax(jdg2, times)
    got = execute_multipoint_torch(dg, times, device=CPU)
    for t in times:
        _assert_masks(got[t], ref[t], t)
        _assert_replay(uni, jev, t, *got[t])
    for t in times[:3]:
        nm, em, an = execute_singlepoint_fused(dg, t, device=CPU)
        jnm, jem, jan = jax_exec.execute_singlepoint_fused(jdg2, t)
        _assert_masks((nm, em), (jnm, jem), t)
        _assert_fused_equal(an.edge, jan.edge, t)
        assert np.array_equal(an.degrees(), jan.degrees()), t


# ---------------------------------------------------------------------------
# DeviceStager (mirrors tests/test_device_pipeline.py)
# ---------------------------------------------------------------------------


def test_stager_overlap_order():
    """With depth=2, chunk i+1 is built and put before chunk i's apply is
    issued — the double-buffering contract, visible in the event log."""
    st = DeviceStager(depth=2, put_fn=lambda x: x)
    chunks = [(np.full(4, i),) for i in range(5)]
    seen = []

    def apply(carry, dev):
        seen.append(int(dev[0][0]))
        return carry + dev[0].sum()

    out = st.stream(5, lambda i: chunks[i], apply, 0)
    assert out == sum(np.full(4, i).sum() for i in range(5))
    assert seen == [0, 1, 2, 3, 4]
    puts = [i for kind, i in st.events if kind == "put"]
    applies = [i for kind, i in st.events if kind == "apply"]
    assert puts == [0, 1, 2, 3, 4] and applies == [0, 1, 2, 3, 4]
    assert st.events.index(("put", 1)) < st.events.index(("apply", 0))
    assert st.events.index(("put", 2)) < st.events.index(("apply", 1))


def test_stager_depth_bound():
    """Never more than `depth` puts ahead of the apply cursor."""
    st = DeviceStager(depth=3, put_fn=lambda x: x)
    ahead = []

    def apply(carry, dev):
        puts = sum(1 for k, _ in st.events if k == "put")
        applies = sum(1 for k, _ in st.events if k == "apply")
        ahead.append(puts - applies)
        return carry

    st.stream(8, lambda i: (np.zeros(1),), apply, None)
    assert max(ahead) <= 3


def test_stager_empty_and_validation():
    st = DeviceStager(put_fn=lambda x: x)
    assert st.stream(0, lambda i: (), lambda c, d: c, "carry") == "carry"
    with pytest.raises(ValueError):
        DeviceStager(depth=0)


def test_stager_with_prefetcher_builds_on_worker():
    pf = Prefetcher(MemKV(), workers=2)
    main = threading.get_ident()
    build_threads = []

    def build(i):
        build_threads.append(threading.get_ident())
        return (np.full(2, i),)

    st = DeviceStager(depth=2, put_fn=lambda x: x, prefetcher=pf)
    out = st.stream(4, build, lambda c, d: c + int(d[0][0]), 0)
    assert out == 0 + 1 + 2 + 3
    assert all(t != main for t in build_threads)   # built off-thread
    pf.close(wait=True)


def test_stream_chunk_env(monkeypatch):
    monkeypatch.setenv("REPRO_STREAM_CHUNK", "3")
    assert stream_chunk_k() == 3
    monkeypatch.setenv("REPRO_STREAM_CHUNK", "junk")
    assert stream_chunk_k() == 8
    monkeypatch.delenv("REPRO_STREAM_CHUNK")
    assert stream_chunk_k() == 8


def test_pinned_put_on_cpu_is_a_word_view():
    """On the CPU the default put is the zero-copy identity, with packed
    uint32 words turned into their int32 view."""
    put = PinnedPut(CPU)
    words = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    t = put(words)
    assert t.dtype == torch.int32 and put.pending() == 0
    assert np.array_equal(t.numpy().view(np.uint32), words)
    assert np.shares_memory(t.numpy(), words)
    f = put(np.ones(3, np.float32))
    assert f.dtype == torch.float32
