"""The port's copied host modules against the JAX package's originals.

On the ``churn`` and ``growing`` fixtures (tests/conftest.py) the port's
generators, DeltaGraph, codec/KV layer, planner and HostExecutor must give
identical histories, byte-identical KV blobs, identical plan steps and
identical host-executed states.
"""
import numpy as np
import pytest

from repro.core.deltagraph import DeltaGraph as JDeltaGraph
from repro.core.query import NO_ATTRS as J_NO_ATTRS
from repro.core.query import parse_attr_options as j_parse_attr_options
from repro.storage.kv import MemKV as JMemKV

from repro_torch.core.deltagraph import DeltaGraph
from repro_torch.core.query import NO_ATTRS, parse_attr_options
from repro_torch.data.generators import churn_network, growing_network
from repro_torch.interop import event_arrays, universe_arrays
from repro_torch.storage.kv import MemKV

# the conftest fixtures' generator calls, repeated with the port's generators
PORT_HISTORY = {
    "churn": lambda: churn_network(n_initial_edges=150, n_events=1200, seed=1),
    "growing": lambda: growing_network(n_events=1500, seed=2),
}
INDEX_CONFIGS = {
    "balanced-k2": dict(L=100, k=2),
    "intersection-k4": dict(L=150, k=4, diff_fn="intersection"),
    "two-hierarchies": dict(L=120, k=2, diff_fn=["intersection", "union"]),
    "partitioned": dict(L=100, k=3, num_partitions=2),
}


def _assert_same_values(a, b, path="") -> None:
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_values(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, path


@pytest.fixture(scope="module", params=sorted(PORT_HISTORY))
def histories(request):
    """(name, JAX-package history, port history)."""
    name = request.param
    return name, request.getfixturevalue(name), PORT_HISTORY[name]()


@pytest.fixture(scope="module", params=sorted(INDEX_CONFIGS))
def indexes(request, histories):
    """Both packages' DeltaGraphs over the same history and settings."""
    name, (juni, jev), (uni, ev) = histories
    cfg = INDEX_CONFIGS[request.param]
    jdg = JDeltaGraph(juni, JMemKV(), **cfg).build(jev)
    dg = DeltaGraph(uni, MemKV(), **cfg).build(ev)
    return juni, jev, jdg, uni, ev, dg


def _query_times(ev) -> list[int]:
    tmax = int(ev.time[-1])
    return sorted({-1, 0, tmax // 7, tmax // 3, tmax // 2, tmax - 1, tmax,
                   tmax + 5})


def test_generators_identical(histories):
    _, (juni, jev), (uni, ev) = histories
    _assert_same_values(universe_arrays(juni), universe_arrays(uni))
    _assert_same_values(event_arrays(jev), event_arrays(ev))


def test_kv_blobs_identical(indexes):
    _, _, jdg, _, _, dg = indexes
    jdg.save_skeleton()
    dg.save_skeleton()
    jkeys, keys = sorted(jdg.store.keys(), key=repr), sorted(dg.store.keys(),
                                                              key=repr)
    assert jkeys == keys
    for k in keys:
        assert jdg.store.get(k) == dg.store.get(k), k


def test_plan_steps_identical(indexes):
    _, jev, jdg, _, _, dg = indexes
    times = _query_times(jev)
    for t in times:
        for use_current in (True, False):
            jp = jdg.plan_singlepoint(t, J_NO_ATTRS, use_current)
            p = dg.plan_singlepoint(t, NO_ATTRS, use_current)
            assert [s.action for s in jp.steps] == [s.action for s in p.steps]
            assert jp.total_weight == p.total_weight
    jp = jdg.plan_multipoint(times, J_NO_ATTRS, True)
    p = dg.plan_multipoint(times, NO_ATTRS, True)
    assert [s.action for s in jp.steps] == [s.action for s in p.steps]
    assert jp.targets == p.targets
    assert [type(n.op).__name__ for n in jp.nodes] == [
        type(n.op).__name__ for n in p.nodes]


def test_host_executor_states_identical(indexes):
    juni, jev, jdg, uni, _, dg = indexes
    times = _query_times(jev)
    jopts = j_parse_attr_options("+node:all+edge:all", juni)
    opts = parse_attr_options("+node:all+edge:all", uni)
    for jo, o in ((J_NO_ATTRS, NO_ATTRS), (jopts, opts)):
        jstates = jdg.get_snapshots(times, jo)
        states = dg.get_snapshots(times, o)
        assert jstates.keys() == states.keys()
        for t in times:
            for field in ("node_mask", "edge_mask", "node_attrs",
                          "edge_attrs"):
                a = getattr(jstates[t], field)
                b = getattr(states[t], field)
                assert np.array_equal(a, b, equal_nan=True), (t, field)
