"""The port's manager and query API against the JAX package's, on the CPU.

A seeded history from the JAX package's generator is carried into the port
through ``interop.universe_arrays`` / ``build_universe`` /
``event_arrays``; both packages then build a ``GraphManager`` over it
(the port's with ``device="cpu"``) and run the same documents in the same
order.  Held equal:

* the ``to_dict()`` envelopes of every document kind (snapshot,
  multipoint, expr, interval, evolve with named operators), CRCs, KV
  counters, plan costs and cache hits included, wall times excepted;
  PageRank values within 1e-5 instead (f32 sums differ in order);
* the legacy ``GraphManager`` entry points, against each other and the
  ``replay`` oracle;
* error envelopes and exceptions of the typed taxonomy, with positions;
* the materialization advisor's advice and the cache's hit counts on a
  fixed workload, and the analytical cost model of ``core/analysis.py``.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

from repro.api import GraphQuery as JGraphQuery
from repro.core import GraphManager as JGraphManager
from repro.core import TimeExpression as JTimeExpression
from repro.core import analysis as janalysis
from repro.core.errors import QueryError as JQueryError
from repro.core.events import GraphHistoryBuilder as JBuilder
from repro.core.query import parse_attr_options as j_parse_attr_options
from repro.data.generators import churn_network as j_churn_network

from repro_torch.api import GraphQuery, Q
from repro_torch.core import EventList, GraphManager, TimeExpression, replay
from repro_torch.core import analysis
from repro_torch.core.errors import (AttrOptionsError, DocumentError,
                                     QueryError, TimeExpressionError,
                                     UnknownAttributeError,
                                     UnknownOperatorError)
from repro_torch.core.events import GraphHistoryBuilder
from repro_torch.core.query import parse_attr_options
from repro_torch.core.temporal import resolve_op
from repro_torch.interop import build_universe, event_arrays, universe_arrays

CPU = "cpu"


def carry(juni, jev):
    """A JAX-package history as the port's universe and events."""
    return (build_universe(universe_arrays(juni)),
            EventList(**event_arrays(jev)))


def _history(n_initial_edges=150, n_events=1200, seed=1):
    juni, jev = j_churn_network(n_initial_edges=n_initial_edges,
                                n_events=n_events, seed=seed)
    return carry(juni, jev), (juni, jev)


@pytest.fixture(scope="module")
def pair():
    """``(uni, ev, gm, jgm)``: both packages' managers on one history."""
    (uni, ev), (juni, jev) = _history()
    gm = GraphManager(uni, ev, L=100, k=2, diff_fn="balanced", device=CPU)
    jgm = JGraphManager(juni, jev, L=100, k=2, diff_fn="balanced")
    yield uni, ev, gm, jgm
    gm.close()
    jgm.close()


def _strip_wall(d):
    """An envelope without its wall-time fields."""
    if isinstance(d, dict):
        return {k: _strip_wall(v) for k, v in d.items() if k != "wall_s"}
    if isinstance(d, list):
        return [_strip_wall(v) for v in d]
    return d


def _run_both(gm, jgm, text, safe=False):
    doc, jdoc = GraphQuery.from_json(text), JGraphQuery.from_json(text)
    if safe:
        return gm.query.run_safe(doc), jgm.query.run_safe(jdoc)
    return gm.query.run(doc), jgm.query.run(jdoc)


def _t(ev, i):
    return int(ev.time[i])


def _docs(ev):
    """Wire documents of every kind, as JSON text."""
    t = [_t(ev, i) for i in (100, 300, 500, 700, 900, 1150)]
    ev_times = sorted(t[2:5] + [t[2] + 7, t[3] + 3])
    return {
        "snapshot": {"kind": "snapshot", "t": t[1]},
        "snapshot-attrs": {"kind": "snapshot", "t": t[4],
                           "attrs": "+node:all+edge:all"},
        "snapshot-full": {"kind": "snapshot", "t": t[0], "reply": "full",
                          "use_current": False},
        "multipoint": {"kind": "multipoint", "times": t[:4],
                       "attrs": "+node:all"},
        "multipoint-fresh": {"kind": "multipoint", "times": t[2:],
                             "no_cache": True},
        "expr": {"kind": "expr", "expr": "t0 & ~t1", "times": t[1:3]},
        "expr-full": {"kind": "expr", "expr": "(t0 | t1) & ~t2",
                      "times": t[:3], "reply": "full"},
        "interval": {"kind": "interval", "ts": t[1], "te": t[3]},
        "evolve-masks": {"kind": "evolve", "times": ev_times, "op": "masks"},
        "evolve-degree": {"kind": "evolve", "times": ev_times,
                          "op": "degree", "reply": "full"},
        "evolve-density": {"kind": "evolve", "times": ev_times,
                           "op": "density", "incremental": False},
        "evolve-components": {"kind": "evolve", "times": ev_times,
                              "op": "components"},
        "evolve-components-recompute": {"kind": "evolve", "times": ev_times,
                                        "op": "components",
                                        "incremental": False},
        "evolve-id": {"kind": "evolve", "times": ev_times[:2],
                      "op": "density", "id": "req-7"},
    }


# the document names, from a stand-in history of the same length
_KINDS = list(_docs(types.SimpleNamespace(time=np.zeros(1200, np.int64))))


@pytest.mark.parametrize("name", _KINDS)
def test_envelopes_equal(pair, name):
    uni, ev, gm, jgm = pair
    text = json.dumps(_docs(ev)[name])
    got, want = _run_both(gm, jgm, text)
    assert got.ok and want.ok
    g, w = _strip_wall(got.to_dict()), _strip_wall(want.to_dict())
    assert g == w
    assert json.loads(got.to_json()).keys() == json.loads(
        want.to_json()).keys()


@pytest.mark.parametrize("incremental", [True, False])
def test_evolve_pagerank_envelope(pair, incremental):
    """PageRank through the service: every envelope field but the ranks'
    CRCs and the solver counts is equal; ranks agree within 1e-5 and the
    counts within 2."""
    uni, ev, gm, jgm = pair
    times = [_t(ev, i) for i in (400, 500, 600, 700)]
    text = json.dumps({"kind": "evolve", "times": times, "op": "pagerank",
                       "op_kwargs": {"tol": 1e-6},
                       "incremental": incremental})
    got, want = _run_both(gm, jgm, text)
    g, w = _strip_wall(got.to_dict()), _strip_wall(want.to_dict())
    gi = g["result"]["engine_stats"].pop("solver_iters")
    wi = w["result"]["engine_stats"].pop("solver_iters")
    assert all(abs(a - b) <= 2 for a, b in zip(gi, wi))
    gv, wv = g["result"].pop("values"), w["result"].pop("values")
    assert [v["size"] for v in gv] == [v["size"] for v in wv]
    assert g == w
    for a, b in zip(got.value.values, want.value.values):
        assert np.allclose(a, b, atol=1e-5)


def test_run_batch_merges_and_isolates_errors(pair):
    """Co-batched point documents share one merged plan in both packages;
    a bad document yields the same error envelope and poisons nothing."""
    uni, ev, gm, jgm = pair
    ts = [_t(ev, i) for i in (150, 550, 950)]
    texts = [json.dumps(d) for d in (
        {"kind": "snapshot", "t": ts[0]},
        {"kind": "multipoint", "times": ts[1:]},
        {"kind": "snapshot", "t": ts[1], "attrs": "+node:nope"},
        {"kind": "expr", "expr": "t0 | t1", "times": ts[:2]},
        {"kind": "evolve", "times": ts, "op": "no-such-op"},
        {"kind": "interval", "ts": ts[0], "te": ts[1]})]
    got = gm.query.run_batch([GraphQuery.from_json(x) for x in texts],
                             on_error="envelope")
    want = jgm.query.run_batch([JGraphQuery.from_json(x) for x in texts],
                               on_error="envelope")
    assert [r.ok for r in got] == [True, True, False, True, False, True]
    for g, w in zip(got, want):
        assert _strip_wall(g.to_dict()) == _strip_wall(w.to_dict())
    assert got[0].stats["merged_docs"] == 3


# ---------------------------------------------------------------------------
# the legacy GraphManager entry points
# ---------------------------------------------------------------------------


def _assert_state(got, want, msg=""):
    assert np.array_equal(got.node_mask, want.node_mask), msg
    assert np.array_equal(got.edge_mask, want.edge_mask), msg
    assert want.equal(got), msg


def test_manager_entry_points(pair):
    uni, ev, gm, jgm = pair
    ts = [_t(ev, i) for i in (120, 640, 1100)]
    for t in ts:
        got = gm.get_snapshot(t, "+node:all+edge:all")
        _assert_state(got, jgm.get_snapshot(t, "+node:all+edge:all"), t)
        _assert_state(got, replay(uni, ev, t), t)
    got = gm.get_snapshots(ts, "+node:all")
    want = jgm.get_snapshots(ts, "+node:all")
    assert list(got) == list(want)
    for t in ts:
        _assert_state(got[t], want[t], t)
    assert gm.get_snapshots([]) == {}
    hs, jhs = gm.get_hist_graphs(ts, use_current=False), \
        jgm.get_hist_graphs(ts, use_current=False)
    for h, jh in zip(hs, jhs):
        assert (h.gid, h.time, h.num_nodes(), h.num_edges()) == \
            (jh.gid, jh.time, jh.num_nodes(), jh.num_edges())
        node = uni.node_ids[int(np.nonzero(h.node_mask)[0][0])]
        assert h.get_neighbors(node) == jh.get_neighbors(node)
        h.close()
        jh.close()
    tex = TimeExpression.parse("t0 & ~t1", ts[:2])
    jtex = JTimeExpression.parse("t0 & ~t1", ts[:2])
    with gm.get_hist_graph_expr(tex, "+node:all") as h, \
            jgm.get_hist_graph_expr(jtex, "+node:all") as jh:
        _assert_state(h.to_state(), jh.to_state())
    got = gm.get_hist_graph_interval(ts[0], ts[1])
    want = jgm.get_hist_graph_interval(ts[0], ts[1])
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    with gm.get_hist_graph(ts[1], "+node:all") as h, \
            jgm.get_hist_graph(ts[1], "+node:all") as jh:
        assert h.get_nodes() == jh.get_nodes()
        name = next(iter(uni.node_attr_cols))
        node = h.get_nodes()[0]
        a, b = h.node_attr(node, name), jh.node_attr(node, name)
        assert a == b or (np.isnan(a) and np.isnan(b))


def test_materialize_roots_and_total(pair):
    (uni, ev), (juni, jev) = _history(n_initial_edges=60, n_events=600,
                                      seed=5)
    gm = GraphManager(uni, ev, L=32, k=2, device=CPU)
    jgm = JGraphManager(juni, jev, L=32, k=2)
    assert gm.materialize_roots(2) == jgm.materialize_roots(2)
    assert gm.total_materialization() == jgm.total_materialization()
    assert gm.pool.memory_bytes() == jgm.pool.memory_bytes()
    t = _t(ev, 400)
    _assert_state(gm.get_snapshot(t), jgm.get_snapshot(t))
    gm.close()
    jgm.close()
    assert gm.closed and gm.prefetcher is None


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

_BAD = [
    {"kind": "nope"},
    {"kind": "snapshot"},
    {"kind": "snapshot", "t": 1, "times": [2]},
    {"kind": "multipoint", "times": []},
    {"kind": "interval", "ts": 5},
    {"kind": "evolve", "times": [1, 2], "op": "no-such-op"},
    {"kind": "snapshot", "t": 3, "attrs": "+node:all+edge:nope"},
    {"kind": "snapshot", "t": 3, "attrs": "+node:all junk"},
    {"kind": "expr", "expr": "t0 & #", "times": [1, 2]},
    {"kind": "expr", "expr": "(t0", "times": [1]},
    {"kind": "expr", "expr": "t0 & t9", "times": [1, 2]},
    {"kind": "snapshot", "t": 1, "bogus": 2},
    {"v": 99, "kind": "snapshot", "t": 1},
]


@pytest.mark.parametrize("bad", _BAD, ids=lambda d: json.dumps(d))
def test_error_envelopes_equal(pair, bad):
    uni, ev, gm, jgm = pair
    text = json.dumps(bad)
    try:
        doc = GraphQuery.from_json(text)
    except QueryError as e:
        with pytest.raises(JQueryError) as ei:
            JGraphQuery.from_json(text)
        assert type(e).__name__ == type(ei.value).__name__
        assert e.to_dict() == ei.value.to_dict()
        return
    got = gm.query.run_safe(doc)
    want = jgm.query.run_safe(JGraphQuery.from_json(text))
    assert not got.ok and not want.ok
    assert got.to_dict() == want.to_dict()


def _small_universes():
    out = []
    for builder in (GraphHistoryBuilder, JBuilder):
        b = builder()
        b.add_node(0, 1, attrs={"name": "x", "salary": 10.0, "age": 3.0})
        b.add_node(1, 1)
        b.add_edge(0, 1, 2, attrs={"weight": 1.0, "label": "e"})
        out.append(b.finalize()[0])
    return out


@pytest.mark.parametrize("spec", ["+node:all+edge:nope", "+node:all junk",
                                  "+node:nope", "+edge:weight-edge:zz"])
def test_attr_errors_typed_and_positioned(spec):
    uni, juni = _small_universes()
    with pytest.raises(QueryError) as ei:
        parse_attr_options(spec, uni)
    with pytest.raises(JQueryError) as ej:
        j_parse_attr_options(spec, juni)
    assert isinstance(ei.value, (UnknownAttributeError, AttrOptionsError))
    assert type(ei.value).__name__ == type(ej.value).__name__
    assert ei.value.to_dict() == ej.value.to_dict()
    assert str(ei.value) == str(ej.value)


@pytest.mark.parametrize("expr,times", [("t0 & #", [1, 2]), ("(t0", [1]),
                                        ("t0 & t9", [1, 2]), ("", [1])])
def test_time_expression_errors(expr, times):
    with pytest.raises(TimeExpressionError) as ei:
        TimeExpression.parse(expr, times)
    with pytest.raises(JQueryError) as ej:
        JTimeExpression.parse(expr, times)
    assert ei.value.to_dict() == ej.value.to_dict()


def test_operator_and_document_errors():
    with pytest.raises(UnknownOperatorError):
        resolve_op("no-such-op", {})
    with pytest.raises(DocumentError) as ei:
        Q.at(5).build().__class__(kind="multipoint").validate()
    assert ei.value.position == "times"
    assert Q.between(0, 9).step(3).compute("degree").build().times == \
        (0, 3, 6, 9)
    d = Q.at(5).fresh().full().use_current(False).build()
    assert d.to_json() == JGraphQuery.from_json(d.to_json()).to_json()


# ---------------------------------------------------------------------------
# advisor, cache and the cost model
# ---------------------------------------------------------------------------


def test_advisor_and_cache_equal_on_fixed_workload():
    (uni, ev), (juni, jev) = _history(n_initial_edges=160, n_events=2000,
                                      seed=3)
    kw = dict(L=80, k=2, diff_fn="intersection")
    gm = GraphManager(uni, ev, device=CPU, **kw)
    jgm = JGraphManager(juni, jev, **kw)
    budget = gm.pool.memory_bytes() + (64 << 10)
    assert budget == jgm.pool.memory_bytes() + (64 << 10)
    advice = [m.enable_advisor(budget_bytes=budget, replan_every=12)
              for m in (gm, jgm)]
    assert dataclasses.asdict(advice[0]) == dataclasses.asdict(advice[1])
    rng = np.random.default_rng(0)
    tmax = int(ev.time[-1])
    # a skewed workload with repeats: old history first, then recent
    times = np.concatenate([rng.integers(0, tmax // 5, 30),
                            rng.integers(tmax // 2, tmax, 30)])
    times = np.concatenate([times, times[::3]])
    for t in times:
        a, b = gm.get_snapshot(int(t)), jgm.get_snapshot(int(t))
        _assert_state(a, b, int(t))
    assert (gm.cache.hits, gm.cache.misses) == (jgm.cache.hits,
                                                jgm.cache.misses)
    assert gm.cache.hits > 0
    assert dict(gm.advisor.pinned) == dict(jgm.advisor.pinned)
    assert gm.workload.snapshot() == jgm.workload.snapshot()
    assert gm.pool.memory_bytes() <= budget
    last = [m.advisor.replan() for m in (gm, jgm)]
    assert dataclasses.asdict(last[0]) == dataclasses.asdict(last[1])
    for m in (gm, jgm):
        m.disable_advisor()
    assert gm.advisor is None and gm.pool.memory_bytes() == \
        jgm.pool.memory_bytes()
    gm.close()
    jgm.close()


def test_cost_model_equal():
    (uni, ev), (juni, jev) = _history(n_events=3000, seed=2)
    r, jr = analysis.estimate_rates(ev), janalysis.estimate_rates(jev)
    assert dataclasses.asdict(r) == dataclasses.asdict(jr)
    for L, k in ((100, 2), (250, 4)):
        for fn in ("balanced_total_space", "balanced_level_space"):
            assert getattr(analysis, fn)(L, k, r) == \
                getattr(janalysis, fn)(L, k, jr)
        assert analysis.expected_singlepoint_bytes(r, L, k) == \
            janalysis.expected_singlepoint_bytes(jr, L, k)
        assert analysis.copylog_space(L, r) == janalysis.copylog_space(L, jr)
    for fn in ("balanced_root_size", "balanced_path_weight",
               "intersection_root_size", "interval_tree_space",
               "segment_tree_space"):
        assert getattr(analysis, fn)(r) == getattr(janalysis, fn)(jr)
    pick = analysis.choose_parameters(r, space_budget_events=4 * 3000)
    jpick = janalysis.choose_parameters(jr, space_budget_events=4 * 3000)
    assert dataclasses.asdict(pick) == dataclasses.asdict(jpick)
