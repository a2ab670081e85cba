"""The port's spans and counters (``repro_torch.obs``) on the CPU.

Spans record only inside a ``torch.profiler`` window and stamp
``time.time_ns()``, the profiler's own host clock; the program adds no
event to the window.  Counters count with or without a profiler.  One
point retrieval and its analytics form one request's span tree, the
analytics joining the ``retrieve`` span after it has closed.
"""
import inspect
import time

import numpy as np
import pytest
import torch

from repro_torch import kernels, obs, transfer
from repro_torch.core import DeltaGraph, bitmaps
from repro_torch.core import deltagraph as deltagraph_mod
from repro_torch.data.generators import random_history
from repro_torch.kernels.delta_apply import ops as da_ops
from repro_torch.kernels.segment_sum import ops as ss_ops
from repro_torch.runtime import torch_exec
from repro_torch.storage.kv import MemKV

ANALYTICS = ("analytics.degrees", "analytics.counts",
             "analytics.weighted_total")
# the spans of one point retrieval with its analytics on the CPU (no
# ``stage``: a copy to the CPU is no copy)
CPU_SPANS = {"retrieve", "plan", "lower", "fetch", "pack",
             "launch.delta_apply_fused", "readback", "unpack", "bucket",
             "launch.segment_sum", *ANALYTICS}


@pytest.fixture(scope="module")
def history():
    uni, ev = random_history(600, 5, max_time_step=2)
    dg = DeltaGraph(uni, MemKV(), L=24, k=2).build(ev)
    t = int(ev.time[len(ev.time) // 3])
    w = np.random.default_rng(5).random(uni.num_nodes, dtype=np.float32)
    return dg, t, w


def _request(dg, t, w):
    nm, em, an = torch_exec.execute_singlepoint_fused(dg, t, node_weights=w,
                                                      device="cpu")
    return nm, em, an.degrees(), an.num_nodes(), an.node.weighted_total()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _traced_request(dg, t, w):
    obs.clear()
    with _profiler() as prof:
        out = _request(dg, t, w)
    return out, obs.records(), prof


def test_no_profiler_no_records_counters_count(history):
    dg, t, w = history
    obs.clear()
    before = obs.counters()
    _request(dg, t, w)
    after = obs.counters()
    assert obs.records() == []
    assert after["bucket_entries"] > before.get("bucket_entries", 0)
    assert {k: v for k, v in after.items() if k.startswith("span_ns.")} == \
        {k: v for k, v in before.items() if k.startswith("span_ns.")}
    # copies to and from the CPU are no copies
    assert after.get("h2d_bytes", 0) == before.get("h2d_bytes", 0)
    assert after.get("d2h_bytes", 0) == before.get("d2h_bytes", 0)


def test_one_request_one_span_tree(history):
    dg, t, w = history
    _, recs, _ = _traced_request(dg, t, w)
    assert {r.name for r in recs} == CPU_SPANS
    assert len({r.rid for r in recs}) == 1
    by_sid = {r.sid: r for r in recs}
    (root,) = [r for r in recs if r.parent == 0]
    assert root.name == "retrieve" and root.work == {"t": t}
    for r in recs:
        assert r.start <= r.end
        if r is root:
            continue
        up = by_sid[r.parent]
        if r.name in ANALYTICS:
            # after the retrieval has returned, under its span
            assert up is root and r.start >= root.end
        else:
            assert up.start <= r.start and r.end <= up.end, (r, up)
    parents = {r.name: by_sid[r.parent].name for r in recs if r.parent}
    assert parents["plan"] == parents["lower"] == "retrieve"
    assert parents["fetch"] == "lower"
    assert parents["bucket"] == parents["launch.segment_sum"] == \
        "analytics.degrees"
    assert parents["unpack"] == parents["launch.delta_apply_fused"] == \
        "retrieve"
    readback_parents = sorted(by_sid[r.parent].name for r in recs
                              if r.name == "readback")
    assert readback_parents == ["analytics.counts", "analytics.degrees",
                                "analytics.weighted_total", "retrieve",
                                "retrieve"]


def test_span_work_counts(history):
    dg, t, w = history
    _, recs, _ = _traced_request(dg, t, w)
    uni = dg.universe
    W_n, W_e = bitmaps.num_words(uni.num_nodes), bitmaps.num_words(
        uni.num_edges)
    (launch,) = [r for r in recs if r.name == "launch.delta_apply_fused"]
    (lower,) = [r for r in recs if r.name == "lower"]
    assert launch.work == {"K": lower.work["K"] + 1, "W_n": W_n, "W_e": W_e,
                           "weights_n": uni.num_nodes, "weights_e": 0,
                           "live": True}
    by_name = {r.sid: r.name for r in recs}
    buckets = [r for r in recs if r.name == "bucket"]
    assert [b.work["edges"] for b in buckets] == [uni.num_edges] * 2
    launches = [r.work["shape"] for r in recs
                if r.name == "launch.segment_sum"]
    assert launches == [(b.work["NB"], b.work["ME"], 1) for b in buckets]
    # a store fetch names its payload and bytes; a pack, the eventlist rows
    # it turns into index lists or the plane words it builds from them
    fetches = [r.work for r in recs if r.name == "fetch"]
    assert fetches and all(set(f) == {"pid", "bytes"} for f in fetches)
    assert sum(f["bytes"] for f in fetches) > 0
    packs = [(by_name[r.parent], set(r.work)) for r in recs
             if r.name == "pack"]
    assert ("retrieve", {"words"}) in packs
    assert all(p in (("lower", {"rows"}), ("lower", {"words"}),
                     ("retrieve", {"words"})) for p in packs), packs
    masks = [r.work["bytes"] for r in recs
             if r.name == "readback" and by_name[r.parent] == "retrieve"]
    assert masks == [4 * W_n, 4 * W_e]


def test_counters_while_traced(history):
    """``span_ns.<name>`` adds each outermost span's length;
    ``bucket_entries`` adds NB x ME a bucketing."""
    dg, t, w = history
    before = obs.counters()
    _, recs, _ = _traced_request(dg, t, w)
    after = obs.counters()
    for name in CPU_SPANS:
        spent = sum(r.end - r.start for r in recs if r.name == name)
        assert after["span_ns." + name] - before.get("span_ns." + name, 0) \
            == spent, name
    entries = sum(r.work["NB"] * r.work["ME"] for r in recs
                  if r.name == "bucket")
    assert after["bucket_entries"] - before["bucket_entries"] == entries


def test_span_inside_itself_counts_once():
    before = obs.counters().get("span_ns.nested", 0)
    with _profiler():
        with obs.span("nested") as outer:
            with obs.span("nested") as inner:
                time.sleep(0.002)
    assert inner.parent == outer.sid and inner.rid == outer.rid
    assert obs.counters()["span_ns.nested"] - before == outer.end - outer.start


def test_record_function_inside_a_span_on_the_profilers_clock():
    """A ``record_function`` range opened inside a span lies inside the
    span once the profiler's times are moved onto ``time.time_ns()`` by
    the window's ``trace_start_ns()``."""
    with _profiler() as prof:
        with torch.profiler.record_function("warm"):
            pass
        with obs.span("outer") as sp:
            time.sleep(0.002)
            with torch.profiler.record_function("probe"):
                time.sleep(0.002)
            time.sleep(0.002)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (probe,) = [e for e in prof.events() if e.name == "probe"]
    a = start_ns + probe.time_range.start * 1000
    b = start_ns + probe.time_range.end * 1000
    slack = 1_000_000                                   # 1 ms
    assert sp.start - slack <= a < b <= sp.end + slack
    assert b - a >= 1_000_000           # the probe's own 2 ms, not a stub


def test_program_adds_no_profiler_event(history):
    dg, t, w = history
    _, recs, prof = _traced_request(dg, t, w)
    names = {e.name for e in prof.events()}
    assert recs and not names & {r.name for r in recs}
    # nor does its source open a profiler or NVTX range anywhere on the path
    for mod in (obs, transfer, torch_exec, deltagraph_mod, bitmaps, da_ops,
                ss_ops, kernels):
        src = inspect.getsource(mod)
        for call in ("record_function(", "nvtx", "_record_function_enter"):
            assert call not in src, (mod.__name__, call)


def test_ring_buffer_overflow_counts_dropped_spans():
    obs.clear()
    before = obs.counters().get("spans_dropped", 0)
    with _profiler():
        for _ in range(obs.CAPACITY + 7):
            with obs.span("tick"):
                pass
    assert obs.counters()["spans_dropped"] - before == 7
    recs = obs.records()
    assert len(recs) == obs.CAPACITY
    assert recs[0].sid < recs[-1].sid                   # oldest dropped
    obs.clear()


def test_launch_counts_keep_their_names_and_results():
    names = ["delta_apply_chain", "delta_apply_fused", "planes_from_indices",
             "flash_attention", "flash_attention_prefill",
             "flash_attention_prefill_f32",
             "flash_attention_decode", "flash_attention_mla",
             "flash_attention_prefill_stats",
             "flash_attention_prefill_f32_stats", "segment_sum_bucketed"]
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(names, 0)
    assert list(kernels.launch_counts()) == names
    obs.count("launch.segment_sum_bucketed", 3)
    obs.count("launch.delta_apply_fused")
    got = kernels.launch_counts()
    assert got["segment_sum_bucketed"] == 3 and got["delta_apply_fused"] == 1
    assert obs.counters()["launch.segment_sum_bucketed"] == 3
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_plain_versions_launch_nothing(history):
    dg, t, w = history
    kernels.reset_launch_counts()
    with _profiler():
        _request(dg, t, w)
    assert set(kernels.launch_counts().values()) == {0}


def test_transfer_to_the_cpu_is_no_copy():
    a = np.arange(12, dtype=np.uint32)
    before = obs.counters()
    obs.clear()
    with _profiler():
        t = transfer.to_device(a, torch.device("cpu"))
        back = transfer.to_host(t)
    assert t.dtype == torch.int32 and t.data_ptr() == a.ctypes.data
    assert np.array_equal(back.view(np.uint32), a)
    assert [r.name for r in obs.records()] == ["readback"]
    after = obs.counters()
    assert after.get("h2d_bytes", 0) == before.get("h2d_bytes", 0)
    assert after.get("d2h_bytes", 0) == before.get("d2h_bytes", 0)
