"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.obs``): reported on a traced CPU run, left out where the
program keeps no such counter (a program older than them) or where its
span buffer overflowed during the window."""
import sys

import pytest

from hgbench import catalog, harness, trace
from hgbench.tests import small

PROGRAM_METRICS = ("fetch_ms", "pack_ms", "stage_ms", "readback_ms",
                   "unpack_ms", "h2d_bytes_per_request",
                   "bucket_entries_per_request")


def _metric(name):
    return catalog.Benchmark(small.ROOT).metric(name)


def test_traced_cpu_run_reports_the_program_metrics():
    res = harness.run(small.cell("growing.point-analytics"),
                      seed=small.SEED, seconds=0.2, traced=True, device="cpu")
    assert res.correct
    for name in ("fetch_ms", "pack_ms", "readback_ms", "unpack_ms",
                 "bucket_entries_per_request"):
        assert res.metrics[name]["value"] > 0, name
    # a copy to the CPU is no copy: nothing staged, nothing to report
    assert "stage_ms" not in res.metrics
    assert "h2d_bytes_per_request" not in res.metrics


def _trace(counters):
    return trace.Trace(4, (0.0, 1.0), {}, {}, [], counters)


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_a_program_without_the_counters_reads_nothing(name, monkeypatch):
    import repro_torch
    m = _metric(name)
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # import fails
    values = {k: fn(None) for k, fn in m.COUNTERS.items()}
    assert all(v != v for v in values.values())                # NaN
    assert m.read(_trace({k: (v, v) for k, v in values.items()})) is None


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_an_overflowed_span_buffer_reads_nothing(name):
    m = _metric(name)
    (key,) = [k for k in m.COUNTERS if k != "spans_dropped"]
    sound = {key: (1e6, 9e6), "spans_dropped": (2, 2)}
    per_request = 8e6 / 4                         # ns, bytes or entries
    assert m.read(_trace(sound)) == pytest.approx(
        per_request / 1e6 if m.SOURCE == "program_span" else per_request)
    assert m.read(_trace(sound | {"spans_dropped": (2, 3)})) is None
    assert m.read(_trace(sound | {key: (5.0, 5.0)})) is None
