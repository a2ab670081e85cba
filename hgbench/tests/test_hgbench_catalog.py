"""``BENCHMARK.json`` against the contract's shapes, every entry resolved
to its files, and a cell, a mix and a metric added as files alone picked
up without an edit."""
import json
import re
import shutil

import pytest

from hgbench import catalog, harness, trace
from hgbench.tests import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_resolves():
    spec = small.spec()
    bench = catalog.Benchmark(small.ROOT)
    for w in spec["workloads"]:
        cell = bench.cell(w["name"])
        for fn in ("prepare", "call", "after", "check", "control"):
            assert callable(getattr(cell.driver, fn))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m, module in cell.per_layer:
            assert callable(module.read)
            assert module.SOURCE == m["source"]
        assert cell.config["name"] == w["config"]
    for m in spec["end_to_end"]:
        assert m["name"] in harness.E2E
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_names_and_limits():
    spec = small.spec()
    raw = (small.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    layers = {m["moves"] for m in spec["per_layer"]}
    assert layers <= {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        for w in m["workloads"]:
            assert w in {x["name"] for x in spec["workloads"]}
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in spec["configs"]:
        assert (small.ROOT / c["file"]).is_file()
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    assert 1 <= spec["run_seconds"] <= 51


def _copy_files(tmp_path):
    """The benchmark's own files beside a copy of ``BENCHMARK.json`` in
    ``tmp_path``: the tree a later PR adds files to."""
    here = tmp_path / "hgbench"
    for sub in ("configs", "traffic", "drivers", "metrics", "samplers",
                "generators"):
        shutil.copytree(small.ROOT / "hgbench" / sub, here / sub)
    return here, small.spec()


def test_cell_mix_and_metric_added_as_files(tmp_path):
    """A new sampler file, a mix file that picks it, a new metric file and
    new entries: the harness runs the cell and reports the metric, no
    existing file edited."""
    here, spec = _copy_files(tmp_path)
    (here / "samplers" / "uniform_t.py").write_text(
        'def requests(spec, tmax, rng):\n'
        '    while True:\n'
        '        yield [int(rng.integers(0, tmax + 1))]\n')
    (here / "traffic" / "point-uniform.json").write_text(json.dumps(
        {"driver": "point_analytics", "times": {"pick": "uniform_t"}}))
    (here / "metrics" / "requests_traced.py").write_text(
        'SOURCE = "program_counter"\n'
        'def read(trace):\n'
        '    return float(trace.requests)\n')
    spec["workloads"].append({"name": "churn.point-uniform", "config": "churn",
                              "traffic": "point-uniform", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "requests_traced", "unit": "1",
                              "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "snapshots_per_s",
                              "workloads": ["churn.point-uniform"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = small.cell("churn.point-uniform", root=tmp_path)
    assert cell.sampler.__file__.endswith("uniform_t.py")
    assert [m["name"] for m, _ in cell.per_layer] == ["requests_traced"]
    res = harness.run(cell, seed=small.SEED, seconds=0.2, traced=True,
                      device="cpu")
    assert res.correct
    assert res.metrics["requests_traced"]["value"] >= 1
    assert res.breakdown is not None


def test_config_with_new_generator_added_as_files(tmp_path):
    """A new history generator file, a configuration that names it and a
    cell entry: the run builds that history, and the reference holds the
    program to it."""
    here, spec = _copy_files(tmp_path)
    (here / "generators" / "ring.py").write_text(
        'import numpy as np\n'
        'from hgbench.history import ADD_EDGE, ADD_NODE, DEL_EDGE, History\n'
        'def generate(params, seed):\n'
        '    n = params["n_nodes"]\n'
        '    rng = np.random.default_rng(seed)\n'
        '    kind = [ADD_NODE] * n + [ADD_EDGE] * n + [DEL_EDGE] * (n // 2)\n'
        '    a = list(range(n)) + list(range(n))\n'
        '    a += rng.permutation(n)[: n // 2].tolist()\n'
        '    b = [-1] * n + [(i + 1) % n for i in range(n)] + [-1] * (n // 2)\n'
        '    t = np.sort(rng.integers(0, 10 * len(kind), len(kind)))\n'
        '    return History(t.astype(np.int64), np.array(kind, np.int8),\n'
        '                   np.array(a, np.int64), np.array(b, np.int64),\n'
        '                   np.full(len(kind), np.nan, np.float32), 0)\n')
    config = json.loads((here / "configs" / "churn.json").read_text())
    config.update(name="ring", history={"generator": "ring",
                                        "n_nodes": 3000})
    (here / "configs" / "ring.json").write_text(json.dumps(config))
    spec["configs"].append({"name": "ring", "source": "test",
                            "file": "hgbench/configs/ring.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "ring.point-analytics",
                              "config": "ring", "traffic": "point-analytics",
                              "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = catalog.Benchmark(tmp_path).cell("ring.point-analytics")
    cell.config["index"]["L"] = 500
    assert cell.generator.__file__.endswith("ring.py")
    res = harness.run(cell, seed=small.SEED, seconds=0.2, traced=False,
                      device="cpu")
    assert res.correct and res.attempted >= 1
    assert dict((n, v) for n, v, _ in res.checks)["mask_bits_wrong"] == 0


def test_traced_run_reports_layers():
    res = harness.run(small.cell("growing.point-analytics"),
                      seed=small.SEED, seconds=0.2, traced=True, device="cpu")
    assert res.correct
    for name in ("plan_ms", "lower_ms", "bucket_edges_ms",
                 "kv_bytes_per_request", "index_bytes_per_event"):
        assert res.metrics[name]["value"] > 0, name
    # no device on the CPU: the device readers find nothing and say so
    assert "device_idle_pct" not in res.metrics
    assert "delta_apply_fused_roofline" not in res.metrics
    line = res.line()
    assert list(line)[-1] == "checks"


def test_union_and_breakdown():
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == pytest.approx(4)
    tr = trace.Trace(2, (0.0, 10.0),
                     {"request": [(0.0, 4.0), (5.0, 10.0)],
                      "plan": [(0.5, 3.0)]}, {},
                     [("k1", 1.0, 2.0), ("k2", 6.0, 6.5), ("k1", 7.0, 7.5)],
                     {})
    assert tr.busy_s() == pytest.approx(2.0)
    assert tr.device_s("k1") == pytest.approx(1.5)
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "k1"
    assert b["idle_gaps"][0] == ["request", pytest.approx(4.0)]   # 2-6
    assert ["plan", pytest.approx(1.0)] in b["idle_gaps"]


def test_roofline_reproduces_the_kernel_table():
    """The fused kernel's bound at K 16, W 2^21, one weight a slot and the
    live indicator: 0.2479 ms in the port's kernel table."""
    from hgbench import roofline
    W = 2 ** 21
    s = roofline.least_s(*roofline.fused_plane_work(16, W, 32 * W, True))
    assert s * 1e3 == pytest.approx(0.2479, abs=5e-5)
