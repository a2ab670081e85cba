"""``BENCHMARK.json`` resolved to the files it names.

Everything that belongs to one configuration, traffic mix, call or
per-layer metric is a file of its own, found by name, so that a cell, a
mix or a metric is added by adding files and entries only:

* ``configs[].file``: the configuration (a JSON file under ``hgbench/``);
  its ``history.generator`` names ``hgbench/generators/<generator>.py``,
  which makes the history from the seed;
* ``hgbench/traffic/<traffic>.json``: the mix; its ``driver`` names
  ``hgbench/drivers/<driver>.py``, the call into the program and the
  comparison with the reference for that kind of request, and its
  ``times.pick`` names ``hgbench/samplers/<pick>.py``, which draws each
  request's timepoints;
* ``hgbench/metrics/<metric>.py``: one per-layer metric (what it wraps,
  the counters it reads, and ``read(trace)``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    generator: ModuleType
    sampler: ModuleType
    driver: ModuleType
    end_to_end: list[dict]          # the BENCHMARK.json entries it reports
    per_layer: list[tuple[dict, ModuleType]]


def load_module(path: Path) -> ModuleType:
    """A Python file as a module of its own (file names may hold dots and
    dashes)."""
    name = "hgbench_file_" + re.sub(r"\W", "_", str(path.resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Benchmark:
    """The ``BENCHMARK.json`` and the ``hgbench/`` files of a checkout."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.here = self.root / "hgbench"

    def config(self, name: str) -> dict:
        (entry,) = [c for c in self.spec["configs"] if c["name"] == name]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def generator(self, name: str) -> ModuleType:
        return load_module(self.here / "generators" / f"{name}.py")

    def sampler(self, name: str) -> ModuleType:
        return load_module(self.here / "samplers" / f"{name}.py")

    def driver(self, name: str) -> ModuleType:
        return load_module(self.here / "drivers" / f"{name}.py")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.here / "metrics" / f"{name}.py")

    def cell(self, name: str) -> Cell:
        matches = [w for w in self.spec["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = matches[0]
        config, traffic = self.config(w["config"]), self.traffic(w["traffic"])
        return Cell(
            name=name, chips=w["chips"], config=config, traffic=traffic,
            generator=self.generator(config["history"]["generator"]),
            sampler=self.sampler(traffic["times"]["pick"]),
            driver=self.driver(traffic["driver"]),
            end_to_end=[m for m in self.spec["end_to_end"]
                        if applies(m, name)],
            per_layer=[(m, self.metric(m["name"]))
                       for m in self.spec["per_layer"] if applies(m, name)])
