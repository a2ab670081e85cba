"""The benchmark's cells at a size a CPU test run holds: the histories of
a few thousand events, the index cut to match, windows of a fraction of a
second, on the program's plain PyTorch versions (``device="cpu"``)."""
from __future__ import annotations

import json
from pathlib import Path

from hgbench import catalog

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("growing.point-analytics", "churn.point-analytics")
N_EVENTS, L = 6000, 300
SEED = 2 ** 40 + 12345          # larger than 32 bits, as a run's --seed may be


def shrink(cell: catalog.Cell) -> catalog.Cell:
    cell.config["history"]["n_events"] = N_EVENTS
    cell.config["index"]["L"] = L
    return cell


def cell(name: str, root: Path = ROOT) -> catalog.Cell:
    return shrink(catalog.Benchmark(root).cell(name))


def generator(name: str):
    return catalog.Benchmark(ROOT).generator(name)


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
