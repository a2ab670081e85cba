"""The port's three retrieval examples against the JAX package's, on the CPU.

Each ``examples/pt_<name>.py`` runs with ``--device cpu`` and its
reference ``examples/<name>.py`` under ``JAX_PLATFORMS=cpu``, both as
subprocesses at the reference's defaults, and their standard output must
agree line by line: counts, node lists, attributes, wire documents, the
fig-1 rank table (so every PageRank rank) and the triangle counts
exactly.  Wall-clock figures are the one exception: the latency line is
left out and the served line's seconds and qps are masked (its count of
documents and KV gets still compared).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_TIMED = re.compile(r" in [0-9.]+s \([0-9]+ qps,")


def _lines(out: str) -> list[str]:
    keep = []
    for line in out.splitlines():
        if line.startswith("per-query latency:"):
            continue
        keep.append(_TIMED.sub(" in <s> (<qps>,", line))
    return keep


def _run_pair(name: str, *args: str) -> tuple[list[str], list[str]]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{script}.py"), *args,
         *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for script, extra in ((f"pt_{name}", ("--device", "cpu")),
                              (name, ()))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return _lines(outs[0]), _lines(outs[1])


@pytest.mark.parametrize("name,args", [
    ("quickstart", ()),
    ("evolution_analysis", ()),
    ("snapshot_server", ()),
    ("snapshot_server", ("--advise", "--requests", "96")),
    ("snapshot_server", ("--materialize", "--requests", "40")),
], ids=["quickstart", "evolution", "server", "server-advise",
        "server-materialize"])
def test_example_prints_the_reference_lines(name, args):
    got, want = _run_pair(name, *args)
    assert len(want) >= 4
    assert got == want


def test_pt_example_refuses_without_a_card():
    """``--device`` defaults to the card: without one the example raises
    before it builds anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "pt_quickstart.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
