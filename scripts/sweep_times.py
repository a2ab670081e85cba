#!/usr/bin/env python3
"""Wall seconds of the dry run's whole sweep, for source trees in turns.

    python3 scripts/sweep_times.py --src NAME=DIR [--src NAME=DIR ...]
        [--rounds 2] [--out-dir DIR]

Runs ``python -m repro_torch.launch.dryrun --no-resume`` (every cell on
both production meshes, on the ``meta`` device: no card is needed) once
per tree per round, one process at a time, with ``PYTHONPATH`` at the
tree's ``src``.  The trees take turns, and each round reverses the order
of the one before (two trees: A, B, B, A, A, B, ...), so that a drift of
the host's speed falls on both alike.  Each run writes its records to
``--out-dir`` (default: a temporary directory) as ``<NAME>_<round>.json``.

Prints, per run, the tree, the round, the wall seconds of the process and
the sweep's own count line; then one JSON line: every tree's seconds and
their median.  Times are on the host's clock; compare trees only inside
one run on one host.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="NAME=DIR, DIR a source tree's root (holding src/)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()

    trees = [s.split("=", 1) for s in args.src]
    out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="sweep_times_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    seconds: dict[str, list[float]] = {name: [] for name, _ in trees}
    for r in range(args.rounds):
        for name, root in (trees if r % 2 == 0 else trees[::-1]):
            root = Path(root).resolve()
            env = {**os.environ, "PYTHONPATH": str(root / "src")}
            out = out_dir / f"{name}_{r}.json"
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--no-resume", "--out", str(out)], cwd=root, env=env,
                capture_output=True, text=True)
            wall = time.perf_counter() - t0
            last = (run.stdout.strip().splitlines() or [""])[-1]
            print(f"{name} round {r}: {wall:.3f} s, rc {run.returncode}: "
                  f"{last}", flush=True)
            if run.returncode != 0:
                print(run.stderr[-3000:], file=sys.stderr)
                return 1
            seconds[name].append(wall)
    print(json.dumps({name: {"seconds": s, "median": statistics.median(s)}
                      for name, s in seconds.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
