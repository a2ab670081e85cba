"""The readings that the correctness limits are set from, on the card:
for each seed one run of the cell (a window of ``--seconds``), the
program's compared numbers, and the same numbers of each control on the
window's own requests.  Not run by the benchmark's runs.

    python3 hgbench/control.py --workload growing.point-analytics \\
        --seeds 11,12,13 --seconds 30

Prints one JSON line a seed: ``{"seed", "correct", "attempted",
"program": {number: value}, "controls": {control: {number: value}}}``.
Each control must read above a limit that every sound run reads under.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell, seed: int, seconds: float, device, t0=None) -> dict:
    """One seed's readings of the program and of the controls."""
    from hgbench import harness
    from hgbench.reference import Replay
    seen = {}
    driver = cell.driver

    class Keep:       # the cell's driver, its state kept for the controls
        def __getattr__(self, name):
            return getattr(driver, name)

        def prepare(self, ctx):
            seen["ctx"], seen["state"] = ctx, driver.prepare(ctx)
            return seen["state"]

    cell.driver = Keep()
    try:
        res = harness.run(cell, seed=seed, seconds=seconds, traced=False,
                          device=device, t0=t0)
    finally:
        cell.driver = driver
    ctx, state = seen["ctx"], seen["state"]
    controls = driver.control(ctx, state, Replay(ctx.hist))
    return {"seed": seed, "correct": res.correct, "attempted": res.attempted,
            "program": {n: v for n, v, _ in res.checks},
            "limits": {n: lim for n, _, lim in res.checks},
            "controls": {c: dict(nums) for c, nums in controls.items()},
            "metrics": res.metrics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from hgbench import catalog
    if not torch.cuda.is_available():
        print("hgbench: no CUDA device", file=sys.stderr)
        return 3
    cell = catalog.Benchmark(ROOT).cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = readings(cell, seed, args.seconds, "cuda",
                       t0=T0 if i == 0 else None)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
