"""Run one cell of the benchmark once, on the card.

    python3 hgbench/run.py --workload growing.point-analytics \\
        --seed 12345 --seconds 30 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``hgbench/``
and the program under test, ``src/repro_torch``.  The program is the
PyTorch/CUDA package alone: nothing here imports JAX or the JAX package,
and a run whose process holds either when the window has closed fails.

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (``--trace 1``) and, last, ``checks``: every number compared
with the reference beside its limit, which also close standard error.
Exits non-zero, printing no result, without enough CUDA devices, without
the program, or with JAX loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("hgbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    # the checkout's root and the program's sources, never this directory
    # (its module names would shadow others)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from hgbench import catalog, harness
    cell = catalog.Benchmark(ROOT).cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hgbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run(cell, seed=args.seed, seconds=args.seconds,
                         traced=bool(args.trace), device="cuda", t0=T0)
    if result.build_s and any(result.build_s.values()):
        print(f"hgbench: built {json.dumps(result.build_s)}", file=sys.stderr)
    print(f"hgbench: set-up seconds by step {json.dumps(result.setup_parts)}",
          file=sys.stderr)
    found = harness.banned_modules()
    if found:
        print(f"hgbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for line in result.check_lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
