#!/usr/bin/env python3
"""Warm LM serving times, for one source tree, on one NVIDIA GPU.

    python3 scripts/serve_lm_times.py [--src DIR] [--label NAME]
        [--arch gemma3-1b] [--batch 8] [--prompt 4096] [--gen 32]
        [--repeats 5]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees, say a parent commit unpacked by ``git archive`` and the
change, are timed by the same code; compare them only inside one run on
one card, in turns (parent, change, change, parent), one process each.

Builds the two kernels serving runs (``flash_prefill``, ``flash_decode``),
loads the architecture at full width with random weights
(``launch/serve.py``'s ``load_lm``, seed 0), serves one untimed batch
(``generate``: a prefill of ``batch`` × ``prompt`` tokens, then ``gen``
greedy decode steps), then ``repeats`` timed ones.  Each time is on the
host's clock and ends in a device synchronise, as ``serve --mode model``
prints it; unlike that command, no time here includes a process's first
calls.  Prints the card's name and power limit, then one JSON line: the
prefill ms and the decode ms a step of every timed batch, and their
medians.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("serve_lm_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build(("flash_prefill", "flash_decode"))
    cfg, params = serve.load_lm(args.arch)
    tokens = serve.prompt_tokens(cfg, args.batch, args.prompt)
    prefill_ms, decode_ms = [], []
    for i in range(1 + args.repeats):
        res = serve.generate(params, cfg, tokens, args.gen)
        if i:
            prefill_ms.append(res["prefill_s"] * 1e3)
            decode_ms.append(res["decode_s"] * 1e3 / args.gen)
    print(json.dumps({
        "label": args.label, "src": args.src, "arch": args.arch,
        "batch": args.batch, "prompt": args.prompt, "gen": args.gen,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "prefill_median_ms": statistics.median(prefill_ms),
        "decode_median_ms_per_step": statistics.median(decode_ms)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
