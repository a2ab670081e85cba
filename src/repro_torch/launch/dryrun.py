"""Dry run of every (architecture, shape) cell: the port's counterpart of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--out FILE] [--no-resume]

The reference lowers each cell's step on a faked 256- or 512-device CPU
mesh and reads memory, FLOPs, bytes and collectives from XLA.  Here each
cell's step (``configs/registry.py::get_cell``: the port's train, prefill,
decode, GNN and DIN steps on ``meta`` tensors) runs once under
:class:`~repro_torch.launch.op_analysis.OpAnalysis`: nothing is allocated
or computed and no card is needed, and the hand-written kernels report
their work through their shape-only routes.  The two production meshes
(``launch/mesh.py``) reuse the cell's one trace.  A record keeps the
reference's keys where they mean the same (``chips``, ``step_kind``,
``model_flops``, ``n_params``, ``n_params_active``) and adds:

* ``memory``: ``argument_bytes_per_device``, exact from the spec trees
  under the mesh (the reference's ``argument_size_in_bytes``: AdamW's
  master of an f32 leaf counted apart, as XLA holds it);
  ``argument_bytes_whole`` and ``peak_bytes_whole`` (one device holding
  the cell: storages alive at once, the arguments included, an f32
  master that is its parameter counted once, as the port holds it);
  ``live_bytes_per_device``, the arguments per device plus the rest of
  the peak divided by ``chips``: an ideal split, not a partitioner's;
* ``fits_80gb`` (the H100's 80 GB, against the reference's 16 GB TPU);
* ``counted``: FLOPs by dtype, HBM bytes, op count, calls per kernel
  route and the top ops by bytes and by FLOPs;
* ``roofline`` per device under the ideal split, on the H100 SXM data
  sheet's peaks: ``compute_s``, ``memory_s``, ``bottleneck``,
  ``useful_flops_ratio`` (model FLOPs over counted FLOPs),
  ``roofline_fraction`` (the model FLOPs at the peak of the step's
  dominant dtype, over the bound) and ``collective_s: null``: with no
  partitioner there is no collective to count.

Results go to ``--out`` (``pt_dryrun_results.json``), written after every
cell; a rerun skips cells already ``ok`` or ``skipped`` there unless
``--no-resume``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs.registry import get_cell, list_cells
from .mesh import make_production_mesh
from .op_analysis import analyze

# NVIDIA H100 SXM data sheet (dense, no sparsity; a 700 W power limit).
# f32 products run on the CUDA cores: TF32 stays off, as the port runs.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12            # bytes/s
HBM_BYTES = 80e9            # device memory
NO_COLLECTIVES = ("no partitioner: one traced program on the meta device "
                  "shows no collective (ROADMAP.md §1: still to port)")


def sharded_bytes(args, specs, mesh) -> int:
    """Bytes per device of ``args`` laid out by ``specs`` (the same tree,
    a spec tuple at each tensor) on ``mesh``: each tensor divided by the
    product of the mesh axes its spec names."""
    if isinstance(args, torch.Tensor):
        div = 1
        for entry in specs:
            if entry is not None:
                for ax in entry if isinstance(entry, tuple) else (entry,):
                    div *= mesh.shape[ax]
        return args.numel() * args.element_size() // div
    if isinstance(args, dict):
        return sum(sharded_bytes(args[k], specs[k], mesh) for k in args)
    return sum(sharded_bytes(a, s, mesh) for a, s in zip(args, specs))


def roofline(counted: dict, chips: int, model_flops: float) -> dict:
    """Roofline terms per device, the counted work split evenly over
    ``chips``."""
    flops = counted["flops"]
    compute_s = sum(f / PEAK_FLOPS[dt] for dt, f in flops.items()) / chips
    memory_s = counted["hbm_bytes"] / HBM_BW / chips
    main = max(flops, key=flops.get) if flops else "bfloat16"
    bound = max(compute_s, memory_s)
    total = counted["flops_total"]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": None, "collective_note": NO_COLLECTIVES,
            "bottleneck": "compute_s" if compute_s >= memory_s else
                          "memory_s",
            "useful_flops_ratio": model_flops / total if total else 0.0,
            "peak_dtype": main,
            "roofline_fraction": (model_flops / (chips * PEAK_FLOPS[main])
                                  / bound) if bound else 0.0}


def trace_cell(cell) -> tuple[dict, float]:
    """The op analysis of one run of the cell's step; and its seconds."""
    t0 = time.perf_counter()
    summary = analyze(cell.fn, *cell.args).summary()
    return summary, time.perf_counter() - t0


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             traces: dict | None = None) -> dict:
    """One cell's record on the single-pod or multi-pod mesh; ``traces``
    (``(arch, shape) -> (summary, seconds)``) keeps the cell's trace for
    the other mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    cell = get_cell(arch, shape, mesh, multi_pod)
    rec: dict = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                 "chips": chips, "step_kind": cell.step_kind,
                 "model_flops": cell.flops_model,
                 "n_params": cell.n_params,
                 "n_params_active": cell.n_params_active}
    if cell.skip_reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip_reason
        return rec
    traces = {} if traces is None else traces
    if (arch, shape) not in traces:
        traces[arch, shape] = trace_cell(cell)
    counted, trace_s = traces[arch, shape]
    rec["trace_s"] = trace_s
    args_dev = sharded_bytes(cell.args, cell.pspecs, mesh)
    transient = counted["peak_bytes"] - counted["argument_bytes"]
    live = args_dev + transient / chips
    rec["memory"] = {
        "argument_bytes_per_device": args_dev,
        "argument_bytes_whole": counted["argument_bytes"],
        "peak_bytes_whole": counted["peak_bytes"],
        "live_bytes_per_device": live,
        "live_note": "arguments per device by the spec trees, plus the "
                     "rest of the one-device peak divided by chips (an "
                     "ideal split)"}
    rec["fits_80gb"] = bool(live <= HBM_BYTES)
    rec["counted"] = {k: counted[k] for k in (
        "flops", "flops_total", "hbm_bytes", "ops", "kernels",
        "top_by_bytes", "top_by_flops")}
    rec["roofline"] = roofline(counted, chips, cell.flops_model)
    rec["status"] = "ok"
    return rec


def sweep(cells, meshes, results: dict, out: str | None = None,
          log=print) -> dict:
    """Every cell of ``cells`` on each mesh of ``meshes`` (``multi_pod``
    flags) not already ``ok`` or ``skipped`` in ``results``, which gains
    a record per cell (an ``error`` record for a cell that raises) and is
    written to ``out`` after each; returns ``results``."""
    traces: dict = {}
    for arch, shape in cells:
        for multi_pod in meshes:
            key = f"{arch}|{shape}|{'multi' if multi_pod else 'single'}"
            if results.get(key, {}).get("status") in ("ok", "skipped"):
                continue
            try:
                rec = run_cell(arch, shape, multi_pod, traces=traces)
            except Exception as e:  # record the failure, keep sweeping
                rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            results[key] = rec
            if out is not None:
                with open(out, "w") as f:
                    json.dump(results, f, indent=1)
            log(describe(key, rec))
        traces.pop((arch, shape), None)
    return results


def describe(key: str, rec: dict) -> str:
    """One line for a record."""
    if rec["status"] != "ok":
        return f"{key}: {rec['status']}: " + rec.get(
            "skip_reason", rec.get("error", ""))
    r, m = rec["roofline"], rec["memory"]
    return (f"{key}: trace {rec['trace_s']:.2f} s, "
            f"{rec['counted']['ops']} ops, live/dev "
            f"{m['live_bytes_per_device'] / 2**30:.2f} GiB, peak (one "
            f"device) {m['peak_bytes_whole'] / 2**30:.2f} GiB, compute "
            f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
            f"bottleneck {r['bottleneck']}, roofline "
            f"{r['roofline_fraction']:.3f}")


def main() -> None:
    ap = argparse.ArgumentParser(description="meta-device dry run of every "
                                 "architecture x shape cell")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="pt_dryrun_results.json")
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args()

    results: dict[str, dict] = {}
    if os.path.exists(args.out) and not args.no_resume:
        with open(args.out) as f:
            results = json.load(f)
    cells = list_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    t0 = time.perf_counter()
    sweep(cells, meshes, results, args.out, log=lambda s: print(s, flush=True))
    counts = {s: sum(r.get("status") == s for r in results.values())
              for s in ("ok", "skipped", "error")}
    print(f"done in {time.perf_counter() - t0:.1f} s: {counts['ok']} ok, "
          f"{counts['skipped']} skipped, {counts['error']} errors -> "
          f"{args.out}")


if __name__ == "__main__":
    main()
