"""Dry run of every (architecture, shape) cell: the port's counterpart of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--out FILE] [--no-resume]

The reference lowers each cell's step on a faked 256- or 512-device CPU
mesh and reads memory, FLOPs, bytes and collectives from XLA.  Here each
cell's step (``configs/registry.py::get_cell``: the port's train, prefill,
decode, GNN and DIN steps on ``meta`` tensors, with the reference's
sharding constraints) runs once under
:class:`~repro_torch.launch.op_analysis.OpAnalysis`: nothing is allocated
or computed and no card is needed, and the hand-written kernels report
their work through their shape-only routes.  The trace records the step's
ops; the two production meshes (``launch/mesh.py``) reuse it, and
``launch/sharding.py`` replays it under each mesh from the cell's spec
trees for the collectives (the multi-pod cell is the one traced: its
constraints name ``pod`` too, which the single-pod replay drops).  A
record keeps the reference's keys where they mean the same (``chips``,
``step_kind``, ``model_flops``, ``n_params``, ``n_params_active``) and
adds:

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
  route and the top ops by bytes and by FLOPs; ``collective_bytes`` per
  device and ``collectives`` by kind (the reference's five names) from
  the sharding pass, and its ``top_collectives`` (op and kind);
* ``collectives_unmodeled``: ops the pass has no rule for (gathered to
  replicated; name -> calls), empty in every cell of the sweep;
* ``roofline`` per device under the ideal split, on the H100 SXM data
  sheet's peaks: ``compute_s``, ``memory_s``, ``collective_s``
  (collective bytes over :data:`LINK_BW`), ``bottleneck`` (the largest
  of the three), ``useful_flops_ratio`` (model FLOPs over counted FLOPs)
  and ``roofline_fraction`` (the model FLOPs at the peak of the step's
  dominant dtype, over the largest term), as the reference's
  (``repro/launch/dryrun.py:95``).

Results go to ``--out`` (``pt_dryrun_results.json``), written after every
cell; a rerun skips cells already ``ok`` (with this version's keys) or
``skipped`` there unless ``--no-resume``.
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
from .sharding import flatten_specs, partition

# NVIDIA H100 SXM data sheet (dense, no sparsity; a 700 W power limit).
# f32 products run on the CUDA cores: TF32 stays off, as the port runs.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12            # bytes/s
HBM_BYTES = 80e9            # device memory
# One 400 Gb/s NDR InfiniBand port per GPU (DGX H100 data sheet), bytes/s
# each way.  A 16-wide mesh axis does not fit one 8-GPU NVLink domain, so
# every production axis crosses nodes.
LINK_BW = 50e9


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


def roofline(counted: dict, chips: int, model_flops: float,
             collective_bytes: float = 0.0) -> dict:
    """Roofline terms per device: the counted work split evenly over
    ``chips``, the collectives' bytes per device (the sharding pass's)
    over :data:`LINK_BW`."""
    flops = counted["flops"]
    terms = {"compute_s": sum(f / PEAK_FLOPS[dt]
                              for dt, f in flops.items()) / chips,
             "memory_s": counted["hbm_bytes"] / HBM_BW / chips,
             "collective_s": collective_bytes / LINK_BW}
    main = max(flops, key=flops.get) if flops else "bfloat16"
    bottleneck = max(terms, key=terms.get)
    bound = terms[bottleneck]
    total = counted["flops_total"]
    return {**terms, "bottleneck": bottleneck,
            "useful_flops_ratio": model_flops / total if total else 0.0,
            "peak_dtype": main,
            "roofline_fraction": (model_flops / (chips * PEAK_FLOPS[main])
                                  / bound) if bound else 0.0}


def trace_cell(cell, record: bool = True) -> tuple[dict, float, object]:
    """The op analysis of one run of the cell's step, its seconds, and
    (``record``) the recorded program for the sharding pass."""
    t0 = time.perf_counter()
    acct = analyze(cell.fn, *cell.args, record=record)
    return acct.summary(), time.perf_counter() - t0, acct.program


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             traces: dict | None = None) -> dict:
    """One cell's record on the single-pod or multi-pod mesh; ``traces``
    (``(arch, shape) -> (summary, seconds, program)``) keeps the cell's
    trace for the other mesh."""
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
        traced = cell if multi_pod else get_cell(
            arch, shape, make_production_mesh(multi_pod=True), True)
        traces[arch, shape] = trace_cell(traced)
    counted, trace_s, program = traces[arch, shape]
    rec["trace_s"] = trace_s
    t0 = time.perf_counter()
    coll = partition(program, flatten_specs(cell.args, cell.pspecs), mesh)
    rec["partition_s"] = time.perf_counter() - t0
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
    rec["counted"].update(collective_bytes=coll["collective_bytes"],
                          collectives=coll["collectives"],
                          top_collectives=coll["top_collectives"])
    rec["collectives_unmodeled"] = coll["unmodeled"]
    rec["roofline"] = roofline(counted, chips, cell.flops_model,
                               coll["collective_bytes"])
    rec["status"] = "ok"
    return rec


def _key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}|{shape}|{'multi' if multi_pod else 'single'}"


def done(rec: dict | None) -> bool:
    """A record a rerun keeps: ``skipped``, or ``ok`` with this version's
    keys (an ``ok`` record written before the collective term, with
    ``collective_s: null``, is recomputed)."""
    if rec is None:
        return False
    if rec.get("status") == "skipped":
        return True
    return (rec.get("status") == "ok" and "collectives_unmodeled" in rec
            and rec.get("roofline", {}).get("collective_s") is not None)


def sweep(cells, meshes, results: dict, out: str | None = None,
          log=print) -> dict:
    """Every cell of ``cells`` on each mesh of ``meshes`` (``multi_pod``
    flags) not already :func:`done` in ``results``, which gains a record
    per cell (an ``error`` record for a cell that raises) and is written
    to ``out`` after each; returns ``results``."""
    for arch, shape in cells:
        traces: dict = {}       # the cell's one trace, for both meshes
        for multi_pod in meshes:
            key = _key(arch, shape, multi_pod)
            if done(results.get(key)):
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
            f"collective {r['collective_s']:.4g} s, bottleneck "
            f"{r['bottleneck']}, roofline {r['roofline_fraction']:.3f}"
            + (f", unmodeled {rec['collectives_unmodeled']}"
               if rec["collectives_unmodeled"] else ""))


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
