#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. set-up: the card's name and power limit; every CUDA kernel built from
   ``src/repro_torch/kernels/csrc`` with one ``nvcc`` per source, all at
   once, and ptxas's registers, spills and shared memory for the prefill,
   chain and segment-sum kernels;
2. retrieval path: a ``growing_network(2_000_000)`` history (the
   generator's analogue of the paper's Dataset 1) indexed by a
   ``GraphManager`` (``L=50_000, k=4, diff_fn="intersection"``, no snapshot
   cache, ``device="cuda"``) whose ``DeltaGraph`` serves this phase and the
   next; 64 timepoints retrieved by
   ``execute_multipoint_torch(land_in_pool=True)`` and 8 by
   ``execute_singlepoint_fused`` with ``degrees()``, checked against the
   ``replay`` oracle.  Launch counts are zeroed just before and read just
   after: each of the path's three kernels must have run, the fused
   kernel once per fused retrieval (``delta_apply_fused_pair``: node and
   edge planes in one launch) and segment-sum twice per ``degrees()``;
3. evolve path, on the same manager: ``dense_intervals(tmax, 8, 32,
   window_frac=0.05)`` (``serve --mode evolve``'s default workload);
   ``GraphManager.evolve`` for masks, degree, PageRank
   (tol 1e-6) and components, incrementally at every point and by the
   recompute engine at every 4th; ``evolve_intervals_torch`` over the
   8 intervals at once; one ``SnapshotBatchLoader`` window (8 points, a label
   horizon).  Checks, at every 4th point: masks equal ``replay``, degrees
   a ``bincount`` of its live edges, components of both engines equal
   and equal to scipy's partition of the replayed snapshot, PageRank of
   the two engines within L1 5e-5 and max 1e-5; the interval sweep's masks
   equal the incremental engine's at every point; the loader's edge and
   label masks, edge counts and raw degrees equal replay's at every point
   of its window.  Launch counts zeroed before and read after each
   sub-phase: the sweep launches the chain kernel; the loader launches the
   fused kernel once per degree pass (two a window: the window and its
   horizon) and segment-sum twice per timepoint of each pass;
4. retrieval kernels: each against its plain PyTorch version on the card,
   at full width (chain W = 2^21 words, K = 16, B = 8; fused W = 2^21,
   K = 16 with weights, ``live`` on and off; segment-sum on the degree
   feeds by source and by destination node, the second with hub buckets)
   and at the largest shape the path gave it (for the fused kernel,
   the largest pair call, and its edge plane alone); bit for bit (degrees
   exactly, and
   segment-sum also on general f32 and against ``index_add_``).  Kernel
   and ``index_add_`` times are device times, a CUDA graph of repeated
   calls replayed between CUDA events, beside the same calls in a host
   loop (``host_loop_ms``: adds the wrapper's host work); plain and bound
   times;
5. churn: a ``churn_network`` history with deletes and transient slots,
   monolithic and streamed (``DeviceStager``) retrieval and fused
   analytics, and ``evolve_intervals_torch`` (monolithic and streamed) and
   a ``SnapshotBatchLoader`` window, against ``replay``;
6. LM serving: gemma3-1b at full width and depth (26 layers, d 1152,
   vocab 262,144, bf16, seeded random weights) through
   ``repro_torch.launch.serve.serve_lm``: batch 8, a 4,096-token prompt,
   32 greedy decode steps (the repo's ``prefill_32k`` / ``decode_32k``
   cut to one card).  Checks: finite logits; ``flash_attention``
   launched 26 times per forward call, every prefill call through the
   wgmma/TMA prefill kernel (``flash_attention_prefill``: 26 per prefill
   forward) and every decode call through the split-K decode kernel
   (``flash_attention_decode``: 26 per decode step); prefill of
   ``prompt[:, :-16]`` and
   16 decode steps against the whole prompt's prefill (relative error of
   the last logits): in bf16 within the reference's 5e-2 at the first 6
   layers, and at full depth within 1.5 times the drift of the same run
   with the plain attention in the kernel's place (at full depth bf16
   drifts past 5e-2 whatever computes attention); in f32 at full depth
   within 1e-3; a kernel that drops the last key tile must fail the bf16
   check.  The kernel against its plain version at each attention shape
   the path used (local and global prefill, local and global decode at
   ``q_offset`` 4,100 against the ``max_len`` cache) in bf16 within 2e-2
   and, element by element, two bf16 ulps plus 1e-5 (which the plain
   version with the last key tile dropped must fail), and at the
   global-prefill and global-decode shapes in f32 within 3e-5; each shape
   names the kernel that ran and its splits.  Kernel and
   ``scaled_dot_product_attention`` times (over the visible keys) are
   device times, a CUDA graph of repeated calls replayed between CUDA
   events, beside the same calls in a host loop (which the wrapper's host
   work bounds at decode); at the prefill shapes also the old prefill
   kernel (``attention_mma_kernel``, through ``ops._attention_mma``) in
   the same run, and its error; plain and bound times; prefill ms, decode
   ms per step and tokens per second.  Last, ``flash_attention.cu`` at
   the shapes it serves, against its plain version and SDPA:
   ``attention_mma_kernel`` at stablelm-12b's prefill (bf16, q [1, 32,
   4096, 160], k/v [1, 8, 4096, 160], causal) and
   ``attention_simt_kernel`` at gemma3-1b's global prefill in f32.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate (data sheet)
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor rate (data sheet)
SEED = 0
# the attention kernel against its plain version in bf16, element by
# element: both sum in f32 and round once to bf16, so they differ by at
# most one bf16 ulp (2^-7 of the value at most) plus f32 noise from the
# order of the sums (5e-7 measured in f32 at the global-prefill shape).
# The limit allows two ulps and 1e-5.
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-5
RETRIEVAL_KERNELS = ("delta_apply_chain", "delta_apply_fused",
                     "segment_sum_bucketed")
# LM serving: gemma3-1b at full width and depth.  The repo's LM shapes
# prefill_32k (B = 32) and decode_32k (B = 128) at 32,768 tokens are cut
# to one card: 32k-token caches at B = 128 alone would take 112 GB.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_TAIL = "gemma3-1b", 8, 4096, 32, 16
# the tail-drift checks (lm_phase): the reference's 5e-2 bound at a cut
# depth of 6 layers (five local, one global); at full depth, the kernel's
# bf16 drift against the plain version's on the same prompt
LM_CUT_LAYERS, DRIFT_OVER_PLAIN = 6, 1.5
# evolve path: serve --mode evolve's default workload, 8 intervals of 32
# points over 5 % of the history each; the recompute engine and the checks
# run at every 4th point.  One loader window of 8 points: its host
# bucket_edges (twice per timepoint and pass, about 0.2 s a call at this
# edge count) makes windows the costliest part of the phase.
EVOLVE_INTERVALS, EVOLVE_POINTS, CHECK_EVERY, LOADER_BATCH = 8, 32, 4, 8


def fail(msg: str) -> None:
    raise AssertionError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card with no host in the way:
    ``iters`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
             ) -> tuple[float, str]:
    """Least time for ``nbytes`` moved and ``ops`` done at ``ops_per_s``,
    and its bound."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(got, want) -> float:
    """Largest |got - want|: words compared as unsigned 32-bit integers,
    floats as floats; 0 means identical."""
    import torch
    if got.dtype == torch.int32:
        g = got.to(torch.int64) & 0xFFFFFFFF
        w = want.to(torch.int64) & 0xFFFFFFFF
        return float((g - w).abs().max()) if g.numel() else 0.0
    return float((got - want).abs().max()) if got.numel() else 0.0


def over_bf16_limit(got, want) -> float:
    """The largest |got - want| / (BF16_RTOL·|want| + BF16_ATOL) over the
    elements of two bf16 results: at most 1 when each element is within
    one bf16 ulp of ``want`` plus f32 summation noise."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (BF16_RTOL * w.abs() + BF16_ATOL)).max())


def same_bits(got, want) -> bool:
    import torch
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def rand_words(gen, shape, dev):
    import torch
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int32, device=dev)


def visible_span(Sq: int, Sk: int, window, q_offset: int
                 ) -> tuple[int, int, int]:
    """Causal attention of Sq rows from ``q_offset`` over Sk keys: the
    unmasked (query, key) pairs, and the first and one-past-last key any
    row sees."""
    pairs, lo, hi = 0, Sk, 0
    for i in range(Sq):
        qpos = i + q_offset
        a = 0 if window is None else max(0, qpos - window + 1)
        b = min(Sk, qpos + 1)
        if b > a:
            pairs, lo, hi = pairs + b - a, min(lo, a), max(hi, b)
    return pairs, lo, max(hi, lo)


def print_ptxas(log: str, kernel: str) -> None:
    """ptxas's registers, spills and shared memory for each instantiation
    of ``kernel``, from the build's ``-Xptxas -v`` output."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m[1].split(kernel, 1)
            args = (re.findall(r"Li(n?\d+)E", mangled[1].split("EEv")[0])
                    if len(mangled) == 2 else None)
            name = None if args is None else (
                f"{kernel}<{', '.join(a.replace('n', '-') for a in args)}>"
                if args else kernel)
        elif name and ("spill" in line or "registers" in line):
            print(f"ptxas {name}: "
                  f"{line.strip().removeprefix('ptxas info    : ')}")


def live_degrees(uni, edge_mask):
    """Degrees (both endpoints of each live edge) by ``bincount``."""
    import numpy as np
    live = np.nonzero(edge_mask)[0]
    N = uni.num_nodes
    return (np.bincount(uni.edge_src[live], minlength=N)
            + np.bincount(uni.edge_dst[live], minlength=N))


def scipy_components(uni, state):
    """Labels as the HashMin fixpoint gives them (each live node's smallest
    live node id in its component, int32 max for dead nodes), from scipy's
    connected components of the live subgraph."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    N = uni.num_nodes
    nm = state.node_mask
    e = np.nonzero(state.edge_mask)[0]
    s, d = uni.edge_src[e], uni.edge_dst[e]
    keep = nm[s] & nm[d]
    graph = coo_matrix((np.ones(int(keep.sum()), np.int8),
                        (s[keep], d[keep])), shape=(N, N))
    n_comp, lab = connected_components(graph, directed=False)
    live = np.nonzero(nm)[0]
    first = np.full(n_comp, N, np.int64)
    np.minimum.at(first, lab[live], live)
    return np.where(nm, first[lab], np.iinfo(np.int32).max)


def loader_window(gm, ev, times, horizon, dev, label):
    """One ``SnapshotBatchLoader`` window at ``times``, checked against
    ``replay``; returns its launch counts, wall seconds and the host
    ``bucket_edges`` seconds inside it."""
    import importlib

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import SnapshotBatchLoader, replay

    ss_ops = importlib.import_module("repro_torch.kernels.segment_sum.ops")
    uni = gm.universe
    N, E = uni.num_nodes, uni.num_edges
    bucket = ss_ops.bucket_edges
    spent = []

    def timed_bucket(*args, **kw):
        t0 = time.perf_counter()
        out = bucket(*args, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    loader = SnapshotBatchLoader(gm, times, batch_size=len(times),
                                 label_horizon=horizon)
    ss_ops.bucket_edges = timed_bucket
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        (batch,) = list(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        ss_ops.bucket_edges = bucket
    T = len(times)
    check(launches["delta_apply_fused"] == 2, f"{label}: loader launched the "
          f"fused kernel {launches['delta_apply_fused']} times for one "
          f"window and its horizon")
    check(launches["segment_sum_bucketed"] == 2 * 2 * T, f"{label}: loader "
          f"launched segment-sum {launches['segment_sum_bucketed']} times "
          f"for 2 degree passes of {T} points")
    check(all(v.device.type == dev.type for k, v in batch.items()
              if k != "times"), f"{label}: batch tensors off the device")
    check(batch["x"].shape == (T, N, 16) and batch["edge_mask"].shape ==
          (T, 2 * E) and batch["labels"].shape == (T, N), f"{label}: shapes")
    em = batch["edge_mask"].cpu().numpy()
    lm = batch["label_mask"].cpu().numpy()
    x = batch["x"][..., -1].cpu().numpy()
    ne = batch["num_edges"].cpu().numpy()
    labels = batch["labels"].cpu().numpy()
    for j, t in enumerate(times):
        truth = replay(uni, ev, t)
        deg = live_degrees(uni, truth.edge_mask)
        check(np.array_equal(em[j, :E] > 0, truth.edge_mask) and
              np.array_equal(em[j, E:] > 0, truth.edge_mask),
              f"{label}: loader edge_mask t={t}")
        check(np.array_equal(lm[j] > 0, truth.node_mask),
              f"{label}: loader label_mask t={t}")
        check(int(ne[j]) == int(truth.edge_mask.sum()),
              f"{label}: loader num_edges t={t}")
        check(np.array_equal(x[j], deg.astype(np.float32)),
              f"{label}: loader degrees t={t}")
        fut = live_degrees(uni, replay(uni, ev, t + horizon).edge_mask)
        check(np.array_equal(labels[j], (fut > deg).astype(np.int32)),
              f"{label}: loader labels t={t}")
    return {"launches": launches, "wall_s": wall,
            "bucket_edges_s": sum(spent), "bucket_edges_calls": len(spent)}


def evolve_phase(gm, ev, dev) -> dict:
    """The evolve path on the main history (phase 3); returns the evolve
    launches of the retrieval kernels, by kernel name."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import replay
    from repro_torch.data.generators import dense_intervals
    from repro_torch.runtime import torch_exec

    t_phase = time.perf_counter()
    uni = gm.universe
    tmax = int(ev.time[-1])
    ivs = dense_intervals(tmax, EVOLVE_INTERVALS, EVOLVE_POINTS,
                          window_frac=0.05, seed=SEED)
    ops = (("masks", {}), ("degree", {}), ("pagerank", {"tol": 1e-6}),
           ("components", {}))
    inc, rec, secs, iters = {}, {}, {}, {}
    for name, kw in ops:
        for incremental in (True, False):
            if not incremental and name not in ("pagerank", "components"):
                continue
            engine = "incremental" if incremental else "recompute"
            pts = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b, iv in enumerate(ivs):
                times = iv if incremental else iv[::CHECK_EVERY]
                res = gm.evolve(times, name, incremental=incremental, **kw)
                (inc if incremental else rec)[name, b] = res
                pts += len(times)
                iters.setdefault((name, engine), []).extend(
                    res.stats["solver_iters"] or [])
            torch.cuda.synchronize()
            secs[name, engine] = (time.perf_counter() - t0) / pts
    pr_l1 = pr_max = 0.0
    n_checked = 0
    t0 = time.perf_counter()
    for b, iv in enumerate(ivs):
        for j, t in enumerate(iv):
            if j % CHECK_EVERY:
                continue
            truth = replay(uni, ev, t)
            nm, em = inc["masks", b].values[j]
            check(np.array_equal(nm, truth.node_mask) and
                  np.array_equal(em, truth.edge_mask),
                  f"evolve masks differ from replay at t={t}")
            check(np.array_equal(inc["degree", b].values[j],
                                 live_degrees(uni, truth.edge_mask)),
                  f"evolve degrees differ from bincount at t={t}")
            c_inc = inc["components", b].values[j]
            c_rec = rec["components", b].values[j // CHECK_EVERY]
            check(np.array_equal(c_inc, c_rec), f"components: incremental "
                  f"and recompute engines differ at t={t}")
            check(np.array_equal(c_inc, scipy_components(uni, truth)),
                  f"components differ from scipy's partition at t={t}")
            d = np.abs(inc["pagerank", b].values[j].astype(np.float64)
                       - rec["pagerank", b].values[j // CHECK_EVERY])
            pr_l1, pr_max = max(pr_l1, float(d.sum())), max(pr_max,
                                                            float(d.max()))
            n_checked += 1
    check(pr_l1 <= 5e-5 and pr_max <= 1e-5, f"PageRank: incremental and "
          f"recompute engines differ by L1 {pr_l1}, max {pr_max}")
    for (name, engine), s in secs.items():
        it = iters.get((name, engine))
        print(f"evolve: {name} {engine} {s:.6f} s/point" + (
            f", solver iterations {sum(it)} over {len(it)} points (first "
            f"{it[0]}, min {min(it)}, max {max(it)})" if it else ""))
    print(f"evolve: {n_checked} checked points: masks = replay, degrees = "
          f"bincount, components = recompute = scipy; PageRank incremental "
          f"vs recompute L1 {pr_l1:.6e} (limit 5e-5), max {pr_max:.6e} "
          f"(limit 1e-5); checks {time.perf_counter() - t0:.3f} s")

    # the batched interval sweep, every interval at once
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    swept = torch_exec.evolve_intervals_torch(gm.dg, ivs, device=dev,
                                              pool=gm.pool,
                                              prefetch=gm.prefetcher)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    sweep_launches = kernels.launch_counts()
    check(sweep_launches["delta_apply_chain"] > 0,
          "evolve_intervals_torch launched no chain kernel")
    for b, iv in enumerate(ivs):
        for j, t in enumerate(iv):
            nm, em = inc["masks", b].values[j]
            check(np.array_equal(swept[b][t][0], nm) and
                  np.array_equal(swept[b][t][1], em),
                  f"evolve_intervals_torch differs from the incremental "
                  f"engine at t={t}")
    print(f"evolve: evolve_intervals_torch over {len(ivs)} x "
          f"{EVOLVE_POINTS} points {t_sweep:.6f} s "
          f"({t_sweep / (len(ivs) * EVOLVE_POINTS):.6f} s/point), equal to "
          f"the incremental engine at every point; launches "
          f"{json.dumps(sweep_launches)}")

    # one loader window with a label horizon of 4 interval steps
    iv = ivs[0]
    horizon = (iv[-1] - iv[0]) // (EVOLVE_POINTS - 1) * 4
    lw = loader_window(gm, ev, iv[:LOADER_BATCH], horizon, dev, "evolve")
    print(f"evolve: SnapshotBatchLoader window of {LOADER_BATCH} points, "
          f"horizon {horizon}: {lw['wall_s']:.6f} s, of which host "
          f"bucket_edges {lw['bucket_edges_s']:.6f} s in "
          f"{lw['bucket_edges_calls']} calls; batch = replay; launches "
          f"{json.dumps(lw['launches'])}; phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    return {name: {"evolve_intervals_torch": sweep_launches[name],
                   "loader_window": lw["launches"][name]}
            for name in RETRIEVAL_KERNELS}


def served_shapes(rand, sdpa_call) -> list[dict]:
    """``flash_attention.cu`` at the prefill shapes it serves (the rest go
    to flash_prefill.cu and flash_decode.cu): ``attention_mma_kernel`` at
    stablelm-12b's D = 160 in bf16, ``attention_simt_kernel`` at
    gemma3-1b's global prefill in f32; each against its plain version and
    SDPA, timed by CUDA-graph replay."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import attention, attention_ref

    out = []
    for label, kernel, dtype, (B, Hq, Hkv, Sq, Sk, D) in (
            ("stablelm-12b prefill", "attention_mma_kernel", torch.bfloat16,
             (1, 32, 8, 4096, 4096, 160)),
            ("gemma3-1b global prefill, f32", "attention_simt_kernel",
             torch.float32, (8, 4, 1, 4096, 4096 + LM_GEN, 256))):
        q = rand((B, Hq, Sq, D), dtype)
        k, v = rand((B, Hkv, Sk, D), dtype), rand((B, Hkv, Sk, D), dtype)
        n0 = kernels.launch_counts()
        got = attention(q, k, v)
        n1 = kernels.launch_counts()
        moved = {n for n in n1 if n1[n] != n0[n]}
        check(moved == {"flash_attention"}, f"{label} ran {sorted(moved)}, "
              f"not flash_attention.cu alone")
        want = attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = max_abs_err(got.float(), want.float())
        bf16 = dtype == torch.bfloat16
        ratio = over_bf16_limit(got, want) if bf16 else None
        check(err <= (2e-2 if bf16 else 3e-5) and (ratio or 0) <= 1.0,
              f"{kernel} differs from plain at {label}: {err}, {ratio}")
        del got, want
        lib = sdpa_call(q, k, v, None, 0)
        lib_err = max_abs_err(lib().float(), attention_ref(q, k, v).float())
        ms = graph_ms(lambda: attention(q, k, v), 2)
        plain = cuda_ms(lambda: attention_ref(q, k, v), 2, warmup=1)
        lib_ms = graph_ms(lib, 2)
        pairs, lo, hi = visible_span(Sq, Sk, None, 0)
        esize = q.element_size()
        nbytes = esize * (B * Hq * Sq * 2 * D + B * Hkv * (hi - lo) * 2 * D)
        b, by = bound_ms(nbytes, 2.0 * B * Hq * pairs * 2 * D,
                         BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S)
        rec = {"shape": f"{label}: q {[B, Hq, Sq, D]} k/v {[B, Hkv, Sk, D]} "
                        f"causal {str(dtype).split('.')[-1]}",
               "kernel": f"flash_attention.cu: {kernel}", "ms": ms,
               "plain_ms": plain, "bound_ms": b, "bound_by": by,
               "library_ms": lib_ms, "library_max_abs_err": lib_err,
               "max_abs_err": err, "err_over_bf16_limit": ratio,
               "over_library": ms / lib_ms}
        print(f"flash_attention.cu at {json.dumps(rec)}")
        out.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def lm_phase(dev) -> list[dict]:
    """LM serving through the port's ``launch/serve.py``; returns the
    records of the attention kernels: prefill, decode, and the old prefill
    design (``flash_attention.cu``) timed beside them."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import visible
    from repro_torch.launch import serve
    from repro_torch.models.transformer import model as tm

    t_phase = time.perf_counter()
    cfg, params = serve.load_lm(LM_ARCH, device=dev, seed=SEED)
    L = cfg.n_layers
    print(f"LM: {LM_ARCH} at full width and depth ({L} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab}, {cfg.dtype}), random weights "
          f"(seed {SEED}); batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} "
          f"greedy decode steps: the repo's prefill_32k (B=32) and "
          f"decode_32k (B=128) at 32,768 tokens cut to one card")
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, SEED, dev)
    serve.generate(params, cfg, tokens[:, :512], 2)      # warm-up

    # the main path: serve_lm, with the shapes it hands the kernel recorded
    seen = []
    orig = tm.attention

    def rec(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw["window"], kw["q_offset"]))
        return orig(q, k, v, **kw)

    tm.attention = rec
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = serve.serve_lm(LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, device=dev,
                         seed=SEED)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    tm.attention = orig
    n_fa = launches["flash_attention"]
    n_pre = launches["flash_attention_prefill"]
    n_dec = launches["flash_attention_decode"]
    check(n_fa == L * (1 + LM_GEN) == len(seen),
          f"flash_attention launched {n_fa} times for {1 + LM_GEN} forward "
          f"calls of {L} layers")
    check(n_pre == L == sum(1 for s in seen if s[0][2] > 1),
          f"the prefill kernel launched {n_pre} times for one prefill "
          f"forward of {L} layers")
    check(n_dec == L * LM_GEN, f"the decode kernel launched {n_dec} times "
          f"for {LM_GEN} decode steps of {L} layers")
    prefill_ms = res["prefill_s"] * 1e3
    step_ms = res["decode_s"] / LM_GEN * 1e3
    tok_s = LM_BATCH * LM_GEN / res["decode_s"]
    whole = res["prefill_logits"].float()
    check(bool(torch.isfinite(whole).all()), "prefill logits not finite")
    check(res["tokens"].shape == (LM_BATCH, LM_GEN) and
          ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all(),
          "generated tokens out of range")

    # prefill of prompt[:, :-16] then 16 decode steps over the last 16
    # prompt tokens against a prefill of the whole prompt (tail drift).
    # bf16 drift grows with depth whatever computes attention: at full
    # depth the plain version in the kernel's place drifts past the
    # reference's 5e-2 as well.  So: the first LM_CUT_LAYERS layers (both
    # window kinds) in bf16 within 5e-2; full depth in bf16 within
    # DRIFT_OVER_PLAIN times the plain version's drift on the same prompt;
    # full depth in f32 within 1e-3.
    def drift(p, c, att=orig):
        tm.attention = att
        try:
            return serve.tail_drift(p, c, tokens, LM_TAIL)
        finally:
            tm.attention = orig

    kernels.reset_launch_counts()
    direct, rel = drift(params, cfg)
    same = float((direct - whole).abs().max())
    check(same <= 1e-3 * float(whole.abs().max()),
          f"serve_lm and a direct prefill disagree by {same}")
    _, rel_plain = drift(params, cfg, attention_ref)
    check(rel <= DRIFT_OVER_PLAIN * rel_plain, f"bf16 tail drift {rel} "
          f"through the kernel, {rel_plain} through the plain version")

    def dropped(q, k, v, **kw):
        # the kernel with the last visible key tile dropped: a wrong kernel
        hi = min(k.shape[2], kw["q_offset"] + q.shape[2])
        return orig(q, k[:, :, :hi - 32], v[:, :, :hi - 32], **kw)

    _, rel_wrong = drift(params, cfg, dropped)
    check(rel_wrong > DRIFT_OVER_PLAIN * rel_plain, f"the bf16 tail check "
          f"passes a kernel that drops the last key tile ({rel_wrong})")
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    _, rel_cut = drift({k: ({n: w[:LM_CUT_LAYERS] for n, w in v.items()}
                            if isinstance(v, dict) else v)
                        for k, v in params.items()}, cut)
    check(rel_cut <= 5e-2, f"bf16 tail drift {rel_cut} at {LM_CUT_LAYERS} "
          f"layers")
    _, rel32 = drift(serve.cast_params(params, torch.float32),
                     dataclasses.replace(cfg, dtype=torch.float32))
    check(rel32 <= 1e-3, f"f32 tail drift {rel32}")
    del direct
    n_fa2 = kernels.launch_counts()["flash_attention"]
    n_pre2 = kernels.launch_counts()["flash_attention_prefill"]
    n_dec2 = kernels.launch_counts()["flash_attention_decode"]
    check(n_fa2 == (3 * L + LM_CUT_LAYERS) * (2 + LM_TAIL),
          f"flash_attention launched {n_fa2} times in the tail checks")
    # two prefill forwards per check; the f32 one runs flash_attention.cu
    check(n_pre2 == (2 * L + LM_CUT_LAYERS) * 2,
          f"the prefill kernel launched {n_pre2} times in the tail checks")
    check(n_dec2 == (3 * L + LM_CUT_LAYERS) * LM_TAIL,
          f"the decode kernel launched {n_dec2} times in the tail checks")
    torch.cuda.empty_cache()
    print(f"LM serving: prefill {LM_BATCH}x{LM_PROMPT} {prefill_ms:.3f} ms; "
          f"decode {step_ms:.3f} ms/step ({tok_s:.1f} tok/s); "
          f"flash_attention launches {n_fa} on serve_lm ({L} x "
          f"{1 + LM_GEN} forward calls), {n_pre} of them through the prefill "
          f"kernel and {n_dec} through the decode kernel; prefill + "
          f"{LM_TAIL} decode steps "
          f"vs whole-prompt prefill: relative error {rel:.6e} in bf16 "
          f"({rel_plain:.6e} through the plain version, {rel_wrong:.6e} "
          f"with the last key tile dropped), {rel_cut:.6e} in "
          f"bf16 at {LM_CUT_LAYERS} layers, {rel32:.6e} in f32")

    # the kernel against its plain version at each shape the path used
    def first(prefill, local, offset=None):
        return next(s for s in seen if (s[0][2] > 1) == prefill and
                    (s[3] is not None) == local and
                    (offset is None or s[4] == offset))

    def count(prefill, local):
        return sum(1 for s in seen if (s[0][2] > 1) == prefill and
                   (s[3] is not None) == local)

    dec_off = LM_PROMPT + 4
    cases = [("local prefill", first(True, True), count(True, True)),
             ("global prefill", first(True, False), count(True, False)),
             ("local decode", first(False, True, dec_off), count(False, True)),
             ("global decode", first(False, False, dec_off),
              count(False, False))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def sdpa_call(q, k, v, window, off):
        """SDPA over the keys some row sees, in its fastest form for the
        mask that is left: none, ``is_causal``, or an explicit one."""
        Sq = q.shape[2]
        _, lo, hi = visible_span(Sq, k.shape[2], window, off)
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        mask = visible(Sq, hi - lo, causal=True, window=window,
                       q_offset=off - lo, device=q.device)
        kw = {}
        if Sq == hi - lo and torch.equal(mask, torch.ones_like(mask).tril()):
            kw["is_causal"] = True
        elif not bool(mask.all()):
            kw["attn_mask"] = mask
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for label, (qs, ks, vs, window, off), n in cases:
        q, k, v = (rand(s, cfg.dtype) for s in (qs, ks, vs))
        kw = dict(causal=True, window=window, q_offset=off)
        n0 = kernels.launch_counts()
        got = attention(q, k, v, **kw)
        n1 = kernels.launch_counts()
        decode = n1["flash_attention_decode"] > n0["flash_attention_decode"]
        ran_prefill = (n1["flash_attention_prefill"] >
                       n0["flash_attention_prefill"])
        want = attention_ref(q, k, v, **kw)
        # the plain version with the last 32 visible keys dropped: a kernel
        # that lost its last key tile would give this, and must fail
        hi = visible_span(qs[2], ks[2], window, off)[2]
        wrong = attention_ref(q, k[:, :, :hi - 32], v[:, :, :hi - 32], **kw)
        lib = sdpa_call(q, k, v, window, off)
        lib_err = max_abs_err(lib().float(), want.float())
        torch.cuda.synchronize()
        err = max_abs_err(got.float(), want.float())
        ratio = over_bf16_limit(got, want)
        wrong_ratio = over_bf16_limit(wrong, want)
        check(err <= 2e-2 and ratio <= 1.0, f"flash_attention differs from "
              f"plain at {label}: max abs {err}, {ratio} x the bf16 limit")
        check(wrong_ratio > 1.0, f"the bf16 check at {label} passes a "
              f"result with the last key tile dropped ({wrong_ratio})")
        prefill = qs[2] > 1
        check(decode != prefill and ran_prefill == prefill, f"{label} ran "
              f"the {'decode' if decode else 'prefill'} kernel "
              f"(flash_prefill.cu: {ran_prefill})")
        iters = 4 if prefill else 50
        ms = graph_ms(lambda: attention(q, k, v, **kw), iters)
        old = {}
        if prefill:     # the old design, attention_mma_kernel, same inputs
            mma = fa_ops._attention_mma(q, k, v, **kw)
            torch.cuda.synchronize()
            old = {"mma_ms": graph_ms(
                       lambda: fa_ops._attention_mma(q, k, v, **kw), iters),
                   "mma_max_abs_err": max_abs_err(mma.float(), want.float()),
                   "mma_err_over_bf16_limit": over_bf16_limit(mma, want)}
            old["speedup_over_mma"] = old["mma_ms"] / ms
            check(old["mma_max_abs_err"] <= 2e-2 and
                  old["mma_err_over_bf16_limit"] <= 1.0,
                  f"attention_mma_kernel differs from plain at {label}")
            del mma
        loop_ms = cuda_ms(lambda: attention(q, k, v, **kw), iters)
        plain = cuda_ms(lambda: attention_ref(q, k, v, **kw),
                        3 if prefill else 20)
        lib_ms = graph_ms(lib, iters)
        lib_loop_ms = cuda_ms(lib, iters)
        B, Hq, Sq, D = qs
        Hkv, Sk, Dv = ks[1], ks[2], vs[3]
        n_splits = fa_ops.plan_splits(
            Sq, Sk, causal=True, window=window, q_offset=off,
            blocks=B * Hkv, n_sm=n_sm).n_splits if decode else None
        pairs, lo, hi = visible_span(Sq, Sk, window, off)
        nbytes = 2.0 * (B * Hq * Sq * (D + Dv) + B * Hkv * (hi - lo) * (D + Dv))
        ops = 2.0 * B * Hq * pairs * (D + Dv)
        b, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        shapes.append({
            "shape": f"{label}: q {list(qs)} k/v {list(ks)} window {window} "
                     f"q_offset {off} bf16", "launches": n,
            "kernel": ("flash_decode.cu: attention_decode_split_kernel + "
                       "attention_decode_combine_kernel" if decode else
                       "flash_prefill.cu: attention_prefill_kernel"),
            "n_splits": n_splits,
            "max_abs_err": err, "err_over_bf16_limit": ratio,
            "dropped_tile_err_over_bf16_limit": wrong_ratio,
            "max_abs_plain": float(want.float().abs().max()), "ms": ms,
            "host_loop_ms": loop_ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib_ms,
            "library_host_loop_ms": lib_loop_ms,
            "library_max_abs_err": lib_err, **old})
        del q, k, v, got, want, wrong
    # f32 at the global-prefill and global-decode shapes, held to 3e-5
    err32 = {}
    for label, (qs, ks, vs, window, off), _ in (cases[1], cases[3]):
        q, k, v = (rand(s, torch.float32) for s in (qs, ks, vs))
        err32[label] = max_abs_err(
            attention(q, k, v, window=window, q_offset=off),
            attention_ref(q, k, v, window=window, q_offset=off))
        torch.cuda.synchronize()
        check(err32[label] <= 3e-5, f"flash_attention differs from plain in "
              f"f32 at {label}: {err32[label]}")
        del q, k, v

    served = served_shapes(rand, sdpa_call)

    by_label = {s["shape"].split(":")[0]: s for s in shapes}
    kern_prefill = sum(by_label[f"{w} prefill"]["ms"] * by_label[
        f"{w} prefill"]["launches"] for w in ("local", "global"))
    kern_step = sum(by_label[f"{w} decode"]["ms"] * by_label[
        f"{w} decode"]["launches"] for w in ("local", "global")) / LM_GEN
    print(f"LM serving: the attention kernel at these shapes takes about "
          f"{kern_prefill:.3f} ms of the {prefill_ms:.3f} ms prefill "
          f"({kern_prefill / prefill_ms:.1%}) and {kern_step:.3f} ms of the "
          f"{step_ms:.3f} ms decode step ({kern_step / step_ms:.1%}); f32 "
          f"max_abs_err {json.dumps(err32)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    del params, res
    torch.cuda.empty_cache()
    limits = {"bf16": "max abs <= 2e-2, and |kernel - plain| <= "
                      "2^-6 |plain| + 1e-5 per element",
              "f32": "max abs <= 3e-5"}
    replaces = "src/repro/kernels/flash_attention/flash_attention.py:95"
    csrc = "src/repro_torch/kernels/csrc"
    recs = []
    prefill_labels = ("local prefill", "global prefill")
    for name, source, n_launch, top_label, own in (
            ("flash_attention_prefill", f"{csrc}/flash_prefill.cu", n_pre,
             "global prefill", prefill_labels),
            ("flash_attention_decode", f"{csrc}/flash_decode.cu", n_dec,
             "global decode", ("local decode", "global decode")),
            ("flash_attention", f"{csrc}/flash_attention.cu", n_fa,
             "global prefill", prefill_labels)):
        top = by_label[top_label]
        mine = [by_label[lb] for lb in own]
        old = name == "flash_attention"     # attention_mma_kernel's numbers
        err_key = "mma_max_abs_err" if old else "max_abs_err"
        ratio_key = ("mma_err_over_bf16_limit" if old else
                     "err_over_bf16_limit")
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n_launch,
               "max_abs_err": max(s[err_key] for s in mine),
               "err_over_bf16_limit": max(s[ratio_key] for s in mine),
               "limits": limits, "ms": top["mma_ms" if old else "ms"],
               "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
               "bound_by": top["bound_by"], "library_ms": top["library_ms"],
               "shape": top["shape"],
               f"f32_{top_label.replace(' ', '_')}_max_abs_err":
                   err32[top_label]}
        if old:
            rec["served_shapes"] = served
            rec["launches_note"] = (
                f"every attention() call on the path; {n_pre} of them ran "
                f"flash_prefill.cu, {n_dec} flash_decode.cu and "
                f"{n_fa - n_pre - n_dec} this source (whose f32 kernel "
                f"attention_simt_kernel the f32 tail check runs); ms, "
                f"errors and mma_ms are attention_mma_kernel through "
                f"ops._attention_mma on the prefill inputs of this run")
            rec["mma_ms"] = {s["shape"]: s["mma_ms"] for s in mine}
        else:
            rec["host_loop_ms"] = top["host_loop_ms"]
            rec["shapes"] = mine
        if name == "flash_attention_prefill":
            rec["serving"] = {
                "prefill_ms": prefill_ms, "decode_ms_per_step": step_ms,
                "decode_tok_per_s": tok_s,
                "attention_kernel_ms_per_prefill": kern_prefill,
                "attention_kernel_ms_per_decode_step": kern_step,
                "tail_rel_err_bf16": rel,
                "tail_rel_err_bf16_plain_attention": rel_plain,
                "tail_rel_err_bf16_last_tile_dropped": rel_wrong,
                f"tail_rel_err_bf16_{LM_CUT_LAYERS}_layers": rel_cut,
                "tail_rel_err_f32": rel32}
        print(f"kernel {name}: {json.dumps(rec)}")
        recs.append(rec)
    return recs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import GraphManager, GraphPool, replay
    from repro_torch.data.generators import churn_network, growing_network
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_apply.ref import (delta_apply_chain_ref,
                                                     delta_apply_fused_ref)
    from repro_torch.kernels.segment_sum import (bucket_edges,
                                                 segment_sum_bucketed,
                                                 segment_sum_bucketed_ref)
    from repro_torch.runtime import torch_exec
    from repro_torch.runtime.staging import DeviceStager
    from repro_torch.storage.kv import MemKV

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- set-up
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build_s = _build.build()
    print(f"build: nvcc per source {json.dumps(build_s)}; all sources "
          f"{time.perf_counter() - t0:.3f} s wall (parallel)")
    for source, kernel in (("flash_prefill", "attention_prefill_kernel"),
                           ("delta_apply", "delta_apply_fused_kernel"),
                           ("segment_sum", "segment_sum_bucketed_kernel")):
        print_ptxas(_build.logs.get(source, ""), kernel)

    # ------------------------------------------------------------- main path
    t0 = time.perf_counter()
    uni, ev = growing_network(n_events=2_000_000, seed=SEED,
                              attrs_on_add=False)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    gm = GraphManager(uni, ev, store=MemKV(), L=50_000, k=4,
                      diff_fn="intersection", cache_bytes=0, device=dev)
    dg = gm.dg
    t_index = time.perf_counter() - t0
    N, E = uni.num_nodes, uni.num_edges
    print(f"history: {len(ev)} events, {N} nodes, {E} edges, "
          f"{len(dg.leaf_nids)} leaves; generate {t_gen:.3f} s, "
          f"GraphManager (index, current graph, rates) {t_index:.3f} s")
    tmax = int(ev.time[-1])
    rng = np.random.default_rng(SEED)
    times = sorted({int(t) for t in np.linspace(0, tmax, 64)})
    fused_times = [int(t) for t in rng.choice(times, 8, replace=False)]

    # record the shapes the main path hands the kernels
    seen = {"chain": [], "fused": []}
    orig_chain = torch_exec.delta_apply_chain_batched
    orig_fused = torch_exec.delta_apply_fused_pair

    def rec_chain(b, a, d):
        seen["chain"].append(tuple(a.shape))
        return orig_chain(b, a, d)

    def rec_fused(bn, an, dn, be, ae, de, wn=None, we=None, **kw):
        seen["fused"].append((an.shape[0], an.shape[1], ae.shape[1],
                              wn is not None))
        return orig_fused(bn, an, dn, be, ae, de, wn, we, **kw)

    torch_exec.delta_apply_chain_batched = rec_chain
    torch_exec.delta_apply_fused_pair = rec_fused

    pool = GraphPool(uni)
    weights = rng.random(N, dtype=np.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gids = torch_exec.execute_multipoint_torch(dg, times, pool=pool,
                                               land_in_pool=True)
    torch.cuda.synchronize()
    t_multi = time.perf_counter() - t0
    fused = {}
    t0 = time.perf_counter()
    for t in fused_times:
        nm, em, an = torch_exec.execute_singlepoint_fused(
            dg, t, node_weights=weights)
        fused[t] = (nm, em, an.degrees(), an.num_nodes(), an.num_edges(),
                    float(an.node.weighted_total()))
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    launches = kernels.launch_counts()
    torch_exec.delta_apply_chain_batched = orig_chain
    torch_exec.delta_apply_fused_pair = orig_fused
    print(f"main path: multipoint 64 timepoints into GraphPool "
          f"{t_multi:.3f} s; fused + degrees at 8 timepoints "
          f"{t_fused:.3f} s; launches {json.dumps(launches)}")
    for name in RETRIEVAL_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the retrieval path")
    # one fused launch lands a retrieval's node and edge planes together,
    # and each degrees() call reduces by source and by destination
    check(launches["delta_apply_chain"] == len(seen["chain"]),
          f"{launches['delta_apply_chain']} chain launches for "
          f"{len(seen['chain'])} calls")
    check(launches["delta_apply_fused"] == len(fused_times) ==
          len(seen["fused"]), f"{launches['delta_apply_fused']} fused "
          f"launches for {len(fused_times)} fused retrievals")
    check(launches["segment_sum_bucketed"] == 2 * len(fused_times),
          f"{launches['segment_sum_bucketed']} segment-sum launches for "
          f"{len(fused_times)} degrees() calls")

    for t in times[:: len(times) // 4]:
        truth = replay(uni, ev, t)
        check(np.array_equal(pool.get_node_mask(gids[t]), truth.node_mask),
              f"pool node mask differs from replay at t={t}")
        check(np.array_equal(pool.get_edge_mask(gids[t]), truth.edge_mask),
              f"pool edge mask differs from replay at t={t}")
    for t in fused_times[:3]:
        nm, em, deg, n_nodes, n_edges, wt = fused[t]
        truth = replay(uni, ev, t)
        check(np.array_equal(nm, truth.node_mask), f"fused nodes t={t}")
        check(np.array_equal(em, truth.edge_mask), f"fused edges t={t}")
        check(n_nodes == int(truth.node_mask.sum()), f"num_nodes t={t}")
        check(n_edges == int(truth.edge_mask.sum()), f"num_edges t={t}")
        ref = np.zeros(N, np.float32)
        live = np.nonzero(truth.edge_mask)[0]
        np.add.at(ref, uni.edge_src[live], 1)
        np.add.at(ref, uni.edge_dst[live], 1)
        check(np.array_equal(deg, ref), f"degrees t={t}")
        check(np.isfinite(wt) and np.isclose(
            wt, weights[truth.node_mask].sum(dtype=np.float64), rtol=1e-4),
            f"weighted total t={t}")
    print("main path: masks, counts and degrees agree with replay")

    # ----------------------------------------------------------- evolve path
    evolve_launches = evolve_phase(gm, ev, dev)

    # --------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    record = []

    def entry(name, source, replaces, ms, plain_ms, err, nbytes, ops,
              library_ms=None, **extra):
        b, by = bound_ms(nbytes, ops)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": library_ms,
               "evolve_path_launches": evolve_launches[name], **extra}
        print(f"kernel {name}: {json.dumps(rec)}")
        return rec

    def timed(fn, iters):
        """Device time (CUDA-graph replay) and host-loop time of ``fn``."""
        return {"ms": graph_ms(fn, iters), "host_loop_ms": cuda_ms(fn, iters)}

    def chain_words(B, K, W):
        return (rand_words(gen, (B, W), dev), rand_words(gen, (B, K, W), dev),
                rand_words(gen, (B, K, W), dev))

    def chain_bytes(B, K, W):
        return B * (2 * K + 2) * W * 4.0, B * K * W * 3.0

    def chain_case(B, K, W, iters):
        words = chain_words(B, K, W)
        got = kernels.delta_apply_chain_batched(*words)
        want = delta_apply_chain_ref(*words)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"chain kernel differs at {B, K, W}")
        t = timed(lambda: kernels.delta_apply_chain_batched(*words), iters)
        plain = cuda_ms(lambda: delta_apply_chain_ref(*words), 5)
        return max_abs_err(got, want), t, plain, *chain_bytes(B, K, W)

    def fused_bytes(K, W, with_weights, emit_live):
        nbytes = ((2 * K + 1) * W * 4.0 + W * 4 + -(-W // 1024) * 4 + W * 4
                  + W * 32 * 4.0 * (with_weights + emit_live))
        return nbytes, K * W * 3.0 + W * 32.0 * (2 if with_weights else 0)

    def check_fused(got, want, label):
        err = 0.0
        for field, g, r in zip(got._fields, got, want):
            if r is None:
                check(g is None, f"fused {field} should be None")
                continue
            check(same_bits(g, r), f"fused {field} differs at {label}")
            err = max(err, max_abs_err(g, r))
        return err

    def fused_case(K, W, with_weights, emit_live):
        base = rand_words(gen, (W,), dev)
        adds = rand_words(gen, (K, W), dev)
        dels = rand_words(gen, (K, W), dev)
        w = (torch.rand(W * 32, generator=gen, device=dev)
             if with_weights else None)
        got = kernels.delta_apply_fused(base, adds, dels, w,
                                        emit_live=emit_live)
        want = delta_apply_fused_ref(base, adds, dels, w,
                                     emit_live=emit_live)
        torch.cuda.synchronize()
        err = check_fused(got, want, f"K={K} W={W} weights={with_weights} "
                                     f"live={emit_live}")
        t = timed(lambda: kernels.delta_apply_fused(
            base, adds, dels, w, emit_live=emit_live),
            20 if W > 2 ** 20 else 200)
        plain = cuda_ms(lambda: delta_apply_fused_ref(
            base, adds, dels, w, emit_live=emit_live), 3)
        return err, t, plain, *fused_bytes(K, W, with_weights, emit_live)

    def fused_pair_case(K, W_n, W_e):
        """Both planes of a fused retrieval in one call: the node plane
        with weights, both with ``live``, as the main path lands them."""
        planes = [(rand_words(gen, (W,), dev), rand_words(gen, (K, W), dev),
                   rand_words(gen, (K, W), dev)) for W in (W_n, W_e)]
        w = torch.rand(W_n * 32, generator=gen, device=dev)
        got = kernels.delta_apply_fused_pair(*planes[0], *planes[1], w)
        want = (delta_apply_fused_ref(*planes[0], w),
                delta_apply_fused_ref(*planes[1]))
        torch.cuda.synchronize()
        err = max(check_fused(g, r, f"pair K={K} W={W_n}+{W_e}")
                  for g, r in zip(got, want))
        t = timed(lambda: kernels.delta_apply_fused_pair(
            *planes[0], *planes[1], w), 200)
        plain = cuda_ms(lambda: (delta_apply_fused_ref(*planes[0], w),
                                 delta_apply_fused_ref(*planes[1])), 3)
        nb_n, ops_n = fused_bytes(K, W_n, True, True)
        nb_e, ops_e = fused_bytes(K, W_e, False, True)
        return err, t, plain, nb_n + nb_e, ops_n + ops_e

    da_src = "src/repro_torch/kernels/csrc/delta_apply.cu"
    da_tpu = "src/repro/kernels/delta_apply/delta_apply.py"
    (cB, cK, cW) = max(seen["chain"], key=lambda s: s[0] * (s[1] + 1) * s[2])
    err, t, plain, nb, ops = chain_case(8, 16, 2 ** 21, 20)
    m_err, m_t, m_plain, m_nb, m_ops = chain_case(cB, cK, cW, 200)
    record.append(entry(
        "delta_apply_chain", da_src, f"{da_tpu}:45", t["ms"], plain, err, nb,
        ops, host_loop_ms=t["host_loop_ms"], shape="B=8 K=16 W=2^21",
        at_main_path_shape={
            "shape": f"B={cB} K={cK} W={cW}", **m_t, "plain_ms": m_plain,
            "bound_ms": bound_ms(m_nb, m_ops)[0], "max_abs_err": m_err}))

    err_off, t_off, plain_off, nb_off, ops_off = fused_case(
        16, 2 ** 21, True, False)
    err, t, plain, nb, ops = fused_case(16, 2 ** 21, True, True)
    fK, fWn, fWe, _ = max(seen["fused"], key=lambda s: s[0] * (s[1] + s[2]))
    e_err, e_t, e_plain, e_nb, e_ops = fused_case(fK, fWe, False, True)
    m_err, m_t, m_plain, m_nb, m_ops = fused_pair_case(fK, fWn, fWe)
    record.append(entry(
        "delta_apply_fused", da_src, f"{da_tpu}:151", t["ms"], plain,
        max(err, err_off, e_err, m_err), nb, ops,
        host_loop_ms=t["host_loop_ms"], shape="K=16 W=2^21 weights live",
        emit_live_off={**t_off, "plain_ms": plain_off,
                       "bound_ms": bound_ms(nb_off, ops_off)[0]},
        at_main_path_shape={
            "shape": f"one pair call: K={fK} W={fWn} (nodes, weights) + "
                     f"{fWe} (edges), live", **m_t, "plain_ms": m_plain,
            "bound_ms": bound_ms(m_nb, m_ops)[0], "max_abs_err": m_err},
        edge_plane_alone={
            "shape": f"K={fK} W={fWe} live", **e_t, "plain_ms": e_plain,
            "bound_ms": bound_ms(e_nb, e_ops)[0], "max_abs_err": e_err}))

    # segment sum on the main path's degree feeds: a live indicator over
    # every edge slot, bucketed by source node and by destination node as
    # degrees() does
    live = (torch.rand(E, generator=gen, device=dev) < 0.5).to(torch.float32)

    def segsum_case(ends):
        t0 = time.perf_counter()
        order, local, ME = bucket_edges(ends, N, 128)
        t_bucket = time.perf_counter() - t0
        NB = local.shape[0]
        data = live[torch.from_numpy(order.reshape(-1)).to(dev)].reshape(
            NB, ME, 1)
        lid = torch.from_numpy(local).to(dev)
        got = segment_sum_bucketed(data, lid, block_n=128)
        want = segment_sum_bucketed_ref(data, lid, block_n=128)
        ids = torch.from_numpy(ends.astype(np.int64)).to(dev)

        def library():
            return torch.zeros(N, dtype=torch.float32, device=dev).index_add_(
                0, ids, live)

        lib = library()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"segment-sum kernel differs from "
              f"plain at ME={ME}")
        check(torch.equal(got.reshape(-1)[:N], lib), f"segment-sum differs "
              f"from the library scatter at ME={ME}")
        # general f32 at the same shape: both add each row's edges in order
        noise = torch.randn(data.shape, generator=gen, device=dev)
        check(same_bits(segment_sum_bucketed(noise, lid, block_n=128),
                        segment_sum_bucketed_ref(noise, lid, block_n=128)),
              f"segment-sum kernel differs from plain on general f32 at "
              f"ME={ME}")
        t = timed(lambda: segment_sum_bucketed(data, lid, block_n=128), 200)
        plain = cuda_ms(lambda: segment_sum_bucketed_ref(data, lid,
                                                          block_n=128), 5)
        t_lib = timed(library, 200)
        nbytes = E * 8.0 + NB * 128 * 4.0
        return nbytes, {
                "shape": f"NB={NB} ME={ME} D=1 (E={E})", **t,
                "plain_ms": plain, "bound_ms": bound_ms(nbytes, float(E))[0],
                "max_abs_err": max_abs_err(got, want),
                "library_ms": t_lib["ms"],
                "library_host_loop_ms": t_lib["host_loop_ms"],
                "bucket_edges_host_s": t_bucket}

    nbytes, src_feed = segsum_case(uni.edge_src)
    _, dst_feed = segsum_case(uni.edge_dst)
    record.append(entry(
        "segment_sum_bucketed", "src/repro_torch/kernels/csrc/segment_sum.cu",
        "src/repro/kernels/segment_sum/segment_sum.py:42", src_feed["ms"],
        src_feed["plain_ms"],
        max(src_feed["max_abs_err"], dst_feed["max_abs_err"]), nbytes,
        float(E),
        library_ms=src_feed["library_ms"],
        host_loop_ms=src_feed["host_loop_ms"],
        library_host_loop_ms=src_feed["library_host_loop_ms"],
        shape=f"source feed: {src_feed['shape']}",
        bucket_edges_host_s=src_feed["bucket_edges_host_s"],
        destination_feed=dst_feed))

    # ------------------------------------------------------------------ churn
    t0 = time.perf_counter()
    cuni, cev = churn_network(n_initial_edges=2000, n_events=50_000, seed=1)
    cgm = GraphManager(cuni, cev, store=MemKV(), L=2_000, k=2,
                       cache_bytes=0, device=dev)
    cdg = cgm.dg
    ctmax = int(cev.time[-1])
    ctimes = sorted({int(t) for t in np.linspace(0, ctmax + 3, 16)})
    ctruth = {t: replay(cuni, cev, t) for t in ctimes}
    cpool = GraphPool(cuni)
    cgids = torch_exec.execute_multipoint_torch(cdg, ctimes, pool=cpool,
                                                land_in_pool=True)
    mono = torch_exec.execute_multipoint_torch(cdg, ctimes)
    os.environ["REPRO_STREAM_CHUNK"] = "1"
    stager = DeviceStager()
    streamed = torch_exec.execute_multipoint_torch(cdg, ctimes,
                                                   stager=stager)
    del os.environ["REPRO_STREAM_CHUNK"]
    check(any(k == "apply" for k, _ in stager.events),
          "streamed path did not engage the stager")
    for t in ctimes:
        truth = ctruth[t]
        for nm, em in (mono[t], streamed[t],
                       (cpool.get_node_mask(cgids[t]),
                        cpool.get_edge_mask(cgids[t]))):
            check(np.array_equal(nm, truth.node_mask), f"churn nodes t={t}")
            check(np.array_equal(em, truth.edge_mask), f"churn edges t={t}")
    for t in ctimes[::4]:
        nm, em, an = torch_exec.execute_singlepoint_fused(cdg, t)
        truth = ctruth[t]
        check(np.array_equal(em, truth.edge_mask), f"churn fused t={t}")
        check(an.num_edges() == int(truth.edge_mask.sum()), f"churn t={t}")
        ref = np.zeros(cuni.num_nodes, np.float32)
        live_e = np.nonzero(truth.edge_mask)[0]
        np.add.at(ref, cuni.edge_src[live_e], 1)
        np.add.at(ref, cuni.edge_dst[live_e], 1)
        check(np.array_equal(an.degrees(), ref), f"churn degrees t={t}")
    # the evolve path over deletes and transient slots: two overlapping
    # intervals swept monolithic and streamed, and one loader window
    civs = [ctimes[:12], ctimes[5:]]
    for chunk in ("0", "2"):
        os.environ["REPRO_STREAM_CHUNK"] = chunk
        kernels.reset_launch_counts()
        swept = torch_exec.evolve_intervals_torch(cdg, civs, device=dev,
                                                  pool=cpool)
        check(kernels.launch_counts()["delta_apply_chain"] > 0,
              f"churn: evolve_intervals_torch (chunk {chunk}) launched no "
              f"chain kernel")
        for out, iv in zip(swept, civs):
            for t in iv:
                check(np.array_equal(out[t][0], ctruth[t].node_mask) and
                      np.array_equal(out[t][1], ctruth[t].edge_mask),
                      f"churn: evolve_intervals_torch (chunk {chunk}) "
                      f"differs from replay at t={t}")
    del os.environ["REPRO_STREAM_CHUNK"]
    clw = loader_window(cgm, cev, ctimes[2:10], ctimes[3] - ctimes[2], dev,
                        "churn")
    cgm.close()
    torch.cuda.synchronize()
    print(f"churn: {len(cev)} events, {int(cuni.edge_transient.sum())} "
          f"transient edge slots, 16 timepoints monolithic, streamed and "
          f"pooled + fused at 4, evolve_intervals_torch (monolithic and "
          f"streamed) and a loader window (launches "
          f"{json.dumps(clw['launches'])}) agree with replay "
          f"({time.perf_counter() - t0:.3f} s)")
    gm.close()

    # ------------------------------------------------------------ LM serving
    record.extend(lm_phase(dev))

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
