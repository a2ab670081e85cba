#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. set-up: the card's name and power limit; every CUDA kernel built from
   ``src/repro_torch/kernels/csrc`` with one ``nvcc`` per source, all at
   once;
2. main path: a ``growing_network(2_000_000)`` history (the generator's
   analogue of the paper's Dataset 1) indexed by a ``DeltaGraph``; 64
   timepoints retrieved by ``execute_multipoint_torch(land_in_pool=True)``
   and 8 by ``execute_singlepoint_fused`` with ``degrees()``, checked
   against the ``replay`` oracle.  Kernel launch counts are zeroed just
   before and read just after: every kernel must have run;
3. kernels: each kernel against its plain PyTorch version on the card, at
   full width (chain W = 2^21 words, K = 16, B = 8; fused W = 2^21, K = 16
   with weights, ``live`` on and off; segment-sum on the degree feed) and
   at the largest shape the main path gave it; bit for bit (degrees
   exactly), with kernel, plain, bound and library times;
4. churn: a ``churn_network`` history with deletes and transient slots,
   monolithic and streamed (``DeviceStager``) retrieval and fused
   analytics against ``replay``.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate (data sheet)
SEED = 0


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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for ``nbytes`` moved and ``ops`` done, and its bound."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
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


def same_bits(got, want) -> bool:
    import torch
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def rand_words(gen, shape, dev):
    import torch
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int32, device=dev)


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
    from repro_torch.core import DeltaGraph, GraphPool, replay
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

    # ------------------------------------------------------------- main path
    t0 = time.perf_counter()
    uni, ev = growing_network(n_events=2_000_000, seed=SEED,
                              attrs_on_add=False)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = DeltaGraph(uni, MemKV(), L=50_000, k=4,
                    diff_fn="intersection").build(ev)
    t_index = time.perf_counter() - t0
    N, E = uni.num_nodes, uni.num_edges
    print(f"history: {len(ev)} events, {N} nodes, {E} edges, "
          f"{len(dg.leaf_nids)} leaves; generate {t_gen:.3f} s, "
          f"index {t_index:.3f} s")
    tmax = int(ev.time[-1])
    rng = np.random.default_rng(SEED)
    times = sorted({int(t) for t in np.linspace(0, tmax, 64)})
    fused_times = [int(t) for t in rng.choice(times, 8, replace=False)]

    # record the shapes the main path hands the kernels
    seen = {"chain": [], "fused": []}
    orig_chain = torch_exec.delta_apply_chain_batched
    orig_fused = torch_exec.delta_apply_fused

    def rec_chain(b, a, d):
        seen["chain"].append(tuple(a.shape))
        return orig_chain(b, a, d)

    def rec_fused(b, a, d, w=None, **kw):
        seen["fused"].append((tuple(a.shape), w is not None))
        return orig_fused(b, a, d, w, **kw)

    torch_exec.delta_apply_chain_batched = rec_chain
    torch_exec.delta_apply_fused = rec_fused

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
    torch_exec.delta_apply_fused = orig_fused
    print(f"main path: multipoint 64 timepoints into GraphPool "
          f"{t_multi:.3f} s; fused + degrees at 8 timepoints "
          f"{t_fused:.3f} s; launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

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
               **extra}
        print(f"kernel {name}: {json.dumps(rec)}")
        return rec

    def chain_case(B, K, W):
        bases = rand_words(gen, (B, W), dev)
        adds = rand_words(gen, (B, K, W), dev)
        dels = rand_words(gen, (B, K, W), dev)
        got = kernels.delta_apply_chain_batched(bases, adds, dels)
        want = delta_apply_chain_ref(bases, adds, dels)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"chain kernel differs at {B, K, W}")
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: kernels.delta_apply_chain_batched(
            bases, adds, dels), 20)
        plain = cuda_ms(lambda: delta_apply_chain_ref(bases, adds, dels), 5)
        return err, ms, plain, B * (2 * K + 2) * W * 4.0, B * K * W * 3.0

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
        err = 0.0
        for field, g, r in zip(got._fields, got, want):
            if r is None:
                check(g is None, f"fused {field} should be None")
                continue
            check(same_bits(g, r), f"fused {field} differs at K={K} W={W} "
                  f"weights={with_weights} live={emit_live}")
            err = max(err, max_abs_err(g, r))
        ms = cuda_ms(lambda: kernels.delta_apply_fused(
            base, adds, dels, w, emit_live=emit_live), 20)
        plain = cuda_ms(lambda: delta_apply_fused_ref(
            base, adds, dels, w, emit_live=emit_live), 3)
        G = -(-W // 1024)
        nbytes = (2 * K + 1) * W * 4.0 + W * 4 + G * 4 + W * 4
        ops = K * W * 3.0 + W * 32.0 * (2 if with_weights else 0)
        if with_weights:
            nbytes += W * 32 * 4.0
        if emit_live:
            nbytes += W * 32 * 4.0
        return err, ms, plain, nbytes, ops

    da_src = "src/repro_torch/kernels/csrc/delta_apply.cu"
    da_tpu = "src/repro/kernels/delta_apply/delta_apply.py"
    (cB, cK, cW) = max(seen["chain"], key=lambda s: s[0] * (s[1] + 1) * s[2])
    err, ms, plain, nb, ops = chain_case(8, 16, 2 ** 21)
    m_err, m_ms, m_plain, m_nb, m_ops = chain_case(cB, cK, cW)
    record.append(entry(
        "delta_apply_chain", da_src, f"{da_tpu}:45", ms, plain, err, nb, ops,
        shape="B=8 K=16 W=2^21", at_main_path_shape={
            "shape": f"B={cB} K={cK} W={cW}", "ms": m_ms, "plain_ms": m_plain,
            "bound_ms": bound_ms(m_nb, m_ops)[0], "max_abs_err": m_err}))

    err_off, ms_off, plain_off, nb_off, ops_off = fused_case(
        16, 2 ** 21, True, False)
    err, ms, plain, nb, ops = fused_case(16, 2 ** 21, True, True)
    (fK, fW), _ = max(seen["fused"], key=lambda s: s[0][0] * s[0][1])
    m_err, m_ms, m_plain, m_nb, m_ops = fused_case(fK, fW, False, True)
    record.append(entry(
        "delta_apply_fused", da_src, f"{da_tpu}:151", ms, plain,
        max(err, err_off, m_err), nb, ops,
        shape="K=16 W=2^21 weights live", emit_live_off={
            "ms": ms_off, "plain_ms": plain_off,
            "bound_ms": bound_ms(nb_off, ops_off)[0]},
        at_main_path_shape={
            "shape": f"K={fK} W={fW} live", "ms": m_ms, "plain_ms": m_plain,
            "bound_ms": bound_ms(m_nb, m_ops)[0], "max_abs_err": m_err}))

    # segment sum on the main path's degree feed: a live indicator over
    # every edge slot, bucketed by source node as degrees() does
    live = (torch.rand(E, generator=gen, device=dev) < 0.5).to(torch.float32)
    t0 = time.perf_counter()
    order, local, ME = bucket_edges(uni.edge_src, N, 128)
    t_bucket = time.perf_counter() - t0
    NB = local.shape[0]
    data = live[torch.from_numpy(order.reshape(-1)).to(dev)].reshape(NB, ME, 1)
    lid = torch.from_numpy(local).to(dev)
    got = segment_sum_bucketed(data, lid, block_n=128)
    want = segment_sum_bucketed_ref(data, lid, block_n=128)
    src_ids = torch.from_numpy(uni.edge_src.astype(np.int64)).to(dev)
    lib = torch.zeros(N, dtype=torch.float32, device=dev).index_add_(
        0, src_ids, live)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "segment-sum kernel differs from plain")
    check(torch.equal(got.reshape(-1)[:N], lib), "segment-sum differs from "
          "the library scatter")
    # general f32 at the same shape: both add each row's edges in order
    noise = torch.randn(data.shape, generator=gen, device=dev)
    check(same_bits(segment_sum_bucketed(noise, lid, block_n=128),
                    segment_sum_bucketed_ref(noise, lid, block_n=128)),
          "segment-sum kernel differs from plain on general f32")
    ms = cuda_ms(lambda: segment_sum_bucketed(data, lid, block_n=128), 20)
    plain = cuda_ms(lambda: segment_sum_bucketed_ref(data, lid,
                                                      block_n=128), 5)
    lib_ms = cuda_ms(lambda: torch.zeros(N, dtype=torch.float32, device=dev)
                     .index_add_(0, src_ids, live), 20)
    record.append(entry(
        "segment_sum_bucketed", "src/repro_torch/kernels/csrc/segment_sum.cu",
        "src/repro/kernels/segment_sum/segment_sum.py:42", ms, plain,
        max_abs_err(got, want), E * 8.0 + NB * 128 * 4.0, float(E),
        library_ms=lib_ms,
        shape=f"NB={NB} ME={ME} D=1 (E={E})", bucket_edges_host_s=t_bucket))

    # ------------------------------------------------------------------ churn
    t0 = time.perf_counter()
    cuni, cev = churn_network(n_initial_edges=2000, n_events=50_000, seed=1)
    cdg = DeltaGraph(cuni, MemKV(), L=2_000, k=2).build(cev)
    ctmax = int(cev.time[-1])
    ctimes = sorted({int(t) for t in np.linspace(0, ctmax + 3, 16)})
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
        truth = replay(cuni, cev, t)
        for nm, em in (mono[t], streamed[t],
                       (cpool.get_node_mask(cgids[t]),
                        cpool.get_edge_mask(cgids[t]))):
            check(np.array_equal(nm, truth.node_mask), f"churn nodes t={t}")
            check(np.array_equal(em, truth.edge_mask), f"churn edges t={t}")
    for t in ctimes[::4]:
        nm, em, an = torch_exec.execute_singlepoint_fused(cdg, t)
        truth = replay(cuni, cev, t)
        check(np.array_equal(em, truth.edge_mask), f"churn fused t={t}")
        check(an.num_edges() == int(truth.edge_mask.sum()), f"churn t={t}")
        ref = np.zeros(cuni.num_nodes, np.float32)
        live_e = np.nonzero(truth.edge_mask)[0]
        np.add.at(ref, cuni.edge_src[live_e], 1)
        np.add.at(ref, cuni.edge_dst[live_e], 1)
        check(np.array_equal(an.degrees(), ref), f"churn degrees t={t}")
    torch.cuda.synchronize()
    print(f"churn: {len(cev)} events, {int(cuni.edge_transient.sum())} "
          f"transient edge slots, 16 timepoints monolithic, streamed and "
          f"pooled + fused at 4 agree with replay "
          f"({time.perf_counter() - t0:.3f} s)")

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
