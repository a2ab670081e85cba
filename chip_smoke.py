#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. set-up: the card's name and power limit; every CUDA kernel built from
   ``src/repro_torch/kernels/csrc`` with one ``nvcc`` per source, all at
   once, and ptxas's registers and spills for the prefill kernel;
2. retrieval path: a ``growing_network(2_000_000)`` history (the
   generator's analogue of the paper's Dataset 1) indexed by a
   ``DeltaGraph``; 64 timepoints retrieved by
   ``execute_multipoint_torch(land_in_pool=True)`` and 8 by
   ``execute_singlepoint_fused`` with ``degrees()``, checked against the
   ``replay`` oracle.  Launch counts are zeroed just before and read just
   after: each of the path's three kernels must have run;
3. retrieval kernels: each against its plain PyTorch version on the card,
   at full width (chain W = 2^21 words, K = 16, B = 8; fused W = 2^21,
   K = 16 with weights, ``live`` on and off; segment-sum on the degree
   feed) and at the largest shape the path gave it; bit for bit (degrees
   exactly), with kernel, plain, bound and library times;
4. churn: a ``churn_network`` history with deletes and transient slots,
   monolithic and streamed (``DeviceStager``) retrieval and fused
   analytics against ``replay``;
5. LM serving: gemma3-1b at full width and depth (26 layers, d 1152,
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
   ms per step and tokens per second.

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


def print_ptxas(log: str) -> None:
    """ptxas's registers and spills for each instantiation of the prefill
    kernel, from the build's ``-Xptxas -v`` output."""
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*attention_prefill_kernel"
                      r"ILi(\d+)ELi(\d+)E", line)
        if m:
            kernel = f"attention_prefill_kernel<{m[1]}, {m[2]}>"
        elif kernel and ("spill" in line or "registers" in line):
            print(f"ptxas {kernel}: "
                  f"{line.strip().removeprefix('ptxas info    : ')}")


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
    print_ptxas(_build.logs.get("flash_prefill", ""))

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
    for name in RETRIEVAL_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the retrieval path")

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

    # ------------------------------------------------------------ LM serving
    record.extend(lm_phase(dev))

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
