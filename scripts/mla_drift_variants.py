#!/usr/bin/env python3
"""deepseek-v3's tail drift through several attention paths, over several
seeds, with the router's route flips and their margins, and a call-by-call
check of MLA's absorbed decode, on one NVIDIA GPU.

    python3 scripts/mla_drift_variants.py [--prompt-seeds N] \
        [--weight-seeds S ...]

The model and the drift are ``chip_smoke.py``'s (phase 8): deepseek-v3 at
full width cut to 3 layers (1 dense, 2 MoE), ``mtp`` off, the no-drop
capacity (E / K), random weights from a weight seed; a prefill of all but
the last 16 of a 256-token prompt (from a prompt seed) and 16 decode steps
against the whole prompt's prefill (``serve.tail_drift``: max |Δlogit| /
max |logit|).  MLA's absorbed decode (D = 576, Dv = 512) through:

* ``plain``: the plain version for every attention call (the smoke's
  reference);
* ``plain_p_hi_lo``: the plain version with p carried as P_hi + P_lo
  (``attention_ref(p_terms=2)``) for the MLA calls;
* ``plain_split``: :func:`split_ref`, the plain version computed as
  ``flash_mla_wgmma.cu`` cuts and merges it, at the kernel's plan: an
  independent witness of the split merge;
* ``flash_mla_wgmma``: ``attention()`` as served;
* ``flash_mla_wgmma_one_split``: the same kernel with its keys in one
  split (no cluster size "fits");
* ``flash_mla_wgmma_tile_splits``: the same kernel with a split per 64-key
  tile (the plan's minimum of two tiles a split lifted);
* ``flash_mla``: the first MLA kernel (``ops._mla_mma``).

Each with the router free and with every token's routes pinned
(``chip_smoke.pinned_routes``).  A route flip is a (MoE layer, tail token)
whose 8 experts in the decode step differ from those of the same token in
the whole prefill; its margin is the gap between the 8th and 9th biased
scores of that token in the whole prefill.  Every path runs twice at the
first seeds, to show the runs repeat.  At the first seeds with free routes,
every MLA call of the served decode is captured and run through each path:
the largest |Δ| against the plain version in units of the bf16 limit
(``chip_smoke.over_bf16_limit``) and the share of output elements that
differ from it.  Prints the card's name and power limit, a line per run,
then one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import (DRIFT_PROMPT, DS_ARCH, DS_DENSE,  # noqa: E402
                        DS_LAYERS, LM_TAIL, over_bf16_limit, pinned_routes)


def split_ref(q, k, v, *, causal=True, window=None, q_offset=0, scale=None,
              bounds):
    """The plain version's function computed as ``flash_mla_wgmma.cu``
    computes it, in f32 with torch: the keys cut at ``bounds`` (``(begin,
    end)`` a split), each split's p taken against its own row max and
    carried into p·v as P_hi + P_lo, its row sum l of p in f32; the
    partials merged with weights exp(m_j - M) (M the largest m_j, 0 for a
    split that saw no key) and divided once by max(Σ weight·l, 1e-30)."""
    import torch

    from repro_torch.kernels.flash_attention.ref import split_bf16, visible
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float().reshape(B, Hkv, G, Sq, D),
                     k.float()) * scale
    mask = visible(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                   device=q.device)
    ms, ls, os_ = [], [], []
    for b, e in bounds:
        if e <= b:                             # no key: weighs nothing
            continue
        sj = s[..., b:e].masked_fill(~mask[:, b:e], float("-inf"))
        m = sj.amax(dim=-1, keepdim=True)
        p = torch.where(mask[:, b:e], torch.exp(sj - torch.where(
            torch.isfinite(m), m, 0.0)), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        os_.append(torch.einsum("bhgqk,bhkd->bhgqd", split_bf16(p, 2),
                                v[:, :, b:e].float()))
    M = torch.stack(ms).amax(dim=0)
    out, den = 0.0, 0.0
    for m, l, o in zip(ms, ls, os_):
        w = torch.where(torch.isfinite(m), torch.exp(m - M), 0.0)
        out, den = out + w * o, den + w * l
    out = out / torch.clamp(den, min=1e-30)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt-seeds", type=int, default=8,
                    help="prompt seeds 0..N-1 for each weight seed")
    ap.add_argument("--weight-seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("mla_drift_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import model as tm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    _build.build(("flash_mla", "flash_mla_wgmma", "flash_prefill"))
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(DS_ARCH)[0], n_layers=DS_LAYERS,
                              mtp=False, n_dense_layers=DS_DENSE)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    K = cfg.moe.top_k
    served, planner, route = tm.attention, fa_ops.plan_mla_wgmma_splits, \
        tm._route

    def mla(fn):        # fn for MLA's calls (D = 576), the rest as served
        return lambda q, k, v, **kw: (fn(q, k, v, **kw) if q.shape[-1] > 256
                                      else served(q, k, v, **kw))

    def planned(**over):
        """attention() with the kernel's planner given other arguments."""
        def fn(q, k, v, **kw):
            fa_ops.plan_mla_wgmma_splits = lambda *a, **k2: (
                over["plan"](*a, **k2) if "plan" in over
                else planner(*a, **{**k2, **over}))
            try:
                return served(q, k, v, **kw)
            finally:
                fa_ops.plan_mla_wgmma_splits = planner
        return fn

    def tile_plan(Sq, Sk, *, causal, window, q_offset, block_n, **_):
        _, lo, hi = fa_ops.visible_pairs(Sq, Sk, causal=causal,
                                         window=window, q_offset=q_offset)
        n = max(1, -(-hi // block_n) - lo // block_n)
        if n > fa_ops.MLA_MAX_CLUSTER:
            raise ValueError(f"{n} tiles: more than a cluster holds")
        return fa_ops.SplitPlan(lo, hi, 1, n, block_n)

    def kernel_bounds(q, k, **kw):
        B, Hq, Sq, _ = q.shape
        Hkv = k.shape[1]
        rows = Hq // Hkv * Sq                   # query rows per KV head
        plan = planner(Sq, k.shape[2], causal=kw["causal"],
                       window=kw["window"], q_offset=kw["q_offset"],
                       blocks=B * Hkv * -(-rows // fa_ops.MLA_ROWS),
                       block_n=fa_ops.MLA_BLOCK_N,
                       max_clusters=lambda n: fa_ops.mla_cluster_slots(dev, n))
        return plan.bounds()

    def plain_split(q, k, v, **kw):
        return split_ref(q, k, v, **kw, bounds=kernel_bounds(q, k, **kw))

    paths = {"plain": attention_ref,
             "plain_p_hi_lo": mla(functools.partial(attention_ref,
                                                    p_terms=2)),
             "plain_split": mla(plain_split),
             "flash_mla_wgmma": served,
             "flash_mla_wgmma_one_split": planned(max_clusters=lambda n: 0),
             "flash_mla_wgmma_tile_splits": planned(plan=tile_plan),
             "flash_mla": mla(fa_ops._mla_mma)}

    routes: list = []          # (sorted ids [G, T, K], margin [G, T]) a call

    def recording_route(logits, bias, moe):
        ids, w = route(logits, bias, moe)
        top = torch.topk(torch.sigmoid(logits) + bias, K + 1, dim=-1).values
        routes.append((ids.sort(dim=-1).values, top[..., K - 1] -
                       top[..., K]))
        return ids, w

    def drift(params, tokens, fn):
        """(drift, flips [(layer, token, margin)], least margin) of one
        run of ``tail_drift`` with ``fn`` as the model's attention."""
        routes.clear()
        tm.attention, tm._route = fn, recording_route
        try:
            rel = serve.tail_drift(params, cfg, tokens, LM_TAIL)[1]
        finally:
            tm.attention, tm._route = served, route
        n = len(routes) // (2 + LM_TAIL)         # MoE layers
        S = tokens.shape[1]
        flips, least = [], float("inf")
        for t in range(LM_TAIL):
            for layer in range(n):
                ids_w, margin = routes[layer]
                ids_d = routes[(2 + t) * n + layer][0]
                gap = float(margin[0, S - LM_TAIL + t])
                least = min(least, gap)
                if not torch.equal(ids_d[0, 0], ids_w[0, S - LM_TAIL + t]):
                    flips.append((layer, t, gap))
        return rel, flips, least

    def witness(params, tokens):
        """Every MLA call of the served decode, run through each path."""
        calls = []

        def capture(q, k, v, **kw):
            if q.shape[-1] > 256:
                calls.append((q.clone(), k.clone(), v.shape[-1], kw))
            return served(q, k, v, **kw)

        tm.attention = capture
        try:
            serve.tail_drift(params, cfg, tokens, LM_TAIL)
        finally:
            tm.attention = served
        out = {}
        for name, fn in paths.items():
            ratio, differ, n = 0.0, 0, 0
            for q, k, dv, kw in calls:
                want = attention_ref(q, k, k[..., :dv], **kw)
                got = fn(q, k, k[..., :dv], **kw)
                ratio = max(ratio, over_bf16_limit(got, want))
                differ += int((got != want).sum())
                n += want.numel()
            out[name] = {"calls": len(calls), "max_over_bf16_limit": ratio,
                         "share_differing": differ / n}
            print(f"calls {name}: {json.dumps(out[name])}", flush=True)
        return out

    result = {"runs": [], "calls": None}
    for w_seed in args.weight_seeds:
        _, params = serve.load_lm(DS_ARCH, device=dev, seed=w_seed, cfg=cfg)
        for p_seed in range(args.prompt_seeds):
            tokens = serve.prompt_tokens(cfg, 1, DRIFT_PROMPT, p_seed, dev)
            first = w_seed == args.weight_seeds[0] and p_seed == 0
            if first:
                result["calls"] = witness(params, tokens)
            for pinned in (False, True):
                for name, fn in paths.items():
                    for rep in range(2 if first else 1):
                        if pinned:
                            with pinned_routes(params, K):
                                rel, flips, least = drift(params, tokens, fn)
                        else:
                            rel, flips, least = drift(params, tokens, fn)
                        run = {"weight_seed": w_seed, "prompt_seed": p_seed,
                               "routes": "pinned" if pinned else "free",
                               "path": name, "rep": rep, "drift": rel,
                               "flips": flips, "least_margin": least}
                        result["runs"].append(run)
                        print(json.dumps(run), flush=True)
        del params
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
