"""Serving in the port: LM prefill + greedy decode, and evolutionary
queries.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode model \\
        --arch gemma3-1b --reduced --device cpu     # reduced width, host
    PYTHONPATH=src python -m repro_torch.launch.serve --mode model \\
        --arch gemma3-1b --batch 8 --prompt 4096 --gen 32   # full, card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode evolve \\
        --events 20000 --intervals 8 --points 32 --op pagerank   # card

``--mode model`` is the counterpart of ``repro/launch/serve.py::serve_lm``
for the dense LM architectures.  Weights are random, from a seeded
``torch.Generator``; the prompt is ``numpy.random.default_rng(seed)``
token ids.  The reference always runs the reduced config on its host;
here ``reduced=True`` selects it, and the card runs the full width.

``--mode evolve`` is the counterpart of ``serve_evolve``: dense
evolutionary-query windows through the incremental temporal engine and
the per-snapshot recompute loop, with the fixpoint operators on
``--device``.  The snapshots, query, server and ingest modes of the
reference come with a later slice.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_arch, reduced_config
from ..kernels.policy import resolve_device
from ..models.common import init_params
from ..models.transformer import model as tm


def load_lm(arch: str, *, reduced: bool = False, device="cuda",
            seed: int = 0):
    """``(config, params)``: the architecture at full width (or its
    reduced config) with random weights on ``device``."""
    dev = resolve_device(device)
    cfg = reduced_config(arch) if reduced else get_arch(arch)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return cfg, init_params(tm.param_defs(cfg), gen, dev)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """``[batch, prompt_len]`` token ids from ``default_rng(seed)``, on the
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, (batch, prompt_len))
    return torch.from_numpy(ids).to(dev)


def generate(params, cfg, tokens: torch.Tensor, gen: int) -> dict:
    """Prefill ``tokens`` into a cache of ``prompt_len + gen`` and decode
    ``gen`` greedy steps.  Returns the prefill's last-position logits, the
    generated ids ``[B, gen]`` and the host-clock times (each ending in a
    device synchronise on the card)."""
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    B, S = tokens.shape
    sync()
    t0 = time.perf_counter()
    last, cache = tm.prefill_step(params, tokens, cfg, max_len=S + gen)
    sync()
    prefill_s = time.perf_counter() - t0
    tok = last.argmax(-1, keepdim=True)
    out = []
    t0 = time.perf_counter()
    for i in range(gen):
        logits, cache = tm.decode_step(params, cache, tok, S + i, cfg)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    return {"prefill_logits": last,
            "tokens": (torch.cat(out, 1) if out else
                       tokens.new_zeros((B, 0))).cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s}


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """A copy of ``params`` with every tensor cast to ``dtype``."""
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) else
                cast_params(v, dtype)) for k, v in params.items()}


def tail_drift(params, cfg, tokens: torch.Tensor, tail: int = 16
               ) -> tuple[torch.Tensor, float]:
    """Prefill and decode against each other: a prefill of all but the
    last ``tail`` prompt tokens, then ``tail`` decode steps fed those
    tokens, against a prefill of the whole prompt.  Returns the whole
    prefill's last logits (f32) and max |Δlogit| / max |logit| (NaN if
    either side is not finite)."""
    S = tokens.shape[1]
    whole, _ = tm.prefill_step(params, tokens, cfg)
    _, cache = tm.prefill_step(params, tokens[:, :S - tail], cfg, max_len=S)
    for i in range(S - tail, S):
        last, cache = tm.decode_step(params, cache, tokens[:, i:i + 1], i,
                                     cfg)
    whole = whole.float()
    return whole, float((last.float() - whole).abs().max() /
                        whole.abs().max())


def serve_evolve(n_events: int, intervals: int, points: int, op: str, *,
                 seed: int = 0, window_frac: float = 0.05,
                 device="cuda") -> dict:
    """Drive an evolutionary-query workload — ``intervals`` dense
    ``points``-timepoint windows over a ``churn_network`` history —
    through the incremental temporal engine and the per-snapshot
    recompute loop on ``device``, print microseconds per point for each
    and the speedup, and return ``{engine: (wall_s, solver_iters)}``."""
    from ..core import GraphManager
    from ..data.generators import churn_network, dense_intervals

    dev = resolve_device(device)
    uni, ev = churn_network(n_initial_edges=max(n_events // 12, 50),
                            n_events=n_events, seed=seed)
    tmax = int(ev.time[-1])
    ivs = dense_intervals(tmax, intervals, points,
                          window_frac=window_frac, seed=seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with GraphManager(uni, ev, L=max(n_events // 40, 64), k=2,
                      diff_fn="intersection", cache_bytes=0,
                      device=dev) as gm:
        # warm both engines (first launches, lazily built kernels) so that
        # one-time costs are not charged to whichever engine runs first
        for engine_warm in (False, True):
            gm.evolve(ivs[0][:3], op, incremental=engine_warm)
        results = {}
        for engine in ("recompute", "incremental"):
            sync()
            t0 = time.perf_counter()
            iters = 0
            for iv in ivs:
                res = gm.evolve(iv, op,
                                incremental=(engine == "incremental"))
                if res.stats.get("solver_iters"):
                    iters += sum(res.stats["solver_iters"])
            sync()
            results[engine] = (time.perf_counter() - t0, iters)
    q = intervals * points
    for engine, (wall, iters) in results.items():
        print(f"{engine:12s}: {wall / q * 1e6:8.1f} us/point "
              f"({q / wall:8.0f} points/s, solver iters {iters})")
    print(f"speedup x{results['recompute'][0] / results['incremental'][0]:.2f}"
          f"  ({intervals} intervals x {points} points, op={op}, "
          f"device {dev})")
    return results


def serve_lm(arch: str, batch: int, prompt_len: int, gen: int, *,
             reduced: bool = False, device="cuda", seed: int = 0) -> dict:
    """Serve one batch: ``batch`` prompts of ``prompt_len`` tokens, ``gen``
    greedy decode steps; prints the times and a sample and returns
    :func:`generate`'s record with ``config``."""
    cfg, params = load_lm(arch, reduced=reduced, device=device, seed=seed)
    tokens = prompt_tokens(cfg, batch, prompt_len, seed,
                           params["embed"].device)
    res = generate(params, cfg, tokens, gen)
    dt = res["decode_s"]
    per_step = dt / gen * 1000 if gen else 0.0
    rate = batch * gen / dt if gen and dt > 0 else 0.0
    print(f"prefill {batch}x{prompt_len}: {res['prefill_s'] * 1000:.3f} ms; "
          f"decode {gen} steps: {per_step:.3f} ms/step ({rate:.1f} tok/s)")
    print("sample:", res["tokens"][0][:16].tolist())
    return {**res, "config": cfg}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("model", "evolve"), default="model",
                    help="LM serving, or evolutionary queries (the other "
                         "retrieval modes are not ported yet)")
    ap.add_argument("--arch", default="gemma3-1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's smoke-test scale of --arch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", type=int, default=20_000,
                    help="evolve mode: history length")
    ap.add_argument("--intervals", type=int, default=8,
                    help="evolve mode: number of evolutionary queries")
    ap.add_argument("--points", type=int, default=32,
                    help="evolve mode: timepoints per interval")
    ap.add_argument("--op", default="pagerank",
                    choices=("masks", "degree", "density", "pagerank",
                             "components"),
                    help="evolve mode: incremental operator")
    args = ap.parse_args()
    if args.mode == "evolve":
        serve_evolve(args.events, args.intervals, args.points, args.op,
                     seed=args.seed, device=args.device)
    else:
        serve_lm(args.arch, args.batch, args.prompt, args.gen,
                 reduced=args.reduced, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
