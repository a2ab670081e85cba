"""Where the port's LM serving spends its time on the card, and how far
bf16 prefill and decode drift apart.

    PYTHONPATH=src python -m repro_torch.launch.lm_profile   # one NVIDIA GPU
    PYTHONPATH=src python -m repro_torch.launch.lm_profile --reduced \\
        --device cpu --batch 2 --prompt 64 --seeds 1         # host rehearsal

gemma3-1b (full width and depth unless ``--reduced``) with seeded random
weights, loaded through :mod:`repro_torch.launch.serve`:

1. for each prompt seed, :func:`~repro_torch.launch.serve.tail_drift` in
   bf16 twice: through the attention kernel, and with the plain version
   (``attention_ref``) in its place, so that the kernel's share of the
   drift shows; for the first seed also with the same weights in f32, and
   how far the bf16 whole-prompt logits lie from the f32 ones;
2. ``torch.profiler`` over one prefill and over 4 decode steps: device
   time by kernel, summed into attention kernel / matrix products / other,
   and the device's busy share of the host-clock wall time.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels.flash_attention import attention_ref
from ..models.transformer import model as tm
from . import serve


def kind(name: str) -> str:
    if "attention" in name:
        return "attention kernel"
    if name.startswith("nvjet") or "gemm" in name.lower():
        return "matrix products"
    return "other"


def profiled(fn, sync, label: str, rows: int) -> None:
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kind: dict[str, float] = {}
    for e in kernels:
        by_kind[kind(e.key)] = (by_kind.get(kind(e.key), 0.0)
                                + e.self_device_time_total / 1e3)
    print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in sorted(by_kind.items())))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=8)
    args = ap.parse_args()
    cfg, params = serve.load_lm("gemma3-1b", reduced=args.reduced,
                                device=args.device, seed=0)
    dev = params["embed"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    print(f"gemma3-1b {'reduced' if args.reduced else 'full width'}: "
          f"batch {args.batch}, prompt {args.prompt}")
    kernel = tm.attention
    whole0 = None
    for seed in range(args.seeds):
        tokens = serve.prompt_tokens(cfg, args.batch, args.prompt, seed, dev)
        whole, rel = serve.tail_drift(params, cfg, tokens)
        whole0 = whole if whole0 is None else whole0
        tm.attention = attention_ref
        try:
            _, rel_plain = serve.tail_drift(params, cfg, tokens)
        finally:
            tm.attention = kernel
        print(f"prompt seed {seed}: bf16 tail drift {rel:.6e} through the "
              f"kernel, {rel_plain:.6e} through the plain version",
              flush=True)
    tokens = serve.prompt_tokens(cfg, args.batch, args.prompt, 0, dev)
    whole32, rel32 = serve.tail_drift(
        serve.cast_params(params, torch.float32),
        dataclasses.replace(cfg, dtype=torch.float32), tokens)
    print(f"prompt seed 0: f32 tail drift {rel32:.6e}; whole-prompt logits, "
          f"bf16 against f32 with the same weights: "
          f"{float((whole0 - whole32).abs().max() / whole32.abs().max()):.6e}",
          flush=True)

    S = args.prompt
    serve.generate(params, cfg, tokens[:, :min(S, 512)], 2)     # warm-up
    profiled(lambda: tm.prefill_step(params, tokens, cfg, max_len=S + 8),
             sync, f"prefill {args.batch}x{S}", args.rows)
    _, cache = tm.prefill_step(params, tokens, cfg, max_len=S + 8)
    tok = tokens[:, -1:]

    def decode4():
        nonlocal cache
        for i in range(4):
            _, cache = tm.decode_step(params, cache, tok, S + i, cfg)

    profiled(decode4, sync, "4 decode steps", args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
