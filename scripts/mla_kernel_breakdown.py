#!/usr/bin/env python3
"""Where ``flash_mla_wgmma.cu``'s time goes, on one NVIDIA GPU, without a
profiler: the kernel and builds of it with one part left out (the
source's ``MLA_OMIT`` bits), timed in the same run.

    python3 scripts/mla_kernel_breakdown.py [--src DIR]

``DIR`` (default: this checkout's ``src``) holds the ``repro_torch``
package whose kernel is built and timed.  Variants:

* ``kernel``: the kernel as the library builds it, checked against the
  plain version;
* ``mask_every_tile``: every tile takes the per-element mask (the kernel
  skips it on tiles that every row sees whole);
* ``no_s``: S = Q·Kᵀ not computed (the scores are zeros);
* ``no_pv``: no P·V products;
* ``pv_hi_only``: P·V with P_hi alone (one product instead of two);
* ``no_merge_reads``: the split merge writes its partials and weights but
  reads no block's partial and stores nothing.

The variants other than ``kernel`` compute wrong results; their times,
against ``kernel``'s, say what each part costs.  Each is timed (calls
captured in a CUDA graph, replayed between CUDA events) through
``attention()`` at MLA's absorbed decode, q [8, 128, 1, 576] on one latent
KV head of 576 with v its first 512 columns: at the smoke run's cache of
4,128 keys (``q_offset`` 4,100), at 32,768 keys (``q_offset`` 32,740) and
at 128 keys (one split: the fixed costs), beside ``flash_mla.cu`` through
``ops._mla_mma`` on the same inputs; twice, in turns.  Prints the card's
name and power limit, the plan, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import graph_ms, over_bf16_limit  # noqa: E402

# the source's MLA_OMIT bits of each variant
OMIT = {"kernel": 0, "mask_every_tile": 1, "no_s": 2, "no_pv": 4,
        "pv_hi_only": 8, "no_merge_reads": 16}
# (keys in the cache, q_offset)
CASES = ((4128, 4100), (32768, 32740), (128, 127))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("mla_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    src = _build.CSRC / "flash_mla_wgmma.cu"
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, f"-DMLA_OMIT={bits}", "-o",
         str(out / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, bits in OMIT.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        if name == "kernel":        # ptxas's notes on wgmma serialisation
            for line in log.splitlines():
                if "Performance" in line:
                    print(line.strip())
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in fa_ops._MLA_WGMMA_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    _build.build(("flash_mla",))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, Hq, D, Dv = 8, 128, 576, 512
    times: dict[str, list[float]] = {}
    for Sk, off in CASES:
        q = torch.randn(B, Hq, 1, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, 1, Sk, D, generator=gen, device=dev).bfloat16()
        v = k[..., :Dv]
        kw = dict(causal=True, window=None, q_offset=off, scale=192 ** -0.5)
        _build._libs["flash_mla_wgmma"] = libs["kernel"]
        got = attention(q[:1], k[:1], v[:1], **kw)
        ratio = over_bf16_limit(got, attention_ref(q[:1], k[:1], v[:1], **kw))
        if ratio > 1.0:
            raise SystemExit(f"the kernel differs from plain at Sk {Sk}: "
                             f"{ratio} x the bf16 limit")
        plan = fa_ops.plan_mla_wgmma_splits(
            1, Sk, causal=True, window=None, q_offset=off, blocks=B * 2,
            block_n=fa_ops.MLA_BLOCK_N,
            max_clusters=lambda n: fa_ops.mla_cluster_slots(dev, n))
        print(f"Sk {Sk}: plan {plan._asdict()}; the kernel within "
              f"{ratio:.4f} of the bf16 limit on batch 0", flush=True)
        for _ in range(2):
            for name, lib in libs.items():
                _build._libs["flash_mla_wgmma"] = lib
                times.setdefault(f"{name} Sk={Sk}", []).append(graph_ms(
                    lambda: attention(q, k, v, **kw), 20))
            times.setdefault(f"flash_mla.cu Sk={Sk}", []).append(graph_ms(
                lambda: fa_ops._mla_mma(q, k, v, **kw), 20))
        del q, k, v
    _build._libs.pop("flash_mla_wgmma")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
