#!/usr/bin/env python3
"""Device time of the port's retrieval kernels, for one source tree, on one
NVIDIA GPU.

    python3 scripts/retrieval_kernel_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees, say a parent commit unpacked by ``git archive`` and the
change, are timed by the same code; compare them only inside one run on
one card, in turns (parent, change, change, parent), one process each.

At the shapes of ``chip_smoke.py``'s retrieval path on the
``growing_network(2_000_000, seed=0)`` history, and at full width, each
public wrapper is timed two ways: ``ms``, device time (calls captured in a
CUDA graph, replayed between CUDA events), and ``host_loop_ms``, the same
calls in a host loop between CUDA events, which adds the wrapper's host
work.  Each result is first checked against the plain version.  Rows:

* ``chain_wave``: one wave of the multipoint path, node plane (W 18,764)
  and edge plane (W 43,737) at B = 6, K = 2, as two
  ``delta_apply_chain_batched`` calls; ``chain_edge``, the edge plane alone;
  ``chain_full``, B = 8, K = 16, W = 2^21;
* ``fused_pair``: one fused retrieval, node plane (W 18,764, per-slot
  weights) and edge plane (W 43,737) at K = 7, both with ``live``: one
  ``delta_apply_fused_pair`` call where the tree has it, else two
  ``delta_apply_fused`` calls; ``fused_edge``, the edge plane alone;
  ``fused_full``, K = 16, W = 2^21, weights, ``live``;
* ``segment_sum``: ``segment_sum_bucketed`` on the degree feed bucketed by
  source node (NB 4,691, ME 662, D 1), ``segment_sum_dst`` by destination
  node (ME 2,805), each beside ``index_add``/``index_add_dst``,
  ``torch.zeros(N).index_add_`` on the same edges, the library yardstick.

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import bound_ms, cuda_ms, graph_ms, rand_words  # noqa: E402

# the largest wave chip_smoke.py's 64-timepoint multipoint hands the chain
# kernel, and the longest chain of its fused retrievals, on the 2 M-event
# history
WAVE_B, WAVE_K, FUSED_K = 6, 2, 7


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("retrieval_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import bitmaps as bmod
    from repro_torch.data.generators import growing_network
    from repro_torch.kernels.delta_apply.ref import (delta_apply_chain_ref,
                                                     delta_apply_fused_ref)
    from repro_torch.kernels.segment_sum import (bucket_edges,
                                                 segment_sum_bucketed,
                                                 segment_sum_bucketed_ref)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    uni, _ = growing_network(n_events=2_000_000, seed=0, attrs_on_add=False)
    N, E = uni.num_nodes, uni.num_edges
    W_n, W_e = bmod.num_words(N), bmod.num_words(E)
    rows = {}

    def row(name, fn, want, nbytes, ops, iters, shape):
        got = fn()
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if w is None:
                continue
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel differs from plain")
        b, by = bound_ms(nbytes, ops)
        rows[name] = {"shape": shape, "ms": graph_ms(fn, iters),
                      "host_loop_ms": cuda_ms(fn, iters), "bound_ms": b,
                      "bound_by": by}

    def chain(B, K, W):
        return (rand_words(gen, (B, W), dev), rand_words(gen, (B, K, W), dev),
                rand_words(gen, (B, K, W), dev))

    def chain_bytes(B, K, W):
        return B * (2 * K + 2) * W * 4.0, B * K * W * 3.0

    node, edge = chain(WAVE_B, WAVE_K, W_n), chain(WAVE_B, WAVE_K, W_e)
    want = (delta_apply_chain_ref(*node), delta_apply_chain_ref(*edge))
    nb_n, op_n = chain_bytes(WAVE_B, WAVE_K, W_n)
    nb_e, op_e = chain_bytes(WAVE_B, WAVE_K, W_e)
    row("chain_wave", lambda: (kernels.delta_apply_chain_batched(*node),
                               kernels.delta_apply_chain_batched(*edge)),
        want, nb_n + nb_e, op_n + op_e, 200,
        f"B={WAVE_B} K={WAVE_K} W={W_n}+{W_e}, two calls")
    row("chain_edge", lambda: kernels.delta_apply_chain_batched(*edge),
        want[1], nb_e, op_e, 200, f"B={WAVE_B} K={WAVE_K} W={W_e}")
    del node, edge, want
    full = chain(8, 16, 2 ** 21)
    row("chain_full", lambda: kernels.delta_apply_chain_batched(*full),
        delta_apply_chain_ref(*full), *chain_bytes(8, 16, 2 ** 21), 20,
        "B=8 K=16 W=2^21")
    del full

    def fused_plane(K, W, weighted):
        base, adds, dels = (t[0] for t in chain(1, K, W))
        w = (torch.rand(W * 32, generator=gen, device=dev) if weighted
             else None)
        nbytes = ((2 * K + 1) * W * 4.0 + W * 4 + -(-W // 1024) * 4 + W * 4
                  + W * 32 * 4.0 * (2 if weighted else 1))
        ops = K * W * 3.0 + W * 32.0 * (2 if weighted else 0)
        return (base, adds, dels, w), nbytes, ops

    (n_args, nb_n, op_n), (e_args, nb_e, op_e) = (
        fused_plane(FUSED_K, W_n, True), fused_plane(FUSED_K, W_e, False))
    want = (*delta_apply_fused_ref(*n_args), *delta_apply_fused_ref(*e_args))
    pair = getattr(kernels, "delta_apply_fused_pair", None)
    if pair is not None:
        def retrieval():
            fn, fe = pair(*n_args[:3], *e_args[:3], n_args[3])
            return (*fn, *fe)
    else:
        def retrieval():
            return (*kernels.delta_apply_fused(*n_args),
                    *kernels.delta_apply_fused(*e_args))
    row("fused_pair", retrieval, want, nb_n + nb_e, op_n + op_e, 200,
        f"K={FUSED_K} W={W_n} weights + {W_e}, live, "
        f"{'one pair call' if pair else 'two calls'}")
    row("fused_edge", lambda: tuple(kernels.delta_apply_fused(*e_args)),
        want[4:], nb_e, op_e, 200, f"K={FUSED_K} W={W_e} live")
    del n_args, e_args, want
    f_args, nb, ops = fused_plane(16, 2 ** 21, True)
    row("fused_full", lambda: tuple(kernels.delta_apply_fused(*f_args)),
        tuple(delta_apply_fused_ref(*f_args)), nb, ops, 20,
        "K=16 W=2^21 weights live")
    del f_args

    live = (torch.rand(E, generator=gen, device=dev) < 0.5).to(torch.float32)
    for feed, ends in (("", uni.edge_src), ("_dst", uni.edge_dst)):
        order, local, ME = bucket_edges(ends, N, 128)
        NB = local.shape[0]
        data = live[torch.from_numpy(order.reshape(-1)).to(dev)].reshape(
            NB, ME, 1)
        lid = torch.from_numpy(local).to(dev)
        want = segment_sum_bucketed_ref(data, lid, block_n=128)
        row(f"segment_sum{feed}",
            lambda: segment_sum_bucketed(data, lid, block_n=128), want,
            E * 8.0 + NB * 128 * 4.0, float(E), 200,
            f"NB={NB} ME={ME} D=1 (E={E})")
        ids = torch.from_numpy(ends.astype(np.int64)).to(dev)
        row(f"index_add{feed}",
            lambda: torch.zeros(N, dtype=torch.float32,
                                device=dev).index_add_(0, ids, live),
            want.reshape(-1)[:N], E * 12.0 + N * 4.0, float(E), 200,
            f"N={N} E={E}")
    print(json.dumps({"label": args.label, "src": args.src,
                      "launches": kernels.launch_counts(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
