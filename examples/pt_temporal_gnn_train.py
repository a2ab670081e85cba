"""End-to-end driver, in torch: train a GCN over *historical snapshots*
served by the DeltaGraph — the paper's substrate feeding an ML training
loop, with checkpoint/resume fault tolerance.  The port of
``examples/temporal_gnn_train.py``.

The task: node classification where the label is whether a node's degree
will grow in the future (a simple self-supervised temporal target), trained
across a stream of snapshot windows served by
:class:`repro_torch.core.SnapshotBatchLoader` — interval retrieval runs on
the chain kernel (the double-buffered prefix-chain sweep), the degree
features come from the fused delta-apply kernel and the segment-sum kernel,
so the training loop never replays events or scatters degrees on the host.

Run:  PYTHONPATH=src python examples/pt_temporal_gnn_train.py [--steps 300]
          [--device cpu]

``--device`` defaults to the card, which must be present.  The functions
below are the loop's parts, so that another history (a
:class:`~repro_torch.core.GraphManager` of one's own) can feed the same
model and step.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import GraphManager, SnapshotBatchLoader
from repro_torch.data.generators import churn_network
from repro_torch.kernels.policy import resolve_device
from repro_torch.models import common as mc
from repro_torch.models.gnn import GCNConfig, gnn_loss, gnn_param_defs
from repro_torch.storage.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.storage.kv import LogFileKV
from repro_torch.training.optim import OPTIMIZERS
from repro_torch.training.trainer import make_train_step

CFG = GCNConfig(d_in=16, d_hidden=32, n_layers=2, n_classes=2)
LR = 5e-3
BATCH_SIZE = 4          # timepoints a loader window


def build_history(device="cuda"):
    """The example's churn history and its ``GraphManager``; returns
    ``(gm, tmax)``."""
    uni, ev = churn_network(n_initial_edges=600, n_events=6000, seed=5)
    gm = GraphManager(uni, ev, L=400, k=4, diff_fn="balanced",
                      device=device)
    return gm, int(ev.time[-1])


def time_grid(tmax: int) -> list[int]:
    """64 points between a quarter and four fifths of the history."""
    lo, hi = tmax // 4, int(tmax * 0.8)
    return sorted({int(t) for t in np.linspace(lo, hi, 64)})


def make_loader(gm, times, tmax: int, cfg=CFG) -> SnapshotBatchLoader:
    """Windows of ``BATCH_SIZE`` points, labelled at ``tmax // 10``
    ahead."""
    return SnapshotBatchLoader(gm, times, batch_size=BATCH_SIZE,
                               label_horizon=tmax // 10, d_in=cfg.d_in)


def snapshot_stream(loader):
    """Endless per-snapshot training examples from windowed loader batches.

    The loader yields ``[T, ...]`` window stacks (one batched retrieval +
    one fused analytics pass per window); each timepoint slice is a
    static-shape batch for the train step."""
    while True:
        for b in loader:
            for j in range(len(b["times"])):
                yield {"x": b["x"][j], "edge_index": b["edge_index"],
                       "edge_mask": b["edge_mask"][j],
                       "labels": b["labels"][j],
                       "label_mask": b["label_mask"][j]}


def init_model(cfg=CFG, device="cuda", seed: int = 0) -> dict:
    """Random GCN weights from a seeded ``torch.Generator`` on
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return mc.init_params(gnn_param_defs(cfg), gen, dev)


def make_step(cfg=CFG, lr: float = LR):
    """``(optimizer, step_fn)``: AdamW at ``lr`` over ``gnn_loss``."""
    opt = OPTIMIZERS["adamw"](lr=lr)
    return opt, make_train_step(lambda p, b: gnn_loss(p, b, cfg), opt)


def train_steps(step_fn, params, opt_state, stream, start: int, steps: int,
                store=None, ckpt_every: int = 100, log=print):
    """Steps ``start .. steps - 1`` on the stream's batches, a checkpoint
    into ``store`` every ``ckpt_every``; returns ``(params, opt_state,
    losses)``."""
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        params, opt_state, m = step_fn(params, opt_state, next(stream))
        losses.append(float(m["loss"]))
        if (step + 1) % 50 == 0:
            log(f"step {step + 1:4d} loss {losses[-1]:.4f} "
                f"({(time.time() - t0) / (step - start + 1) * 1000:.0f} "
                f"ms/step)")
        if store is not None and (step + 1) % ckpt_every == 0:
            save_checkpoint(store, step + 1, (params, opt_state))
            log(f"  checkpointed @ {step + 1}")
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a card must be present) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    print("building historical trace + DeltaGraph index ...")
    gm, tmax = build_history(dev)

    params = init_model(CFG, dev)
    opt, step_fn = make_step(CFG, LR)
    opt_state = opt[0](params)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_gnn_ckpt")
    store = LogFileKV(ckpt_dir)
    start = 0
    try:
        try:
            (params, opt_state), _, start = restore_checkpoint(
                store, like=(params, opt_state))
            print(f"resumed from step {start}")
        except (FileNotFoundError, KeyError):
            pass
        stream = snapshot_stream(make_loader(gm, time_grid(tmax), tmax))
        params, opt_state, losses = train_steps(
            step_fn, params, opt_state, stream, start, args.steps, store,
            args.ckpt_every)
        save_checkpoint(store, args.steps, (params, opt_state))
    finally:
        store.close()
        gm.close()
    if losses:
        print("done — final loss", losses[-1])


if __name__ == "__main__":
    main()
