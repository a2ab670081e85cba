"""Training launcher for the LM family, in torch: the port of
``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch gemma3-1b --steps 8 \\
        --batch 8 --seq 2048 --full-config          # on the card
    python -m repro_torch.launch.train --arch gemma3-1b --device cpu

``--arch <id>`` runs a real train loop: the reduced config by default, the
published one with ``--full-config``; seeded random weights
(``torch.Generator`` seed 0); the architecture's optimizer under a
``warmup_cosine`` schedule (20 warm-up steps over ``--steps``); synthetic
token batches from numpy's ``default_rng(0)``, as the reference draws
them; checkpoint and resume through :mod:`repro_torch.storage.checkpoint`
on a :class:`~repro_torch.storage.kv.LogFileKV` (``--ckpt-dir``, every
``--ckpt-every`` steps); ``--grad-compression bf16|int8``;
``--accum-steps`` micro-batches a step.  ``--device`` defaults to the
card, which must be present; ``--device cpu`` trains on the host.

One difference from the reference: on resume the data stream skips the
batches the checkpoint's steps consumed (its ``data_cursor``), so a
resumed run trains on what an uninterrupted run would have, and reaches
the same parameters.  The reference restarts the stream at its first batch.
The GNN and recsys families are not ported yet (``ROADMAP.md`` §1 item
6.4): their architectures raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable

import numpy as np
import torch

from ..configs.registry import family_of, get_arch, reduced_config
from ..kernels.policy import resolve_device
from ..models import common as mc
from ..storage.checkpoint import restore_checkpoint, save_checkpoint
from ..storage.kv import LogFileKV
from ..training.optim import OPTIMIZERS, warmup_cosine
from ..training.trainer import make_train_step
from ..tree_util import leaves


# the reference's GNN and recsys architectures, which the port does not
# know yet (repro/configs/gnn_archs.py)
LATER_FAMILIES = {"gcn-cora": "gnn", "gin-tu": "gnn", "meshgraphnet": "gnn",
                  "dimenet": "gnn", "din": "recsys"}


def _lm_only(arch: str) -> None:
    if arch in LATER_FAMILIES:
        raise NotImplementedError(
            f"{arch}: training the {LATER_FAMILIES[arch]} family is not "
            f"ported yet (ROADMAP.md §1 item 6.4, GNN and DIN)")
    family_of(arch)


def synth_tokens(cfg, rng: np.random.Generator, batch: int, seq: int
                 ) -> np.ndarray:
    """The reference's LM batch draw: ``rng.integers(0, vocab, (batch,
    seq))``."""
    return rng.integers(0, cfg.vocab, (batch, seq))


def synth_batch(arch: str, cfg, rng: np.random.Generator, batch: int,
                seq: int, device="cuda") -> dict:
    """``{"tokens": int32 [batch, seq]}`` on ``device`` for an LM arch."""
    _lm_only(arch)
    return {"tokens": torch.from_numpy(
        synth_tokens(cfg, rng, batch, seq).astype(np.int32)).to(
            resolve_device(device))}


def make_loss(arch: str, cfg):
    """``(loss_fn(params, batch), param_defs)`` of an LM arch."""
    _lm_only(arch)
    from ..models.transformer import model as tm
    return (lambda p, b: tm.loss_fn(p, b, cfg)), tm.param_defs(cfg)


def train(arch: str, *, steps: int = 200, batch: int = 4, seq: int = 64,
          lr: float = 3e-4, full_config: bool = False,
          ckpt_dir: str | None = None, ckpt_every: int = 100,
          grad_compression: str | None = None, accum_steps: int = 1,
          device="cuda", data: Callable | None = None,
          log: Callable = print) -> dict:
    """The train loop of :func:`main`.  ``data(step) -> batch`` replaces
    the synthetic stream (a repeated batch).  Resumes from the latest
    checkpoint in ``ckpt_dir``.  Returns ``{"params", "opt_state",
    "start", "losses", "step_s", "ckpt_s"}``: the final trees, the step it
    resumed at, each step's loss and wall seconds (ended by a device
    synchronise), and the seconds of the restore and of each save."""
    _lm_only(arch)
    dev = resolve_device(device)
    cfg, opt_name = get_arch(arch)
    if not full_config:
        cfg = reduced_config(arch)
    log(f"arch={arch} family={family_of(arch)} opt={opt_name}")
    loss_fn, defs = make_loss(arch, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mc.init_params(defs, gen, dev)
    n_params = sum(math.prod(x.shape) for x in leaves(params))
    log(f"params: {n_params / 1e6:.2f}M")

    opt = OPTIMIZERS[opt_name](lr=lr, schedule=warmup_cosine(lr, 20, steps))
    opt_state = opt[0](params)
    step_fn = make_train_step(loss_fn, opt, accum_steps=accum_steps,
                              grad_compression=grad_compression)

    store = None
    start = 0
    ckpt_s = {"restore": 0.0, "save": []}
    if ckpt_dir:
        store = LogFileKV(ckpt_dir)
        t = time.perf_counter()
        try:
            (params, opt_state), extra, start = restore_checkpoint(
                store, like=(params, opt_state))
            ckpt_s["restore"] = time.perf_counter() - t
            log(f"resumed @ step {start}")
        except (FileNotFoundError, KeyError):
            pass

    rng = np.random.default_rng(0)
    if data is None:
        for _ in range(start):          # the batches steps < start consumed
            synth_tokens(cfg, rng, batch, seq)

        def data(step):
            return synth_batch(arch, cfg, rng, batch, seq, dev)

    losses, step_s = [], []
    t0 = time.perf_counter()
    try:
        for step in range(start, steps):
            t = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, data(step))
            losses.append(float(m["loss"]))     # waits for the step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
            if (step + 1) % 20 == 0:
                dt = (time.perf_counter() - t0) / (step - start + 1)
                log(f"step {step + 1:5d}  loss {losses[-1]:.4f}  "
                    f"{dt * 1000:.0f} ms/step")
            if store and (step + 1) % ckpt_every == 0:
                t = time.perf_counter()
                save_checkpoint(store, step + 1, (params, opt_state),
                                extra={"data_cursor": step + 1})
                ckpt_s["save"].append(time.perf_counter() - t)
                log(f"checkpoint @ step {step + 1}: "
                    f"{ckpt_s['save'][-1]:.3f} s")
    finally:
        if store is not None:
            store.close()
    if losses:
        log(f"final loss {losses[-1]:.4f}")
    return {"params": params, "opt_state": opt_state, "start": start,
            "losses": losses, "step_s": step_s, "ckpt_s": ckpt_s}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (published) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a card must be present) or cpu")
    args = ap.parse_args()
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, full_config=args.full_config, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every,
          grad_compression=args.grad_compression,
          accum_steps=args.accum_steps, device=args.device)


if __name__ == "__main__":
    main()
