"""Optimizers as pure tree transforms, in torch: the port of
``repro/training/optim.py``.

* :func:`adamw`     — bf16/f32 params with an f32 master copy and f32
  moments; the default for the dense models.
* :func:`adafactor` — factored second moment, no master copy; the choice
  for the two MoE models.
* :func:`sgd`       — momentum SGD.

Each returns ``(init_fn, update_fn)``; ``update_fn(grads, state, params)
-> (new_params, new_state)`` builds new tensors and changes none of its
arguments.  Gradient clipping and the learning-rate schedule are closed
over.  The state trees have the reference's keys (``{"step", "m", "v",
"master"}``, ``{"step", "stats"}`` with ``{"vr", "vc"}`` or ``{"v"}`` per
leaf, ``{"step", "mom"}``) and ``step`` is an int32 0-d tensor, so a state
carries over leaf for leaf (:func:`repro_torch.interop.opt_state_from_reference`,
:mod:`repro_torch.storage.checkpoint`).  Everything is computed in f32 on
the parameters' device; like the reference's, ``adamw`` casts its master
back to the parameter dtype every step, so bf16 parameters round each
step while the master keeps the f32 value.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..tree_util import flatten_with_paths, leaves, tree_map, unflatten


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves summed in
    flatten order as the reference's Python ``sum`` does."""
    total = None
    for leaf in leaves(tree):
        sq = torch.sum(leaf.float() ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip(grads, max_norm):
    if max_norm is None:
        return grads
    g = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), grads)


def warmup_cosine(base_lr: float, warmup: int = 100, total: int = 10_000,
                  min_frac: float = 0.1) -> Callable:
    """``lr(step)`` for an int tensor ``step``: linear warm-up over
    ``warmup`` steps, then a cosine from ``base_lr`` down to ``min_frac``
    of it at ``total``; an f32 0-d tensor."""
    def lr(step):
        step = step.float()
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * w * cos
    return lr


def _constant(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def _step0(params) -> torch.Tensor:
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          clip_norm=1.0, schedule: Callable | None = None):
    lr_fn = schedule or _constant(lr)

    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"step": _step0(params),
                "m": tree_map(f32, params),
                "v": tree_map(f32, params),
                "master": tree_map(lambda p: p.float(), params)}

    def update(grads, state, params):
        grads = _clip(grads, clip_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        ms, vs, masters, new_params = [], [], [], []
        for g, m, v, master, p in zip(leaves(grads), leaves(state["m"]),
                                      leaves(state["v"]),
                                      leaves(state["master"]),
                                      leaves(params)):
            g = g.float()
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            new_master = master - lr_t * (u + weight_decay * master)
            ms.append(m2)
            vs.append(v2)
            masters.append(new_master)
            new_params.append(new_master.to(p.dtype))
        return (unflatten(params, new_params),
                {"step": step, "m": unflatten(params, ms),
                 "v": unflatten(params, vs),
                 "master": unflatten(params, masters)})

    return init, update


def _stats_at(stats: dict, path: tuple) -> dict:
    for key in path:
        stats = stats[key]
    return stats


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_norm=1.0,
              schedule: Callable | None = None):
    """Factored second moment (Shazeer & Stern, arXiv:1804.04235), no
    first moment, no master copy: O(n+m) state per n×m matrix."""
    lr_fn = schedule or _constant(lr)

    def init(params):
        def fac(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"step": _step0(params),
                "stats": unflatten(params, [fac(p) for p in leaves(params)])}

    def update(grads, state, params):
        grads = _clip(grads, clip_norm)
        step = state["step"] + 1
        beta = 1.0 - (step.float() + 1) ** -decay
        lr_t = lr_fn(step)
        new_params, new_stats = [], []
        for (path, p), g in zip(flatten_with_paths(params), leaves(grads)):
            st = _stats_at(state["stats"], path)
            g = g.float()
            if p.dim() >= 2:
                vr = beta * st["vr"] + (1 - beta) * (g * g).mean(-1)
                vc = beta * st["vc"] + (1 - beta) * (g * g).mean(-2)
                rfac = torch.rsqrt(vr / torch.clamp(
                    vr.mean(-1, keepdim=True), min=eps) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                new_stats.append({"vr": vr, "vc": vc})
            else:
                v = beta * st["v"] + (1 - beta) * g * g
                u = g * torch.rsqrt(v + eps)
                new_stats.append({"v": v})
            # update clipping (RMS <= 1) per the paper
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms, min=1.0)
            new_params.append((p.float() - lr_t * u).to(p.dtype))
        return (unflatten(params, new_params),
                {"step": step, "stats": unflatten(params, new_stats)})

    return init, update


def sgd(lr=1e-2, momentum=0.9, clip_norm=None,
        schedule: Callable | None = None):
    lr_fn = schedule or _constant(lr)

    def init(params):
        return {"step": _step0(params),
                "mom": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params):
        grads = _clip(grads, clip_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        moms, new_params = [], []
        for g, m, p in zip(leaves(grads), leaves(state["mom"]),
                           leaves(params)):
            m2 = momentum * m + g.float()
            moms.append(m2)
            new_params.append((p.float() - lr_t * m2).to(p.dtype))
        return (unflatten(params, new_params),
                {"step": step, "mom": unflatten(params, moms)})

    return init, update


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}
