"""Generic train-step builder, in torch: the port of
``repro/training/trainer.py``.  ``loss_fn`` → gradients by
``torch.autograd`` → optional gradient accumulation and compression → the
optimizer's update.  Eager, no ``torch.compile``.

The step is a function ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` over plain trees of tensors: parameters are not
``nn.Parameter``s, and each call differentiates with respect to detached
leaves of the ``params`` it is given, so the step changes none of its
arguments.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..runtime.compression import compress_tree, decompress_tree
from ..tree_util import leaves, tree_map, unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``, as ``jax.value_and_grad(has_aux=True)``: ``grads`` in the
    parameters' dtypes and structure, ``loss`` and ``metrics`` detached."""
    ps = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, metrics = loss_fn(unflatten(params, ps), batch)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, ps)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


def make_train_step(loss_fn: Callable, optimizer: tuple[Callable, Callable],
                    *, accum_steps: int = 1,
                    grad_compression: str | None = None) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``;
    ``optimizer = (init_fn, update_fn)``.

    With ``accum_steps > 1`` every leaf of the batch is cut along its
    first dim into that many micro-batches (micro-batch i: rows ``[i·b,
    (i+1)·b)``); their gradients are summed in f32, one micro-batch at a
    time, then divided by ``accum_steps``; the metrics are the last
    micro-batch's (the sum is one f32 tree added to in place, where the
    reference's scan carries it).  ``grad_compression`` (``"bf16"`` or
    ``"int8"``, :mod:`repro_torch.runtime.compression`; int8 draws its
    noise from seed 0 every step, as the reference's default key) packs
    and unpacks the gradients before the update."""
    _, update_fn = optimizer

    def step(params, opt_state, batch):
        if accum_steps == 1:
            (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(accum_steps):
                mb = tree_map(lambda x: x.reshape(
                    (accum_steps, -1) + tuple(x.shape[1:]))[i], batch)
                (_, metrics), g = value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)        # in place: no second f32 copy
                del g
            grads = tree_map(lambda g: g / accum_steps, grads)
        if grad_compression is not None:
            packed = compress_tree(grads, kind=grad_compression)
            grads = decompress_tree(packed, like=grads)
        new_params, new_state = update_fn(grads, opt_state, params)
        return new_params, new_state, metrics

    return step


def make_eval_step(loss_fn: Callable) -> Callable:
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return step
