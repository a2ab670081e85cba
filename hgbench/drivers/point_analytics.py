"""Point analytics: one snapshot a request, landed with its analytics.

The call: ``torch_exec.execute_singlepoint_fused(dg, t, node_weights=w)``
(the planner, the chain's lowering, the fused kernel for both planes),
then ``degrees()`` (host bucketing and the segment-sum kernel, by source
and by destination), ``num_nodes()``, ``num_edges()`` and
``node.weighted_total()``, all on the host when the request ends.  ``w``
is one seeded f32 weight a node, made in set-up.

Every answer of the window is kept and compared with the reference:
the two masks bit for bit, the counts and the degrees exactly, and the
weighted total against the reference's float64 sum, relatively.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from hgbench import traffic
from hgbench.history import ADD_NODE
from hgbench.reference import count_differing, weighted_total

# The exact numbers' limit is 0.  The weighted total's is the
# configuration's (``limits``), set between the program's largest gap and
# the bfloat16 control's smallest on the card (``limits_from``).
EXACT = ("mask_bits_wrong", "count_errors", "degree_errors")
WEIGHTS_STREAM = 3


@dataclasses.dataclass
class Answer:
    t: int
    node_bits: np.ndarray       # packed masks (np.packbits)
    edge_bits: np.ndarray
    sizes: tuple[int, int]
    degrees: np.ndarray
    num_nodes: int
    num_edges: int
    weighted_total: float


@dataclasses.dataclass
class State:
    weights: np.ndarray
    kept: list


def prepare(ctx) -> State:
    n = int((ctx.hist.kind == ADD_NODE).sum())
    rng = traffic.rng_for(ctx.seed, WEIGHTS_STREAM)
    return State(rng.random(n, dtype=np.float32), [])


def call(ctx, state: State, times):
    from repro_torch.runtime import torch_exec
    (t,) = times
    nm, em, an = torch_exec.execute_singlepoint_fused(
        ctx.dg, t, node_weights=state.weights, device=ctx.device)
    return (nm, em, an.degrees(), an.num_nodes(), an.num_edges(),
            float(an.node.weighted_total())), 1


def after(ctx, state: State, index: int, times, answer) -> None:
    if index < 0:
        return
    nm, em, deg, n, e, w = answer
    state.kept.append(Answer(times[0], np.packbits(nm), np.packbits(em),
                             (nm.size, em.size), deg, int(n), int(e), w))



def numbers(answers, replay, weights) -> list[tuple[str, float]]:
    """The compared numbers of ``answers`` (the program's or a control's)
    against the reference."""
    bits = counts = degs = 0
    gap = 0.0
    for a in answers:
        nm = np.unpackbits(a.node_bits, count=a.sizes[0]).astype(bool)
        em = np.unpackbits(a.edge_bits, count=a.sizes[1]).astype(bool)
        rn, re = replay.masks(a.t)
        bits += count_differing(nm, rn) + count_differing(em, re)
        counts += (a.num_nodes != int(rn.sum())) + (a.num_edges != int(re.sum()))
        degs += count_differing(np.asarray(a.degrees), replay.degrees(re))
        ref = weighted_total(rn, weights)
        gap = max(gap, abs(a.weighted_total - ref) / abs(ref) if ref
                  else abs(a.weighted_total))
    return [("mask_bits_wrong", bits), ("count_errors", counts),
            ("degree_errors", degs), ("weighted_total_rel_gap", gap)]


def check(ctx, state: State, replay) -> list[tuple[str, float, float]]:
    limits = {n: 0 for n in EXACT} | ctx.config["limits"]
    return [(n, v, limits[n]) for n, v in
            numbers(state.kept, replay, state.weights)]


def _kernel_total(node_mask: np.ndarray, weights: np.ndarray) -> float:
    """The fused kernel's weighted total of f32 ``weights``: each word's 32
    slots added in slot order in f32, the words' partials summed on the
    host in f32, as ``node.weighted_total()`` does."""
    W = -(-node_mask.size // 32)
    w = np.zeros(W * 32, np.float32)
    w[:weights.size] = weights
    m = np.zeros(W * 32, bool)
    m[:node_mask.size] = node_mask
    w = np.where(m, w, np.float32(0)).reshape(W, 32)
    acc = np.zeros(W, np.float32)
    for j in range(32):
        acc = acc + w[:, j]
    return float(acc.sum(dtype=np.float32))


def control(ctx, state: State, replay) -> dict[str, list[tuple[str, float]]]:
    """The controls' numbers on the window's requests.  ``bf16``: the
    reference in the program's place with the weights stored in bfloat16
    (the precision below the configuration's f32).  ``stale``: the
    reference answering from the last leaf boundary before each ``t``,
    which breaks the exact-snapshot guarantee."""
    import torch
    w16 = (torch.from_numpy(state.weights).to(ctx.device)
           .to(torch.bfloat16).float().cpu().numpy())
    L = ctx.config["index"]["L"]
    out = {}
    for name in ("bf16", "stale"):
        answers = []
        for a in state.kept:
            nm, em = (replay.masks(a.t) if name == "bf16"
                      else replay.stale_masks(a.t, L))
            total = _kernel_total(nm, w16 if name == "bf16"
                                  else state.weights)
            answers.append(Answer(a.t, np.packbits(nm), np.packbits(em),
                                  (nm.size, em.size),
                                  replay.degrees(em).astype(np.float32),
                                  int(nm.sum()), int(em.sum()), total))
        out[name] = numbers(answers, replay, state.weights)
    return out
