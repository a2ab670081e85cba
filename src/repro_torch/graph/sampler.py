"""Layer-wise neighbor sampler (GraphSAGE-style) for ``minibatch_lg``.

Real sampler, not a stub: given CSR adjacency, sample ``fanout[i]``
neighbors per hop (with replacement when degree < fanout, as in DGL's
default), producing the padded block arrays the sampled-training step
consumes.  Output shapes are static per (batch_nodes, fanouts), so the
jitted train step never recompiles.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSR


@dataclasses.dataclass
class SampledBlocks:
    """Flattened multi-hop sample.  ``nodes`` are global ids of every node
    involved (seeds first); ``edge_index`` is (src, dst) into the *local*
    node numbering; ``seed_mask`` marks the loss rows."""

    nodes: np.ndarray        # int32[N_total]
    edge_index: np.ndarray   # int32[2, E_total]
    edge_mask: np.ndarray    # bool[E_total] (False = padding)
    node_mask: np.ndarray    # bool[N_total]
    n_seeds: int


def sample_blocks(csr: CSR, seeds: np.ndarray, fanouts: list[int],
                  rng: np.random.Generator) -> SampledBlocks:
    seeds = np.asarray(seeds, np.int64)
    local_of: dict[int, int] = {int(s): i for i, s in enumerate(seeds)}
    nodes: list[int] = list(map(int, seeds))
    srcs: list[int] = []
    dsts: list[int] = []
    emask: list[bool] = []
    frontier = seeds
    for f in fanouts:
        nxt: list[int] = []
        for u in frontier:
            nb = csr.neighbors(int(u))
            du = local_of[int(u)]
            if nb.size == 0:
                # pad with self-edges (masked out)
                for _ in range(f):
                    srcs.append(du)
                    dsts.append(du)
                    emask.append(False)
                continue
            take = rng.choice(nb, size=f, replace=nb.size < f)
            for v in take:
                v = int(v)
                lv = local_of.get(v)
                if lv is None:
                    lv = len(nodes)
                    local_of[v] = lv
                    nodes.append(v)
                    nxt.append(v)
                srcs.append(lv)
                dsts.append(du)
                emask.append(True)
        frontier = np.asarray(nxt, np.int64)
    return SampledBlocks(
        np.asarray(nodes, np.int32),
        np.stack([np.asarray(srcs, np.int32), np.asarray(dsts, np.int32)]),
        np.asarray(emask, bool),
        np.ones(len(nodes), bool),
        len(seeds))


def pad_blocks(b: SampledBlocks, n_nodes_pad: int, n_edges_pad: int
               ) -> SampledBlocks:
    """Pad to static shapes for jit (extra rows masked)."""
    N, E = b.nodes.size, b.edge_index.shape[1]
    assert N <= n_nodes_pad and E <= n_edges_pad, (N, E)
    nodes = np.zeros(n_nodes_pad, np.int32)
    nodes[:N] = b.nodes
    ei = np.zeros((2, n_edges_pad), np.int32)
    ei[:, :E] = b.edge_index
    em = np.zeros(n_edges_pad, bool)
    em[:E] = b.edge_mask
    nm = np.zeros(n_nodes_pad, bool)
    nm[:N] = True
    return SampledBlocks(nodes, ei, em, nm, b.n_seeds)


def sampled_shapes(batch_nodes: int, fanouts: list[int]) -> tuple[int, int]:
    """Static padded sizes for a fanout schedule (worst case: all new)."""
    n_nodes = batch_nodes
    n_edges = 0
    frontier = batch_nodes
    for f in fanouts:
        n_edges += frontier * f
        frontier = frontier * f
        n_nodes += frontier
    return n_nodes, n_edges
