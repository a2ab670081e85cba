"""Evolution analysis (paper fig 1), in torch: track top-PageRank nodes
across the network's history using multipoint retrieval + batched
PageRank over GraphPool planes, plus 'new triangles this period' (§1's
example query).  The port of ``examples/evolution_analysis.py``; it
prints the same lines.

Run:  PYTHONPATH=src python examples/pt_evolution_analysis.py [--device cpu]

``--device`` defaults to the card, which must be present: PageRank over
the stacked planes (:func:`repro_torch.graph.algorithms
.multi_snapshot_pagerank`, ``index_add_`` steps) runs there.  Retrieval
and the triangle counts run on the host, as in the reference.  The steps
are functions, so that another history (a ``GraphManager`` of one's own)
can be analysed the same way.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import GraphManager
from repro_torch.data.generators import growing_network
from repro_torch.graph.algorithms import multi_snapshot_pagerank, triangle_count
from repro_torch.kernels.policy import resolve_device

EPOCHS = 6
ITERS = 30


def build_history(device="cuda"):
    """The example's growing network and its ``GraphManager``; returns
    ``(gm, tmax)``."""
    uni, ev = growing_network(n_events=8000, seed=3, n_attrs=0)
    gm = GraphManager(uni, ev, L=500, k=4, device=device)
    return gm, int(ev.time[-1])


def epoch_times(tmax: int, n: int = EPOCHS) -> list[int]:
    """``n`` points from a fifth of the history to its end."""
    return [int(t) for t in np.linspace(tmax * 0.2, tmax, n)]


def retrieve(gm: GraphManager, epochs: list[int]):
    """One multipoint (Steiner) retrieval for all epochs: ``(hist graphs,
    node planes [G, W_n], edge planes [G, W_e])``."""
    hs = gm.get_hist_graphs(epochs)
    nps, eps = gm.pool.stacked_planes([h.gid for h in hs])
    return hs, nps, eps


def pagerank(gm: GraphManager, nps, eps, device="cuda",
             iters: int = ITERS) -> torch.Tensor:
    """PageRank of every epoch's snapshot in one batched solve on
    ``device``: ``[G, N]``."""
    uni = gm.universe
    return multi_snapshot_pagerank(uni.edge_src, uni.edge_dst, eps, nps,
                                   num_nodes=uni.num_nodes, iters=iters,
                                   device=device)


def rank_table(uni, prs: np.ndarray, epochs: list[int], top: int = 5
               ) -> list[str]:
    """The fig-1 table: the final top nodes' ranks at every epoch."""
    lines = ["node " + " ".join(f"t={t:>6d}" for t in epochs)]
    for n in np.argsort(-prs[-1])[:top]:
        ranks = []
        for i in range(len(epochs)):
            order = np.argsort(-prs[i])
            ranks.append(int(np.nonzero(order == n)[0][0]) + 1)
        lines.append(f"{uni.node_ids[n]!s:>4} "
                     + " ".join(f"{r:>8d}" for r in ranks))
    return lines


def triangle_lines(uni, hs, epochs: list[int]) -> list[str]:
    """Triangles up to each epoch and the new ones since the last."""
    lines, prev = [], 0
    for h, t in zip(hs, epochs):
        tri = triangle_count(uni.edge_src, uni.edge_dst, h.edge_mask,
                             uni.num_nodes)
        lines.append(f"  up to t={t:>6d}: {tri:>6d} triangles "
                     f"(+{tri - prev})")
        prev = tri
    return lines


def analyse(gm: GraphManager, epochs: list[int], device="cuda",
            log=print) -> np.ndarray:
    """The whole analysis over ``epochs``, printed to ``log``; returns the
    PageRank planes ``[G, N]`` (host)."""
    hs, nps, eps = retrieve(gm, epochs)
    log("vmapped PageRank over", len(epochs), "snapshots ...")
    prs = pagerank(gm, nps, eps, device).cpu().numpy()
    log("\nrank evolution of the final top-5 nodes (fig 1 style):")
    for line in rank_table(gm.universe, prs, epochs):
        log(line)
    log("\nnew triangles per period (§1 example query):")
    for line in triangle_lines(gm.universe, hs, epochs):
        log(line)
    for h in hs:
        h.close()
    return prs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a card must be present) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    print("building a growing co-authorship-style network ...")
    gm, tmax = build_history(dev)
    try:
        analyse(gm, epoch_times(tmax), dev)
    finally:
        gm.close()


if __name__ == "__main__":
    main()
