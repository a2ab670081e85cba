"""Input shapes per architecture family, copied from the JAX package's
``configs/shapes.py`` (framework-free), plus padded static sizes for the
GNN regimes."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


LM_SHAPES = {
    "train_4k": LMShape("train_4k", 4096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": LMShape("decode_32k", 32768, 128, "decode"),
    "long_500k": LMShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int
    kind: str                      # 'full' | 'sampled' | 'batched'
    n_graphs: int = 1
    batch_nodes: int = 0
    fanouts: tuple[int, ...] = ()
    n_classes: int = 7

    def padded(self) -> tuple[int, int]:
        """Static (N, E) rounded to multiples of 512 for even sharding."""
        rnd = lambda v: -(-v // 512) * 512
        return rnd(self.n_nodes), rnd(self.n_edges)


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", 2_708, 10_556, 1_433, "full",
                              n_classes=7),
    # reddit-scale sampled training: fanout (15, 10) from 1,024 seeds
    "minibatch_lg": GNNShape("minibatch_lg", 232_965, 114_615_892, 602,
                             "sampled", batch_nodes=1_024, fanouts=(15, 10),
                             n_classes=41),
    "ogb_products": GNNShape("ogb_products", 2_449_029, 61_859_140, 100,
                             "full", n_classes=47),
    "molecule": GNNShape("molecule", 30, 64, 16, "batched", n_graphs=128,
                         n_classes=2),
}


@dataclasses.dataclass(frozen=True)
class RecSysShape:
    name: str
    batch: int
    kind: str                      # 'train' | 'serve' | 'retrieval'
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecSysShape("train_batch", 65_536, "train"),
    "serve_p99": RecSysShape("serve_p99", 512, "serve"),
    "serve_bulk": RecSysShape("serve_bulk", 262_144, "serve"),
    "retrieval_cand": RecSysShape("retrieval_cand", 1, "retrieval",
                                  n_candidates=1_000_000),
}
