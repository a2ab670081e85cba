"""The four GNN architectures and DIN, copied from the JAX package's
``configs/gnn_archs.py`` with the port's config classes."""
from __future__ import annotations

import dataclasses

from ..models.gnn import (DimeNetConfig, GCNConfig, GINConfig,
                          MeshGraphNetConfig)
from ..models.recsys import DINConfig

GCN_CORA = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16)
GIN_TU = GINConfig(name="gin-tu", n_layers=5, d_hidden=64, mlp_layers=2)
MESHGRAPHNET = MeshGraphNetConfig(name="meshgraphnet", n_layers=15,
                                  d_hidden=128, mlp_layers=2)
DIMENET = DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                        n_bilinear=8, n_spherical=7, n_radial=6)
DIN = DINConfig(name="din", embed_dim=18, seq_len=100,
                attn_mlp=(80, 40), out_mlp=(200, 80))

GNN_ARCHS = {
    "gcn-cora": (GCN_CORA, "adamw"),
    "gin-tu": (GIN_TU, "adamw"),
    "meshgraphnet": (MESHGRAPHNET, "adamw"),
    "dimenet": (DIMENET, "adamw"),
}

RECSYS_ARCHS = {"din": (DIN, "adamw")}


def reduced_gnn(cfg):
    if isinstance(cfg, GCNConfig):
        return dataclasses.replace(cfg, d_in=12, d_hidden=8, n_classes=3)
    if isinstance(cfg, GINConfig):
        return dataclasses.replace(cfg, n_layers=2, d_hidden=8, d_in=6,
                                   n_classes=2)
    if isinstance(cfg, MeshGraphNetConfig):
        return dataclasses.replace(cfg, n_layers=3, d_hidden=16,
                                   d_node_in=4, d_edge_in=4, d_out=2)
    if isinstance(cfg, DimeNetConfig):
        return dataclasses.replace(cfg, n_blocks=2, d_hidden=16,
                                   n_bilinear=4, n_spherical=3, n_radial=3)
    raise TypeError(cfg)


def reduced_din(cfg: DINConfig) -> DINConfig:
    return dataclasses.replace(cfg, n_goods=1000, n_cates=50, seq_len=12)
