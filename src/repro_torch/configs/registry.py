"""Architecture lookups: the port's counterpart of the lookups of
``repro/configs/registry.py`` (:func:`family_of`, :func:`shapes_for`,
:func:`get_arch`, :func:`reduced_config`) over the three families, the
LMs, the four GNNs and DIN.  The reference's cells, mesh rules and
sharding helpers belong to its dry run and are not ported here.
"""
from __future__ import annotations

from .gnn_archs import GNN_ARCHS, RECSYS_ARCHS, reduced_din, reduced_gnn
from .lm_archs import LM_ARCHS, reduced_lm
from .shapes import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES

ARCH_IDS = list(LM_ARCHS) + list(GNN_ARCHS) + list(RECSYS_ARCHS)


def family_of(arch_id: str) -> str:
    if arch_id in LM_ARCHS:
        return "lm"
    if arch_id in GNN_ARCHS:
        return "gnn"
    if arch_id in RECSYS_ARCHS:
        return "recsys"
    raise KeyError(arch_id)


def shapes_for(arch_id: str) -> list[str]:
    return list({"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                 "recsys": RECSYS_SHAPES}[family_of(arch_id)])


def get_arch(arch_id: str):
    """``(config, optimizer name)`` of an architecture."""
    fam = family_of(arch_id)
    table = {"lm": LM_ARCHS, "gnn": GNN_ARCHS, "recsys": RECSYS_ARCHS}[fam]
    return table[arch_id]


def reduced_config(arch_id: str):
    """The reference's smoke-test scale of an architecture."""
    cfg, _ = get_arch(arch_id)
    fam = family_of(arch_id)
    if fam == "lm":
        return reduced_lm(cfg)
    if fam == "gnn":
        return reduced_gnn(cfg)
    return reduced_din(cfg)
