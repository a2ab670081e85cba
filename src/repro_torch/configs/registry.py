"""Architecture lookups that LM serving needs.

The port's counterpart of the LM part of ``repro/configs/registry.py``:
:func:`family_of`, :func:`get_arch` and :func:`reduced_config`.  The
reference's cells, sharding rules and optimizer state wait for the
training slice; its GNN and DIN architectures for the slice that ports
those models.
"""
from __future__ import annotations

from .lm_archs import LM_ARCHS, reduced_lm

ARCH_IDS = list(LM_ARCHS)


def family_of(arch_id: str) -> str:
    if arch_id in LM_ARCHS:
        return "lm"
    raise KeyError(f"{arch_id}: the port knows the LM architectures only "
                   f"({', '.join(ARCH_IDS)}); GNN and DIN come with a later "
                   f"slice")


def get_arch(arch_id: str):
    """``(config, optimizer name)`` of an architecture."""
    family_of(arch_id)
    return LM_ARCHS[arch_id]


def reduced_config(arch_id: str):
    """The reference's smoke-test scale of an architecture."""
    cfg, _ = get_arch(arch_id)
    return reduced_lm(cfg)
