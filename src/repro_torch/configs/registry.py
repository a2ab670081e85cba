"""Architecture × shape registry: the port's counterpart of
``repro/configs/registry.py``, shared by the launchers and the dry run.

The lookups (:func:`family_of`, :func:`shapes_for`, :func:`get_arch`,
:func:`reduced_config`) span the three families: the LMs, the four GNNs
and DIN.  ``get_cell(arch, shape, mesh, multi_pod)`` returns what the dry
run (``launch/dryrun.py``) traces for one cell: the port's step function,
its arguments as ``meta`` tensors (no allocation; Python ints in a GNN
batch stay static), and the partition spec of each argument derived from
each parameter's logical axes through the per-family rules, as the
reference derives its ``PartitionSpec``s.  A spec here is a plain tuple:
one entry per dimension, a mesh axis name, a tuple of names or ``None``.
Parameter counts and model FLOPs are the reference's formulas, term for
term.  The LM cells set ``act_spec`` and the GNN cells ``node_spec`` /
``edge_spec``, as the reference's do: their steps then carry the
reference's sharding constraints (``models/common.py::constrain``), which
the dry run's sharding pass reads.  One difference from the reference's
cells (``ROADMAP.md`` §3): a decode cell's ``cache_len`` is a Python int
(``S - 1`` on a cache of ``max_len = S``) where the reference traces an
int32 scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..graph.sampler import sampled_shapes
from ..models import common as mc
from ..models.gnn import gnn_loss, gnn_param_defs
from ..models.recsys.din import (din_forward, din_loss, din_param_defs,
                                 din_retrieval)
from ..models.transformer import model as tm
from ..training.optim import OPTIMIZERS
from ..training.trainer import make_train_step
from .gnn_archs import GNN_ARCHS, RECSYS_ARCHS, reduced_din, reduced_gnn
from .lm_archs import LM_ARCHS, LONG_CONTEXT_OK, TRAIN_ACCUM, reduced_lm
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


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def mesh_rules(mesh, multi_pod: bool) -> dict[str, Any]:
    return {
        "vocab": "model", "heads": "model", "kv": "model", "mlp": "model",
        "experts": "model", "embed": "data", "table_rows": "model",
        "layers": None,
        "batch": ("pod", "data") if multi_pod else ("data",),
        "nodes": ("data", "model"), "edges": ("data", "model"),
    }


def _divides(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """Drop mesh axes that don't divide the dimension evenly."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(mesh.shape[a] for a in axes)
        out.append(ax if dim % n == 0 else None)
    return tuple(out)


def _param_pspecs(defs: dict, rules: dict, mesh):
    return mc.tree_map_defs(
        lambda d: _divides(d.shape, mc.logical_to_spec(d.axes, rules), mesh),
        defs)


def _opt_pspecs(defs: dict, opt_name: str, rules: dict, mesh):
    """Optimizer-state specs derived from the ParamDef axes."""
    def pspec(d: mc.ParamDef) -> tuple:
        return _divides(d.shape, mc.logical_to_spec(d.axes, rules), mesh)

    if opt_name == "adamw":
        per = mc.tree_map_defs(pspec, defs)
        return {"step": (), "m": per, "v": per, "master": per}
    if opt_name == "adafactor":
        def fac(d: mc.ParamDef):
            if len(d.shape) >= 2:
                return {"vr": _divides(d.shape[:-1],
                                       mc.logical_to_spec(d.axes[:-1], rules),
                                       mesh),
                        "vc": _divides(d.shape[:-2] + d.shape[-1:],
                                       mc.logical_to_spec(
                                           d.axes[:-2] + d.axes[-1:], rules),
                                       mesh)}
            return {"v": pspec(d)}
        return {"step": (), "stats": mc.tree_map_defs(fac, defs)}
    if opt_name == "sgd":
        return {"step": (), "mom": mc.tree_map_defs(pspec, defs)}
    raise KeyError(opt_name)


def _abstract_opt_state(opt_name: str, params_abs):
    """The optimizer's ``init`` on ``meta`` parameters.  AdamW's master of
    an f32 leaf is the leaf itself (``p.float()``), as on the card."""
    init, _ = OPTIMIZERS[opt_name]()
    return init(params_abs)


def ds(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_kind: str
    fn: Callable | None
    args: tuple | None
    pspecs: tuple | None
    skip_reason: str | None = None
    flops_model: float = 0.0          # MODEL_FLOPS (6·N_active·D etc.)
    n_params: float = 0.0
    n_params_active: float = 0.0
    cfg: Any = None                   # the config the step runs


def _count_params(defs: dict) -> float:
    total = 0.0
    def walk(t):
        nonlocal total
        for v in t.values():
            if isinstance(v, mc.ParamDef):
                total += float(math.prod(v.shape))
            else:
                walk(v)
    walk(defs)
    return total


def _lm_active_params(cfg: tm.TransformerConfig) -> float:
    """Per-token active params (MoE: top-k + shared experts only)."""
    defs = tm.param_defs(cfg)
    total = _count_params(defs)
    if cfg.moe is None:
        return total
    moe = cfg.moe
    expert_full = 0.0
    for gi, (kind, L) in enumerate(cfg.layer_groups()):
        if kind in ("moe", "hybrid"):
            expert_full += L * moe.n_experts * 3 * cfg.d_model * moe.d_expert
    if cfg.mtp:  # the MTP block's experts are routed top-k as well
        expert_full += moe.n_experts * 3 * cfg.d_model * moe.d_expert
    active_frac = moe.top_k / moe.n_experts
    return total - expert_full * (1.0 - active_frac)


def _lm_attn_flops(cfg: tm.TransformerConfig, B: int, S: int,
                   kind: str) -> float:
    """Forward attention FLOPs (QKᵀ + AV), causal-halved, window-aware.
    MLA uses its per-head qk/v dims (prefill path; the absorbed decode path
    is strictly cheaper)."""
    if cfg.mla is not None:
        dqk, dv = cfg.mla.qk_nope + cfg.mla.qk_rope, cfg.mla.v_dim
    else:
        dqk = dv = cfg.head_dim
    H = cfg.n_heads
    total = 0.0
    for i in range(cfg.n_layers):
        is_global = (cfg.local_global_pattern is None or
                     (i + 1) % (cfg.local_global_pattern + 1) == 0)
        if kind == "decode":
            span = S if (is_global or cfg.window is None) else min(cfg.window, S)
            total += 2.0 * B * H * span * (dqk + dv)
        else:
            span = (S / 2 if (is_global or cfg.window is None)
                    else min(cfg.window, S))
            total += 2.0 * B * S * span * H * (dqk + dv)
    return total


def abstract_cache(cfg: tm.TransformerConfig, batch: int, max_len: int):
    """:func:`~repro_torch.models.transformer.model.init_cache`'s trees as
    ``meta`` tensors."""
    caches = []
    for _, L in cfg.layer_groups():
        if cfg.mla is not None:
            caches.append((ds((L, batch, max_len, cfg.mla.kv_lora), cfg.dtype),
                           ds((L, batch, max_len, cfg.mla.qk_rope),
                              cfg.dtype)))
        else:
            s = (L, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            caches.append((ds(s, cfg.dtype), ds(s, cfg.dtype)))
    return caches


def _lm_cell(arch_id: str, shape_id: str, mesh, multi_pod: bool) -> Cell:
    cfg, opt_name = LM_ARCHS[arch_id]
    shape = LM_SHAPES[shape_id]
    if shape_id == "long_500k" and arch_id not in LONG_CONTEXT_OK:
        return Cell(arch_id, shape_id, shape.kind, None, None, None,
                    skip_reason="pure full-attention GQA arch: 500k-token "
                    "decode needs a sub-quadratic/compressed-KV path "
                    "(DESIGN.md §4)", cfg=cfg)
    rules = mesh_rules(mesh, multi_pod)
    batch_ax = rules["batch"]
    cfg = dataclasses.replace(cfg, act_spec=(batch_ax, "model", None))
    defs = tm.param_defs(cfg)
    params_abs = mc.abstract_params(defs)
    p_specs = _param_pspecs(defs, rules, mesh)
    B, S = shape.global_batch, shape.seq_len
    n_params = _count_params(defs)
    n_active = _lm_active_params(cfg)
    tok_spec = _divides((B, S), (batch_ax, None), mesh)

    if shape.kind == "train":
        opt_abs = _abstract_opt_state(opt_name, params_abs)
        o_specs = _opt_pspecs(defs, opt_name, rules, mesh)
        step = make_train_step(lambda p, b: tm.loss_fn(p, b, cfg),
                               OPTIMIZERS[opt_name](),
                               accum_steps=TRAIN_ACCUM.get(arch_id, 1))
        args = (params_abs, opt_abs, {"tokens": ds((B, S), torch.int32)})
        specs = (p_specs, o_specs, {"tokens": tok_spec})
        # train FLOPs = 6·N_active·tokens + 3× forward attention
        flops = 6.0 * n_active * B * S + 3.0 * _lm_attn_flops(cfg, B, S, "train")
        return Cell(arch_id, shape_id, "train", step, args, specs,
                    flops_model=flops, n_params=n_params,
                    n_params_active=n_active, cfg=cfg)

    if shape.kind == "prefill":
        def prefill(p, tokens):
            return tm.prefill_step(p, tokens, cfg)
        args = (params_abs, ds((B, S), torch.int32))
        specs = (p_specs, tok_spec)
        flops = 2.0 * n_active * B * S + _lm_attn_flops(cfg, B, S, "prefill")
        return Cell(arch_id, shape_id, "prefill", prefill, args, specs,
                    flops_model=flops, n_params=n_params,
                    n_params_active=n_active, cfg=cfg)

    # decode: one token against a cache of seq_len, filled to S - 1
    cache_abs = abstract_cache(cfg, B, S)
    cache_specs_tree = []
    for kind, L in cfg.layer_groups():
        if cfg.mla is not None:
            cspec = _divides((L, B, S, cfg.mla.kv_lora),
                             (None, batch_ax, "model", None), mesh)
            kspec = _divides((L, B, S, cfg.mla.qk_rope),
                             (None, batch_ax, "model", None), mesh)
            cache_specs_tree.append((cspec, kspec))
        else:
            sp = _divides((L, B, cfg.n_kv_heads, S, cfg.head_dim),
                          (None, batch_ax, None, "model", None), mesh)
            cache_specs_tree.append((sp, sp))

    def decode(p, cache, tokens):
        return tm.decode_step(p, cache, tokens, S - 1, cfg)
    args = (params_abs, cache_abs, ds((B, 1), torch.int32))
    specs = (p_specs, cache_specs_tree,
             _divides((B, 1), (batch_ax, None), mesh))
    flops = 2.0 * n_active * B + _lm_attn_flops(cfg, B, S, "decode")
    return Cell(arch_id, shape_id, "decode", decode, args, specs,
                flops_model=flops, n_params=n_params, n_params_active=n_active,
                cfg=cfg)


def _gnn_batch_abstract(cfg, shape, rules, mesh):
    """Abstract input batch + specs per GNN arch kind and shape."""
    kind = cfg.kind
    if shape.kind == "sampled":
        # sampled training consumes the sampler's padded blocks, not the
        # full graph
        n_raw, e_raw = sampled_shapes(shape.batch_nodes, list(shape.fanouts))
        rnd = lambda v: -(-v // 512) * 512
        Np, Ep = rnd(n_raw), rnd(e_raw)
    else:
        Np, Ep = shape.padded()
    node_sp = _divides((Np,), (("data",),), mesh)  # see _gnn_cell
    edge_sp = _divides((Ep,), (rules["edges"],), mesh)
    node2 = lambda d: _divides((Np, d), (rules["nodes"], None), mesh)
    edge2 = lambda d: _divides((Ep, d), (rules["edges"], None), mesh)
    ei_sp = _divides((2, Ep), (None, rules["edges"]), mesh)

    batch: dict[str, Any] = {"edge_index": ds((2, Ep), torch.int32),
                             "edge_mask": ds((Ep,)),
                             "node_mask": ds((Np,))}
    specs: dict[str, Any] = {"edge_index": ei_sp, "edge_mask": edge_sp,
                             "node_mask": node_sp}
    G = shape.n_graphs
    if kind in ("gcn", "gin"):
        batch["x"] = ds((Np, cfg.d_in))
        specs["x"] = node2(cfg.d_in)
        if shape.kind == "batched" and kind == "gin":
            batch.update(graph_ids=ds((Np,), torch.int32),
                         labels=ds((G,), torch.int32),
                         label_mask=ds((G,)))
            specs.update(graph_ids=node_sp, labels=(), label_mask=())
            batch["n_graphs"] = G
            specs["n_graphs"] = None
        else:
            batch.update(labels=ds((Np,), torch.int32),
                         label_mask=ds((Np,)))
            specs.update(labels=node_sp, label_mask=node_sp)
    elif kind == "meshgraphnet":
        batch.update(x=ds((Np, cfg.d_node_in)),
                     edge_attr=ds((Ep, cfg.d_edge_in)),
                     target=ds((Np, cfg.d_out)))
        specs.update(x=node2(cfg.d_node_in), edge_attr=edge2(cfg.d_edge_in),
                     target=node2(cfg.d_out))
    elif kind == "dimenet":
        T = 4 * Ep  # triplets capped at 4·E (cutoff-sampled)
        t_sp = _divides((T,), (rules["edges"],), mesh)
        batch.update(z=ds((Np,), torch.int32), pos=ds((Np, 3)),
                     x=ds((Np, 1)),
                     triplet_kj=ds((T,), torch.int32),
                     triplet_ji=ds((T,), torch.int32),
                     graph_ids=ds((Np,), torch.int32),
                     target=ds((G, cfg.d_out)))
        specs.update(z=node_sp, pos=node2(3), x=node2(1),
                     triplet_kj=t_sp, triplet_ji=t_sp,
                     graph_ids=node_sp, target=())
        batch["n_graphs"] = G
        specs["n_graphs"] = None
    return batch, specs


def _gnn_cell(arch_id: str, shape_id: str, mesh, multi_pod: bool) -> Cell:
    cfg, opt_name = GNN_ARCHS[arch_id]
    shape = GNN_SHAPES[shape_id]
    rules = mesh_rules(mesh, multi_pod)
    # adapt io dims to the dataset shape
    if cfg.kind in ("gcn", "gin"):
        cfg = dataclasses.replace(cfg, d_in=shape.d_feat,
                                  n_classes=shape.n_classes)
    elif cfg.kind == "meshgraphnet":
        cfg = dataclasses.replace(cfg, d_node_in=shape.d_feat)
    # edge tensors 256-way sharded, node tensors on 'data' only (the
    # reference's choice: the step constrains its node and edge tensors)
    big_full = shape.kind == "full" and shape.n_nodes > 100_000
    extra = {}
    if big_full and cfg.kind in ("meshgraphnet", "dimenet"):
        extra["act_dtype"] = torch.bfloat16   # mixed precision at 62M edges
    cfg = dataclasses.replace(cfg, node_spec=("data",),
                              edge_spec=rules["edges"],
                              gather_chunks=32 if big_full else 0, **extra)
    defs = gnn_param_defs(cfg)
    params_abs = mc.abstract_params(defs)
    p_specs = _param_pspecs(defs, rules, mesh)
    opt_abs = _abstract_opt_state(opt_name, params_abs)
    o_specs = _opt_pspecs(defs, opt_name, rules, mesh)
    batch, b_specs = _gnn_batch_abstract(cfg, shape, rules, mesh)
    static = {k: v for k, v in batch.items() if isinstance(v, int)}

    def loss(p, b):
        return gnn_loss(p, {**b, **static}, cfg)

    step = make_train_step(loss, OPTIMIZERS[opt_name]())
    args = (params_abs, opt_abs,
            {k: v for k, v in batch.items() if not isinstance(v, int)})
    specs = (p_specs, o_specs,
             {k: v for k, v in b_specs.items()
              if not isinstance(batch[k], int)})
    # message passing flops ≈ 2 · E · d_hidden²-ish per layer: the
    # reference's gather+matmul term
    Np, Ep = shape.padded()
    depth = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", 1))
    dh = cfg.d_hidden
    flops = 2.0 * depth * (Ep * dh + Np * dh * dh) * 3  # fwd+bwd
    return Cell(arch_id, shape_id, "train", step, args, specs,
                flops_model=flops, n_params=_count_params(defs),
                n_params_active=_count_params(defs), cfg=cfg)


def _recsys_cell(arch_id: str, shape_id: str, mesh,
                 multi_pod: bool) -> Cell:
    cfg, opt_name = RECSYS_ARCHS[arch_id]
    shape = RECSYS_SHAPES[shape_id]
    rules = mesh_rules(mesh, multi_pod)
    batch_ax = rules["batch"]
    defs = din_param_defs(cfg)
    params_abs = mc.abstract_params(defs)
    p_specs = _param_pspecs(defs, rules, mesh)
    B, S = shape.batch, cfg.seq_len
    bsp = lambda *dims: _divides((B,) + dims,
                                 (batch_ax, *([None] * len(dims))), mesh)
    base = {"hist_goods": ds((B, S), torch.int32),
            "hist_cates": ds((B, S), torch.int32),
            "hist_mask": ds((B, S), torch.bool)}
    base_sp = {"hist_goods": bsp(S), "hist_cates": bsp(S),
               "hist_mask": bsp(S)}
    n_params = _count_params(defs)
    d = cfg.d_item
    if shape.kind == "train":
        batch = {**base, "target_goods": ds((B,), torch.int32),
                 "target_cates": ds((B,), torch.int32),
                 "labels": ds((B,), torch.int32)}
        specs = {**base_sp, "target_goods": bsp(), "target_cates": bsp(),
                 "labels": bsp()}
        opt_abs = _abstract_opt_state(opt_name, params_abs)
        o_specs = _opt_pspecs(defs, opt_name, rules, mesh)
        step = make_train_step(lambda p, b: din_loss(p, b, cfg),
                               OPTIMIZERS[opt_name]())
        flops = 6.0 * B * (S * 4 * d * (80 + 80 * 40 // (4 * d) + 1)
                           + 3 * d * 200 + 200 * 80)
        return Cell(arch_id, shape_id, "train", step,
                    (params_abs, opt_abs, batch),
                    (p_specs, o_specs, specs), flops_model=flops,
                    n_params=n_params, n_params_active=n_params, cfg=cfg)
    if shape.kind == "serve":
        batch = {**base, "target_goods": ds((B,), torch.int32),
                 "target_cates": ds((B,), torch.int32)}
        specs = {**base_sp, "target_goods": bsp(), "target_cates": bsp()}
        fn = lambda p, b: din_forward(p, b, cfg)
        flops = 2.0 * B * (S * 4 * d * 80 + 3 * d * 200)
        return Cell(arch_id, shape_id, "serve", fn, (params_abs, batch),
                    (p_specs, specs), flops_model=flops,
                    n_params=n_params, n_params_active=n_params, cfg=cfg)
    # retrieval: 1 user × 1e6 candidates — batched dot, not a loop
    N = shape.n_candidates
    cand_sp = _divides((B, N), (None, "data"), mesh)
    batch = {**base, "cand_goods": ds((B, N), torch.int32),
             "cand_cates": ds((B, N), torch.int32)}
    specs = {**base_sp, "cand_goods": cand_sp, "cand_cates": cand_sp}
    fn = lambda p, b: din_retrieval(p, b, cfg)
    flops = 2.0 * B * N * d
    return Cell(arch_id, shape_id, "retrieval", fn, (params_abs, batch),
                (p_specs, specs), flops_model=flops,
                n_params=n_params, n_params_active=n_params, cfg=cfg)


def get_cell(arch_id: str, shape_id: str, mesh,
             multi_pod: bool = False) -> Cell:
    """One (architecture, shape) cell under ``mesh`` (anything with a
    ``.shape`` of axis -> size: :mod:`repro_torch.launch.mesh`)."""
    fam = family_of(arch_id)
    if fam == "lm":
        return _lm_cell(arch_id, shape_id, mesh, multi_pod)
    if fam == "gnn":
        return _gnn_cell(arch_id, shape_id, mesh, multi_pod)
    return _recsys_cell(arch_id, shape_id, mesh, multi_pod)


def list_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in shapes_for(a)]
