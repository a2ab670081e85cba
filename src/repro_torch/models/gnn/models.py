"""The four GNN architectures, on segment-op message passing, in torch: the
port of ``repro/models/gnn/models.py``.

Message passing is gather (``x[src]``, ``index_select``) → transform →
segment sum (``index_add`` into zeros) over ``edge_index``.  On the card
``index_add`` adds with float atomics, so aggregation there changes its
order from run to run; the CPU adds in index order.

* **gcn-cora**       [arXiv:1609.02907]  2 layers, d=16, symmetric norm.
* **gin-tu**         [arXiv:1810.00826]  5 layers, d=64, sum agg,
  learnable ε, graph-level readout for batched molecule graphs.
* **meshgraphnet**   [arXiv:2010.03409]  encode-process-decode, 15 MP
  steps, d=128, 2-layer MLPs, edge+node features, sum aggregation.
* **dimenet**        [arXiv:2003.03123]  directional message passing:
  radial Bessel + spherical basis over (kj → ji) edge-triplets, 6 blocks,
  d=128, 8 bilinear.

Every config shares the batch contract: node features ``x [N, F]``,
``edge_index [2, E]`` (src, dst), optional per-graph ids for readout,
padding masks for static shapes.  Python ints in a batch (``n_graphs``)
stay ints.  The configs keep the reference's fields, ``node_spec``,
``edge_spec`` and ``gather_chunks`` included, so they compare equal to the
reference's; the two specs name mesh axes and have no effect on one card.
Each MeshGraphNet layer and DimeNet block is a non-reentrant
``torch.utils.checkpoint``, as the reference ``jax.checkpoint``-s them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common import ParamDef, cross_entropy, seg_sum


def _cg_impl(x: torch.Tensor, idx: torch.Tensor, n_chunks: int
             ) -> torch.Tensor:
    """``x[idx]`` chunk by chunk of ``x``'s rows (padded to a multiple of
    ``n_chunks``): each chunk's hits are gathered and added in."""
    N, D = x.shape
    C = -(-N // n_chunks)
    Npad = C * n_chunks
    if Npad != N:
        x = F.pad(x, (0, 0, 0, Npad - N))
    acc = torch.zeros((idx.shape[0], D), dtype=x.dtype, device=x.device)
    for c in range(n_chunks):
        local = idx - c * C
        hit = (local >= 0) & (local < C)
        vals = x[c * C:(c + 1) * C].index_select(0, local.clamp(0, C - 1))
        acc = acc + torch.where(hit[:, None], vals, 0)
    return acc


def _css_impl(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
              n_chunks: int) -> torch.Tensor:
    """segment sum in destination chunks of ``ceil(num_segments /
    n_chunks)`` segments, concatenated and cut back to ``num_segments``."""
    C = -(-num_segments // n_chunks)
    parts = []
    for c in range(n_chunks):
        local = ids - c * C
        hit = (local >= 0) & (local < C)
        parts.append(seg_sum(torch.where(hit[:, None], data, 0),
                             local.clamp(0, C - 1), C))
    return torch.cat(parts)[:num_segments]


class ChunkedGather(torch.autograd.Function):
    """``x[idx]`` without gathering from the whole operand at once; the
    backward is the adjoint :func:`_css_impl`, so only ``idx`` and ``N``
    are saved (the reference's ``chunked_gather`` ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, idx, n_chunks: int):
        ctx.save_for_backward(idx)
        ctx.N, ctx.n_chunks = x.shape[0], n_chunks
        return _cg_impl(x, idx, n_chunks)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _css_impl(g, idx, ctx.N, ctx.n_chunks), None, None


class ChunkedSegmentSum(torch.autograd.Function):
    """segment sum in destination chunks; the backward is the adjoint
    :func:`_cg_impl`, saving only ``ids`` (the reference's
    ``chunked_segment_sum`` ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments: int, n_chunks: int):
        ctx.save_for_backward(ids)
        ctx.n_chunks = n_chunks
        return _css_impl(data, ids, num_segments, n_chunks)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _cg_impl(g, ids, ctx.n_chunks), None, None, None


def chunked_gather(x: torch.Tensor, idx: torch.Tensor, n_chunks: int
                   ) -> torch.Tensor:
    return ChunkedGather.apply(x, idx, n_chunks)


def chunked_segment_sum(data: torch.Tensor, ids: torch.Tensor,
                        num_segments: int, n_chunks: int) -> torch.Tensor:
    return ChunkedSegmentSum.apply(data, ids, num_segments, n_chunks)


def _gather(x: torch.Tensor, idx: torch.Tensor, n_chunks: int
            ) -> torch.Tensor:
    if n_chunks and n_chunks > 1:
        return chunked_gather(x, idx, n_chunks)
    return x.index_select(0, idx)


def _mlp_defs(name: str, dims: list[int], dt=torch.float32) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{name}_w{i}"] = ParamDef((a, b), (None, None), dt)
        out[f"{name}_b{i}"] = ParamDef((b,), (None,), dt, "zeros")
    return out


def _mlp(p, name: str, x, n_layers: int, act=torch.relu, norm: bool = False):
    for i in range(n_layers):
        x = x @ p[f"{name}_w{i}"] + p[f"{name}_b{i}"]
        if i < n_layers - 1:
            x = act(x)
    if norm:
        # the population variance, as jnp's x.var
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        x = (x - mu) * torch.rsqrt(var + 1e-6)
    return x


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    n_classes: int = 7
    kind: str = "gcn"
    node_spec: tuple | None = None
    edge_spec: tuple | None = None
    gather_chunks: int = 0


def _gcn_defs(cfg: GCNConfig) -> dict:
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = ParamDef((a, b), (None, None), torch.float32)
        out[f"b{i}"] = ParamDef((b,), (None,), torch.float32, "zeros")
    return out


def _gcn_forward(p, batch, cfg: GCNConfig):
    x = batch["x"]
    src, dst = batch["edge_index"]
    N = x.shape[0]
    emask = batch.get("edge_mask")
    # edge_index carries both directions for undirected graphs; degree is
    # in-degree at dst (+1 for the implicit self loop, Kipf & Welling eq. 2)
    ones = torch.ones(src.shape, dtype=torch.float32, device=x.device)
    if emask is not None:
        ones = ones * emask
    deg = seg_sum(ones, dst, N) + 1.0
    norm = torch.rsqrt(deg)
    norm_src = norm.index_select(0, src)[:, None]
    for i in range(cfg.n_layers):
        h = x @ p[f"w{i}"]
        m = _gather(h, src, cfg.gather_chunks) * norm_src
        if emask is not None:
            m = m * emask[:, None]
        agg = seg_sum(m, dst, N) * norm[:, None] + h * norm[:, None] ** 2
        x = agg + p[f"b{i}"]
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 16
    n_classes: int = 2
    mlp_layers: int = 2
    kind: str = "gin"
    node_spec: tuple | None = None
    edge_spec: tuple | None = None
    gather_chunks: int = 0


def _gin_defs(cfg: GINConfig) -> dict:
    out = {"eps": ParamDef((cfg.n_layers,), (None,), torch.float32, "zeros")}
    d_prev = cfg.d_in
    for l in range(cfg.n_layers):
        out.update(_mlp_defs(f"mlp{l}",
                             [d_prev] + [cfg.d_hidden] * cfg.mlp_layers))
        d_prev = cfg.d_hidden
    out.update(_mlp_defs("readout", [cfg.d_hidden, cfg.n_classes]))
    return out


def _gin_forward(p, batch, cfg: GINConfig):
    x = batch["x"]
    src, dst = batch["edge_index"]
    N = x.shape[0]
    emask = batch.get("edge_mask")
    for l in range(cfg.n_layers):
        m = _gather(x, src, cfg.gather_chunks)
        if emask is not None:
            m = m * emask[:, None]
        agg = seg_sum(m, dst, N)
        x = _mlp(p, f"mlp{l}", (1.0 + p["eps"][l]) * x + agg,
                 cfg.mlp_layers, norm=True)
        x = torch.relu(x)
    if "graph_ids" in batch:  # graph-level readout (molecule batches)
        G = batch["n_graphs"]
        nm = batch.get("node_mask")
        xm = x if nm is None else x * nm[:, None]
        pooled = seg_sum(xm, batch["graph_ids"], G)
        return _mlp(p, "readout", pooled, 1)
    return _mlp(p, "readout", x, 1)


# ---------------------------------------------------------------------------
# MeshGraphNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4
    d_out: int = 3
    kind: str = "meshgraphnet"
    node_spec: tuple | None = None
    edge_spec: tuple | None = None
    gather_chunks: int = 0
    act_dtype: Any = torch.float32


def _mgn_defs(cfg: MeshGraphNetConfig) -> dict:
    h, m = cfg.d_hidden, cfg.mlp_layers
    out = {}
    out.update(_mlp_defs("enc_node", [cfg.d_node_in] + [h] * m))
    out.update(_mlp_defs("enc_edge", [cfg.d_edge_in] + [h] * m))
    for l in range(cfg.n_layers):
        out.update(_mlp_defs(f"edge{l}", [3 * h] + [h] * m))
        out.update(_mlp_defs(f"node{l}", [2 * h] + [h] * m))
    out.update(_mlp_defs("dec", [h] * m + [cfg.d_out]))
    return out


def _mgn_forward(p, batch, cfg: MeshGraphNetConfig):
    src, dst = batch["edge_index"]
    N = batch["x"].shape[0]
    m = cfg.mlp_layers
    h_n = _mlp(p, "enc_node", batch["x"], m, norm=True).to(cfg.act_dtype)
    h_e = _mlp(p, "enc_edge", batch["edge_attr"], m, norm=True).to(
        cfg.act_dtype)

    def mp_layer(l, h_n, h_e):
        e_in = torch.cat([h_e, _gather(h_n, src, cfg.gather_chunks),
                          _gather(h_n, dst, cfg.gather_chunks)], dim=-1)
        h_e = h_e + _mlp(p, f"edge{l}", e_in, m, norm=True)
        if cfg.gather_chunks:
            agg = chunked_segment_sum(h_e, dst, N, cfg.gather_chunks)
        else:
            agg = seg_sum(h_e, dst, N)
        n_in = torch.cat([h_n, agg], dim=-1)
        h_n = h_n + _mlp(p, f"node{l}", n_in, m, norm=True)
        return h_n, h_e

    # recompute each message-passing layer in the backward instead of
    # keeping 15 layers' residuals
    for l in range(cfg.n_layers):
        h_n, h_e = checkpoint(mp_layer, l, h_n, h_e, use_reentrant=False)
        h_n = h_n.to(cfg.act_dtype)
        h_e = h_e.to(cfg.act_dtype)
    return _mlp(p, "dec", h_n.float(), m)


# ---------------------------------------------------------------------------
# DimeNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_out: int = 1
    kind: str = "dimenet"
    node_spec: tuple | None = None
    edge_spec: tuple | None = None
    gather_chunks: int = 0
    act_dtype: Any = torch.float32


def _dimenet_defs(cfg: DimeNetConfig) -> dict:
    h = cfg.d_hidden
    out = {
        "emb_z": ParamDef((95, h), (None, None), torch.float32),
        "rbf_w": ParamDef((cfg.n_radial, h), (None, None), torch.float32),
        "sbf_w": ParamDef((cfg.n_spherical * cfg.n_radial, cfg.n_bilinear),
                          (None, None), torch.float32),
    }
    out.update(_mlp_defs("edge_emb", [3 * h, h]))
    for b in range(cfg.n_blocks):
        out[f"bil{b}"] = ParamDef((h, cfg.n_bilinear, h), (None, None, None),
                                  torch.float32)
        out.update(_mlp_defs(f"msg{b}", [h, h, h]))
        out.update(_mlp_defs(f"upd{b}", [h, h]))
        out.update(_mlp_defs(f"out{b}", [h, h]))
    out.update(_mlp_defs("head", [h, h, cfg.d_out]))
    return out


def _bessel_rbf(d, n_radial, cutoff):
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    dc = torch.clamp(d / cutoff, 1e-6, 1.0)
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * dc[..., None]) / (
        d[..., None] + 1e-6)


def _angular_sbf(angle, d, n_spherical, n_radial, cutoff):
    ls = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    cosl = torch.cos(angle[..., None] * (ls + 1.0))        # simplified basis
    rad = _bessel_rbf(d, n_radial, cutoff)                 # [T, n_radial]
    return (cosl[..., :, None] * rad[..., None, :]).reshape(
        angle.shape[0], n_spherical * n_radial)


def _wedge_cos(v1, v2):
    """The cosine of each triplet's angle as the reference computes it.
    Its denominator has ``jnp.linalg.norm(v2 + 1e-9, -1)``: the -1 is the
    ord, not the axis, so that factor is the matrix (-1)-norm of the whole
    ``[T, 3]`` array, the smallest column sum of ``|.|``, one scalar for
    every triplet.  A property of the reference, kept (``ROADMAP.md``
    §3)."""
    return (v1 * v2).sum(-1) / (
        torch.linalg.vector_norm(v1 + 1e-9, dim=-1)
        * (v2 + 1e-9).abs().sum(0).min())


def _bilinear(g, bil, w):
    """``einsum("th,hbk,tb->tk", g, bil, w)`` as one product over ``(b,
    h)``: ``w ⊗ g`` ``[T, b·h]`` against ``bil`` laid out ``[b·h, k]``, so
    the largest live intermediate is ``[T, b, h]``."""
    T, h = g.shape
    nb, k = bil.shape[1], bil.shape[2]
    outer = (w[:, :, None] * g[:, None, :]).reshape(T, nb * h)
    return outer @ bil.permute(1, 0, 2).reshape(nb * h, k)


def _dimenet_forward(p, batch, cfg: DimeNetConfig):
    """batch: z [N] atom types, pos [N, 3], edge_index [2, E],
    triplets (t_kj, t_ji) indices into edges with k→j→i wedges,
    graph_ids [N] for energy readout."""
    z, pos = batch["z"], batch["pos"]
    src, dst = batch["edge_index"]
    t_kj, t_ji = batch["triplet_kj"], batch["triplet_ji"]
    N, E = z.shape[0], src.shape[0]
    vec = pos.index_select(0, dst) - pos.index_select(0, src)
    dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
    rbf = _bessel_rbf(dist, cfg.n_radial, cfg.cutoff)      # [E, R]
    h_z = p["emb_z"].index_select(0, z)
    m = torch.cat([h_z.index_select(0, src), h_z.index_select(0, dst),
                   rbf @ p["rbf_w"]], dim=-1)
    m = F.silu(_mlp(p, "edge_emb", m, 1)).to(cfg.act_dtype)  # [E, h]
    # triplet geometry: angle between edge ji and edge kj at vertex j
    cosang = _wedge_cos(vec.index_select(0, t_ji), -vec.index_select(0, t_kj))
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = _angular_sbf(angle, dist.index_select(0, t_kj), cfg.n_spherical,
                       cfg.n_radial, cfg.cutoff)           # [T, S*R]
    out_energy = 0.0
    G = batch.get("n_graphs", 1)
    gids = batch.get("graph_ids")
    if gids is None:
        gids = torch.zeros(N, dtype=torch.int32, device=z.device)

    def block(b, m, out_energy):
        mk = F.silu(_mlp(p, f"msg{b}", m, 2))
        w = sbf @ p["sbf_w"]                                # [T, n_bilinear]
        inter = _bilinear(_gather(mk, t_kj, cfg.gather_chunks),
                          p[f"bil{b}"], w)
        if cfg.gather_chunks:
            agg = chunked_segment_sum(inter, t_ji, E, cfg.gather_chunks)
        else:
            agg = seg_sum(inter, t_ji, E)
        m = m + F.silu(_mlp(p, f"upd{b}", agg, 1))
        mo = F.silu(_mlp(p, f"out{b}", m, 1))
        if cfg.gather_chunks:
            node_out = chunked_segment_sum(mo, dst, N, cfg.gather_chunks)
        else:
            node_out = seg_sum(mo, dst, N)
        return m, out_energy + seg_sum(node_out, gids, G)

    for b in range(cfg.n_blocks):
        m, out_energy = checkpoint(block, b, m, out_energy,
                                   use_reentrant=False)
        m = m.to(cfg.act_dtype)
    return _mlp(p, "head", out_energy, 2)                   # [G, d_out]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

GNNConfig = Any

_DEFS = {"gcn": _gcn_defs, "gin": _gin_defs, "meshgraphnet": _mgn_defs,
         "dimenet": _dimenet_defs}
_FWD = {"gcn": _gcn_forward, "gin": _gin_forward, "meshgraphnet": _mgn_forward,
        "dimenet": _dimenet_forward}


def gnn_param_defs(cfg: GNNConfig) -> dict:
    return _DEFS[cfg.kind](cfg)


def gnn_forward(params, batch, cfg: GNNConfig):
    return _FWD[cfg.kind](params, batch, cfg)


def gnn_loss(params, batch, cfg: GNNConfig):
    out = gnn_forward(params, batch, cfg)
    if cfg.kind in ("gcn", "gin"):
        loss = cross_entropy(out, batch["labels"], batch.get("label_mask"))
        return loss, {"loss": loss}
    target = batch["target"]
    mask = batch.get("node_mask")
    err = (out - target) ** 2
    if mask is not None and err.shape[0] == mask.shape[0]:
        loss = (err * mask[:, None]).sum() / torch.clamp(
            mask.sum() * err.shape[-1], min=1)
    else:
        loss = err.mean()
    return loss, {"loss": loss}
