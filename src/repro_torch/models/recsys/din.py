"""DIN — Deep Interest Network [arXiv:1706.06978], in torch: the port of
``repro/models/recsys/din.py``.

Config: embed_dim=18, seq_len=100, target-attention MLP 80-40, output MLP
200-80, interaction = target attention over the user behaviour sequence.
The goods and category tables are the hot path; lookups are gathers
(``table[ids]``) and, for the retrieval's pseudo-target, ``embedding_bag``.

Shapes (``configs/shapes.py::RECSYS_SHAPES``):

* ``train_batch``     batch=65,536 training step (binary CTR loss)
* ``serve_p99``       batch=512 online scoring
* ``serve_bulk``      batch=262,144 offline scoring
* ``retrieval_cand``  one user × 1,000,000 candidates — a single batched
  product of the user interest vector against candidate embeddings, not a
  loop.
"""
from __future__ import annotations

import dataclasses

import torch

from ..common import ParamDef
from .embedding import embedding_bag


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    out_mlp: tuple[int, ...] = (200, 80)
    n_goods: int = 10_000_000
    n_cates: int = 100_000
    kind: str = "din"

    @property
    def d_item(self) -> int:
        return 2 * self.embed_dim  # goods ⊕ category (paper's concat)


def din_param_defs(cfg: DINConfig) -> dict:
    d = cfg.d_item
    tree: dict = {
        "goods_emb": ParamDef((cfg.n_goods, cfg.embed_dim),
                              ("table_rows", None), torch.float32),
        "cate_emb": ParamDef((cfg.n_cates, cfg.embed_dim),
                             ("table_rows", None), torch.float32),
    }
    # target-attention MLP over [hist, target, hist-target, hist*target]
    dims = [4 * d] + list(cfg.attn_mlp) + [1]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        tree[f"attn_w{i}"] = ParamDef((a, b), (None, None), torch.float32)
        tree[f"attn_b{i}"] = ParamDef((b,), (None,), torch.float32, "zeros")
    # output MLP over [user_interest, target, user_interest*target]
    dims = [3 * d] + list(cfg.out_mlp) + [1]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        tree[f"out_w{i}"] = ParamDef((a, b), (None, None), torch.float32)
        tree[f"out_b{i}"] = ParamDef((b,), (None,), torch.float32, "zeros")
    return tree


def _mlp(p, name, x, n, act):
    for i in range(n):
        x = x @ p[f"{name}_w{i}"] + p[f"{name}_b{i}"]
        if i < n - 1:
            x = act(x)
    return x


def _item_embed(p, goods_ids, cate_ids):
    return torch.cat([p["goods_emb"][goods_ids], p["cate_emb"][cate_ids]],
                     dim=-1)


def _interest(p, cfg: DINConfig, hist, hist_mask, target):
    """Target attention: weight history items by relevance to the target.
    hist [B, S, d]; target [B, d] → interest [B, d]."""
    tgt = target[:, None, :].expand_as(hist)
    feat = torch.cat([hist, tgt, hist - tgt, hist * tgt], dim=-1)
    n_attn = len(cfg.attn_mlp) + 1
    scores = _mlp(p, "attn", feat, n_attn, torch.sigmoid)[..., 0]  # [B, S]
    scores = torch.where(hist_mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bs,bsd->bd", w, hist)


def din_forward(p, batch, cfg: DINConfig):
    """batch: hist_goods/hist_cates [B, S], hist_mask [B, S],
    target_goods/target_cates [B] → CTR logit [B]."""
    hist = _item_embed(p, batch["hist_goods"], batch["hist_cates"])
    target = _item_embed(p, batch["target_goods"], batch["target_cates"])
    interest = _interest(p, cfg, hist, batch["hist_mask"], target)
    x = torch.cat([interest, target, interest * target], dim=-1)
    n_out = len(cfg.out_mlp) + 1
    return _mlp(p, "out", x, n_out, torch.relu)[..., 0]


def din_retrieval(p, batch, cfg: DINConfig):
    """Score each user against N candidates with one batched product: the
    user interest vector is computed once (against a mean-pooled
    pseudo-target) and dotted with every candidate embedding."""
    hist = _item_embed(p, batch["hist_goods"], batch["hist_cates"])
    mask = batch["hist_mask"]
    pseudo = torch.cat([
        embedding_bag(p["goods_emb"], torch.where(mask, batch["hist_goods"],
                                                  -1), mode="mean"),
        embedding_bag(p["cate_emb"], torch.where(mask, batch["hist_cates"],
                                                 -1), mode="mean")], dim=-1)
    interest = _interest(p, cfg, hist, mask, pseudo)        # [B, d]
    cand = _item_embed(p, batch["cand_goods"], batch["cand_cates"])
    return torch.einsum("bd,bnd->bn", interest, cand)       # [B, N]


def din_loss(p, batch, cfg: DINConfig):
    logits = din_forward(p, batch, cfg)
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"loss": loss}
