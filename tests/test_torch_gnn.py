"""The port's four GNN architectures against the JAX package's, on the CPU.

Same inputs on both sides: the reference's ``init_params`` weights carried
by ``params_from_reference``, batches drawn from numpy (the train
launcher's ``synth_batch`` at seed 0, or the graphs below).  At each
architecture's ``reduced_gnn`` config, in f32:

* ``gnn_forward`` within 1e-5 of the reference's largest magnitude;
* the gradients of ``gnn_loss`` (``torch.autograd.grad``) within 1e-4 of
  each leaf's largest magnitude of ``jax.grad``'s (the sums run in another
  order), the loss within 1e-5 relative;
* GCN with an ``edge_mask``, GIN with a graph-level readout and a
  ``node_mask``, MeshGraphNet and DimeNet with ``gather_chunks``;
* ``chunked_gather`` and ``chunked_segment_sum`` (``autograd.Function``s)
  against the reference's ``custom_vjp``, forward and gradient, at 1, 3
  and 4 chunks over N = 10 rows (3 and 4 pad and cut): in f32 within 1e-6,
  in bf16 within 2e-2;
* DimeNet's angle keeps the reference's ``ord=-1`` norm: the same
  forward with the per-row norm in its place is far from the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced_config
from repro.models import common as jmc
from repro.models.gnn import gnn_forward as j_gnn_forward
from repro.models.gnn import gnn_loss as j_gnn_loss
from repro.models.gnn import gnn_param_defs as j_gnn_param_defs
from repro.models.gnn import models as jgm

from repro_torch.configs.registry import reduced_config
from repro_torch.interop import params_from_reference
from repro_torch.launch.train import synth_batch
from repro_torch.models.gnn import gnn_forward, gnn_loss
from repro_torch.models.gnn import models as gm
from repro_torch.training.trainer import value_and_grad
from repro_torch.tree_util import flatten_with_paths, path_name

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
ARCHS = ("gcn-cora", "gin-tu", "meshgraphnet", "dimenet")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err / scale if scale > 0 else err


def _to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, int)
            else v for k, v in b.items()}


def _to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) if not isinstance(v, int) else v
            for k, v in b.items()}


def _models(arch: str, **over):
    jcfg = dataclasses.replace(j_reduced_config(arch), **over)
    cfg = dataclasses.replace(reduced_config(arch), **over)
    jparams = jmc.init_params(j_gnn_param_defs(jcfg), jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, params


def _synth(arch: str, cfg) -> dict:
    """The train launcher's batch at seed 0, as numpy arrays."""
    b = synth_batch(arch, cfg, np.random.default_rng(0), 4, 8, device="cpu")
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in b.items()}


def _with_masks(arch: str, b: dict) -> dict:
    """GCN: an edge mask; GIN: 8 graphs with a readout and a node mask."""
    rng = np.random.default_rng(1)
    b = dict(b)
    N = b["x"].shape[0] if "x" in b else b["z"].shape[0]
    if arch == "gcn-cora":
        b["edge_mask"] = (rng.random(b["edge_index"].shape[1]) < 0.7).astype(
            np.float32)
    if arch == "gin-tu":
        G = 8
        b["graph_ids"] = np.sort(rng.integers(0, G, N)).astype(np.int32)
        b["n_graphs"] = G
        b["node_mask"] = (rng.random(N) < 0.9).astype(np.float32)
        b["labels"] = rng.integers(0, 2, G).astype(np.int32)
        b["label_mask"] = np.ones(G, np.float32)
    return b


def _case(arch: str, variant: str):
    over = {"gather_chunks": 3} if variant == "chunked" else {}
    jcfg, cfg, jparams, params = _models(arch, **over)
    b = _synth(arch, cfg)
    if variant == "masked":
        b = _with_masks(arch, b)
    return jcfg, cfg, jparams, params, b


VARIANTS = [(a, "plain") for a in ARCHS] + [
    ("gcn-cora", "masked"), ("gin-tu", "masked"),
    ("meshgraphnet", "chunked"), ("dimenet", "chunked")]


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_forward_matches_jax(arch, variant):
    jcfg, cfg, jparams, params, b = _case(arch, variant)
    want = np.asarray(j_gnn_forward(jparams, _to_jax(b), jcfg))
    with torch.no_grad():
        got = gnn_forward(params, _to_torch(b), cfg).numpy()
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert _rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_loss_grads_match_jax(arch, variant):
    jcfg, cfg, jparams, params, b = _case(arch, variant)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_gnn_loss(p, _to_jax(b), jcfg), has_aux=True)(jparams)
    (loss, metrics), grads = value_and_grad(
        lambda p, bb: gnn_loss(p, bb, cfg), params, _to_torch(b))
    assert abs(float(loss) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    assert float(metrics["loss"]) == float(loss)
    want = {path_name(p): np.asarray(x) for p, x in
            flatten_with_paths(jax.tree.map(np.asarray, jgrads))}
    got = {path_name(p): x.numpy() for p, x in flatten_with_paths(grads)}
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert _rel(got[name], want[name]) <= GRAD_TOL, name


def _chunk_inputs(dtype):
    rng = np.random.default_rng(2)
    N, M, D = 10, 23, 5
    x = rng.standard_normal((N, D)).astype(np.float32)
    idx = rng.integers(0, N, M).astype(np.int32)
    g = rng.standard_normal((M, D)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    return (N, x, idx, g, jdt, tdt)


def _close(got: torch.Tensor, want, tol: float) -> bool:
    return _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("n_chunks", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_gather_matches_custom_vjp(n_chunks, dtype):
    N, x, idx, g, jdt, tdt = _chunk_inputs(dtype)
    tol = 1e-6 if dtype == "float32" else 2e-2
    jx = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(lambda a: jgm.chunked_gather(
        a, jnp.asarray(idx), n_chunks), jx)
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = gm.chunked_gather(tx, torch.from_numpy(idx), n_chunks)
    (dx,) = torch.autograd.grad(got, tx, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and dx.dtype == tdt
    assert got.shape == (idx.size, x.shape[1]) and dx.shape == x.shape
    assert _close(got.detach(), want.astype(jnp.float32), tol)
    assert _close(dx, want_dx.astype(jnp.float32), tol)
    # a gather: every row equals x[idx]
    assert torch.equal(got.detach(), torch.from_numpy(x).to(tdt)[idx])


@pytest.mark.parametrize("n_chunks", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_segment_sum_matches_custom_vjp(n_chunks, dtype):
    N, x, idx, g, jdt, tdt = _chunk_inputs(dtype)
    tol = 1e-6 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(3)
    data = g                                     # [M, D] rows to add
    gout = rng.standard_normal((N, x.shape[1])).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jgm.chunked_segment_sum(
        d, jnp.asarray(idx), N, n_chunks), jnp.asarray(data, jdt))
    (want_dd,) = vjp(jnp.asarray(gout, jdt))
    td = torch.from_numpy(data).to(tdt).requires_grad_(True)
    got = gm.chunked_segment_sum(td, torch.from_numpy(idx), N, n_chunks)
    (dd,) = torch.autograd.grad(got, td, torch.from_numpy(gout).to(tdt))
    assert got.shape == (N, x.shape[1]) and dd.shape == data.shape
    assert got.dtype == tdt and dd.dtype == tdt
    assert _close(got.detach(), want.astype(jnp.float32), tol)
    assert _close(dd, want_dd.astype(jnp.float32), tol)


def test_chunked_backward_saves_only_indices():
    """The backward keeps ``idx`` and nothing of the operand."""
    x = torch.randn(10, 4, requires_grad=True)
    idx = torch.tensor([9, 0, 3, 3], dtype=torch.int32)
    out = gm.chunked_gather(x, idx, 3)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is idx
    out = gm.chunked_segment_sum(x, torch.arange(10, dtype=torch.int32) % 4,
                                 4, 3)
    assert len(out.grad_fn.saved_tensors) == 1


def _per_row_cos(v1, v2):
    return (v1 * v2).sum(-1) / (
        torch.linalg.vector_norm(v1 + 1e-9, dim=-1)
        * torch.linalg.vector_norm(v2 + 1e-9, dim=-1))


def test_dimenet_keeps_the_reference_ord_minus_one_norm(monkeypatch):
    """The reference's ``jnp.linalg.norm(v2 + 1e-9, -1)`` is one scalar
    over all triplets; the port's forward matches it, and the same forward
    with a per-row norm in its place does not."""
    jcfg, cfg, jparams, params, b = _case("dimenet", "plain")
    v = np.random.default_rng(4).standard_normal((6, 3)).astype(np.float32)
    assert np.allclose(np.asarray(jnp.linalg.norm(jnp.asarray(v) + 1e-9, -1)),
                       np.abs(v + 1e-9).sum(0).min())
    want = np.asarray(j_gnn_forward(jparams, _to_jax(b), jcfg))
    with torch.no_grad():
        got = gnn_forward(params, _to_torch(b), cfg).numpy()
        assert _rel(got, want) <= FWD_TOL
        monkeypatch.setattr(gm, "_wedge_cos", _per_row_cos)
        other = gnn_forward(params, _to_torch(b), cfg).numpy()
    assert _rel(other, want) > 1e-2
