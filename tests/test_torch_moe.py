"""The port's MoE dispatch against the JAX package's, on the same inputs.

``_dispatch_group`` (the reference's, vmapped over groups) and the port's
group-batched one on seeded assignments: ``buf``, ``se``, ``slot_c``,
``tok`` and ``comb_w`` exactly, with capacity factors that keep every
assignment and ones small enough that tokens drop.  ``_combine_group``
exactly too: the reference scatter-adds a token's K rows in expert-sorted
order and the port gathers them and adds in the same order.

``_moe_ffn`` on layer 0 of the MoE group of the reduced deepseek-v3
(``sigmoid_aux_free`` router, one shared expert) and arctic (``softmax``
router; its hybrid layer's MoE half), weights carried from the JAX
``init_params(..., PRNGKey(0))``: at batch 2 (one dispatch group) and
batch 16 (16 groups), at the reduced capacity 8.0 (no drop) and at 0.5
(drops), in f32 and bf16.  The experts each token chose equal the
reference's (read from ``jax.lax.top_k`` as the reference calls it,
through a debug callback); the
output within 1e-4 relative in f32 and 5e-2 in bf16 (the bounds of
``tests/test_torch_lm.py``), and the aux loss within 1e-5 in f32 and 1e-2
in bf16 relative.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced_config
from repro.models import common as jmc
from repro.models.transformer import model as jtm

from repro_torch.configs.registry import reduced_config
from repro_torch.interop import params_from_reference
from repro_torch.models.transformer import model as tm

DISPATCH_CASES = [
    # (G, T, K, E, capacity_factor)
    (1, 16, 2, 4, 8.0),          # no drop
    (2, 24, 2, 4, 0.5),          # half the assignments drop
    (3, 10, 8, 16, 1.25),        # top-8, deepseek's capacity factor
    (1, 9, 2, 8, 0.3),           # most drop
    (4, 8, 8, 256, 1.25),        # deepseek's decode: C = 1
]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assignments(rng, G, T, K, E):
    ids = np.stack([np.stack([rng.permutation(E)[:K] for _ in range(T)])
                    for _ in range(G)]).astype(np.int32)
    w = rng.random((G, T, K), dtype=np.float32)
    return ids, w


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_dispatch_and_combine_match_jax(case):
    G, T, K, E, cf = case
    rng = np.random.default_rng(G * 100 + T + E)
    d = 6
    xf = rng.standard_normal((G, T, d)).astype(np.float32)
    ids, w = _assignments(rng, G, T, K, E)
    C = int(math.ceil(T * K * cf / E))
    want = jax.jit(jax.vmap(functools.partial(
        jtm._dispatch_group, E=E, K=K, C=C)))(
        jnp.asarray(xf), jnp.asarray(ids), jnp.asarray(w))
    got = tm._dispatch_group(torch.from_numpy(xf),
                             torch.from_numpy(ids).long(),
                             torch.from_numpy(w), E, K, C)
    for name, g, j in zip(("buf", "se", "slot_c", "tok", "comb_w"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
    kept = int((np.asarray(want[4]) != 0).sum())
    if cf < 1 or C == 1:
        assert kept < G * T * K            # tokens dropped
    if cf >= E / K:
        assert kept == G * T * K
    for dtype in (jnp.float32, jnp.bfloat16):
        jh = jnp.asarray(rng.standard_normal((G, E, C, d)), dtype)
        jout = jax.jit(jax.vmap(functools.partial(jtm._combine_group, T=T)))(
            jh, *want[1:])
        out = tm._combine_group(_tensor(jh), *got[1:], T)
        assert out.dtype == _tensor(jh).dtype
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(jout, np.float32))


def _group_layer0(jparams, params, gi):
    return ({k: v[0] for k, v in jparams[f"group{gi}"].items()},
            params[f"group{gi}"])


@pytest.fixture(scope="module", params=[
    (a, d) for a in ("deepseek-v3-671b", "arctic-480b")
    for d in ("float32", "bfloat16")], ids=lambda p: f"{p[0]}-{p[1]}")
def moe_layer(request):
    arch, dtype = request.param
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    jparams = jmc.init_params(jtm.param_defs(jcfg), jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    gi = [kind for kind, _ in cfg.layer_groups()].index(
        "hybrid" if cfg.moe_dense_parallel else "moe")
    jp, p = _group_layer0(jparams, params, gi)
    return jcfg, jp, cfg, p, dtype


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("batch", [2, 16])
def test_moe_ffn_matches_jax(moe_layer, batch, cf, monkeypatch):
    jcfg, jp, cfg, p, dtype = moe_layer
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    S = 3
    G = cfg.moe.n_groups if batch % cfg.moe.n_groups == 0 else 1
    assert G == (16 if batch == 16 else 1)
    x = np.random.default_rng(batch).standard_normal((batch, S, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)

    chosen = {}
    top_k = jax.lax.top_k

    def rec_top_k(a, k):
        vals, idx = top_k(a, k)
        jax.debug.callback(lambda i: chosen.__setitem__("jax", np.asarray(i)),
                           idx)
        return vals, idx

    route = tm._route

    def rec_route(*args):
        ids, w = route(*args)
        chosen["port"] = ids.numpy()
        return ids, w

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(tm, "_route", rec_route)
    jout, jaux = jax.jit(lambda q, y: jtm._moe_ffn(q, y, jcfg))(jp, jx)
    jax.effects_barrier()
    out, aux = tm._moe_ffn(p, 0, _tensor(jx), cfg)
    np.testing.assert_array_equal(chosen["port"], chosen["jax"])
    assert chosen["port"].shape == (G, batch // G * S, cfg.moe.top_k)
    assert tuple(out.shape) == (batch, S, cfg.d_model)
    assert out.dtype == cfg.dtype
    w = np.asarray(jout, np.float32)
    rel = np.abs(out.float().numpy() - w).max() / np.abs(w).max()
    assert rel <= (1e-4 if dtype == "float32" else 5e-2), rel
    aux_tol = 1e-5 if dtype == "float32" else 1e-2
    assert abs(float(aux) - float(jaux)) <= aux_tol * abs(float(jaux))
