"""The port's LMs against the JAX package's, with the same weights.

Reduced gemma3-1b, yi-34b, stablelm-12b, deepseek-v3 (MLA, a dense layer
then MoE layers with the sigmoid aux-free router and a shared expert,
``mtp`` declared) and arctic (dense ∥ MoE) (``reduced_lm``; plus gemma3
at 6 layers, so that its 5:1 pattern reaches a global layer) are built on
both sides; the JAX ``init_params(..., PRNGKey(0))`` weights are carried to
the port by ``params_from_reference``.  Held to the JAX ``forward`` (its
default ``attn_impl="xla"``), ``prefill_step`` and ``decode_step``:
max abs error over max |reference| <= 1e-4 in f32 (both sides on f32
configs; the sums run in another order) and <= 5e-2 in bf16 (the bound of
``tests/test_models_smoke.py``: bf16 rounds at other places in the two
frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced_config
from repro.models import common as jmc
from repro.models.transformer import model as jtm

from repro_torch.configs.registry import (family_of, get_arch,
                                          reduced_config)
from repro_torch.interop import params_from_reference
from repro_torch.launch.serve import serve_lm, tail_drift
from repro_torch.models.transformer import model as tm

CASES = ["gemma3-1b", "gemma3-1b-6L", "yi-34b", "stablelm-12b",
         "deepseek-v3-671b", "arctic-480b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, S0 = 2, 16, 12


def _configs(case: str, dtype: str):
    arch = case.removesuffix("-6L")
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    if case.endswith("-6L"):
        jcfg = dataclasses.replace(jcfg, n_layers=6)
        cfg = dataclasses.replace(cfg, n_layers=6)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module", params=[(c, d) for c in CASES
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request):
    case, dtype = request.param
    jcfg, cfg = _configs(case, dtype)
    jparams = jmc.init_params(jtm.param_defs(jcfg), jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    return jcfg, jparams, cfg, params, tokens, TOL[dtype]


def _rel(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-6))


def test_forward_matches_jax(models):
    jcfg, jparams, cfg, params, tokens, tol = models
    want, jaux = jax.jit(lambda p, t: jtm.forward(p, t, jcfg)[:2])(
        jparams, jnp.asarray(tokens, jnp.int32))
    got, aux, caches, _ = tm.forward(params, torch.from_numpy(tokens), cfg)
    assert tuple(got.shape) == (B, S, cfg.vocab) and got.dtype == cfg.dtype
    assert caches is None
    assert _rel(got, want) <= tol
    if cfg.moe is None:
        assert aux == 0.0
    else:     # the summed load-balance term of the MoE layers
        assert abs(float(aux) - float(jaux)) <= tol * abs(float(jaux))


def test_prefill_and_decode_match_jax(models):
    """Prefill of the first S0 tokens, then S - S0 decode steps fed the
    prompt's next tokens: last logits at every step and the prefill
    caches agree with the JAX package's (MLA: the latents, ``[L, B, S,
    ·]``; the reference's ``serve_lm`` copies them into a decode cache as
    the port's ``prefill_step(max_len=...)`` does)."""
    jcfg, jparams, cfg, params, tokens, tol = models
    jt = jnp.asarray(tokens, jnp.int32)
    jlast, jcaches = jax.jit(lambda p, t: jtm.prefill_step(p, t, jcfg))(
        jparams, jt[:, :S0])
    t = torch.from_numpy(tokens)
    last, caches = tm.prefill_step(params, t[:, :S0], cfg)
    assert _rel(last, jlast) <= tol
    for (k, v), (jk, jv) in zip(caches, jcaches):
        assert tuple(k.shape) == jk.shape and _rel(k, jk) <= tol
        assert _rel(v, jv) <= tol

    seq = (slice(None),) * (2 if cfg.mla is not None else 3) + (
        slice(0, S0),)
    jcache = [(ck.at[seq].set(pk), cv.at[seq].set(pv))
              for (ck, cv), (pk, pv) in zip(jtm.init_cache(jcfg, B, S),
                                            jcaches)]
    dec = jax.jit(lambda p, c, tk, n: jtm.decode_step(p, c, tk, n, jcfg))
    _, cache = tm.prefill_step(params, t[:, :S0], cfg, max_len=S)
    for i in range(S0, S):
        jl, jcache = dec(jparams, jcache, jt[:, i:i + 1], jnp.int32(i))
        lg, cache = tm.decode_step(params, cache, t[:, i:i + 1], i, cfg)
        assert _rel(lg, jl) <= tol, i
    for (k, v), (jk, jv) in zip(cache, jcache):
        assert _rel(k, jk) <= tol and _rel(v, jv) <= tol


def test_prefill_decode_consistency(models):
    """The port alone: prefill of S0 tokens and S - S0 decode steps give
    the last logits of a prefill of all S (the bound of
    ``test_models_smoke.py``, 5e-2, in bf16; 1e-4 in f32)."""
    _, _, cfg, params, tokens, tol = models
    _, rel = tail_drift(params, cfg, torch.from_numpy(tokens), tail=S - S0)
    assert rel <= tol, rel


@pytest.mark.parametrize("arch", ["gemma3-1b", "yi-34b", "stablelm-12b",
                                  "deepseek-v3-671b", "arctic-480b"])
def test_serve_lm_runs_on_cpu(arch):
    res = serve_lm(arch, 2, 8, 3, reduced=True, device="cpu")
    assert res["tokens"].shape == (2, 3)
    assert ((res["tokens"] >= 0) & (res["tokens"] < 256)).all()
    assert torch.isfinite(res["prefill_logits"].float()).all()


def test_params_from_reference_checks_the_tree():
    jcfg, cfg = _configs("gemma3-1b", "bfloat16")
    jparams = jax.tree.map(np.asarray, jmc.init_params(
        jtm.param_defs(jcfg), jax.random.PRNGKey(1)))
    params = params_from_reference(jparams, cfg, device="cpu")
    emb = params["embed"]
    assert emb.dtype == torch.bfloat16
    assert np.array_equal(emb.view(torch.int16).numpy(),
                          jparams["embed"].view(np.int16))
    bad = {**jparams, "group0": {**jparams["group0"]}}
    del bad["group0"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, cfg, device="cpu")
    bad["group0"]["wq"] = jparams["group0"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(bad, cfg, device="cpu")


def test_configs_and_families():
    """The copied configs equal the reference's field by field, and so
    do the parameter trees (key for key, shape for shape, the dtype's
    name) at full width and reduced; the GNN and DIN names belong to
    their families, and an unknown name raises ``KeyError``."""
    from repro.configs.registry import get_arch as j_get_arch
    for arch in ("yi-34b", "stablelm-12b", "gemma3-1b", "deepseek-v3-671b",
                 "arctic-480b"):
        (jcfg, jopt), (cfg, opt) = j_get_arch(arch), get_arch(arch)
        assert opt == jopt and family_of(arch) == "lm"
        for f in dataclasses.fields(cfg):
            if f.name not in ("dtype", "moe", "mla"):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        for sub in ("moe", "mla"):
            a, b = getattr(cfg, sub), getattr(jcfg, sub)
            assert (a is None) == (b is None)
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert cfg.layer_meta() == tuple(np.asarray(x).tolist()
                                         for x in jcfg.layer_meta())

    def dtype_name(dt) -> str:
        if isinstance(dt, torch.dtype):
            return str(dt).removeprefix("torch.")
        return np.dtype(dt).name

    def flat(tree, path=""):
        out = {}
        for key, d in tree.items():
            if isinstance(d, dict):
                out.update(flat(d, f"{path}{key}/"))
            else:
                out[path + key] = (tuple(d.shape), tuple(d.axes), d.init,
                                   dtype_name(d.dtype))
        return out

    for arch in ("yi-34b", "stablelm-12b", "gemma3-1b", "deepseek-v3-671b",
                 "arctic-480b"):
        for make, jmake in ((lambda a: get_arch(a)[0],
                             lambda a: j_get_arch(a)[0]),
                            (reduced_config, j_reduced_config)):
            got, want = (flat(tm.param_defs(make(arch))),
                         flat(jtm.param_defs(jmake(arch))))
            assert got == want, arch
    assert family_of("din") == "recsys" and family_of("dimenet") == "gnn"
    with pytest.raises(KeyError):
        family_of("no-such-arch")


def test_init_params_draws_large_leaves_in_runs(monkeypatch):
    """A leaf whose f32 draw passes ``DRAW_LIMIT_BYTES`` is drawn in runs
    of its trailing matrices (each run's f32 draw within
    ``DRAW_RUN_BYTES``), in order from the generator, scaled by 1 /
    sqrt(fan-in) and cast into a leaf of its own dtype; a leaf within the
    limit is one draw, as before."""
    from repro_torch.models import common as mc

    tree = {"big": mc.ParamDef((2, 3, 4, 5), ("layers", "experts", "embed",
                                              None)),
            "small": mc.ParamDef((4, 5), ("embed", None))}
    monkeypatch.setattr(mc, "DRAW_LIMIT_BYTES", 4 * 4 * 5)      # 1 matrix
    monkeypatch.setattr(mc, "DRAW_RUN_BYTES", 4 * 2 * 4 * 5)    # 2 a run
    got = mc.init_params(tree, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(0)
    runs = [torch.randn(2, 4, 5, generator=gen) for _ in range(3)]
    big = (torch.cat(runs) * 0.5).bfloat16().view(2, 3, 4, 5)  # fan-in 4
    small = (torch.randn(4, 5, generator=gen) * 0.5).bfloat16()
    assert got["big"].dtype == torch.bfloat16
    assert torch.equal(got["big"], big) and torch.equal(got["small"], small)
