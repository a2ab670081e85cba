"""The port's MLA against the JAX package's, with the same weights.

``_mla_attention``'s two paths on layer 0 of the reduced deepseek-v3
(``reduced_lm``: kv_lora 16, qk_nope 8, qk_rope 8, v_dim 8), its weights
carried from the JAX ``init_params(..., PRNGKey(0))`` by
``params_from_reference``: the prefill path (per-head K/V from the latent,
attention at (D, Dv) = (16, 8)) and the absorbed decode path (``W_uk``
folded into the query, ``W_uv`` into the output, attention in latent space
at (24, 16) over a cache filled with seeded latents), output and updated
caches.  Held to 1e-4 relative (max abs error over max |reference|) in f32
and 5e-2 in bf16, the bounds of ``tests/test_torch_lm.py``.

The attention call of the absorbed decode, at the published D = 576 /
Dv = 512 (v the first 512 columns of k, as the port passes it) and at the
reduced latent shape, goes through the port's plain version on the CPU
(the CUDA kernel ``flash_mla_wgmma.cu`` is held to it on the card):
against the JAX package's ``attention`` with ``impl="xla"`` and
``impl="pallas"`` in interpret mode, at the JAX suite's tolerances (3e-5
in f32, 2e-2 in bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs.registry import reduced_config as j_reduced_config
from repro.kernels import attention as j_attention
from repro.models import common as jmc
from repro.models.transformer import model as jtm

from repro_torch.configs.registry import reduced_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels import attention
from repro_torch.models.transformer import model as tm

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
ARCH = "deepseek-v3-671b"


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _rel(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-6))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def layer(request):
    """(jcfg, JAX layer-0 params, cfg, port group params, tolerance)."""
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    if request.param == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    jparams = jmc.init_params(jtm.param_defs(jcfg), jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    jp0 = {k: v[0] for k, v in jparams["group0"].items()}
    return jcfg, jp0, cfg, params["group0"], TOL[request.param]


def _x(cfg, B, S, seed):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    jdt = jnp.float32 if cfg.dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    return jx, _tensor(jx)


def test_mla_prefill_matches_jax(layer):
    jcfg, jp, cfg, p, tol = layer
    B, S = 2, 12
    jx, x = _x(cfg, B, S, 1)
    jout, (jc, jk) = jax.jit(lambda q, y: jtm._mla_attention(
        q, y, jcfg, jnp.arange(S), None, cfg.rope_theta))(jp, jx)
    out, (c, k) = tm._mla_attention(p, 0, x, cfg, torch.arange(S), None,
                                    cfg.rope_theta)
    assert tuple(out.shape) == (B, S, cfg.d_model) and out.dtype == cfg.dtype
    assert _rel(out, jout) <= tol
    assert _rel(c, jc) <= tol and _rel(k, jk) <= tol


@pytest.mark.parametrize("cache_len,S", [(9, 1), (5, 3)])
def test_mla_absorbed_decode_matches_jax(layer, cache_len, S):
    """The absorbed path over a ``max_len`` cache of seeded latents: its
    output, and the caches with the new latents written at ``cache_len``
    (in place in the port)."""
    jcfg, jp, cfg, p, tol = layer
    B, Smax, m = 2, 16, cfg.mla
    jx, x = _x(cfg, B, S, 2)
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if cfg.dtype == torch.float32 else jnp.bfloat16
    jcc = jnp.asarray(rng.standard_normal((B, Smax, m.kv_lora)), jdt)
    jck = jnp.asarray(rng.standard_normal((B, Smax, m.qk_rope)), jdt)
    cc, ck = _tensor(jcc), _tensor(jck)
    positions = cache_len + np.arange(S)
    jout, (jc2, jk2) = jax.jit(lambda q, y, pos, a, b, n: jtm._mla_attention(
        q, y, jcfg, pos, None, cfg.rope_theta, (a, b, n)))(
        jp, jx, jnp.asarray(positions), jcc, jck, jnp.int32(cache_len))
    out, (c2, k2) = tm._mla_attention(
        p, 0, x, cfg, torch.from_numpy(positions), None, cfg.rope_theta,
        (cc, ck, cache_len))
    assert c2 is cc and k2 is ck                  # updated in place
    assert _rel(out, jout) <= tol
    assert _rel(c2, jc2) <= tol and _rel(k2, jk2) <= tol


ABSORBED_SHAPES = [
    # (B, Hq, Sq, Sk, c, r, q_offset): latent c + RoPE r dims, one KV head
    (2, 16, 1, 100, 512, 64, 99),       # deepseek-v3's 576 / 512
    (1, 16, 1, 70, 512, 64, 40),        # cache tail unwritten
    (2, 4, 1, 20, 16, 8, 11),           # the reduced latent, 24 / 16
    (1, 4, 3, 20, 16, 8, 9),            # Sq = 3
]


@pytest.mark.parametrize("shape", ABSORBED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_attention_matches_jax(shape, dtype):
    """The absorbed decode's attention call as the port makes it (v the
    first c columns of k, scale 192^-0.5) against the JAX package's XLA
    path and its Pallas kernel in interpret mode, given v = c_kv as the
    reference passes it."""
    B, Hq, Sq, Sk, c, r, qoff = shape
    rng = np.random.default_rng(Sk + c)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq = jnp.asarray(rng.standard_normal((B, Hq, Sq, c + r)), jdt)
    jk = jnp.asarray(rng.standard_normal((B, 1, Sk, c + r)), jdt)
    kw = dict(causal=True, window=None, q_offset=qoff, scale=192 ** -0.5)
    k = _tensor(jk)
    got = attention(_tensor(jq), k, k[..., :c], **kw)
    assert tuple(got.shape) == (B, Hq, Sq, c)
    tol = ATTN_TOL[dtype]
    for impl in ("xla", "pallas"):
        want = j_attention(jq, jk, jk[..., :c], impl=impl, interpret=True,
                           **kw)
        assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                        rtol=tol, atol=tol, err_msg=impl)
