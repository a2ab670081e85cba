"""The port's DIN and embedding lookups against the JAX package's, on the
CPU.

Same inputs on both sides (numpy draws; the reference's ``init_params``
weights carried by ``params_from_reference``):

* ``embedding_bag`` in the modes ``sum``, ``mean`` and ``max``: fixed-size
  bags with padding ids below 0 (a bag of padding only among them), and
  ragged bags through ``offsets`` with empty bags in the middle and at the
  end; with and without ``per_sample_weights``; within 1e-6 (an empty bag
  under ``max`` is ``-inf`` on both sides);
* ``hash_embedding_lookup`` bit for bit, on ids up to 2^32 - 1 (the
  reference's uint32 ids, the port's int64) and on negative int32 ids;
* at ``reduced_din``: ``din_forward`` within 1e-5 relative, ``din_loss``'s
  gradients within 1e-4 of each leaf's largest magnitude (``attn_b2``,
  whose exact gradient is 0, within 1e-4 of the tree's largest), and
  ``din_retrieval`` (one batched product over the candidates) within
  1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced_config
from repro.models import common as jmc
from repro.models.recsys import din as jdin
from repro.models.recsys import embedding as jemb

from repro_torch.configs.registry import reduced_config
from repro_torch.interop import params_from_reference
from repro_torch.launch.train import synth_batch
from repro_torch.models.recsys import din
from repro_torch.models.recsys import embedding as emb
from repro_torch.training.trainer import value_and_grad
from repro_torch.tree_util import flatten_with_paths, path_name

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# leaves whose gradient is 0 in exact arithmetic (softmax shift invariance)
SHIFT_INVARIANT = ("attn_b2",)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err / scale if scale > 0 else err


def _same_or_close(got: torch.Tensor, want, tol: float = 1e-6) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    inf = np.isinf(want)
    assert np.array_equal(np.isinf(got), inf)
    assert np.array_equal(got[inf], want[inf])
    assert np.allclose(got[~inf], want[~inf], rtol=tol, atol=tol)


TABLE = np.random.default_rng(0).standard_normal((17, 5)).astype(np.float32)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_fixed_matches_jax(mode, weighted):
    rng = np.random.default_rng(1)
    idx = rng.integers(-3, 17, (6, 4)).astype(np.int32)   # < 0: padding
    idx[2] = -1                                           # padding only
    w = rng.random((6, 4)).astype(np.float32) if weighted else None
    want = jemb.embedding_bag(jnp.asarray(TABLE), jnp.asarray(idx),
                              per_sample_weights=None if w is None else
                              jnp.asarray(w), mode=mode)
    got = emb.embedding_bag(torch.from_numpy(TABLE), torch.from_numpy(idx),
                            per_sample_weights=None if w is None else
                            torch.from_numpy(w), mode=mode)
    _same_or_close(got, want)
    if mode == "max":
        assert np.all(np.isneginf(got[2].numpy()))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_ragged_matches_jax(mode, weighted):
    rng = np.random.default_rng(2)
    M = 11
    idx = rng.integers(0, 17, M).astype(np.int32)
    # bags: [0, 3), [3, 3) empty, [3, 7), [7, 11), [11, 11) empty at the end
    offsets = np.array([0, 3, 3, 7, 11], np.int32)
    w = rng.random(M).astype(np.float32) if weighted else None
    want = jemb.embedding_bag(jnp.asarray(TABLE), jnp.asarray(idx),
                              offsets=jnp.asarray(offsets),
                              per_sample_weights=None if w is None else
                              jnp.asarray(w), mode=mode)
    got = emb.embedding_bag(torch.from_numpy(TABLE), torch.from_numpy(idx),
                            offsets=torch.from_numpy(offsets),
                            per_sample_weights=None if w is None else
                            torch.from_numpy(w), mode=mode)
    _same_or_close(got, want)
    empty = [1, 4]
    if mode == "max":
        assert np.all(np.isneginf(got[empty].numpy()))
    else:
        assert np.all(got[empty].numpy() == 0)


def test_embedding_bag_rejects_unknown_mode():
    t = torch.from_numpy(TABLE)
    with pytest.raises(ValueError):
        emb.embedding_bag(t, torch.zeros((2, 2), dtype=torch.int32),
                          mode="median")
    with pytest.raises(ValueError):
        emb.embedding_bag(t, torch.zeros(2, dtype=torch.int32),
                          offsets=torch.zeros(1, dtype=torch.int32),
                          mode="median")


def test_hash_embedding_lookup_bit_for_bit():
    rng = np.random.default_rng(3)
    ids = np.concatenate([
        rng.integers(0, 2 ** 32, 4000, dtype=np.uint64),
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 2,
                  2 ** 32 - 1], np.uint64)]).astype(np.uint32)
    table = rng.standard_normal((1009, 3)).astype(np.float32)
    want = np.asarray(jemb.hash_embedding_lookup(jnp.asarray(table),
                                                 jnp.asarray(ids)))
    got = emb.hash_embedding_lookup(torch.from_numpy(table),
                                    torch.from_numpy(ids.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)
    # the rows it picks, by the reference's own uint32 splitmix in numpy
    x = ids.copy()
    x = (x ^ (x >> 16)) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * np.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    assert np.array_equal(got.numpy(), table[x % 1009])
    # int32 ids are their uint32 bits, as astype(uint32) reads them
    neg = np.array([-1, -2, -2 ** 31, 5], np.int32)
    want = np.asarray(jemb.hash_embedding_lookup(jnp.asarray(table),
                                                 jnp.asarray(neg)))
    got = emb.hash_embedding_lookup(torch.from_numpy(table),
                                    torch.from_numpy(neg))
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def din_models():
    jcfg, cfg = j_reduced_config("din"), reduced_config("din")
    jparams = jmc.init_params(jdin.din_param_defs(jcfg),
                              jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    b = synth_batch("din", cfg, np.random.default_rng(0), 16, 0,
                    device="cpu")
    return jcfg, cfg, jparams, params, b


def _jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def test_din_forward_matches_jax(din_models):
    jcfg, cfg, jparams, params, b = din_models
    want = np.asarray(jdin.din_forward(jparams, _jax_batch(b), jcfg))
    with torch.no_grad():
        got = din.din_forward(params, b, cfg).numpy()
    assert got.shape == want.shape == (16,)
    assert _rel(got, want) <= FWD_TOL


def test_din_loss_grads_match_jax(din_models):
    jcfg, cfg, jparams, params, b = din_models
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jdin.din_loss(p, _jax_batch(b), jcfg),
        has_aux=True)(jparams)
    (loss, _), grads = value_and_grad(
        lambda p, bb: din.din_loss(p, bb, cfg), params, b)
    assert abs(float(loss) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    want = {path_name(p): np.asarray(x) for p, x in
            flatten_with_paths(jax.tree.map(np.asarray, jgrads))}
    got = {path_name(p): x.numpy() for p, x in flatten_with_paths(grads)}
    assert got.keys() == want.keys()
    # the last attention bias adds one constant to every score before the
    # softmax, so its exact gradient is 0 and both sides hold rounding
    # noise: it is held against the largest gradient of the tree instead
    top = max(float(np.abs(w).max()) for w in want.values())
    for name in SHIFT_INVARIANT:
        assert max(float(np.abs(got[name]).max()),
                   float(np.abs(want[name]).max())) <= GRAD_TOL * top, name
    for name in want.keys() - set(SHIFT_INVARIANT):
        assert _rel(got[name], want[name]) <= GRAD_TOL, name


def test_din_retrieval_matches_jax(din_models):
    jcfg, cfg, jparams, params, b = din_models
    rng = np.random.default_rng(5)
    B, N = 3, 257
    rb = {k: b[k][:B].clone()
          for k in ("hist_goods", "hist_cates", "hist_mask")}
    rb["hist_mask"][1] = False                  # a user with no history
    rb["cand_goods"] = torch.from_numpy(
        rng.integers(0, cfg.n_goods, (B, N)).astype(np.int32))
    rb["cand_cates"] = torch.from_numpy(
        rng.integers(0, cfg.n_cates, (B, N)).astype(np.int32))
    want = np.asarray(jdin.din_retrieval(jparams, _jax_batch(rb), jcfg))
    with torch.no_grad():
        got = din.din_retrieval(params, rb, cfg).numpy()
    assert got.shape == want.shape == (B, N)
    assert np.all(np.isfinite(got))
    assert _rel(got, want) <= FWD_TOL
