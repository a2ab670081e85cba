"""The port's attention against the JAX package's, on the same inputs.

On the CPU ``repro_torch.kernels.attention`` runs its plain PyTorch
version (``kernels/flash_attention/ref.py``).  These tests hold it against
the JAX package's three attention paths on the shapes of
``tests/test_kernels.py::test_attention_sweep``: the full-score oracle
``attention_ref``, the chunked XLA path ``attention(impl="xla")`` and the
Pallas kernel ``flash_attention_pallas`` in interpret mode (K and V
repeated over the GQA group, as the JAX wrapper does).  Tolerances are
the JAX suite's own: ``rtol = atol = 3e-5`` in f32 (the sums run in
another order) and ``2e-2`` in bf16 (the XLA path rounds ``p`` to bf16
before ``p·v``; the port keeps it in f32, as the Pallas kernel does).

The split-K decode kernel's algebra (``attention_splitk_ref``: per-split
``(acc, m, l)`` and their combine) is held against ``attention_ref`` and
the JAX package at decode shapes for any cut of the keys, and its host
planner (``ops.plan_splits``, ``ops.decode_shape``) is checked here.  For
the wgmma/TMA prefill kernel the routing rule (``ops.route``), its
tile plan (``ops.prefill_tile_plan``, which the kernel mirrors) against
the mask, and the two-term bf16 split of p (``attention_ref(p_terms=2)``)
against the JAX package are checked here; for the f32 prefill kernel the
three-term TF32 products (``attention_ref(tf32_terms=3)``) against the f32
plain version and the Pallas kernel, and for stablelm's D = 160 at the
(192, 192) instantiation that zero columns past D at the unchanged scale
change nothing.  The CUDA kernels themselves are
held against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from repro.kernels import attention as j_attention
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref

from repro_torch.configs.lm_archs import GEMMA3_1B, LM_ARCHS
from repro_torch.kernels import attention, launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ops_ref
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_splitk_ref,
                                                     visible)

SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_off)
    (2, 4, 2, 16, 16, 32, 32, True, None, 0),
    (1, 4, 4, 33, 33, 16, 16, True, None, 0),
    (1, 8, 1, 8, 64, 32, 32, True, None, 56),
    (2, 4, 2, 32, 32, 32, 32, True, 8, 0),
    (1, 2, 2, 16, 48, 16, 16, False, None, 0),
    (1, 4, 4, 16, 16, 24, 8, True, None, 0),   # MLA-style Dv != D
]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(rng, B, Hq, Hkv, Sq, Sk, D, Dv, dtype):
    """The same q, k, v as JAX arrays and as torch tensors (bf16 carried
    by its bits)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    js = [jnp.asarray(rng.standard_normal(s), jdt)
          for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv))]
    ts = []
    for a in js:
        a = np.asarray(a)
        if dtype == "bfloat16":
            ts.append(torch.from_numpy(a.view(np.uint16).copy())
                      .view(torch.bfloat16))
        else:
            ts.append(torch.from_numpy(a.copy()))
    return js, ts


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pallas(q, k, v, *, causal, window, q_offset, block=16):
    rep = q.shape[1] // k.shape[1]
    return flash_attention_pallas(
        q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1),
        causal=causal, window=window, q_offset=q_offset, block_q=block,
        block_k=block, interpret=True)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_jax(shape, dtype):
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    rng = np.random.default_rng(Sq * Sk + D)
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Hq, Hkv, Sq, Sk, D, Dv, dtype)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    got = attention(q, k, v, **kw)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Hq, Sq, Dv)
    tol = TOL[dtype]
    wants = {"attention_ref": j_attention_ref(jq, jk, jv, **kw),
             "xla": j_attention(jq, jk, jv, impl="xla", block_k=16, **kw),
             "pallas": _pallas(jq, jk, jv, **kw)}
    for name, want in wants.items():
        assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                        err_msg=name)


def test_decode_equals_prefill_row():
    """Decode (Sq = 1, q_offset = i) equals row i of the full attention
    (f32, 1e-5 as in the JAX suite), for MHA and for GQA 4:1."""
    rng = np.random.default_rng(3)
    for Hq, Hkv in ((2, 2), (4, 1)):
        _, (q, k, v) = _inputs(rng, 1, Hq, Hkv, 24, 24, 16, 16, "float32")
        full = attention(q, k, v, causal=True)
        for i in (0, 7, 23):
            row = attention(q[:, :, i:i + 1], k, v, causal=True, q_offset=i)
            assert_allclose(row[:, :, 0].numpy(), full[:, :, i].numpy(),
                            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_with_leading_tiles_masked(dtype):
    """Window 8 over 64 keys in 16-key tiles: every row past 23 sees no
    key of its first tiles.  Matches the Pallas kernel and the oracle."""
    rng = np.random.default_rng(4)
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 4, 1, 64, 64, 32, 32, dtype)
    kw = dict(causal=True, window=8, q_offset=0)
    got = _f32(attention(q, k, v, **kw))
    tol = TOL[dtype]
    assert_allclose(got, _f32(_pallas(jq, jk, jv, **kw)), rtol=tol, atol=tol)
    assert_allclose(got, _f32(j_attention_ref(jq, jk, jv, **kw)), rtol=tol,
                    atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_without_keys_is_zero(dtype):
    """q_offset = -3 under the causal mask: rows 0..2 see no key.  They come
    out exactly 0, as from the Pallas kernel (the JAX oracle gives NaN)."""
    rng = np.random.default_rng(5)
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 2, 1, 16, 16, 16, 16, dtype)
    kw = dict(causal=True, window=None, q_offset=-3)
    got = _f32(attention(q, k, v, **kw))
    want = _f32(_pallas(jq, jk, jv, **kw))
    assert np.all(got[:, :, :3] == 0) and np.all(want[:, :, :3] == 0)
    assert np.isnan(_f32(j_attention_ref(jq, jk, jv, **kw))[:, :, :3]).all()
    tol = TOL[dtype]
    assert_allclose(got, want, rtol=tol, atol=tol)


def test_plain_reads_kv_head_by_index():
    """GQA by head index equals attention over explicitly repeated K/V."""
    rng = np.random.default_rng(6)
    _, (q, k, v) = _inputs(rng, 2, 8, 2, 12, 20, 16, 8, "float32")
    got = attention_ref(q, k, v, causal=True, window=5, q_offset=8)
    rep = attention_ref(q, k.repeat_interleave(4, 1), v.repeat_interleave(4, 1),
                        causal=True, window=5, q_offset=8)
    assert torch.equal(got, rep)


def test_kernel_args_checks():
    """What the CUDA wrapper hands the kernel, checked on the host: strided
    views keep their strides when the kernel can read them (f32: last dim
    contiguous; bf16: strides in multiples of 8 elements), bf16 head dims
    are zero-padded to the tensor-core tile, and head dims above 256,
    mixed dtypes and bad shapes raise."""
    q = torch.zeros(2, 6, 4, 256).transpose(1, 2)        # [B, H=4, S=6, D]
    k = torch.zeros(2, 1, 10, 256)
    v = torch.zeros(2, 1, 10, 160)
    for t in (q, k, v):
        t.normal_(generator=torch.Generator().manual_seed(0))
    q2, k2, v2, sizes, flags = fa_ops.kernel_args(
        q, k, v, causal=True, window=1 << 30, q_offset=3, scale=None)
    assert q2.data_ptr() == q.data_ptr() and q2.stride() == q.stride()
    assert sizes == (2, 4, 1, 6, 10, 256, 160)
    assert flags == (1, 1 << 30, 3, 256 ** -0.5)
    assert fa_ops.kernel_args(q, k, v, causal=False, window=None,
                              q_offset=0, scale=0.5)[4] == (0, 0, 0, 0.5)
    qt = torch.zeros(2, 4, 6, 256).transpose(2, 3).contiguous().transpose(2, 3)
    assert fa_ops.kernel_args(qt, k, v, causal=True, window=None, q_offset=0,
                              scale=None)[0].stride(-1) == 1
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = fa_ops.kernel_args(qb, kb, vb, causal=True, window=None,
                             q_offset=0, scale=None)
    assert got[0].data_ptr() == qb.data_ptr()              # read in place
    odd = fa_ops.kernel_args(qb[..., :24], kb[..., :24], vb[..., :12],
                             causal=True, window=None, q_offset=0, scale=None)
    assert odd[3][5:] == (32, 16) and odd[4][3] == 24 ** -0.5
    assert torch.equal(odd[0][..., :24], qb[..., :24])
    assert not odd[0][..., 24:].any() and not odd[2][..., 12:].any()
    assert all(t.stride(-2) % 8 == 0 for t in odd[:3])
    plain = attention(qb[..., :24], kb[..., :24], vb[..., :12])
    padded = attention(*odd[:3], scale=24 ** -0.5)[..., :12]
    assert torch.equal(plain, padded)                      # zeros change nothing
    with pytest.raises(ValueError, match="up to 256"):
        fa_ops.kernel_args(torch.zeros(1, 1, 1, 576), torch.zeros(1, 1, 4, 576),
                           torch.zeros(1, 1, 4, 512), causal=True,
                           window=None, q_offset=0, scale=None)
    with pytest.raises(TypeError):
        fa_ops.kernel_args(q.half(), k, v, causal=True, window=None,
                           q_offset=0, scale=None)
    with pytest.raises(ValueError):
        fa_ops.kernel_args(q, torch.zeros(2, 3, 10, 256),
                           torch.zeros(2, 3, 10, 256), causal=True,
                           window=None, q_offset=0, scale=None)
    with pytest.raises(ValueError, match="window"):
        fa_ops.kernel_args(q, k, v, causal=True, window=0, q_offset=0,
                           scale=None)
    # the decode kernel copies 16-byte chunks in f32 too: D and Dv padded
    # to multiples of 4, views with other strides copied
    q5 = torch.ones(1, 4, 1, 10)
    k5, v5 = torch.ones(1, 1, 7, 10), torch.ones(1, 1, 7, 6)
    dq, dk, dv, dsizes, dflags = fa_ops.kernel_args(
        q5, k5, v5, causal=True, window=None, q_offset=6, scale=None)
    assert dsizes[5:] == (12, 8) and dflags[3] == 10 ** -0.5
    assert torch.equal(dq[..., :10], q5) and not dq[..., 10:].any()
    assert not dv[..., 6:].any()
    wide = torch.ones(1, 1, 7, 13)[..., :12]                # row stride 13
    got = fa_ops.kernel_args(torch.ones(1, 4, 1, 12), wide, wide,
                             causal=True, window=None, q_offset=6,
                             scale=None)
    assert got[1].stride(-2) % 4 == 0 and torch.equal(got[1], wide)


@pytest.mark.parametrize("Sq,source", [(4, "flash_decode"),
                                       (40, "flash_prefill_f32"),
                                       (40, "flash_prefill")])
def test_no_fallback_to_plain(monkeypatch, Sq, source):
    """Inputs the policy sends to a kernel are launched or raise: with the
    dispatch forced to the kernels and their build failing, the call
    raises instead of answering with the plain version, and no launch is
    counted.  Sq = 4 rows on one KV head takes the decode kernel, Sq = 40
    in f32 at D = 16 the TF32 prefill kernel, Sq = 40 in bf16 at D = 64
    the wgmma/TMA prefill kernel."""
    def failed_build(name, signatures):
        raise RuntimeError(f"nvcc {name}.cu failed")

    monkeypatch.setattr(fa_ops, "use_kernel", lambda *t: True)
    monkeypatch.setattr(fa_ops._build, "load", failed_build)
    before = launch_counts()
    if source == "flash_prefill":
        x = torch.zeros(1, 1, Sq, 64, dtype=torch.bfloat16)
    else:
        x = torch.zeros(1, 1, Sq, 16)
    with pytest.raises(RuntimeError, match=f"nvcc {source}.cu failed"):
        attention(x, x, x)
    assert launch_counts() == before


def test_prefill_shape():
    """The router (``ops.route``, what ``attention()`` launches by): every
    bf16 call that is not decode takes the wgmma/TMA kernel, at any head
    dim up to 256: gemma3-1b (256), the D = 128 archs (yi-34b, arctic,
    deepseek-v3), stablelm's D = 160 and the reduced test widths; f32
    takes the TF32 kernel, decode shapes the split-K kernel, and dims past
    256 none.  Each call runs the cheapest instantiation that holds its
    dims: D = 160 at (192, 192), the MLA prefill at (192, 128)."""
    bf16, f32 = torch.bfloat16, torch.float32
    for name in ("gemma3-1b", "yi-34b", "arctic-480b", "deepseek-v3-671b",
                 "stablelm-12b"):
        cfg = LM_ARCHS[name][0]
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        assert fa_ops.route(4096, H, Hkv, Dh, Dh, bf16) == "flash_prefill"
        assert fa_ops.route(4096, H, Hkv, Dh, Dh, f32) == "flash_prefill_f32"
    g = GEMMA3_1B
    assert fa_ops.route(1, g.n_heads, 1, 256, 256, bf16) == "flash_decode"
    assert fa_ops.route(2, g.n_heads, 1, 256, 256, bf16) == "flash_decode"
    assert fa_ops.route(2, g.n_heads, 1, 256, 256, f32) == "flash_decode"
    assert fa_ops.route(3, g.n_heads, 1, 256, 256, bf16) == "flash_prefill"
    for d in (16, 24, 32, 160):
        assert fa_ops.route(64, 4, 1, d, d, bf16) == "flash_prefill", d
    for bad in ((320, 320, bf16), (64, 64, torch.float16)):
        with pytest.raises(ValueError, match="no attention kernel"):
            fa_ops.route(64, 4, 1, *bad)
    for dv in (128, 96):            # the MLA prefill, and a mixed width
        assert fa_ops.route(40, 2, 1, 192, dv, bf16) == "flash_prefill"
    assert [fa_ops.prefill_dims(*d) for d in
            ((64, 64), (192, 128), (192, 192), (160, 160), (192, 96),
             (64, 128), (256, 128), (16, 16))] == [
        (64, 64), (192, 128), (192, 192), (192, 192), (192, 128),
        (128, 128), (256, 256), (64, 64)]
    assert [fa_ops.prefill_dims(*d, fa_ops.PREFILL_F32_DIMS) for d in
            ((256, 256), (160, 160), (16, 8), (128, 64))] == [
        (256, 256), (256, 256), (64, 64), (128, 128)]


PREFILL_PLAN_CASES = [
    # (Sq, Sk, causal, window, q_offset)
    (4096, 4128, True, None, 0),       # gemma3-1b global prefill
    (4096, 4128, True, 512, 0),        # gemma3-1b local prefill
    (300, 333, True, None, 0),         # Sq and Sk tails
    (200, 260, True, 37, 50),          # window not a tile multiple
    (130, 200, True, 17, 64),          # window smaller than a tile
    (77, 500, True, 64, 400),          # chunked prefill
    (100, 100, True, None, -5),        # the first rows see no key
    (40, 40, True, None, -100),        # no row sees a key
    (150, 90, True, 100, 3),           # keys end before the rows
    (64, 64, False, None, 0),
    (150, 90, False, 20, 10),          # not causal, with a window
    (10, 200, True, 1, 150),           # window of one key
    (65, 129, True, 63, 0),
]


@pytest.mark.parametrize("case", PREFILL_PLAN_CASES)
@pytest.mark.parametrize("block_m,block_n", [(64, 64), (128, 64), (64, 32),
                                             (16, 32)])
def test_prefill_tile_plan(case, block_m, block_n):
    """For each query tile, against the mask itself: every key tile outside
    ``[first, end)`` is wholly masked for the tile's real rows, the first
    and last visited tiles hold a visible key, and a tile is left unmasked
    exactly when every real row sees every one of its keys (all < Sk)."""
    Sq, Sk, causal, window, off = case
    plans = fa_ops.prefill_tile_plan(Sq, Sk, causal=causal, window=window,
                                     q_offset=off, block_m=block_m,
                                     block_n=block_n)
    mask = visible(Sq, Sk, causal=causal, window=window, q_offset=off)
    assert len(plans) == -(-Sq // block_m)
    n_tiles = -(-Sk // block_n)
    for i, plan in enumerate(plans):
        rows = mask[i * block_m:(i + 1) * block_m]
        assert len(plan.masked) == plan.end - plan.first
        seen = rows.any(dim=0)
        if not bool(seen.any()):
            assert plan == (0, 0, ())
            continue
        assert 0 <= plan.first < plan.end <= n_tiles
        for t in range(n_tiles):
            keys = slice(t * block_n, (t + 1) * block_n)
            if not plan.first <= t < plan.end:
                assert not bool(seen[keys].any()), (i, t)
                continue
            whole = (t + 1) * block_n <= Sk and bool(rows[:, keys].all())
            assert plan.masked[t - plan.first] == (not whole), (i, t)
        for t in (plan.first, plan.end - 1):
            assert bool(seen[t * block_n:(t + 1) * block_n].any()), (i, t)


def test_prefill_tile_plan_at_gemma():
    """gemma3-1b prefill: each 64-row tile masks one diagonal tile (global
    layers) and, from row 512 on, the window's edge too; a local 64-row
    tile visits at most 9 of the 65 key tiles."""
    glob = fa_ops.prefill_tile_plan(4096, 4128, causal=True, window=None,
                                    q_offset=0)
    assert all(p.first == 0 and p.end == i + 1 and sum(p.masked) == 1
               for i, p in enumerate(glob))
    loc = fa_ops.prefill_tile_plan(4096, 4128, causal=True,
                                   window=GEMMA3_1B.window, q_offset=0)
    assert max(p.end - p.first for p in loc) == 9
    assert all(sum(p.masked) == (2 if 64 * i >= GEMMA3_1B.window else 1)
               for i, p in enumerate(loc))


TWO_TERM_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_off)
    (1, 4, 1, 48, 48, 64, 64, True, None, 0),
    (1, 2, 1, 40, 72, 32, 32, True, 16, 32),
    (2, 2, 2, 16, 48, 16, 16, False, None, 0),
]


@pytest.mark.parametrize("shape", TWO_TERM_SHAPES)
def test_two_term_p_split(shape):
    """p carried into p·v as bf16 hi + lo (``flash_prefill.cu``'s two
    products) stays within the residual's bound of f32 p, in f32 inputs:
    |p - (hi + lo)| <= 2^-16 |p|, so each output moves by at most
    2^-16 · Σ p |v| / l <= 2^-16 · max |v| (plus 1e-6 of f32 rounding in
    the sums) from ``attention_ref``, and by that plus the JAX suite's
    3e-5 from the Pallas kernel (interpret mode).  One bf16 term (p
    rounded once) breaks that bound."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    rng = np.random.default_rng(Sq * Sk + D + 7)
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Hq, Hkv, Sq, Sk, D, Dv,
                                      "float32")
    kw = dict(causal=causal, window=window, q_offset=qoff)
    bound = 2.0 ** -16 * float(v.abs().max())
    want = _f32(attention_ref(q, k, v, **kw))
    two = _f32(attention_ref(q, k, v, p_terms=2, **kw))
    one = _f32(attention_ref(q, k, v, p_terms=1, **kw))
    assert_allclose(two, want, rtol=0, atol=bound + 1e-6)
    assert_allclose(two, _f32(_pallas(jq, jk, jv, **kw)), rtol=0,
                    atol=bound + TOL["float32"])
    assert np.abs(one - want).max() > bound + 1e-6
    p = torch.from_numpy(rng.random(4096, dtype=np.float32))
    split = fa_ops_ref.split_bf16(p, 2)
    assert bool(((split - p).abs() <= 2.0 ** -16 * p.abs()).all())


TF32_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_off)
    (1, 4, 1, 48, 48, 64, 64, True, None, 0),
    (1, 2, 1, 40, 72, 32, 32, True, 16, 32),
    (2, 2, 2, 16, 48, 16, 16, False, None, 0),
    (1, 4, 4, 16, 16, 24, 8, True, None, 0),
    (1, 2, 1, 33, 33, 256, 256, True, None, 0),
]


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_tf32_three_term_products(shape):
    """``flash_prefill_f32.cu``'s arithmetic: both products as three TF32
    products, ``A_hi·B_hi + A_hi·B_lo + A_lo·B_hi`` with ``x_hi =
    tf32(x)`` and ``x_lo = tf32(x - x_hi)`` (``attention_ref(tf32_terms=3)``),
    within the f32 limit of 3e-5 of the f32 plain version and of the
    Pallas kernel (interpret mode); one TF32 product (10 mantissa bits)
    misses that limit.  The split itself: ``|x - hi - lo| <= 2^-22 |x|``
    and each term has its low 13 bits clear."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    rng = np.random.default_rng(Sq * Sk + D + 11)
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Hq, Hkv, Sq, Sk, D, Dv,
                                      "float32")
    kw = dict(causal=causal, window=window, q_offset=qoff)
    tol = TOL["float32"]
    want = _f32(attention_ref(q, k, v, **kw))
    three = _f32(attention_ref(q, k, v, tf32_terms=3, **kw))
    one = _f32(attention_ref(q, k, v, tf32_terms=1, **kw))
    assert_allclose(three, want, rtol=tol, atol=tol)
    assert_allclose(three, _f32(_pallas(jq, jk, jv, **kw)), rtol=tol,
                    atol=tol)
    assert np.abs(one - want).max() > tol + tol * np.abs(want).max()
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = fa_ops_ref.split_tf32(x)
    assert bool(((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all())
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_columns_change_nothing(dtype):
    """stablelm-12b's D = 160 runs the (192, 192) instantiation, whose
    TMA loads fill the columns past 160 with zeros: q, k and v padded with
    zeros to 192 at the unchanged scale ``160 ** -0.5`` give the unpadded
    result in its first 160 columns (f32 within 1e-6: only the order of
    the sums differs; bf16 within one ulp), and the Pallas kernel's."""
    rng = np.random.default_rng(160)
    B, Hq, Hkv, S, D = 1, 4, 1, 40, 160
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Hq, Hkv, S, S, D, D, dtype)
    kw = dict(causal=True, window=None, q_offset=0)
    want = attention(q, k, v, **kw)
    padded = attention(*(torch.nn.functional.pad(t, (0, 32))
                         for t in (q, k, v)), scale=D ** -0.5, **kw)
    assert padded.shape[-1] == 192 and not padded[..., D:].any()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert_allclose(_f32(padded[..., :D]), _f32(want), rtol=tol, atol=1e-6)
    assert_allclose(_f32(padded[..., :D]), _f32(_pallas(jq, jk, jv, **kw)),
                    rtol=TOL[dtype], atol=TOL[dtype])


# gemma3-1b at the smoke run's decode: B = 8, 4 query heads on 1 KV head
# of 256, the max_len cache of 4,128 keys, q_offset 4,100
GEMMA_DECODE = dict(Sq=1, Sk=4128, q_offset=4100, blocks=8)
PLAN_CASES = [
    # (Sq, Sk, causal, window, q_offset, blocks)
    (1, 4128, True, None, 4100, 8),      # gemma3-1b global decode
    (1, 4128, True, 512, 4100, 8),       # gemma3-1b local decode
    (2, 300, True, 64, 250, 4),
    (1, 100, True, None, 150, 2),        # q_offset past Sk
    (2, 64, True, None, -1, 1),          # row 0 sees no key
    (1, 64, True, None, -5, 1),          # no row sees a key
    (1, 100, False, 30, 99, 4),          # not causal
    (1, 5, True, None, 4, 1),
    (8, 70000, True, None, 69000, 1),    # one long sequence
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_split_planner(case):
    """The splits cover exactly the visible keys (the union of what the
    rows see, from the mask itself), contiguous, inner boundaries on
    32-key tiles, never past q_offset + Sq; where the keys allow 2 blocks
    per SM, the call has at least one per SM, and a split reads at least
    2 tiles."""
    Sq, Sk, causal, window, off, blocks = case
    plan = fa_ops.plan_splits(Sq, Sk, causal=causal, window=window,
                              q_offset=off, blocks=blocks, n_sm=132)
    assert all(isinstance(x, int) for x in plan)
    seen = visible(Sq, Sk, causal=causal, window=window,
                   q_offset=off).any(dim=0).nonzero().flatten().tolist()
    bounds = plan.bounds()
    assert len(bounds) == plan.n_splits >= 1
    if not seen:
        assert bounds == [(plan.lo, plan.lo)]
        return
    assert (plan.lo, plan.hi) == (seen[0], seen[-1] + 1)
    assert bounds[0][0] == plan.lo and bounds[-1][1] == plan.hi
    tile = fa_ops.DECODE_TILE
    for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
        assert e0 == b1 and e0 % tile == 0
    assert all(e > b for b, e in bounds)
    assert all(e - b <= plan.tiles * tile for b, e in bounds)
    if causal:
        assert plan.hi <= off + Sq
    n_tiles = -(-plan.hi // tile) - plan.lo // tile
    assert plan.tiles >= min(fa_ops.DECODE_MIN_TILES, n_tiles)
    if n_tiles >= 2 * 2 * 132 // blocks:       # keys enough for 2 per SM
        assert blocks * plan.n_splits >= 132


def test_split_planner_at_gemma_decode():
    """gemma3-1b decode: global layers read 4,101 keys in B·Hkv·n_splits >=
    132 blocks; local layers' 512 keys (16 tiles) in >= 4 splits per
    (b, hk)."""
    glob = fa_ops.plan_splits(causal=True, window=None, n_sm=132,
                              **GEMMA_DECODE)
    loc = fa_ops.plan_splits(causal=True, window=GEMMA3_1B.window, n_sm=132,
                             **GEMMA_DECODE)
    assert (glob.lo, glob.hi) == (0, 4101) and 8 * glob.n_splits >= 132
    assert (loc.lo, loc.hi) == (3589, 4101) and loc.n_splits >= 4


def test_decode_shape():
    """Every gemma3-1b decode_step call (Sq = 1, 4 query heads on one KV
    head of 256) takes the decode kernel, its prefill does not; so do
    other calls with at most 8 query rows per KV head and head dims up to
    256."""
    cfg = GEMMA3_1B
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert fa_ops.decode_shape(1, H, Hkv, Dh, Dh)
    assert not fa_ops.decode_shape(4096, H, Hkv, Dh, Dh)
    assert not fa_ops.decode_shape(16, H, Hkv, Dh, Dh)
    assert fa_ops.decode_shape(2, H, Hkv, Dh, Dh)          # 8 rows
    assert not fa_ops.decode_shape(3, H, Hkv, Dh, Dh)      # 12 rows
    assert fa_ops.decode_shape(1, 7, 1, 128, 128)
    assert fa_ops.decode_shape(1, 64, 8, 128, 128)         # yi-34b style
    assert not fa_ops.decode_shape(1, 16, 1, 128, 128)
    assert not fa_ops.decode_shape(1, 4, 1, 576, 512)      # MLA widths
    assert not fa_ops.decode_shape(1, 4, 3, 64, 64)
    assert not fa_ops.decode_shape(1, 4, 0, 64, 64)


SPLITK_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, window, q_offset)
    (2, 4, 1, 1, 300, 256, 256, None, 250),    # G = 4, global
    (2, 4, 1, 1, 300, 256, 256, 64, 250),      # windowed
    (1, 7, 1, 1, 200, 160, 96, None, 150),     # G = 7, D = 160, Dv != D
    (1, 8, 2, 2, 120, 64, 32, None, 300),      # q_offset past Sk, Sq = 2
    (1, 4, 1, 2, 64, 256, 128, None, -1),      # row 0 sees no key
    (1, 4, 1, 1, 64, 160, 160, None, -5),      # no row sees a key
]


def _plans(Sq, Sk, window, q_offset, blocks):
    """Three cuts of the keys: the planner's; the planner's with empty
    splits between (and one past every key); and a cut at odd places."""
    planned = fa_ops.plan_splits(Sq, Sk, causal=True, window=window,
                                 q_offset=q_offset, blocks=blocks,
                                 n_sm=132).bounds()
    with_empty = [(0, 0)]
    for b, e in planned:
        with_empty += [(b, e), (e, e)]
    with_empty.append((Sk, Sk + 40))
    cuts = [0, 7, 7, 45, Sk // 2 + 3, Sk]
    odd = list(zip(cuts, cuts[1:]))
    return {"planned": planned, "with_empty": with_empty, "odd": odd}


@pytest.mark.parametrize("shape", SPLITK_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_splitk_plain_matches(shape, dtype):
    """The split-K algebra gives attention_ref's result for any cut of the
    keys, and the JAX package's (its Pallas kernel in interpret mode; its
    oracle where it is finite: it gives NaN for a row with no key, where
    the port gives exactly 0)."""
    B, Hq, Hkv, Sq, Sk, D, Dv, window, qoff = shape
    rng = np.random.default_rng(Sk * D + Hq)
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Hq, Hkv, Sq, Sk, D, Dv, dtype)
    kw = dict(causal=True, window=window, q_offset=qoff)
    want = _f32(attention_ref(q, k, v, **kw))
    pallas = _f32(_pallas(jq, jk, jv, block=64, **kw))
    oracle = _f32(j_attention_ref(jq, jk, jv, **kw))
    keyless = ~visible(Sq, Sk, q_offset=qoff, causal=True,
                       window=window).any(dim=1).numpy()
    assert np.isnan(oracle[:, :, keyless]).all()
    assert np.isfinite(oracle[:, :, ~keyless]).all()
    tol = TOL[dtype]
    for name, splits in _plans(Sq, Sk, window, qoff, B * Hkv).items():
        got = attention_splitk_ref(q, k, v, splits, **kw)
        assert got.dtype == q.dtype and tuple(got.shape) == (B, Hq, Sq, Dv)
        got = _f32(got)
        assert np.all(got[:, :, keyless] == 0), name
        assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)
        assert_allclose(got, pallas, rtol=tol, atol=tol, err_msg=name)
        assert_allclose(got[:, :, ~keyless], oracle[:, :, ~keyless],
                        rtol=tol, atol=tol, err_msg=name)


def test_plain_path_counts_no_launch():
    x = torch.ones(1, 2, 3, 8)
    before = launch_counts()
    attention(x, x, x)
    assert launch_counts() == before
