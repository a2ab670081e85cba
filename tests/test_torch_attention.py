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

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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

from repro_torch.kernels import attention, launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

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


def test_no_fallback_to_plain(monkeypatch):
    """Inputs the policy sends to the kernel are launched or raise: with
    the dispatch forced to the kernel and its build failing, the call
    raises instead of answering with the plain version, and no launch is
    counted."""
    def failed_build(name, signatures):
        raise RuntimeError(f"nvcc {name}.cu failed")

    monkeypatch.setattr(fa_ops, "use_kernel", lambda *t: True)
    monkeypatch.setattr(fa_ops._build, "load", failed_build)
    before = launch_counts()["flash_attention"]
    x = torch.zeros(1, 1, 4, 16)
    with pytest.raises(RuntimeError, match="failed"):
        attention(x, x, x)
    assert launch_counts()["flash_attention"] == before


def test_plain_path_counts_no_launch():
    x = torch.ones(1, 2, 3, 8)
    before = launch_counts()
    attention(x, x, x)
    assert launch_counts() == before
