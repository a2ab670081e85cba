"""The port's attention gradient against the JAX package's, on the CPU.

``repro_torch.kernels.attention`` takes :class:`FlashAttention` when
autograd records: the forward with the rows' statistics
(``attention_stats``: on the CPU the plain ``attention_ref_stats``) and the
backward ``attention_bwd``, a port of the reference's chunked recompute
``_flash_bwd`` (``repro/kernels/flash_attention/ops.py``).  Held here,
on the same numpy inputs and cotangent:

* ``(out, m, l)`` against the reference's ``_flash_fwd_impl``;
* ``dq, dk, dv`` through ``attention()`` against ``jax.grad`` of the
  reference's ``_chunked_gqa_attention`` (``block_k = 512``), and
  ``attention_bwd`` at a small ``block_k`` against the reference at the
  same ``block_k``, so that several chunks and a padded last chunk run;
  over GQA, a window, ``q_offset``, Dv != D (MLA's prefill dims, scaled
  down), rows that see no key, and no causal mask.

Tolerance: max |port - reference| / max |reference| <= 1e-4 in f32 (the
sums run in another order, and the forward's statistics come from the
plain one-pass softmax rather than the reference's online one), 2e-2 in
bf16 (the reference's XLA forward rounds p to bf16 before p·v; the port
keeps it in f32 as the kernels do, and each gradient is rounded to bf16).
The kernels' statistics output is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops

from repro_torch.kernels import attention, launch_counts
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_bwd,
                                                 attention_stats)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CASES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_offset)
    (2, 4, 2, 16, 16, 32, 32, True, None, 0),      # GQA
    (1, 4, 1, 24, 24, 16, 16, True, 8, 0),         # window, G = 4
    (1, 2, 2, 8, 40, 16, 16, True, None, 32),      # q_offset
    (1, 4, 4, 12, 12, 24, 16, True, None, 0),      # Dv != D (MLA-like)
    (1, 2, 1, 8, 16, 16, 16, True, 6, 14),         # rows with no key
    (1, 2, 2, 10, 14, 16, 8, False, None, 0),      # no causal mask
    (1, 2, 1, 530, 530, 16, 16, True, None, 0),    # padded last chunk
]


def _ids(c):
    return "B{}H{}:{}S{}x{}D{}:{}{}{}o{}".format(
        *c[:7], "c" if c[7] else "n", f"w{c[8]}" if c[8] else "", c[9])


def _inputs(case, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, D, Dv, *_ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D), np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D), np.float32)
    v = rng.standard_normal((B, Hkv, Sk, Dv), np.float32)
    cot = rng.standard_normal((B, Hq, Sq, Dv), np.float32)
    if dtype == "bfloat16":   # the same bf16 values on both sides
        q, k, v, cot = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                        for a in (q, k, v, cot))
    return q, k, v, cot


def _rel(got: torch.Tensor, want) -> float:
    w = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - w).max() /
                 (np.abs(w).max() + 1e-12))


def _jax_grads(q, k, v, cot, case, dtype, block_k):
    *_, causal, window, q_offset = case
    jd = JDT[dtype]

    def f(q, k, v):
        out = jops._chunked_gqa_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=None, block_k=block_k)
        return (out.astype(jnp.float32) * cot).sum()
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jd) for a in (q, k, v)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_attention_grad_matches_jax(case, dtype):
    *_, causal, window, q_offset = case
    q, k, v, cot = _inputs(case, dtype)
    want = _jax_grads(q, k, v, cot, case, dtype, block_k=512)
    ts = [torch.tensor(a, dtype=TDT[dtype], requires_grad=True)
          for a in (q, k, v)]
    out = attention(*ts, causal=causal, window=window, q_offset=q_offset)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == (
        "FlashAttentionBackward")
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(ts, want):
        assert t.grad.dtype == TDT[dtype]
        assert _rel(t.grad, w) <= TOL[dtype]


@pytest.mark.parametrize("block_k", [4, 7, 16])
@pytest.mark.parametrize("case", CASES[:6], ids=_ids)
def test_bwd_chunks_match_jax(case, block_k):
    """``attention_bwd`` at the reference's own ``block_k`` (several
    chunks, the last padded where block_k does not divide Sk), from the
    plain forward's ``(out, m, l)``."""
    *_, causal, window, q_offset = case
    q, k, v, cot = _inputs(case, "float32", seed=block_k)
    want = _jax_grads(q, k, v, cot, case, "float32", block_k=block_k)
    tq, tk, tv, tcot = (torch.from_numpy(a) for a in (q, k, v, cot))
    out, m, l = attention_stats(tq, tk, tv, causal=causal, window=window,
                                q_offset=q_offset)
    got = attention_bwd(tq, tk, tv, out, m, l, tcot, causal=causal,
                        window=window, q_offset=q_offset, block_k=block_k)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL["float32"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stats_match_flash_fwd_impl(case):
    """``(out, m, l)`` against the reference's ``_flash_fwd_impl`` (its
    ``q`` reshaped ``[B, Hkv, G, Sq, D]``, keys padded to whole chunks):
    ``l`` relative to its max, ``m`` to 1e-5 absolute where a row sees a
    key and -1e30 where it sees none (both packages), ``out`` 0 there."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_offset = case
    q, k, v, _ = _inputs(case, "float32")
    bk = min(512, Sk)
    pad = -(-Sk // bk) * bk - Sk
    kp = np.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0)))
    qpos = jnp.arange(Sq, dtype=jnp.int32) + q_offset
    win = jnp.int32(window if window is not None else 1 << 30)
    jout, jm, jl = jops._flash_fwd_impl(
        jnp.asarray(q).reshape(B, Hkv, Hq // Hkv, Sq, D), jnp.asarray(kp),
        jnp.asarray(vp), qpos, win, D ** -0.5, bk, causal, Sk)
    out, m, l = attention_stats(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal, window=window,
                                q_offset=q_offset)
    jm = np.asarray(jm).reshape(B, Hq, Sq)
    jl = np.asarray(jl).reshape(B, Hq, Sq)
    assert m.shape == l.shape == (B, Hq, Sq)
    assert m.dtype == l.dtype == torch.float32
    empty = jl == 0
    assert np.array_equal(l.numpy() == 0, empty)
    assert np.all(m.numpy()[empty] == -1e30) and np.all(jm[empty] == -1e30)
    assert np.abs(m.numpy() - jm)[~empty].max(initial=0) <= 1e-5
    assert _rel(l, jl) <= 1e-5
    assert _rel(out, np.asarray(jout).reshape(B, Hq, Sq, Dv)) <= 1e-5
    assert not out.numpy()[empty].any()


def test_attention_without_grad_keeps_its_route():
    """No autograd recording (no input requires grad, or grad disabled):
    the plain forward, no graph; with it, one FlashAttention node whose
    forward counts no kernel launch on the CPU."""
    q, k, v, _ = _inputs(CASES[0], "float32")
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    before = launch_counts()
    assert attention(*ts).grad_fn is None
    req = [t.clone().requires_grad_(True) for t in ts]
    with torch.no_grad():
        assert attention(*req).grad_fn is None
    out = attention(*req)
    assert torch.equal(out.detach(), attention(*ts))
    assert launch_counts() == before
    assert FlashAttention.apply(*req, True, None, 0, None).requires_grad
