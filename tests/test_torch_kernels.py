"""The port's kernel modules against the JAX package's, on the same inputs.

On the CPU every ``repro_torch`` kernel wrapper runs its plain PyTorch
version; these tests hold those bit for bit against the JAX package's
Pallas kernels (interpret mode) and XLA paths — masks, popcount partials,
f32 ``accw`` partials and the ``live`` indicator exactly, segment sums
exactly for 0/1 data and at the JAX suite's own ``rtol = atol = 1e-5`` for
general f32 (the one-hot product sums in another order).

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from repro.core import bitmaps as jbm
from repro.kernels import bucket_edges as j_bucket_edges
from repro.kernels import delta_apply_chain as j_chain
from repro.kernels import delta_apply_fused as j_fused
from repro.kernels import delta_apply_fused_batched as j_fused_batched
from repro.kernels import segment_sum as j_segment_sum
from repro.kernels.delta_apply.delta_apply import delta_apply_chain_pallas

from repro_torch.core import bitmaps as tbm
from repro_torch.kernels import (bucket_edges, delta_apply_chain,
                                 delta_apply_chain_batched, delta_apply_fused,
                                 delta_apply_fused_batched,
                                 delta_apply_fused_pair, launch_counts,
                                 planes_from_indices, policy, segment_sum)
from repro_torch.kernels.segment_sum import (bucket_edges_tensor,
                                             segment_sum_bucketed)
from repro_torch.runtime.staging import host_tensor as _t   # words as int32

JAX_IMPLS = (("pallas", True), ("xla", None))



def _bits(x) -> np.ndarray:
    """Any output (torch or jax, int or f32) as raw 32-bit patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint32)


def _rand_chain(rng, W, K, with_weights=True, B=None):
    lead = () if B is None else (B,)
    base = rng.integers(0, 2 ** 32, (*lead, W), dtype=np.uint32)
    adds = rng.integers(0, 2 ** 32, (*lead, K, W), dtype=np.uint32)
    dels = rng.integers(0, 2 ** 32, (*lead, K, W), dtype=np.uint32)
    w = rng.random(W * 32, dtype=np.float32) if with_weights else None
    return base, adds, dels, w


def _assert_fused_equal(got, want, msg=""):
    for field in ("mask", "pop", "accw", "live"):
        g, r = getattr(got, field), getattr(want, field)
        if r is None:
            assert g is None, (field, msg)
            continue
        assert np.array_equal(_bits(g), _bits(r)), (field, msg)


# ---------------------------------------------------------------------------
# bitmap substrate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("U", [1, 31, 32, 33, 1000])
def test_bitmaps_match_jnp(U):
    rng = np.random.default_rng(U)
    idx = rng.choice(U, size=min(U, 17), replace=False).astype(np.int32)
    padded = np.concatenate([idx, [-1, -1]]).astype(np.int32)
    ref = np.asarray(jbm.from_indices(jnp.asarray(padded), U))
    got = tbm.from_indices(torch.from_numpy(padded), U)
    assert np.array_equal(tbm.to_numpy_words(got), ref)
    mask = rng.random(U) < 0.5
    assert np.array_equal(tbm.to_numpy_words(tbm.pack(torch.from_numpy(mask))),
                          np.asarray(jbm.pack(jnp.asarray(mask))))
    words = rng.integers(0, 2 ** 32, tbm.num_words(U), dtype=np.uint32)
    assert np.array_equal(tbm.unpack(_t(words), U).numpy(),
                          np.asarray(jbm.unpack(jnp.asarray(words), U)))
    assert int(tbm.popcount(_t(words))) == int(jbm.popcount(jnp.asarray(words)))
    a, d = words[::-1].copy(), words ^ np.uint32(0x5A5A5A5A)
    assert np.array_equal(
        tbm.to_numpy_words(tbm.apply_delta(_t(words), _t(a), _t(d))),
        np.asarray(jbm.apply_delta(jnp.asarray(words), jnp.asarray(a),
                                   jnp.asarray(d))))
    _, adds, dels, _ = _rand_chain(rng, words.size, 3, False)
    assert np.array_equal(
        tbm.to_numpy_words(tbm.apply_delta_chain(_t(words), _t(adds),
                                                 _t(dels))),
        np.asarray(jbm.apply_delta_chain(jnp.asarray(words),
                                         jnp.asarray(adds),
                                         jnp.asarray(dels))))


# ---------------------------------------------------------------------------
# delta-apply chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [1, 7, 128, 1000])
@pytest.mark.parametrize("K", [0, 1, 3, 6])
def test_delta_apply_sweep(W, K):
    rng = np.random.default_rng(100 * W + K)
    base, adds, dels, _ = _rand_chain(rng, W, K, False)
    got = tbm.to_numpy_words(delta_apply_chain(_t(base), _t(adds), _t(dels)))
    xla = np.asarray(j_chain(jnp.array(base), jnp.array(adds),
                             jnp.array(dels), impl="xla"))
    pal = np.asarray(delta_apply_chain_pallas(
        jnp.array(base), jnp.array(adds), jnp.array(dels), block_w=256))
    assert np.array_equal(got, xla) and np.array_equal(got, pal)


def test_delta_apply_chain_batched_matches_rows():
    rng = np.random.default_rng(3)
    bases, adds, dels, _ = _rand_chain(rng, 300, 4, False, B=3)
    got = delta_apply_chain_batched(_t(bases), _t(adds), _t(dels))
    for i in range(3):
        one = np.asarray(j_chain(jnp.asarray(bases[i]), jnp.asarray(adds[i]),
                                 jnp.asarray(dels[i]), impl="xla"))
        assert np.array_equal(tbm.to_numpy_words(got[i]), one)


# ---------------------------------------------------------------------------
# fused chain + analytics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W,K,block_w", [
    (100, 0, 128),        # K=0: identity chain, analytics over the base
    (300, 3, 128),        # W not a multiple of block_w
    (1024, 5, 256),       # exact block multiple
    (128, 1, 128),        # single block, single delta
    (129, 2, 128),        # one word past a block boundary
])
@pytest.mark.parametrize("weighted", [True, False])
def test_fused_parity_bitwise(W, K, block_w, weighted):
    """Every output bit for bit against pallas-interpret and XLA —
    including the f32 partials (fixed per-word reduction groups)."""
    rng = np.random.default_rng(W * 10 + K)
    base, adds, dels, w = _rand_chain(rng, W, K, weighted)
    got = delta_apply_fused(_t(base), _t(adds), _t(dels),
                            None if w is None else torch.from_numpy(w),
                            block_w=block_w)
    for impl, interp in JAX_IMPLS:
        ref = j_fused(jnp.asarray(base), jnp.asarray(adds), jnp.asarray(dels),
                      None if w is None else jnp.asarray(w), impl=impl,
                      block_w=block_w, interpret=interp)
        _assert_fused_equal(got, ref, impl)
        assert int(got.live_count()) == int(ref.live_count())
        assert _bits(np.float32(got.weighted_total())) == _bits(
            np.float32(ref.weighted_total()))


def test_fused_nonfinite_weights_propagate():
    """``accw`` multiplies bit by weight (no select), as the reference does:
    an inf weight on a clear bit gives nan, on a set bit inf."""
    rng = np.random.default_rng(13)
    base, adds, dels, w = _rand_chain(rng, 40, 2)
    w[::37] = np.inf
    w[5::53] = np.nan
    got = delta_apply_fused(_t(base), _t(adds), _t(dels), torch.from_numpy(w),
                            block_w=128)
    assert not np.isfinite(got.accw.numpy()).all()
    for impl, interp in JAX_IMPLS:
        ref = j_fused(jnp.asarray(base), jnp.asarray(adds), jnp.asarray(dels),
                      jnp.asarray(w), impl=impl, block_w=128,
                      interpret=interp)
        np.testing.assert_array_equal(got.accw.numpy(), np.asarray(ref.accw),
                                      err_msg=impl)


def test_fused_emit_live_off():
    rng = np.random.default_rng(11)
    base, adds, dels, w = _rand_chain(rng, 256, 2)
    got = delta_apply_fused(_t(base), _t(adds), _t(dels), torch.from_numpy(w),
                            block_w=128, emit_live=False)
    assert got.live is None
    for impl, interp in JAX_IMPLS:
        ref = j_fused(jnp.asarray(base), jnp.asarray(adds), jnp.asarray(dels),
                      jnp.asarray(w), impl=impl, block_w=128,
                      interpret=interp, emit_live=False)
        _assert_fused_equal(got, ref, impl)


def test_fused_matches_plain_chain_mask():
    rng = np.random.default_rng(12)
    base, adds, dels, _ = _rand_chain(rng, 777, 4, False)
    plain = delta_apply_chain(_t(base), _t(adds), _t(dels))
    out = delta_apply_fused(_t(base), _t(adds), _t(dels))
    assert torch.equal(plain, out.mask)
    assert int(out.live_count()) == int(
        np.unpackbits(tbm.to_numpy_words(plain).view(np.uint8)).sum())
    ref = j_fused(jnp.asarray(base), jnp.asarray(adds), jnp.asarray(dels),
                  impl="xla")
    _assert_fused_equal(out, ref)


@pytest.mark.parametrize("K", [0, 1, 5])
@pytest.mark.parametrize("weighted,emit_live", [(True, True), (False, True),
                                                (True, False)])
def test_fused_pair(K, weighted, emit_live):
    """One pair call lands a node plane (with weights) and an edge plane of
    another width exactly as two JAX fused calls do, XLA and Pallas."""
    rng = np.random.default_rng(10 * K + weighted)
    node = _rand_chain(rng, 300, K, weighted)
    edge = _rand_chain(rng, 129, K, False)
    wn = None if node[3] is None else torch.from_numpy(node[3])
    got = delta_apply_fused_pair(*(_t(a) for a in node[:3]),
                                 *(_t(a) for a in edge[:3]), wn,
                                 block_w=128, emit_live=emit_live)
    assert len(got) == 2
    for out, (base, adds, dels, w) in zip(got, (node, edge)):
        for impl, interp in JAX_IMPLS:
            ref = j_fused(jnp.asarray(base), jnp.asarray(adds),
                          jnp.asarray(dels),
                          None if w is None else jnp.asarray(w), impl=impl,
                          block_w=128, interpret=interp,
                          emit_live=emit_live)
            _assert_fused_equal(out, ref, impl)


def test_fused_batched_parity():
    rng = np.random.default_rng(5)
    bases, adds, dels, w = _rand_chain(rng, 200, 4, True, B=3)
    got = delta_apply_fused_batched(_t(bases), _t(adds), _t(dels),
                                    torch.from_numpy(w), block_w=128)
    for impl, interp in JAX_IMPLS:
        ref = j_fused_batched(jnp.asarray(bases), jnp.asarray(adds),
                              jnp.asarray(dels), jnp.asarray(w), impl=impl,
                              block_w=128, interpret=interp)
        _assert_fused_equal(got, ref, impl)
    for i in range(3):
        one = delta_apply_fused(_t(bases[i]), _t(adds[i]), _t(dels[i]),
                                torch.from_numpy(w), block_w=128)
        _assert_fused_equal(one, type(one)(*(None if x is None else x[i]
                                              for x in got)), i)


# ---------------------------------------------------------------------------
# segment sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,N,D,bn", [(100, 37, 8, 16), (1000, 200, 16, 128),
                                      (5, 3, 4, 8), (64, 64, 1, 8)])
@pytest.mark.parametrize("data_kind", ["f32", "binary"])
def test_segment_sum_sweep(E, N, D, bn, data_kind):
    rng = np.random.default_rng(E + N)
    ids = rng.integers(0, N, E)
    if data_kind == "f32":
        data = rng.standard_normal((E, D)).astype(np.float32)
    else:
        data = (rng.random((E, D)) < 0.5).astype(np.float32)
    got = segment_sum(torch.from_numpy(data), ids, N, block_n=bn).numpy()
    for impl in ("xla", "pallas"):
        ref = np.asarray(j_segment_sum(jnp.asarray(data), ids, N, impl=impl,
                                       block_n=bn))
        if data_kind == "binary":
            assert np.array_equal(got, ref), impl
        else:
            assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=impl)


def _layout_ids(layout: str, bn: int, rng) -> tuple[np.ndarray, int]:
    """Segment ids for the bucket layouts the kernel handles apart: a
    bucket of only padding (the middle one of three), empty rows between
    filled ones, and one hub row holding most of a bucket's entries."""
    if layout == "padding_bucket":
        ids = rng.integers(0, 2 * bn, 6 * bn)
        return np.where(ids >= bn, ids + bn, ids), 3 * bn
    if layout == "gaps":
        return 3 * rng.integers(0, bn, 4 * bn), 3 * bn + 1
    ids = rng.integers(0, 2 * bn, 40 * bn)
    ids[rng.random(ids.size) < 0.85] = bn // 2 + 1
    return ids, 2 * bn


@pytest.mark.parametrize("layout", ["padding_bucket", "gaps", "hub"])
@pytest.mark.parametrize("D,bn", [(1, 16), (4, 8), (3, 128)])
@pytest.mark.parametrize("data_kind", ["f32", "binary"])
def test_segment_sum_layouts(layout, D, bn, data_kind):
    rng = np.random.default_rng(len(layout) * bn + D)
    ids, N = _layout_ids(layout, bn, rng)
    E = ids.size
    if data_kind == "f32":
        data = rng.standard_normal((E, D)).astype(np.float32)
    else:
        data = (rng.random((E, D)) < 0.5).astype(np.float32)
    got = segment_sum(torch.from_numpy(data), ids, N, block_n=bn).numpy()
    for impl in ("xla", "pallas"):
        ref = np.asarray(j_segment_sum(jnp.asarray(data), ids, N, impl=impl,
                                       block_n=bn))
        if data_kind == "binary":
            assert np.array_equal(got, ref), impl
        else:
            assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=impl)
    want = np.zeros((N, D), np.float32)
    np.add.at(want, ids, data)          # input order, as the kernel adds
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("E,N,D,bn", [(100, 37, 8, 16), (1000, 200, 1, 128)])
def test_segment_sum_plain_sums_in_input_order(E, N, D, bn):
    """The plain version adds each row's edges one at a time in input order
    (the CUDA kernel's order): bit for bit with ``np.add.at`` on any f32."""
    rng = np.random.default_rng(E * N)
    ids = rng.integers(0, N, E)
    data = rng.standard_normal((E, D)).astype(np.float32)
    want = np.zeros((N, D), np.float32)
    np.add.at(want, ids, data)
    got = segment_sum(torch.from_numpy(data), ids, N, block_n=bn).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("E,N,bn", [(0, 5, 4), (1, 1, 128), (200, 50, 16),
                                    (5000, 700, 128)])
def test_bucket_edges_identical(E, N, bn):
    """The vectorised bucketing emits exactly the JAX package's loop output,
    and precomputed buckets give the same sums."""
    rng = np.random.default_rng(E)
    ids = rng.integers(0, N, E)
    got, ref = bucket_edges(ids, N, bn), j_bucket_edges(ids, N, bn)
    assert got[2] == ref[2]
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert got[1].dtype == ref[1].dtype
    data = (rng.random((E, 2)) < 0.5).astype(np.float32)
    a = segment_sum(torch.from_numpy(data), ids, N, block_n=bn, buckets=got)
    b = segment_sum(torch.from_numpy(data), ids, N, block_n=bn)
    assert torch.equal(a, b)


BUCKET_CASES = ([(layout, None, None, bn)
                 for layout in ("padding_bucket", "gaps", "hub")
                 for bn in (8, 16, 128)]
                + [("random", 0, 300, 128), ("random", 0, 5, 4),
                   ("random", 1, 1, 128), ("random", 200, 50, 16),
                   ("random", 5000, 700, 128)])


@pytest.mark.parametrize("layout,E,N,bn", BUCKET_CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_bucket_edges_tensor_route_identical(layout, E, N, bn, dtype):
    """The device route, run here on CPU tensors, lays out exactly the host
    route's ``order``, ``local`` and ``ME``; its tensors as ``buckets=``
    give the same sums.  A CPU ``device`` keeps the host route."""
    rng = np.random.default_rng(len(layout) * bn + (E or 0))
    if layout == "random":
        ids = rng.integers(0, N, E)
    else:
        ids, N = _layout_ids(layout, bn, rng)
    ids = ids.astype(dtype)
    host = bucket_edges(ids, N, bn, device="cpu")
    assert isinstance(host[0], np.ndarray)
    order, local, ME = bucket_edges_tensor(torch.from_numpy(ids), N, bn)
    assert ME == host[2]
    assert order.dtype == torch.int64 and local.dtype == torch.int32
    assert np.array_equal(order.numpy(), host[0])
    assert np.array_equal(local.numpy(), host[1])
    data = (rng.random((ids.size, 2)) < 0.5).astype(np.float32)
    a = segment_sum(torch.from_numpy(data), ids, N, block_n=bn,
                    buckets=(order, local, ME))
    b = segment_sum(torch.from_numpy(data), ids, N, block_n=bn)
    assert torch.equal(a, b)


def test_bucket_edges_tensor_route_rejects_ids_past_the_buckets():
    with pytest.raises(IndexError):
        bucket_edges_tensor(torch.tensor([0, 9]), 5, 4)
    with pytest.raises(ValueError):
        bucket_edges_tensor(torch.tensor([0, -1]), 5, 4)
    with pytest.raises(IndexError):
        bucket_edges_tensor(torch.tensor([0]), 0, 4)


# ---------------------------------------------------------------------------
# index lists -> packed planes
# ---------------------------------------------------------------------------


def _plane_lists(case: str, rng):
    """``(lists [4][K], rows, U_n, U_e)`` for one case of the plain
    planes-from-indices version."""
    if case == "k0":
        return [[], [], [], []], 1, 40, 70
    if case == "empty":
        return [[np.zeros(0, np.int32)] * 3 for _ in range(4)], 3, 40, 70
    if case == "duplicates_unsorted":
        U_n, U_e = 300, 1000
        lists = [[rng.integers(0, U, 200) for _ in range(3)]
                 for U in (U_n, U_n, U_e, U_e)]
        lists[0][1] = np.concatenate([lists[0][1], lists[0][1][::-1]])
        return lists, 4, U_n, U_e
    if case == "ragged_last_word":
        U_n, U_e = 45, 100                    # W 2 and 4: bits past U too
        lists = [[np.array([31, 32, 44, 63]), np.array([0, 33])],
                 [np.zeros(0, np.int32), np.array([63, 62, 63])],
                 [np.array([96, 99, 127]), np.array([127, 0])],
                 [np.array([5, 100, 120]), np.zeros(0, np.int32)]]
        return lists, 2, U_n, U_e
    assert case == "one_large_list"           # the growing history's shape
    U_n, U_e = 600_000, 1_400_000
    big = np.sort(rng.choice(U_e, 1_260_000, replace=False))
    lists = [[np.sort(rng.choice(U, 500, replace=False)) for _ in range(2)]
             for U in (U_n, U_n, U_e, U_e)]
    lists[2][1] = big
    return lists, 3, U_n, U_e


def _concat_lists(lists, dtype):
    flat = [np.asarray(ix, dtype) for plane in lists for ix in plane]
    offsets = np.zeros(len(flat) + 1, np.int64)
    np.cumsum([ix.size for ix in flat], out=offsets[1:])
    idx = np.concatenate(flat) if flat else np.zeros(0, dtype)
    return torch.from_numpy(idx.astype(dtype)), torch.from_numpy(
        offsets.astype(dtype))


@pytest.mark.parametrize("case", ["k0", "empty", "duplicates_unsorted",
                                  "ragged_last_word", "one_large_list"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_planes_from_indices_plain_matches_np_from_indices(case, dtype):
    """Each row of the four stacks is ``np_from_indices`` of its list, and
    every row past the lists is zero, for lists in any order, with
    duplicates, in the ragged last word (up to the index 32·W - 1), empty,
    or none (K = 0); CPU tensors launch nothing."""
    rng = np.random.default_rng(len(case))
    lists, rows, U_n, U_e = _plane_lists(case, rng)
    idx, offsets = _concat_lists(lists, dtype)
    W_n, W_e = tbm.num_words(U_n), tbm.num_words(U_e)
    before = launch_counts()
    got = planes_from_indices(idx, offsets, rows, W_n, W_e)
    assert launch_counts() == before
    for plane, out, U in zip(lists, got, (U_n, U_n, U_e, U_e)):
        W = tbm.num_words(U)
        assert out.dtype == torch.int32 and out.shape == (rows, W)
        want = np.zeros((rows, W), np.uint32)
        for k, ix in enumerate(plane):
            want[k] = tbm.np_from_indices(ix, U)
        assert np.array_equal(out.numpy().view(np.uint32), want)


@pytest.mark.parametrize("plane", range(4))
@pytest.mark.parametrize("bad", ["32W", "negative"])
def test_planes_from_indices_plain_refuses_slots_past_the_words(plane, bad):
    W_n, W_e = 2, 5
    lists = [[np.array([0, 1])] for _ in range(4)]
    lists[plane][0] = np.array([3, 32 * (W_n, W_n, W_e, W_e)[plane]
                                if bad == "32W" else -1])
    idx, offsets = _concat_lists(lists, np.int32)
    with pytest.raises(IndexError):
        planes_from_indices(idx, offsets, 1, W_n, W_e)


def test_planes_from_indices_checks_its_rows():
    none = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError):                 # fewer rows than steps
        planes_from_indices(none, torch.zeros(9, dtype=torch.int32), 1, 2, 5)
    with pytest.raises(ValueError):                 # not 4K + 1 offsets
        planes_from_indices(none, torch.zeros(8, dtype=torch.int32), 2, 2, 5)


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------


def test_dispatch_by_device_only(monkeypatch):
    """CPU tensors take the plain version and launch nothing; other or
    mixed devices raise; no environment variable changes the choice."""
    monkeypatch.setenv("REPRO_KERNEL", "pallas")
    monkeypatch.setenv("REPRO_TORCH_KERNEL", "triton")
    before = launch_counts()
    x = torch.zeros(4, dtype=torch.int32)
    assert policy.use_kernel(x, None) is False
    delta_apply_chain(x, x[None], x[None])
    assert launch_counts() == before
    m = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        policy.use_kernel(m)
    with pytest.raises(ValueError):
        delta_apply_fused(m, m[None], m[None])
    with pytest.raises(ValueError):
        segment_sum_bucketed(torch.zeros(1, 2, 1, device="meta"),
                             torch.zeros(1, 2, dtype=torch.int32), block_n=4)
    with pytest.raises(ValueError):
        delta_apply_fused_pair(m, m[None], m[None], x, x[None], x[None])
    with pytest.raises(ValueError):
        policy.use_kernel(None)
