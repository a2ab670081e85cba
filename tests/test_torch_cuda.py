"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  They cover the shapes ``chip_smoke.py`` does not:
odd widths, ragged word groups, K = 0 and K past the fused kernel's
unrolled limit, weights shorter than ``32 * W``, both planes in one fused
launch, segment-sum's bucket layouts (a bucket of only padding, empty rows,
a hub bucket longer than the kernel's shared-memory tile; D 1, 4 and 16,
block_n 8, 128 and 256), those buckets built on the card against the
host's, the pinned host-to-device put and the streamed
retrieval path; for flash
attention the JAX suite's shape sweep plus D = 256 with GQA 4:1, windows,
rows without a key, strided inputs, the split-K decode kernel at the
gemma3-1b decode shapes, the wgmma/TMA prefill kernel on ragged tiles,
windows, chunked prefill, GQA groups, every head-dim instantiation and
cache slices, stablelm's D = 160 through it (the (192, 192)
instantiation, TMA filling the columns past 160), the TF32 f32 prefill
kernel on the same cases and on few-row calls just past the decode limit,
the old kernels of ``flash_attention.cu`` (kept as yardsticks) at
gemma3-1b widths, MLA's absorbed decode through ``flash_mla_wgmma.cu``
(its cluster merge at 3, 7 and 8 splits) and ``flash_mla.cu`` beside
it, and a reduced LM on the card; for the temporal engine,
``evolve_intervals_torch`` (monolithic and streamed), the batch loader
and both fixpoint solvers on the card against the port's own CPU runs;
for sharded retrieval, the word-cyclic ``[P, K, Wp]`` stacks through the
chain kernel (two launches a timepoint) against the CPU path; for GNN and
DIN, the four reduced GNNs (two with gather chunks) and reduced DIN on the
card against the CPU (gradients within 1e-4 of each leaf's largest
magnitude: aggregation on the card adds with float atomics) and the
chunked gather and segment sum at 1, 3, 4 and 32 chunks; for the dry run,
CUDA inputs launch the attention kernels under its accounting mode and
take no shape-only route, which ``meta`` copies of them take.
This file imports no JAX, so it runs on a machine without it::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import DeltaGraph
from repro_torch.data.generators import churn_network
from repro_torch.kernels import (attention, delta_apply_chain,
                                 delta_apply_chain_batched,
                                 delta_apply_fused_batched,
                                 delta_apply_fused_pair, launch_counts,
                                 segment_sum)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.segment_sum import (bucket_edges,
                                             segment_sum_bucketed)
from repro_torch.kernels.flash_attention.ref import attention_ref, visible
from repro_torch.kernels.delta_apply.ref import (delta_apply_chain_ref,
                                                 delta_apply_fused_ref)
from repro_torch.runtime import torch_exec
from repro_torch.runtime.staging import DeviceStager, PinnedPut
from repro_torch.runtime.staging import host_tensor as _t   # words as int32
from repro_torch.storage.kv import MemKV



def _rand_chain(rng, W, K, with_weights, B):
    bases = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint32)
    adds = rng.integers(0, 2 ** 32, (B, K, W), dtype=np.uint32)
    dels = rng.integers(0, 2 ** 32, (B, K, W), dtype=np.uint32)
    w = rng.random(W * 32, dtype=np.float32) if with_weights else None
    return bases, adds, dels, w


def _assert_fused_equal(got, want):
    for field in ("mask", "pop", "accw", "live"):
        g, r = getattr(got, field), getattr(want, field)
        if r is None:
            assert g is None, field
            continue
        assert torch.equal(g.cpu().view(torch.int32), r.view(torch.int32)), field


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,W", [(1, 0, 1), (1, 1, 7), (3, 6, 1000),
                                   (2, 3, 4097)])
def test_cuda_chain_matches_plain(cuda_device, B, K, W):
    rng = np.random.default_rng(B * K + W)
    bases, adds, dels, _ = _rand_chain(rng, W, K, False, B=B)
    dev = [_t(a).to(cuda_device) for a in (bases, adds, dels)]
    n0 = launch_counts()["delta_apply_chain"]
    got = delta_apply_chain_batched(*dev)
    one = delta_apply_chain(dev[0][0], dev[1][0], dev[2][0])
    torch.cuda.synchronize()
    assert launch_counts()["delta_apply_chain"] == n0 + 2
    ref = delta_apply_chain_ref(_t(bases), _t(adds), _t(dels))
    assert torch.equal(got.cpu(), ref) and torch.equal(one.cpu(), ref[0])


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,W,block_w", [(1, 0, 1, 128), (1, 3, 100, 128),
                                           (2, 2, 1000, 256),
                                           (3, 4, 3000, 1024),
                                           (1, 1, 2049, 1024),
                                           # K at the unrolled limit and past
                                           # it; groups that split a warp or
                                           # span many tiles
                                           (3, 8, 18764, 384),
                                           (2, 9, 4097, 100),
                                           (1, 16, 43737, 1024),
                                           (1, 13, 255, 8192)])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("emit_live", [True, False])
def test_cuda_fused_matches_plain(cuda_device, B, K, W, block_w, weighted,
                                  emit_live):
    rng = np.random.default_rng(B + K + W)
    bases, adds, dels, w = _rand_chain(rng, W, K, weighted, B=B)
    if weighted:
        w = w[: W * 32 - 5]        # shorter than 32·W: zero-padded
    wt = None if w is None else torch.from_numpy(w)
    got = delta_apply_fused_batched(
        *(_t(a).to(cuda_device) for a in (bases, adds, dels)),
        None if wt is None else wt.to(cuda_device), block_w=block_w,
        emit_live=emit_live)
    torch.cuda.synchronize()
    ref = delta_apply_fused_ref(_t(bases), _t(adds), _t(dels), wt,
                                block_w=block_w, emit_live=emit_live)
    _assert_fused_equal(got, type(got)(*ref))


@pytest.mark.cuda
@pytest.mark.parametrize("K,W_n,W_e", [(7, 18764, 43737), (0, 5, 300),
                                       (11, 1024, 1027), (2, 0, 33)])
@pytest.mark.parametrize("emit_live", [True, False])
def test_cuda_fused_pair_matches_plain(cuda_device, K, W_n, W_e, emit_live):
    """Both planes of a singlepoint retrieval (weights on the node plane)
    in one launch, counted once, bit for bit."""
    rng = np.random.default_rng(K + W_n + W_e)
    node = _rand_chain(rng, W_n, K, True, B=1)
    edge = _rand_chain(rng, W_e, K, False, B=1)
    planes = [[_t(a[0]) for a in p[:3]] for p in (node, edge)]
    wn = torch.from_numpy(node[3])
    n0 = launch_counts()["delta_apply_fused"]
    got = delta_apply_fused_pair(
        *(a.to(cuda_device) for a in planes[0]),
        *(a.to(cuda_device) for a in planes[1]), wn.to(cuda_device),
        emit_live=emit_live)
    torch.cuda.synchronize()
    assert launch_counts()["delta_apply_fused"] == n0 + (1 if W_n + W_e
                                                         else 0)
    for out, p, w in zip(got, planes, (wn, None)):
        ref = delta_apply_fused_ref(*p, w, emit_live=emit_live)
        _assert_fused_equal(out, type(out)(*ref))


@pytest.mark.cuda
def test_cuda_fused_nonfinite_weights_propagate(cuda_device):
    """inf and nan weights reach ``accw`` as in the plain version (nan
    payloads may differ between the card and the host, so nan positions
    are compared, not nan bits)."""
    rng = np.random.default_rng(13)
    bases, adds, dels, w = _rand_chain(rng, 2000, 2, True, B=1)
    w[::37] = np.inf
    w[5::53] = np.nan
    got = delta_apply_fused_batched(
        *(_t(a).to(cuda_device) for a in (bases, adds, dels)),
        torch.from_numpy(w).to(cuda_device))
    ref = delta_apply_fused_ref(_t(bases), _t(adds), _t(dels),
                                torch.from_numpy(w))
    torch.testing.assert_close(got.accw.cpu(), ref[2], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,D,bn", [(100, 37, 8, 16), (5000, 700, 1, 128),
                                      (5, 3, 4, 8)])
def test_cuda_segment_sum_matches_plain(cuda_device, E, N, D, bn):
    rng = np.random.default_rng(E)
    ids = rng.integers(0, N, E)
    binary = (rng.random((E, D)) < 0.5).astype(np.float32)
    general = rng.standard_normal((E, D)).astype(np.float32)
    for data in (binary, general):
        # both sum each row's edges in input order: bit for bit on any f32
        got = segment_sum(torch.from_numpy(data).to(cuda_device), ids, N,
                          block_n=bn).cpu()
        ref = segment_sum(torch.from_numpy(data), ids, N, block_n=bn)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _layout_ids(layout: str, bn: int, rng) -> tuple[np.ndarray, int]:
    """Segment ids of three buckets: the middle one only padding, empty
    rows between filled ones, or one hub row holding most of 30,000
    entries (a bucket longer than the kernel's shared-memory tile)."""
    if layout == "padding_bucket":
        ids = rng.integers(0, 2 * bn, 6 * bn)
        return np.where(ids >= bn, ids + bn, ids), 3 * bn
    if layout == "gaps":
        return 3 * rng.integers(0, bn, 4 * bn), 3 * bn + 1
    ids = rng.integers(0, 2 * bn, 30_000)
    ids[rng.random(ids.size) < 0.85] = bn // 2 + 1
    return ids, 3 * bn


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padding_bucket", "gaps", "hub"])
@pytest.mark.parametrize("D", [1, 4, 16])
@pytest.mark.parametrize("bn", [8, 128, 256])
def test_cuda_segment_sum_layouts(cuda_device, layout, D, bn):
    rng = np.random.default_rng(len(layout) + D + bn)
    ids, N = _layout_ids(layout, bn, rng)
    if layout == "hub":
        assert bucket_edges(ids, N, bn)[2] >= 20_000
    binary = (rng.random((ids.size, D)) < 0.5).astype(np.float32)
    general = rng.standard_normal((ids.size, D)).astype(np.float32)
    for data in (binary, general):
        n0 = launch_counts()["segment_sum_bucketed"]
        got = segment_sum(torch.from_numpy(data).to(cuda_device), ids, N,
                          block_n=bn).cpu()
        assert launch_counts()["segment_sum_bucketed"] == n0 + 1
        ref = segment_sum(torch.from_numpy(data), ids, N, block_n=bn)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padding_bucket", "gaps", "hub",
                                    "random", "empty"])
@pytest.mark.parametrize("bn", [8, 128])
def test_cuda_bucket_edges_device_route(cuda_device, layout, bn):
    """For CUDA data the buckets are built on the card: entry for entry the
    host route's arrays, in one ``bucket`` span that stages the ids once
    (a ``stage`` inside it, their bytes in ``h2d_bytes``) and adds NB x ME
    to ``bucket_entries``; ``segment_sum`` on CUDA data, with and without
    those buckets passed in, equals the plain version bit for bit and
    stages nothing more when given them."""
    rng = np.random.default_rng(len(layout) * bn)
    if layout in ("random", "empty"):
        N = 700
        ids = rng.integers(0, N, 0 if layout == "empty" else 50_000)
    else:
        ids, N = _layout_ids(layout, bn, rng)
    ids = ids.astype(np.int32)
    host = bucket_edges(ids, N, bn)
    NB = -(-N // bn)
    before = obs.counters()
    obs.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        order, local, ME = bucket_edges(ids, N, bn, cuda_device)
    after = obs.counters()
    (bucket,) = [r for r in obs.records() if r.name == "bucket"]
    (stage,) = [r for r in obs.records() if r.name == "stage"]
    assert bucket.work == {"edges": ids.size, "NB": NB, "ME": ME}
    assert stage.parent == bucket.sid and stage.work == {"bytes": ids.nbytes}
    assert after["bucket_entries"] - before.get("bucket_entries", 0) == \
        NB * ME
    assert after["h2d_bytes"] - before.get("h2d_bytes", 0) == ids.nbytes
    assert order.is_cuda and local.is_cuda and ME == host[2]
    assert np.array_equal(order.cpu().numpy(), host[0])
    assert np.array_equal(local.cpu().numpy(), host[1])
    data = rng.standard_normal((ids.size, 2)).astype(np.float32)
    ref = segment_sum(torch.from_numpy(data), ids, N, block_n=bn)
    on_card = torch.from_numpy(data).to(cuda_device)
    got = segment_sum(on_card, ids, N, block_n=bn).cpu()
    h2d = obs.counters().get("h2d_bytes", 0)
    pre = segment_sum(on_card, ids, N, block_n=bn,
                      buckets=(order, local, ME)).cpu()
    assert obs.counters().get("h2d_bytes", 0) == h2d
    for out in (got, pre):
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("ME", [700, 1024, 2100])
def test_cuda_segment_sum_empty_and_short_buckets(cuda_device, ME):
    """ME = 0 gives zeros; a bucket whose valid prefix ends at or next to a
    round of ids (256), a slice of a long bucket's warps or a staged tile
    (1,024 and 4,096 floats) ends there; buckets of a warp each (ME up to
    1,024) and of a block each (longer)."""
    out = segment_sum_bucketed(torch.zeros(3, 0, 2, device=cuda_device),
                               torch.zeros(3, 0, dtype=torch.int32,
                                           device=cuda_device), block_n=4)
    assert torch.equal(out.cpu(), torch.zeros(3, 4, 2))
    rng = np.random.default_rng(ME)
    for n_valid in (0, 1, 255, 256, 257, 511, 512, 513, 525, 526, 1023,
                    1024, 1025, 2048, ME - 1, ME):
        if n_valid > ME:
            continue
        ids = np.full((2, ME), -1, np.int32)
        ids[0, :n_valid] = np.sort(rng.integers(0, 64, n_valid))
        ids[1, :ME - n_valid] = np.sort(rng.integers(0, 64, ME - n_valid))
        data = rng.standard_normal((2, ME, 1)).astype(np.float32)
        got = segment_sum_bucketed(torch.from_numpy(data).to(cuda_device),
                                   torch.from_numpy(ids).to(cuda_device),
                                   block_n=64).cpu()
        ref = segment_sum_bucketed(torch.from_numpy(data),
                                   torch.from_numpy(ids), block_n=64)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_cuda_pinned_put_holds_buffers_until_copied(cuda_device):
    put = PinnedPut(cuda_device)
    words = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    got = [put(words), put(np.arange(5, dtype=np.float32))]
    assert put.pending() <= 2
    torch.cuda.synchronize()
    assert np.array_equal(got[0].cpu().numpy().view(np.uint32), words)
    assert torch.equal(got[1].cpu(), torch.arange(5, dtype=torch.float32))
    put(np.zeros(1, np.int32))        # drains the copies known to be done
    assert put.pending() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", ["1", "0"])
def test_cuda_retrieval_matches_cpu(cuda_device, monkeypatch, chunk):
    """Streamed (chunk 1) and monolithic (chunk 0) multipoint retrieval and
    fused analytics on the card give the CPU path's masks and partials."""
    uni, ev = churn_network(n_initial_edges=150, n_events=1200, seed=1)
    dg = DeltaGraph(uni, MemKV(), L=100, k=2).build(ev)
    tmax = int(ev.time[-1])
    times = [0, tmax // 3, tmax // 2, tmax]
    monkeypatch.setenv("REPRO_STREAM_CHUNK", chunk)
    stager = DeviceStager(device=cuda_device)
    got = torch_exec.execute_multipoint_torch(dg, times, stager=stager)
    want = torch_exec.execute_multipoint_torch(dg, times, device="cpu")
    assert bool(stager.events) == (chunk == "1")     # streaming engaged
    for t in times:
        assert np.array_equal(got[t][0], want[t][0])
        assert np.array_equal(got[t][1], want[t][1])
    nm, em, an = torch_exec.execute_singlepoint_fused(dg, tmax // 2)
    cnm, cem, can = torch_exec.execute_singlepoint_fused(dg, tmax // 2,
                                                         device="cpu")
    assert np.array_equal(em, cem) and np.array_equal(nm, cnm)
    _assert_fused_equal(an.edge, can.edge)
    assert np.array_equal(an.degrees(), can.degrees())


@pytest.mark.cuda
@pytest.mark.parametrize("fn,P,partitions", [("word_cyclic", 8, 8),
                                             ("mod_hash", 4, 8),
                                             ("word_cyclic", 3, 3)])
def test_cuda_sharded_retrieval_matches_cpu(cuda_device, fn, P, partitions):
    """Sharded retrieval on the card: two chain launches a timepoint, the
    P rows as the batch, masks equal to the CPU path's, and the kernel
    equal to its plain version on the lowered stacks."""
    uni, ev = churn_network(n_initial_edges=150, n_events=1200, seed=1)
    dg = DeltaGraph(uni, MemKV(), L=100, k=2, num_partitions=P,
                    partition_fn=fn).build(ev)
    tmax = int(ev.time[-1])
    for t in (0, tmax // 3, tmax):
        before = launch_counts()["delta_apply_chain"]
        got = torch_exec.execute_singlepoint_sharded_torch(
            dg, t, partitions=partitions)
        assert launch_counts()["delta_apply_chain"] == before + 2
        want = torch_exec.execute_singlepoint_sharded_torch(
            dg, t, partitions=partitions, device="cpu")
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    for base, adds, dels, U in torch_exec.lower_singlepoint_sharded(
            dg, tmax // 2, partitions=partitions, device=cuda_device):
        assert adds.shape[0] == partitions and adds.is_cuda
        out = delta_apply_chain_batched(base, adds, dels)
        ref = delta_apply_chain_ref(base.cpu(), adds.cpu(), dels.cpu())
        assert torch.equal(out.cpu(), ref)


ATTN_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_off)
    (2, 4, 2, 16, 16, 32, 32, True, None, 0),
    (1, 4, 4, 33, 33, 16, 16, True, None, 0),
    (1, 8, 1, 8, 64, 32, 32, True, None, 56),
    (2, 4, 2, 32, 32, 32, 32, True, 8, 0),
    (1, 2, 2, 16, 48, 16, 16, False, None, 0),
    (1, 4, 4, 16, 16, 24, 8, True, None, 0),      # Dv != D
    (2, 4, 1, 100, 100, 256, 256, True, 40, 0),   # gemma3 widths, GQA 4:1
    (1, 4, 1, 1, 300, 256, 256, True, None, 250),  # decode, unwritten tail
    (1, 4, 1, 1, 300, 256, 256, True, 64, 250),
    (1, 32, 8, 70, 70, 160, 160, True, None, 0),   # stablelm head_dim
    (1, 2, 1, 40, 40, 192, 128, True, None, 0),    # MLA prefill widths
    (1, 2, 1, 16, 16, 16, 16, True, None, -3),     # rows with no key
    # decode (Sq · Hq / Hkv <= 8 rows per KV head: the split-K kernel)
    (8, 4, 1, 1, 4128, 256, 256, True, None, 4100),  # gemma3-1b global
    (8, 4, 1, 1, 4128, 256, 256, True, 512, 4100),   # gemma3-1b local
    (1, 7, 1, 1, 200, 128, 128, True, None, 150),    # G = 7
    (2, 8, 2, 2, 300, 256, 256, True, 64, 250),      # Sq = 2, G = 4
    (1, 4, 1, 2, 64, 64, 32, True, None, -1),        # row 0 sees no key
    (1, 4, 1, 1, 64, 160, 96, True, None, -5),       # no row sees a key
    (2, 4, 2, 1, 100, 24, 40, False, 30, 99),        # not causal, window
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_matches_plain(cuda_device, shape, dtype):
    """Kernel against plain on the same inputs: 3e-5 in f32; in bf16 each
    element within 2^-6·|plain| + 1e-5 (both sum in f32 and round once to
    bf16: one ulp apart at most, plus f32 noise).  Calls with at most 8
    query rows per KV head take the split-K decode kernel, other bf16 calls
    the wgmma/TMA prefill kernel and other f32 calls the TF32 one."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    g = torch.Generator().manual_seed(Sq * Sk + D)
    q, k, v = (torch.randn(s, generator=g).to(dtype) for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    n0 = launch_counts()
    got = attention(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert n1["flash_attention"] == n0["flash_attention"] + 1
    decode = Sq * Hq // Hkv <= 8
    assert (n1["flash_attention_decode"] - n0["flash_attention_decode"]
            == int(decode))
    bf16 = dtype == torch.bfloat16
    assert (n1["flash_attention_prefill"] - n0["flash_attention_prefill"]
            == int(bf16 and not decode))
    assert (n1["flash_attention_prefill_f32"] -
            n0["flash_attention_prefill_f32"] == int(not bf16 and not decode))
    want = attention_ref(q, k, v, **kw)
    rtol, atol = (3e-5, 3e-5) if dtype == torch.float32 else (2 ** -6, 1e-5)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=rtol,
                               atol=atol)
    if qoff < 0:
        assert torch.all(got[:, :, :-qoff] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,q_offset", [(50, 0), (1, 49), (2, 48)])
def test_cuda_attention_strided_inputs(cuda_device, Sq, q_offset):
    """q as a transposed projection and k/v as slices of longer caches
    (one of them the K half of a cache holding K and V side by side at
    each position), read through their strides by the prefill kernel
    (Sq = 50) and the decode kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(2, Sq, 4, 64, generator=g, device=cuda_device,
                    dtype=torch.bfloat16).transpose(1, 2)
    cache = torch.randn(2, 2, 80, 64, generator=g, device=cuda_device,
                        dtype=torch.bfloat16)
    k, v = cache[:, :, :50], cache.flip(2)[:, :, :50].contiguous()
    kv = torch.randn(2, 80, 2, 2, 64, generator=g, device=cuda_device,
                     dtype=torch.bfloat16)
    k2 = kv[:, :50, 0].transpose(1, 2)
    for kk, vv in ((k, v), (k2, v)):
        n0 = launch_counts()["flash_attention_decode"]
        got = attention(q, kk, vv, window=16, q_offset=q_offset)
        assert (launch_counts()["flash_attention_decode"] - n0 ==
                int(Sq * 2 <= 8))
        want = attention_ref(q.contiguous(), kk.contiguous(), vv, window=16,
                             q_offset=q_offset)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                                   atol=1e-5)


PREFILL_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_off)
    (1, 1, 1, 64, 64, 64, 64, False, None, 0),       # one query, one key tile
    (1, 1, 1, 64, 64, 256, 256, False, None, 0),
    (1, 1, 1, 64, 64, 256, 256, True, None, 0),
    (1, 4, 1, 300, 333, 256, 256, True, None, 33),   # Sq and Sk tails
    (2, 4, 1, 200, 200, 256, 256, True, 17, 0),      # window < a key tile
    (1, 4, 1, 500, 500, 256, 256, True, 100, 0),     # window not a multiple
    (2, 4, 1, 70, 500, 256, 256, True, None, 430),   # chunked prefill
    (1, 4, 1, 64, 640, 256, 256, True, 150, 576),    # chunked, windowed
    (1, 2, 2, 130, 130, 128, 128, True, None, 0),    # G = 1
    (1, 8, 1, 100, 164, 128, 128, True, None, 64),   # G = 8
    (1, 16, 2, 90, 90, 64, 64, True, 40, 0),         # G = 8, Hkv = 2
    (1, 2, 1, 200, 260, 192, 128, True, 37, 50),     # MLA prefill widths
    (1, 4, 1, 100, 100, 64, 64, True, None, -5),     # rows with no key
    (1, 4, 1, 40, 40, 128, 128, True, None, -100),   # no row sees a key
    (1, 2, 1, 100, 90, 64, 64, False, 20, 10),       # not causal, window
    (1, 2, 1, 66, 66, 192, 192, True, None, 0),      # (192, 192)
    (1, 2, 1, 66, 66, 64, 128, True, None, 0),       # run at (128, 128)
    (1, 2, 1, 40, 40, 192, 96, True, None, 0),       # run at (192, 128)
    (1, 4, 1, 50, 50, 16, 16, True, None, 0),        # a box wider than D
    (1, 2, 1, 30, 30, 24, 8, True, None, 0),         # D padded to 32
    # stablelm-12b's D = 160 at (192, 192): columns past 160 zero-filled
    (1, 32, 8, 300, 333, 160, 160, True, None, 33),  # Sq and Sk tails, G 4
    (1, 8, 8, 200, 200, 160, 160, True, 37, 0),      # window, G = 1
    (1, 14, 2, 70, 500, 160, 160, True, None, 430),  # chunked prefill, G 7
    (2, 8, 2, 100, 100, 160, 160, True, None, -5),   # rows with no key
    (1, 4, 1, 40, 40, 160, 160, True, None, -100),   # no row sees a key
    (1, 4, 1, 100, 90, 160, 160, False, 20, 10),     # not causal, window
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_cuda_prefill_matches_plain(cuda_device, shape):
    """The wgmma/TMA prefill kernel against the plain version, element by
    element within 2^-6·|plain| + 1e-5 (two bf16 ulps: both sum in f32,
    the kernel carries p as bf16 hi + lo, within 2^-16 |p|, and each
    rounds once to bf16); rows that see no key exactly 0.  Only
    ``flash_attention`` and ``flash_attention_prefill`` count the call."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    g = torch.Generator().manual_seed(Sq * Sk + D + Dv)
    q, k, v = (torch.randn(s, generator=g).bfloat16() for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    assert fa_ops.route(Sq, Hq, Hkv, D, Dv, q.dtype) == "flash_prefill"
    n0 = launch_counts()
    got = attention(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert {n: n1[n] - n0[n] for n in n0 if n1[n] != n0[n]} == {
        "flash_attention": 1, "flash_attention_prefill": 1}
    want = attention_ref(q, k, v, **kw)
    assert got.shape == want.shape
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2 ** -6,
                               atol=1e-5)
    keyless = ~visible(Sq, Sk, causal=causal, window=window,
                       q_offset=qoff).any(dim=1)
    assert torch.all(got.cpu()[:, :, keyless] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 2])
def test_cuda_prefill_strided(cuda_device, layer):
    """A transposed q projection ([B, S, Hq, D] viewed as [B, Hq, S, D])
    and K/V as one layer of [L, B, Hkv, max_len, D] caches, attended over
    the whole cache from ``q_offset`` 200 as a chunked prefill does: the
    TMA maps read them through their strides, with no copy."""
    L, B, Hkv, G, max_len, D, S, start = 3, 2, 2, 4, 400, 256, 150, 200
    g = torch.Generator(device=cuda_device).manual_seed(layer)
    ck = torch.randn(L, B, Hkv, max_len, D, generator=g, device=cuda_device,
                     dtype=torch.bfloat16)
    cv = torch.randn(L, B, Hkv, max_len, D, generator=g, device=cuda_device,
                     dtype=torch.bfloat16)
    q = torch.randn(B, S, Hkv * G, D, generator=g, device=cuda_device,
                    dtype=torch.bfloat16).transpose(1, 2)
    k, v = ck[layer], cv[layer]
    args = fa_ops.kernel_args(q, k, v, causal=True, window=None,
                              q_offset=start, scale=None)
    assert args[0].data_ptr() == q.data_ptr()        # read in place
    assert args[1].data_ptr() == k.data_ptr() and args[1].stride() == \
        k.stride()
    for window in (None, 64):
        n0 = launch_counts()["flash_attention_prefill"]
        got = attention(q, k, v, window=window, q_offset=start)
        assert launch_counts()["flash_attention_prefill"] == n0 + 1
        want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                             window=window, q_offset=start)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [160, 256])
def test_cuda_prefill_strided_head_dims(cuda_device, D):
    """stablelm's D = 160 (and 256) from a transposed q projection and one
    layer of [L, B, Hkv, max_len, D] caches: the TMA maps read the views
    through their strides with the real D as their column extent, and the
    output is a contiguous ``[B, Hq, S, D]`` tensor, not a view of a
    padded one."""
    L, B, Hkv, G, max_len, S, start = 2, 1, 8, 4, 300, 120, 100
    g = torch.Generator(device=cuda_device).manual_seed(D)
    ck, cv = (torch.randn(L, B, Hkv, max_len, D, generator=g,
                          device=cuda_device, dtype=torch.bfloat16)
              for _ in range(2))
    q = torch.randn(B, S, Hkv * G, D, generator=g, device=cuda_device,
                    dtype=torch.bfloat16).transpose(1, 2)
    args = fa_ops.kernel_args(q, ck[1], cv[1], causal=True, window=None,
                              q_offset=start, scale=None)
    assert args[0].data_ptr() == q.data_ptr()        # read in place
    assert args[1].data_ptr() == ck[1].data_ptr()
    n0 = launch_counts()["flash_attention_prefill"]
    got = attention(q, ck[1], cv[1], q_offset=start)
    assert launch_counts()["flash_attention_prefill"] == n0 + 1
    assert got.shape == (B, Hkv * G, S, D) and got.is_contiguous()
    want = attention_ref(q.contiguous(), ck[1], cv[1], q_offset=start)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=1e-5)


F32_PREFILL_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_off)
    (1, 1, 1, 64, 64, 64, 64, False, None, 0),       # one query, one tile
    (1, 4, 1, 300, 333, 256, 256, True, None, 33),   # Sq and Sk tails, G 4
    (2, 4, 1, 200, 200, 256, 256, True, 17, 0),      # window < a key tile
    (1, 4, 1, 500, 500, 256, 256, True, 100, 0),     # window not a multiple
    (2, 4, 1, 70, 500, 256, 256, True, None, 430),   # chunked prefill
    (1, 2, 2, 130, 130, 128, 128, True, None, 0),    # G = 1
    (1, 7, 1, 100, 164, 128, 128, True, None, 64),   # G = 7
    (1, 16, 2, 90, 90, 64, 64, True, 40, 0),         # G = 8, Hkv = 2
    (1, 4, 1, 100, 100, 64, 64, True, None, -5),     # rows with no key
    (1, 4, 1, 40, 40, 128, 128, True, None, -100),   # no row sees a key
    (1, 2, 1, 100, 90, 64, 64, False, 20, 10),       # not causal, window
    (1, 4, 4, 33, 33, 16, 16, True, None, 0),        # narrow: (64, 64)
    (1, 4, 4, 16, 16, 24, 8, True, None, 0),         # Dv != D
    (1, 2, 1, 66, 66, 160, 160, True, None, 0),      # run at (256, 256)
    (1, 2, 1, 40, 40, 192, 128, True, None, 0),      # MLA widths
    # few-row calls just past the decode limit (8 rows per KV head)
    (1, 4, 1, 3, 300, 256, 256, True, None, 250),    # 12 rows
    (2, 1, 1, 9, 300, 256, 256, True, 64, 250),      # 9 rows, window
    (1, 14, 2, 2, 200, 128, 128, True, None, 150),   # 14 rows, G = 7
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_PREFILL_SHAPES)
def test_cuda_prefill_f32_matches_plain(cuda_device, shape):
    """The TF32 f32 prefill kernel (three TF32 products in each of q·kᵀ and
    p·v) within the f32 limit of 3e-5 of the plain version; rows that see
    no key exactly 0.  Only ``flash_attention`` and
    ``flash_attention_prefill_f32`` count the call."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    g = torch.Generator().manual_seed(Sq * Sk + D + Dv)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    assert not fa_ops.decode_shape(Sq, Hq, Hkv, D, Dv)
    n0 = launch_counts()
    got = attention(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert {n: n1[n] - n0[n] for n in n0 if n1[n] != n0[n]} == {
        "flash_attention": 1, "flash_attention_prefill_f32": 1}
    want = attention_ref(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=3e-5, atol=3e-5)
    keyless = ~visible(Sq, Sk, causal=causal, window=window,
                       q_offset=qoff).any(dim=1)
    assert torch.all(got.cpu()[:, :, keyless] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
def test_cuda_prefill_f32_strided(cuda_device, window):
    """f32 q as a transposed projection and K/V as one layer of
    [L, B, Hkv, max_len, D] caches from ``q_offset`` 200: read through
    their strides by the TF32 kernel, within 3e-5 of the plain version."""
    L, B, Hkv, G, max_len, D, S, start = 3, 2, 2, 4, 400, 256, 150, 200
    g = torch.Generator(device=cuda_device).manual_seed(5)
    ck, cv = (torch.randn(L, B, Hkv, max_len, D, generator=g,
                          device=cuda_device) for _ in range(2))
    q = torch.randn(B, S, Hkv * G, D, generator=g,
                    device=cuda_device).transpose(1, 2)
    args = fa_ops.kernel_args(q, ck[2], cv[2], causal=True, window=window,
                              q_offset=start, scale=None)
    assert args[0].data_ptr() == q.data_ptr()
    assert args[1].data_ptr() == ck[2].data_ptr()
    n0 = launch_counts()["flash_attention_prefill_f32"]
    got = attention(q, ck[2], cv[2], window=window, q_offset=start)
    assert launch_counts()["flash_attention_prefill_f32"] == n0 + 1
    want = attention_ref(q.contiguous(), ck[2], cv[2], window=window,
                         q_offset=start)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
def test_cuda_prefill_f32_at_gemma(cuda_device):
    """gemma3-1b's global prefill in f32 (q [8, 4, 4096, 256], k/v
    [8, 1, 4128, 256], causal), the shape the smoke's f32 tail check runs:
    within 3e-5 of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(8, 4, 4096, 256, generator=g, device=cuda_device)
    k, v = (torch.randn(8, 1, 4128, 256, generator=g, device=cuda_device)
            for _ in range(2))
    got = attention(q, k, v)
    want = attention_ref(q, k, v)
    assert float((got - want).abs().max()) <= 3e-5


@pytest.mark.cuda
def test_cuda_simt_kernel_matches_plain(cuda_device):
    """``attention_simt_kernel``, the f32 design before
    ``flash_prefill_f32.cu``, still matches the plain version within 3e-5
    through ``ops._attention_simt`` (which counts no launch)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q = torch.randn(2, 4, 100, 256, generator=g, device=cuda_device)
    k = torch.randn(2, 1, 120, 256, generator=g, device=cuda_device)
    v = torch.randn(2, 1, 120, 256, generator=g, device=cuda_device)
    n0 = launch_counts()
    got = fa_ops._attention_simt(q, k, v, window=40, q_offset=20)
    assert launch_counts() == n0
    want = attention_ref(q, k, v, window=40, q_offset=20)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
def test_cuda_mma_kernel_matches_plain(cuda_device):
    """``attention_mma_kernel``, the prefill design before
    ``flash_prefill.cu``, still matches the plain version at gemma3-1b
    widths through ``ops._attention_mma`` (which counts no launch)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 4, 100, 256, generator=g, device=cuda_device)
    k = torch.randn(2, 1, 120, 256, generator=g, device=cuda_device)
    v = torch.randn(2, 1, 120, 256, generator=g, device=cuda_device)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    n0 = launch_counts()
    got = fa_ops._attention_mma(q, k, v, window=40, q_offset=20)
    assert launch_counts() == n0
    want = attention_ref(q, k, v, window=40, q_offset=20)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=1e-5)


@pytest.mark.cuda
def test_cuda_lm_matches_cpu(cuda_device):
    """Reduced gemma3-1b at 6 layers (one global layer) in f32: forward and
    prefill + decode on the card match the host's, 1e-4 relative."""
    import dataclasses

    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import model as tm

    cfg = dataclasses.replace(reduced_config("gemma3-1b"), n_layers=6,
                              dtype=torch.float32)
    params = init_params(tm.param_defs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    dparams = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else
                   {n: w.to(cuda_device) for n, w in v.items()})
               for k, v in params.items()}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 20)))
    n0 = launch_counts()["flash_attention"]
    want = tm.forward(params, tokens, cfg)[0]
    got = tm.forward(dparams, tokens.to(cuda_device), cfg)[0].cpu()
    assert launch_counts()["flash_attention"] == n0 + 6
    rel = (got - want).abs().max() / want.abs().max()
    assert rel <= 1e-4, rel
    _, cache = tm.prefill_step(dparams, tokens[:, :16].to(cuda_device), cfg,
                               max_len=20)
    for i in range(16, 20):
        lg, cache = tm.decode_step(dparams, cache,
                                   tokens[:, i:i + 1].to(cuda_device), i, cfg)
    rel = (lg.cpu() - want[:, -1]).abs().max() / want[:, -1].abs().max()
    assert rel <= 1e-4, rel


MLA_SHAPES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_off, v_in_k)
    (2, 128, 1, 1, 300, 576, 512, True, None, 299, True),   # ragged last tile
    (2, 128, 1, 1, 300, 576, 512, True, None, 299, False),  # V a tensor
    (8, 128, 1, 1, 4128, 576, 512, True, None, 4100, True),  # served, tail
    (1, 128, 1, 1, 1, 576, 512, True, None, 0, True),       # one key
    (1, 16, 1, 1, 64, 576, 512, True, None, -1, True),      # no key visible
    (1, 64, 1, 3, 200, 576, 512, True, None, 150, False),   # Sq = 3, 3 blocks
    (1, 8, 2, 40, 100, 320, 256, True, 17, 50, False),      # window, Hkv 2
    (1, 4, 1, 70, 70, 288, 288, False, None, 0, True),      # v = k, acausal
    (1, 32, 1, 1, 77, 272, 264, True, None, 76, True),      # Dv % 16 = 8
]


def _mla_inputs(shape, dev):
    """Seeded bf16 q, k, v of an ``MLA_SHAPES`` case on the host and on
    ``dev`` (v as k's first Dv columns when ``v_in_k``), and the call's
    keywords."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff, v_in_k = shape
    g = torch.Generator().manual_seed(Sq * Sk + D + Dv)
    q, k = (torch.randn(s, generator=g).bfloat16()
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D)))
    v = torch.randn(B, Hkv, Sk, Dv, generator=g).bfloat16()
    qd, kd = q.to(dev), k.to(dev)
    vd = kd[..., :Dv] if v_in_k else v.to(dev)
    if v_in_k:
        v = k[..., :Dv]
    kw = dict(causal=causal, window=window, q_offset=qoff,
              scale=192 ** -0.5)
    return (q, k, v), (qd, kd, vd), kw


def _assert_mla_close(got, want, shape):
    """Element by element within 2^-6·|plain| + 1e-5 (f32 sums, p as bf16
    hi + lo, one rounding to bf16); rows that see no key exactly 0."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff, v_in_k = shape
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2 ** -6,
                               atol=1e-5)
    keyless = ~visible(Sq, Sk, causal=causal, window=window,
                       q_offset=qoff).any(dim=1)
    assert torch.all(got.cpu()[:, :, keyless] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_cuda_mla_matches_plain(cuda_device, shape):
    """The MLA kernel that ``attention()`` routes bf16 calls past a head dim
    of 256 to (``flash_mla_wgmma.cu``) against the plain version
    (:func:`_assert_mla_close`).  v is either k's first Dv columns (a view:
    the kernel reads V from K's 64-key tiles) or a tensor of its own (its
    32-key instantiation with a V ring).  Only ``flash_attention`` and
    ``flash_attention_mla`` count the call."""
    (q, k, v), (qd, kd, vd), kw = _mla_inputs(shape, cuda_device)
    B, Hq, Hkv, Sq, Sk, D, Dv = shape[:7]
    assert fa_ops.route(Sq, Hq, Hkv, D, Dv, q.dtype) == "flash_mla"
    n0 = launch_counts()
    got = attention(qd, kd, vd, **kw)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert {n: n1[n] - n0[n] for n in n0 if n1[n] != n0[n]} == {
        "flash_attention": 1, "flash_attention_mla": 1}
    _assert_mla_close(got, attention_ref(q, k, v, **kw), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_cuda_mla_mma_matches_plain(cuda_device, shape):
    """The first MLA kernel (``flash_mla.cu``, a yardstick now: no route
    takes it) through ``ops._mla_mma`` on the same shapes, within the same
    limits; it counts no launch."""
    (q, k, v), (qd, kd, vd), kw = _mla_inputs(shape, cuda_device)
    n0 = launch_counts()
    got = fa_ops._mla_mma(qd, kd, vd, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == n0
    _assert_mla_close(got, attention_ref(q, k, v, **kw), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("Sk,v_in_k,n_splits", [(300, True, 3),
                                                (800, True, 7),
                                                (1000, False, 8)])
def test_cuda_mla_cluster_splits(cuda_device, Sk, v_in_k, n_splits):
    """Key splits merged in a thread block cluster: at B = 2, 128 heads
    (4 row blocks) the card holds clusters of up to 8 blocks in one wave,
    so the plan cuts 5, 13 or 32 tiles (64 keys; 32 with a V of its own)
    into 3, 7 or 8 splits whose last is shorter than the others, and the
    merged result matches the plain version."""
    shape = (2, 128, 1, 1, Sk, 576, 512, True, None, Sk - 1, v_in_k)
    (q, k, v), (qd, kd, vd), kw = _mla_inputs(shape, cuda_device)
    block_n = fa_ops.mla_block_n(v_in_k)
    plan = fa_ops.plan_mla_wgmma_splits(
        1, Sk, causal=True, window=None, q_offset=Sk - 1, blocks=4,
        block_n=block_n,
        max_clusters=lambda n: fa_ops.mla_cluster_slots(cuda_device, n,
                                                        v_in_k))
    bounds = plan.bounds()
    assert plan.n_splits == n_splits and bounds[-1][1] == Sk
    assert bounds[-1][1] - bounds[-1][0] < plan.tiles * block_n
    got = attention(qd, kd, vd, **kw)
    _assert_mla_close(got, attention_ref(q, k, v, **kw), shape)


@pytest.mark.cuda
def test_cuda_mla_route(cuda_device):
    """Past 256 only bf16 has a kernel: an f32 call at MLA's D = 576 raises
    ``ValueError`` naming the dims and launches nothing, and no call goes
    to the plain version."""
    q = torch.zeros(1, 4, 1, 576, device=cuda_device)
    k = torch.zeros(1, 1, 8, 576, device=cuda_device)
    n0 = launch_counts()
    with pytest.raises(ValueError, match="D=576, Dv=512"):
        attention(q, k, k[..., :512], q_offset=7)
    assert launch_counts() == n0
    with pytest.raises(ValueError, match="no attention kernel"):
        fa_ops.route(1, 4, 1, 576, 512, torch.float32)


@pytest.mark.cuda
def test_cuda_mla_model_matches_cpu(cuda_device):
    """A deepseek-v3 model at MLA's published latent widths (kv_lora 512,
    qk_rope 64: attention at D = 576 in the absorbed decode), 16 heads,
    three layers (one dense, two MoE), bf16: prefill and decode on the card
    against the host's within 5e-2 relative (the bf16 bound of the CPU
    tests), each decode step's three attention calls through the MLA
    kernel.  The router bias (which only routes) pins every token to
    experts 0 and 1: at 4 experts top-2, a bf16 ulp between cuBLAS and the
    host's products would otherwise flip a near-tied expert choice."""
    import dataclasses

    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import MLAConfig
    from repro_torch.models.transformer import model as tm

    cfg = dataclasses.replace(
        reduced_config("deepseek-v3-671b"), n_layers=3, n_heads=16,
        mla=MLAConfig(q_lora=64, kv_lora=512, qk_nope=32, qk_rope=64,
                      v_dim=32))
    params = init_params(tm.param_defs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    params["group1"]["router_bias"][:] = torch.tensor([8.0, 4.0, 0.0, -4.0])
    dparams = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else
                   {n: w.to(cuda_device) for n, w in v.items()})
               for k, v in params.items()}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 40)))
    last, cache = tm.prefill_step(params, tokens[:, :36], cfg, max_len=40)
    dlast, dcache = tm.prefill_step(dparams, tokens[:, :36].to(cuda_device),
                                    cfg, max_len=40)
    rel = (dlast.cpu().float() - last.float()).abs().max() / last.abs().max()
    assert rel <= 5e-2, rel
    for i in range(36, 40):
        n0 = launch_counts()["flash_attention_mla"]
        lg, cache = tm.decode_step(params, cache, tokens[:, i:i + 1], i, cfg)
        dlg, dcache = tm.decode_step(dparams, dcache,
                                     tokens[:, i:i + 1].to(cuda_device), i,
                                     cfg)
        assert launch_counts()["flash_attention_mla"] == n0 + 3
        rel = (dlg.cpu().float() - lg.float()).abs().max() / lg.abs().max()
        assert rel <= 5e-2, (i, rel)


@pytest.mark.cuda
def test_cuda_init_params_as_before(cuda_device):
    """gemma3-1b's weights at full width on the card are what one f32 draw
    per leaf, scaled and cast, gave before large leaves were drawn in
    runs (every gemma3-1b leaf is under the limit): bit for bit."""
    import math

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.common import ParamDef, init_params
    from repro_torch.models.transformer import model as tm

    tree = tm.param_defs(get_arch("gemma3-1b")[0])
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    got = init_params(tree, gen, cuda_device)
    gen.manual_seed(0)

    def before(d: ParamDef):
        if d.init != "normal":
            return None
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        v = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=cuda_device)
        return (v * (1.0 / math.sqrt(max(fan_in, 1)))).to(d.dtype)

    def walk(defs, params):
        for key, d in defs.items():
            if isinstance(d, dict):
                walk(d, params[key])
                continue
            want = before(d)
            if want is not None:
                assert torch.equal(params[key].view(torch.int16),
                                   want.view(torch.int16)), key

    walk(tree, got)


# ---------------------------------------------------------------------------
# temporal engine on the card, against the port's CPU runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def churn_managers():
    """``(uni, ev, card manager, cpu manager)`` over one churn history."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.core import GraphManager
    uni, ev = churn_network(n_initial_edges=150, n_events=1500, seed=2)
    gm = GraphManager(uni, ev, L=100, k=2, cache_bytes=0)
    cpu = GraphManager(uni, ev, L=100, k=2, cache_bytes=0, device="cpu")
    yield uni, ev, gm, cpu
    gm.close()
    cpu.close()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", ["2", "0"])
def test_cuda_evolve_intervals_matches_cpu(cuda_device, churn_managers,
                                           monkeypatch, chunk):
    uni, ev, gm, cpu = churn_managers
    tmax = int(ev.time[-1])
    ivs = [list(range(0, tmax + 2, tmax // 11)),
           list(range(tmax // 3, tmax // 2, 5))]
    monkeypatch.setenv("REPRO_STREAM_CHUNK", chunk)
    n0 = launch_counts()["delta_apply_chain"]
    got = torch_exec.evolve_intervals_torch(gm.dg, ivs, pool=gm.pool)
    assert launch_counts()["delta_apply_chain"] > n0
    want = torch_exec.evolve_intervals_torch(cpu.dg, ivs, device="cpu",
                                             pool=cpu.pool)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for t in g:
            assert np.array_equal(g[t][0], w[t][0])
            assert np.array_equal(g[t][1], w[t][1])


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [None, 3])
def test_cuda_loader_matches_cpu(cuda_device, churn_managers, horizon):
    from repro_torch.core import SnapshotBatchLoader
    uni, ev, gm, cpu = churn_managers
    tmax = int(ev.time[-1])
    times = list(range(tmax // 4, tmax, tmax // 13))
    got = SnapshotBatchLoader(gm, times, batch_size=4, label_horizon=horizon)
    want = SnapshotBatchLoader(cpu, times, batch_size=4,
                               label_horizon=horizon)
    n0 = launch_counts()
    batches = list(got)
    n1 = launch_counts()
    passes = len(batches) * (1 if horizon is None else 2)
    assert n1["delta_apply_fused"] - n0["delta_apply_fused"] == passes
    assert (n1["segment_sum_bucketed"] - n0["segment_sum_bucketed"]
            == 2 * 4 * passes)
    for b, w in zip(batches, want):
        assert b["times"] == w["times"]
        for key in w:
            if key != "times":
                assert b[key].is_cuda
                assert torch.equal(b[key].cpu(), w[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["dense", "segment"])
def test_cuda_fixpoints_match_cpu(cuda_device, churn_managers, impl):
    """PageRank within 1e-6 of the CPU run (float atomics reorder the
    sums; iterations within 2), components exactly."""
    from repro_torch.core import bitmaps as bm
    from repro_torch.graph.algorithms import (connected_components_fixpoint,
                                              pagerank_fixpoint)
    uni, ev, gm, cpu = churn_managers
    st = cpu.get_snapshot(int(ev.time[1000]))
    planes = (bm.np_pack(st.edge_mask), bm.np_pack(st.node_mask))
    pr0 = st.node_mask.astype(np.float32) / max(st.node_mask.sum(), 1)
    kw = dict(num_nodes=uni.num_nodes, force_impl=impl, tol=1e-7)
    got, it = pagerank_fixpoint(uni.edge_src, uni.edge_dst, *planes, pr0,
                                **kw)
    want, wit = pagerank_fixpoint(uni.edge_src, uni.edge_dst, *planes, pr0,
                                  device="cpu", **kw)
    assert np.allclose(got, want, atol=1e-6) and abs(it - wit) <= 2
    labels0 = np.arange(uni.num_nodes, dtype=np.int32)
    got, it = connected_components_fixpoint(
        uni.edge_src, uni.edge_dst, *planes, labels0,
        num_nodes=uni.num_nodes)
    want, wit = connected_components_fixpoint(
        uni.edge_src, uni.edge_dst, *planes, labels0,
        num_nodes=uni.num_nodes, device="cpu")
    assert np.array_equal(got, want) and it == wit


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["pagerank", "components", "degree"])
def test_cuda_evolve_ops_match_cpu(cuda_device, churn_managers, op):
    uni, ev, gm, cpu = churn_managers
    tmax = int(ev.time[-1])
    times = [int(t) for t in np.linspace(tmax // 2, tmax, 9)]
    for incremental in (True, False):
        got = gm.evolve(times, op, incremental=incremental)
        want = cpu.evolve(times, op, incremental=incremental)
        for g, w in zip(got.values, want.values):
            if op == "pagerank":
                assert np.allclose(g, w, atol=1e-5)
            else:
                assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# training: the prefill kernels' statistics output, the backward, a step
# ---------------------------------------------------------------------------

def _stats_shapes():
    return ([("bf16", s) for s in PREFILL_SHAPES] +
            [("f32", s) for s in F32_PREFILL_SHAPES])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", _stats_shapes())
def test_cuda_prefill_stats_match_plain(cuda_device, dtype, shape):
    """``attention_stats`` on the card: ``out`` bit for bit the launch
    without statistics; ``m`` within 1e-5·(1 + |m|) and ``l`` within 1e-4
    relative of the plain version's (``m`` is kept in the log2 domain and
    converted by one multiply; ``l`` sums ex2.approx terms in another
    order); rows with no key ``m = -1e30``, ``l = 0``.  Counted under the
    kernel's counter and its ``_stats`` counter."""
    from repro_torch.kernels.flash_attention import (attention_ref_stats,
                                                     attention_stats)
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator().manual_seed(Sq * Sk + D + Dv + 1)
    q, k, v = (torch.randn(s, generator=g).to(td) for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    dq, dk, dv = (t.to(cuda_device) for t in (q, k, v))
    counter = ("flash_attention_prefill" if dtype == "bf16" else
               "flash_attention_prefill_f32")
    n0 = launch_counts()
    out, m, l = attention_stats(dq, dk, dv, **kw)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert {n: n1[n] - n0[n] for n in n0 if n1[n] != n0[n]} == {
        "flash_attention": 1, counter: 1, f"{counter}_stats": 1}
    if fa_ops.route(Sq, Hq, Hkv, D, Dv, td) == counter.replace(
            "flash_attention_", "flash_"):
        assert torch.equal(out, attention(dq, dk, dv, **kw))
    want, wm, wl = attention_ref_stats(q, k, v, **kw)
    tol = dict(rtol=2 ** -6, atol=1e-5) if dtype == "bf16" else dict(
        rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(out.cpu().float(), want.float(), **tol)
    m, l = m.cpu(), l.cpu()
    seen = wl > 0
    assert torch.equal(l > 0, seen)
    assert torch.all(m[~seen] == -1e30) and torch.all(l[~seen] == 0)
    if seen.any():
        assert float(((m - wm).abs() / (1 + wm.abs()))[seen].max()) <= 1e-5
        assert float(((l - wl).abs() / wl.clamp(min=1e-30))[seen].max()) \
            <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 4, 1, 300, 333, 256, 256, True, None, 33),
    (2, 4, 2, 200, 200, 64, 64, True, 17, 0),
    (1, 2, 1, 130, 130, 192, 128, True, None, 0),    # MLA prefill dims
    (1, 4, 1, 600, 600, 128, 128, True, None, 0),    # padded last chunk
])
def test_cuda_attention_grad_matches_cpu(cuda_device, dtype, shape):
    """Gradients through ``attention()`` on the card (the statistics
    launch, then ``attention_bwd`` in torch ops) against the same on the
    CPU: within 1e-4 of each gradient's largest magnitude in f32 (the f32
    kernel's three TF32 products), 2e-2 in bf16 (the card's p keeps
    2^-16, the CPU's is exact; each gradient rounds to bf16)."""
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, qoff = shape
    g = torch.Generator().manual_seed(Sq + D)
    q, k, v = (torch.randn(s, generator=g).to(dtype) for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv)))
    cot = torch.randn((B, Hq, Sq, Dv), generator=g)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    grads = {}
    for dev in ("cpu", cuda_device):
        ts = [t.detach().clone().to(dev).requires_grad_(True)
              for t in (q, k, v)]
        out = attention(*ts, **kw)
        (out.float() * cot.to(dev)).sum().backward()
        grads[str(dev)] = [t.grad.cpu().float() for t in ts]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        assert float((got - want).abs().max()) <= \
            tol * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One momentum-SGD step (linear in the gradient) of reduced gemma3-1b
    in f32 through ``make_train_step`` on the card and on the CPU from the
    same weights: the loss within 1e-5 relative, each parameter's change
    within 1e-4 of its largest magnitude (the gradients' bound)."""
    import dataclasses

    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import optim
    from repro_torch.training.trainer import make_train_step
    from repro_torch.tree_util import flatten_with_paths, tree_map

    cfg = dataclasses.replace(reduced_config("gemma3-1b"),
                              dtype=torch.float32)
    cpu = init_params(tm.param_defs(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    res = {}
    for dev in ("cpu", cuda_device):
        params = tree_map(lambda t: t.to(dev), cpu)
        opt = optim.sgd(lr=0.1)
        step = make_train_step(lambda p, b: tm.loss_fn(p, b, cfg), opt)
        new, _, met = step(params, opt[0](params),
                           {"tokens": tokens.to(dev)})
        res[str(dev)] = (float(met["loss"]), {
            p: (x.cpu() - y.cpu()) for (p, x), (_, y) in zip(
                flatten_with_paths(new), flatten_with_paths(params))})
    (l_cpu, d_cpu), (l_dev, d_dev) = res["cpu"], res[str(cuda_device)]
    assert abs(l_dev - l_cpu) <= 1e-5 * l_cpu
    for p, w in d_cpu.items():
        assert float((d_dev[p] - w).abs().max()) <= \
            1e-4 * float(w.abs().max()), p


# ---------------------------------------------------------------------------
# GNN and DIN: reduced models on the card against the CPU
# ---------------------------------------------------------------------------

def _card_against_cpu(arch: str, dev, **over):
    """``(loss, grads)`` of ``arch``'s reduced config (``over`` replaced)
    on the launcher's seed-0 batch, on the CPU and on ``dev``, from the
    same seeded weights."""
    import dataclasses

    from repro_torch.configs.registry import reduced_config
    from repro_torch.launch.train import make_loss, synth_batch
    from repro_torch.models.common import init_params
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree_util import tree_map

    cfg = dataclasses.replace(reduced_config(arch), **over)
    loss_fn, defs = make_loss(arch, cfg)
    cpu = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    batch = synth_batch(arch, cfg, np.random.default_rng(0), 16, 8, "cpu")
    out = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d), cpu)
        b = {k: v.to(d) if isinstance(v, torch.Tensor) else v
             for k, v in batch.items()}
        (loss, _), grads = value_and_grad(loss_fn, params, b)
        out[str(d)] = (float(loss), grads)
    return out["cpu"], out[str(dev)]


def _assert_grads_close(g_cpu, g_dev, tol=1e-4, zero=()):
    """Every leaf within ``tol`` of its largest CPU magnitude; leaves whose
    exact gradient is 0 (``zero``) within ``tol`` of the tree's largest."""
    from repro_torch.tree_util import flatten_with_paths, path_name

    want = {path_name(p): x for p, x in flatten_with_paths(g_cpu)}
    got = {path_name(p): x.cpu() for p, x in flatten_with_paths(g_dev)}
    assert got.keys() == want.keys()
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        scale = top if name in zero else float(w.abs().max())
        assert float((got[name] - w).abs().max()) <= tol * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [
    ("gcn-cora", {}), ("gin-tu", {}), ("meshgraphnet", {}), ("dimenet", {}),
    ("meshgraphnet", {"gather_chunks": 3}), ("dimenet", {"gather_chunks": 4})])
def test_cuda_gnn_matches_cpu(cuda_device, arch, over):
    """Reduced GNNs in f32: the loss within 1e-5 relative and the
    gradients within 1e-4 of each leaf's largest magnitude (aggregation
    on the card adds with float atomics, in another order)."""
    (l_cpu, g_cpu), (l_dev, g_dev) = _card_against_cpu(arch, cuda_device,
                                                       **over)
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    _assert_grads_close(g_cpu, g_dev)


@pytest.mark.cuda
def test_cuda_din_matches_cpu(cuda_device):
    """Reduced DIN: the loss within 1e-5 relative, the gradients within
    1e-4 (``attn_b2``'s exact gradient is 0: against the tree's largest);
    ``din_retrieval`` within 1e-5 relative."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.common import init_params
    from repro_torch.models.recsys import din
    from repro_torch.tree_util import tree_map

    (l_cpu, g_cpu), (l_dev, g_dev) = _card_against_cpu("din", cuda_device)
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    _assert_grads_close(g_cpu, g_dev, zero=("attn_b2",))
    cfg = reduced_config("din")
    cpu = init_params(din.din_param_defs(cfg),
                      torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    b = {"hist_goods": rng.integers(0, cfg.n_goods, (2, cfg.seq_len)),
         "hist_cates": rng.integers(0, cfg.n_cates, (2, cfg.seq_len)),
         "hist_mask": rng.random((2, cfg.seq_len)) < 0.8,
         "cand_goods": rng.integers(0, cfg.n_goods, (2, 5000)),
         "cand_cates": rng.integers(0, cfg.n_cates, (2, 5000))}
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        want = din.din_retrieval(cpu, b, cfg)
        got = din.din_retrieval(tree_map(lambda t: t.to(cuda_device), cpu),
                                {k: v.to(cuda_device) for k, v in b.items()},
                                cfg).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1, 3, 4, 32])
def test_cuda_chunked_functions_match_cpu(cuda_device, n_chunks):
    """``chunked_gather`` exactly (a gather) and ``chunked_segment_sum``
    within 1e-5, forward and gradient, on the card against the CPU."""
    from repro_torch.models.gnn import models as gm

    gen = torch.Generator().manual_seed(0)
    N, M, D = 1000, 5003, 16
    x = torch.randn(N, D, generator=gen)
    idx = torch.randint(0, N, (M,), generator=gen, dtype=torch.int32)
    gout = torch.randn(M, D, generator=gen)
    gsum = torch.randn(N, D, generator=gen)
    res = {}
    for d in ("cpu", cuda_device):
        xs = x.to(d).requires_grad_(True)
        g = gm.chunked_gather(xs, idx.to(d), n_chunks)
        (dx,) = torch.autograd.grad(g, xs, gout.to(d))
        ds = gout.to(d).requires_grad_(True)
        s = gm.chunked_segment_sum(ds, idx.to(d), N, n_chunks)
        (dd,) = torch.autograd.grad(s, ds, gsum.to(d))
        res[str(d)] = [t.detach().cpu() for t in (g, dx, s, dd)]
    cpu, dev = res["cpu"], res[str(cuda_device)]
    assert torch.equal(dev[0], cpu[0]) and torch.equal(dev[3], cpu[3])
    for a, b in ((dev[1], cpu[1]), (dev[2], cpu[2])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,stats", [(64, False), (1, False), (64, True)])
def test_cuda_attention_takes_no_meta_route(cuda_device, Sq, stats):
    """CUDA inputs launch the kernel under the dry run's accounting mode
    too, and report no shape-only route; ``meta`` copies of the same
    inputs on the same machine take that route and launch nothing."""
    from repro_torch.launch.op_analysis import OpAnalysis

    g = torch.Generator().manual_seed(Sq)
    q, k, v = (torch.randn(s, generator=g).to(torch.bfloat16) for s in
               ((1, 4, Sq, 64), (1, 1, 80, 64), (1, 1, 80, 64)))
    fn = fa_ops.attention_stats if stats else attention
    kw = dict(causal=True, window=None, q_offset=80 - Sq)
    n0 = launch_counts()
    with OpAnalysis() as acct:
        got = fn(*(t.to(cuda_device) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == n0["flash_attention"] + 1
    assert acct.kernels == {}
    n1 = launch_counts()
    with OpAnalysis() as acct:
        meta = fn(*(t.to("meta") for t in (q, k, v)), **kw)
    assert launch_counts() == n1
    (route, rec), = acct.kernels.items()
    assert rec["launches"] == 1
    assert route == ("flash_decode" if Sq == 1 else "flash_prefill")
    for m, c in zip(meta if stats else (meta,), got if stats else (got,)):
        assert m.is_meta and m.shape == c.shape and m.dtype == c.dtype
