"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  They cover the shapes ``chip_smoke.py`` does not:
odd widths, ragged word groups, K = 0, weights shorter than ``32 * W``,
the pinned host-to-device put and the streamed retrieval path.
This file imports no JAX, so it runs on a machine without it::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DeltaGraph
from repro_torch.data.generators import churn_network
from repro_torch.kernels import (delta_apply_chain, delta_apply_chain_batched,
                                 delta_apply_fused_batched, launch_counts,
                                 segment_sum)
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
                                           (1, 1, 2049, 1024)])
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
