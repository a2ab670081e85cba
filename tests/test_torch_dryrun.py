"""The dry run's counterpart (``repro_torch.launch.{dryrun,op_analysis,
mesh}``), the kernels' shape-only routes and the static-shape MoE
dispatch.

* Arguments and FLOPs against XLA: for gcn-cora × ``full_graph_sm`` and
  gin-tu × ``molecule``, ``argument_bytes_per_device`` on a 1×1 mesh
  equals ``memory_analysis().argument_size_in_bytes`` of the reference's
  step compiled on one CPU device (``keep_unused=True``: GCN reads no
  ``node_mask``, and jit would otherwise drop it), and the counted matmul
  FLOPs equal ``hlo_analysis.analyze(...)["flops"]`` within a relative
  1e-6 (measured: equal).
* A reduced dense LM prefill (gemma3-1b's sliding windows, yi-34b's full
  causal attention) against the same: the products outside attention
  equal the reference's once its attention (every 512-key chunk, as its
  XLA path computes them) and the head at the S - 1 positions the port's
  ``prefill_step`` does not compute are taken out; the attention route
  counts the visible (query, key) pairs, 2·(D + Dv) each.
* Remat: a reduced training step counts each layer's forward again (the
  recompute, but for the last product, which checkpoint's early stop
  does not redo) and the attention route twice a layer.
* The shape-only routes return the plain versions' shapes and dtypes,
  report the route :func:`ops.route` picks and the bound's work, and
  count no launch; no CUDA tensor reaches them or the plain versions.
* The static-shape MoE dispatch equals the ``nonzero`` one it replaced,
  with and without drops, and traces on ``meta``; deepseek-v3 and arctic
  trace at full depth (their decode cells: one MLA or decode route a
  layer).
* The live-bytes tracker's peak on small programs built by hand.
* ``run_cell``'s keys for one cell of each family (a finite collective
  term from the sharding pass, no unmodeled op), and the CLI's resume.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import registry as jreg
from repro.configs.registry import reduced_config as j_reduced_config
from repro.launch import hlo_analysis
from repro.models import common as jmc
from repro.models.transformer import model as jtm
from repro.runtime import compat

from repro_torch import kernels
from repro_torch.configs import registry as reg
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import policy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_stats)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.op_analysis import OpAnalysis, analyze
from repro_torch.models import common as mc
from repro_torch.models.transformer import model as tm
from repro_torch.training.trainer import value_and_grad

MiB = 1 << 20


# ---------------------------------------------------------------------------
# against XLA
# ---------------------------------------------------------------------------

def _compiled_reference(arch, shape):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    cell = jreg.get_cell(arch, shape, mesh, multi_pod=False)
    shard = jax.tree.map(
        lambda sp: NamedSharding(mesh, sp if isinstance(sp, P) else P()),
        cell.pspecs, is_leaf=lambda x: isinstance(x, P) or x is None)
    with compat.set_mesh(mesh):
        return jax.jit(cell.fn, in_shardings=shard,
                       keep_unused=True).lower(*cell.args).compile()


@pytest.mark.parametrize("arch,shape", [("gcn-cora", "full_graph_sm"),
                                        ("gin-tu", "molecule")])
def test_arguments_and_flops_against_xla(arch, shape):
    compiled = _compiled_reference(arch, shape)
    mesh = make_mesh((1, 1), ("data", "model"))
    cell = reg.get_cell(arch, shape, mesh)
    assert (dryrun.sharded_bytes(cell.args, cell.pspecs, mesh) ==
            compiled.memory_analysis().argument_size_in_bytes)
    want = hlo_analysis.analyze(compiled.as_text())["flops"]
    got = analyze(cell.fn, *cell.args).summary()
    assert set(got["flops"]) == {"float32"} and not got["kernels"]
    assert got["flops_total"] == pytest.approx(want, rel=1e-6)


def _visible_brute(Sq, Sk, window, q_offset, causal=True):
    """(pairs, lo, hi) row by row: the loop the closed form replaces."""
    pairs, lo, hi = 0, Sk, 0
    for i in range(Sq):
        q = i + q_offset
        a = 0 if window is None else max(0, q - window + 1)
        b = min(Sk, q + 1) if causal else Sk
        if b > a:
            pairs, lo, hi = pairs + b - a, min(lo, a), max(hi, b)
    return (pairs, lo, hi) if hi > lo else (0, 0, 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 3, 16, 1 << 30])
def test_visible_pairs_closed_form(window, causal):
    for Sq in (0, 1, 2, 5, 17):
        for Sk in (0, 1, 4, 19):
            for off in (-20, -3, 0, 2, 7, 18, 30):
                assert fa_ops.visible_pairs(
                    Sq, Sk, causal=causal, window=window, q_offset=off) == \
                    _visible_brute(Sq, Sk, window, off, causal), \
                    (Sq, Sk, off)


@pytest.mark.parametrize("arch", ["gemma3-1b", "yi-34b"])
def test_reduced_lm_prefill_flops_against_xla(arch):
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    B, S = 2, 48
    params = jmc.abstract_params(jtm.param_defs(jcfg))
    compiled = jax.jit(lambda p, t: jtm.prefill_step(p, t, jcfg)).lower(
        params, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile()
    want = hlo_analysis.analyze(compiled.as_text())["flops"]
    got = analyze(lambda p, t: tm.prefill_step(p, t, cfg),
                  mc.abstract_params(tm.param_defs(cfg)),
                  torch.empty((B, S), dtype=torch.int32,
                              device="meta")).summary()
    H, D, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    chunks = -(-S // 512) * min(512, S)           # keys the XLA path sees
    ref_attention = L * 2.0 * B * H * S * chunks * 2 * D
    head_rest = 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab
    (route, k), = got["kernels"].items()
    assert route == "flash_prefill" and k["launches"] == L
    assert got["flops_total"] - k["flops"] == pytest.approx(
        want - ref_attention - head_rest, rel=1e-6)
    windows, _ = cfg.layer_meta()
    pairs = sum(_visible_brute(S, S, None if w >= 1 << 30 else w, 0)[0]
                for w in windows)
    assert k["flops"] == 2.0 * B * H * pairs * 2 * D
    assert k["flops"] <= ref_attention / 2 + 2.0 * B * H * S * 2 * D * L


def test_train_step_counts_the_recompute():
    cfg = reduced_config("gemma3-1b")
    B, S = 2, 32
    defs = tm.param_defs(cfg)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")

    def grads(cfg):
        def step(p, b):
            return value_and_grad(lambda p, b: tm.loss_fn(p, b, cfg), p, b)
        return analyze(step, mc.abstract_params(defs),
                       {"tokens": tokens}).summary()

    remat = grads(cfg)
    plain = grads(dataclasses.replace(cfg, remat=False))
    with torch.no_grad():
        fwd = analyze(lambda p, t: tm.forward(p, t, cfg),
                      mc.abstract_params(defs), tokens).summary()
    L = cfg.n_layers
    assert remat["kernels"]["flash_prefill"]["launches"] == 2 * L
    assert plain["kernels"]["flash_prefill"]["launches"] == L
    head = 2.0 * B * S * cfg.d_model * cfg.vocab
    # one more forward of every layer (its products and attention) but
    # its last product: the recompute stops once the tensors the backward
    # saved are back (checkpoint's early stop), and w_down's output is
    # not one of them
    w_down = 2.0 * B * S * cfg.d_ff * cfg.d_model
    assert remat["flops_total"] - plain["flops_total"] == pytest.approx(
        fwd["flops_total"] - head - L * w_down, rel=1e-9)


# ---------------------------------------------------------------------------
# shape-only routes
# ---------------------------------------------------------------------------

ROUTE_CASES = [
    # (dtype, B, Hq, Hkv, Sq, Sk, D, Dv, window, q_offset, v in k)
    ("bf16", 2, 4, 1, 40, 40, 64, 64, None, 0, False),      # prefill
    ("bf16", 1, 4, 2, 33, 47, 40, 24, 7, 14, False),        # padded dims
    ("f32", 2, 4, 2, 24, 24, 16, 16, None, 0, False),       # TF32 prefill
    ("bf16", 2, 4, 1, 1, 50, 64, 64, 16, 49, False),        # decode
    ("f32", 1, 2, 1, 3, 20, 32, 32, None, 17, False),       # f32 decode
    ("bf16", 2, 8, 1, 1, 70, 576, 512, None, 69, True),     # MLA decode
]


def _qkv(rng, case, device):
    dt, B, Hq, Hkv, Sq, Sk, D, Dv, _, _, v_in_k = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype).to(device)

    q, k = t(B, Hq, Sq, D), t(B, Hkv, Sk, D)
    v = k[..., :Dv] if v_in_k else t(B, Hkv, Sk, Dv)
    return q, k, v


@pytest.mark.parametrize("stats", [False, True], ids=["attention", "stats"])
@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "-".join(
    map(str, c[:7])))
def test_meta_route_matches_plain(case, stats):
    dt, B, Hq, Hkv, Sq, Sk, D, Dv, window, off, v_in_k = case
    kw = dict(causal=True, window=window, q_offset=off)
    if stats and D > 256:       # no statistics kernel past 256, as on a card
        with pytest.raises(ValueError, match="statistics"):
            fa_ops.attention_stats(*_qkv(np.random.default_rng(0), case,
                                         "meta"), **kw)
        return
    q, k, v = _qkv(np.random.default_rng(0), case, "cpu")
    plain = (attention_ref_stats if stats else attention_ref)(q, k, v, **kw)
    mq, mk, mv = _qkv(np.random.default_rng(0), case, "meta")
    before = kernels.launch_counts()
    with OpAnalysis() as acct:
        got = (fa_ops.attention_stats if stats else fa_ops.attention)(
            mq, mk, mv, **kw)
    assert kernels.launch_counts() == before
    got, plain = ((got, plain) if stats else ((got,), (plain,)))
    for g, w in zip(got, plain):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype
    Dp, Dvp = fa_ops.padded_dims(D, Dv, q.dtype)
    want_route = (fa_ops._PREFILL[q.dtype][0] if stats else
                  fa_ops.route(Sq, Hq, Hkv, Dp, Dvp, q.dtype))
    (route, rec), = acct.kernels.items()
    assert route == want_route and rec["launches"] == 1
    pairs, lo, hi = _visible_brute(Sq, Sk, window, off)
    assert rec["flops"] == 2.0 * B * Hq * pairs * (D + Dv)
    kv = D if v_in_k else D + Dv
    nbytes = q.element_size() * (B * Hq * Sq * (D + Dv) +
                                 B * Hkv * (hi - lo) * kv)
    assert rec["bytes"] == nbytes + (8 * B * Hq * Sq if stats else 0)


def test_routes_by_device():
    """All-meta inputs take the shape-only route; CPU and CUDA inputs never
    do (``on_meta`` is False for them) and CUDA inputs never take the
    plain version (``use_kernel`` is True); a mix raises."""
    class Cuda:                 # a CUDA tensor as the policy reads one
        is_cuda, is_cpu, is_meta = True, False, False
        device = torch.device("cuda")

    cuda, cpu = Cuda(), torch.zeros(2)
    meta = torch.zeros(2, device="meta")
    assert policy.on_meta(meta, None, meta) is True
    assert policy.on_meta(cuda, cuda) is False
    assert policy.use_kernel(cuda, None, cuda) is True
    assert policy.on_meta(cpu) is False
    assert policy.use_kernel(cpu) is False
    for mix in ((meta, cuda), (cuda, meta), (meta, cpu)):
        with pytest.raises(ValueError):
            policy.on_meta(*mix)
    with pytest.raises(ValueError):
        policy.use_kernel(meta)
    with pytest.raises(ValueError):
        fa_ops.attention(meta.view(1, 1, 2, 1), cpu.view(1, 1, 2, 1),
                         cpu.view(1, 1, 2, 1))


# ---------------------------------------------------------------------------
# the MoE dispatch
# ---------------------------------------------------------------------------

def _dispatch_nonzero(xf, ids, w, E, K, C):
    """The dispatch as it was before its writes had a static shape: kept
    assignments found by ``nonzero`` and written alone."""
    G, T, d = xf.shape
    flat_e = ids.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    counts = torch.zeros(G, E, dtype=torch.long)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    slot = torch.arange(T * K) - starts.gather(1, se)
    keep = slot < C
    tok = order // K
    slot_c = torch.where(keep, slot, 0).to(torch.int32)
    comb_w = torch.where(keep, w.reshape(G, T * K).gather(1, order), 0.0)
    buf = xf.new_zeros((G, E, C, d))
    g, col = keep.nonzero(as_tuple=True)
    buf[g, se[g, col], slot[g, col]] = xf[g, tok[g, col]]
    return buf, se, slot_c, tok, comb_w


@pytest.mark.parametrize("G,T,K,E,cf,dtype", [
    (1, 16, 2, 4, 8.0, torch.float32),       # no drop
    (2, 24, 2, 4, 0.5, torch.float32),       # half the assignments drop
    (3, 10, 8, 16, 1.25, torch.bfloat16),    # top-8
    (4, 8, 8, 256, 1.25, torch.bfloat16),    # C = 1: most drop
])
def test_static_dispatch_equals_nonzero_dispatch(G, T, K, E, cf, dtype):
    rng = np.random.default_rng(G * 100 + E)
    d = 12
    ids = torch.from_numpy(np.stack([np.stack(
        [rng.permutation(E)[:K] for _ in range(T)]) for _ in range(G)]))
    w = torch.from_numpy(rng.random((G, T, K), dtype=np.float32))
    xf = torch.from_numpy(rng.standard_normal((G, T, d)).astype(
        np.float32)).to(dtype)
    C = int(np.ceil(T * K * cf / E))
    got = tm._dispatch_group(xf, ids, w, E, K, C)
    want = _dispatch_nonzero(xf, ids, w, E, K, C)
    assert int((want[2] == 0).sum()) >= 1
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)
    assert got[0].is_contiguous()
    meta = tm._dispatch_group(xf.to("meta"), ids.to("meta"), w.to("meta"),
                              E, K, C)
    for m, x in zip(meta, want):
        assert m.is_meta and m.shape == x.shape and m.dtype == x.dtype


@pytest.mark.parametrize("arch,route", [("deepseek-v3-671b", "flash_mla"),
                                        ("arctic-480b", "flash_decode")])
def test_moe_models_trace_at_full_depth(arch, route):
    cell = reg.get_cell(arch, "decode_32k", make_production_mesh())
    got = analyze(cell.fn, *cell.args).summary()
    assert got["kernels"] == {route: got["kernels"][route]}
    assert got["kernels"][route]["launches"] == cell.cfg.n_layers
    assert {r["op"] for r in got["top_by_flops"]} >= {"aten.bmm"}


# ---------------------------------------------------------------------------
# the live-bytes tracker
# ---------------------------------------------------------------------------

def _meta(n_mib):
    return torch.empty(n_mib * MiB // 4, device="meta")


def test_tracker_chain():
    """x, a and b (4 MiB each) alive at once, x an argument."""
    def chain(x):
        a = x * 2
        b = a + 1
        del a
        return b.sum()

    x = _meta(4)
    acct = analyze(chain, x)
    assert acct.argument_bytes == 4 * MiB
    assert acct.peak_bytes == 12 * MiB
    assert acct.live_bytes == 4 * MiB      # the argument, after the step


def test_tracker_views_and_in_place():
    """Views and in-place ops add no storage; a freed storage's bytes are
    given back before the next allocation."""
    def prog(x):
        v = x.view(2, -1).t()[::2]
        x.mul_(2)
        v.add_(1)
        a = x + 0                  # 8 MiB beside the argument
        del a
        return x[:MiB // 4] * 3    # 1 MiB

    acct = analyze(prog, _meta(8))
    assert acct.peak_bytes == 16 * MiB
    assert acct.ops["aten.mul_"][0] == 1 and "aten.view" not in acct.ops


def test_tracker_autograd_keeps_saved_tensors():
    """exp saves its 4 MiB output for the backward: it stays live after
    the forward drops it, until the backward has run."""
    acct = OpAnalysis()
    x = _meta(4)
    acct.track_arguments(x)
    with acct:
        xg = x.detach().requires_grad_(True)
        y = torch.exp(xg)            # saved by exp's backward
        s = (y * 2).sum()            # y * 2 freed after the sum
        del y
        after_forward = acct.live_bytes
        (g,) = torch.autograd.grad(s, [xg])
        del s
        after_backward = acct.live_bytes
    assert after_forward == 8 * MiB + 4          # x, exp's output, the sum
    # backward: x, the saved output, the gradients of y * 2 and of x
    assert 16 * MiB <= acct.peak_bytes <= 16 * MiB + 64
    assert after_backward == 8 * MiB             # x and its gradient
    del g


# ---------------------------------------------------------------------------
# run_cell and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,chips", [
    ("gemma3-1b", "decode_32k", 256), ("gcn-cora", "full_graph_sm", 512),
    ("din", "serve_p99", 256)])
def test_run_cell_keys(arch, shape, chips):
    rec = dryrun.run_cell(arch, shape, chips == 512)
    assert rec["status"] == "ok" and rec["chips"] == chips
    assert {"arch", "shape", "multi_pod", "step_kind", "model_flops",
            "n_params", "n_params_active", "trace_s", "memory",
            "fits_80gb", "counted", "roofline"} <= set(rec)
    m, r = rec["memory"], rec["roofline"]
    assert 0 < m["argument_bytes_per_device"] <= m["argument_bytes_whole"]
    assert m["peak_bytes_whole"] >= m["argument_bytes_whole"]
    assert m["live_bytes_per_device"] == pytest.approx(
        m["argument_bytes_per_device"] +
        (m["peak_bytes_whole"] - m["argument_bytes_whole"]) / chips)
    assert math.isfinite(r["collective_s"]) and r["collective_s"] >= 0
    assert r["collective_s"] == rec["counted"]["collective_bytes"] / \
        dryrun.LINK_BW
    assert rec["counted"]["collective_bytes"] == sum(
        rec["counted"]["collectives"].values())
    assert rec["collectives_unmodeled"] == {}
    assert r["bottleneck"] == max(("compute_s", "memory_s", "collective_s"),
                                  key=r.get)
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert rec["fits_80gb"] is True
    json.dumps(rec)
    if arch == "gemma3-1b":
        assert rec["counted"]["kernels"]["flash_decode"]["launches"] == 26


def test_cli_resumes(tmp_path, monkeypatch, capsys):
    out = tmp_path / "results.json"
    argv = ["dryrun", "--arch", "din", "--shape", "serve_p99", "--out",
            str(out)]
    monkeypatch.setattr("sys.argv", argv)
    dryrun.main()
    first = json.loads(out.read_text())
    assert sorted(first) == ["din|serve_p99|multi", "din|serve_p99|single"]
    assert all(r["status"] == "ok" for r in first.values())

    def refuse(*a, **k):
        raise AssertionError("a resumed run traced a finished cell")

    monkeypatch.setattr(dryrun, "run_cell", refuse)
    dryrun.main()
    assert json.loads(out.read_text()) == first
    assert "done" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", argv + ["--no-resume"])
    dryrun.main()
    again = json.loads(out.read_text())
    assert all(r["status"] == "error" for r in again.values())


def test_cli_recomputes_records_without_the_collective_term(tmp_path,
                                                           monkeypatch):
    """A record written before the collective term (``collective_s:
    null``, no ``collectives_unmodeled``) is traced again; a current one
    and a skipped one are kept."""
    out = tmp_path / "results.json"
    argv = ["dryrun", "--arch", "din", "--shape", "serve_p99", "--out",
            str(out)]
    monkeypatch.setattr("sys.argv", argv)
    dryrun.main()
    first = json.loads(out.read_text())
    old = dict(first["din|serve_p99|single"])
    del old["collectives_unmodeled"]
    old["roofline"] = {**old["roofline"], "collective_s": None}
    assert not dryrun.done(old)
    assert dryrun.done(first["din|serve_p99|multi"])
    assert dryrun.done({"status": "skipped"})
    assert not dryrun.done({"status": "error"}) and not dryrun.done(None)
    out.write_text(json.dumps({**first, "din|serve_p99|single": old}))
    traced = []
    run_cell = dryrun.run_cell

    def note(arch, shape, multi_pod, **kw):
        traced.append((arch, shape, multi_pod))
        return run_cell(arch, shape, multi_pod, **kw)

    monkeypatch.setattr(dryrun, "run_cell", note)
    dryrun.main()
    assert traced == [("din", "serve_p99", False)]
    again = json.loads(out.read_text())
    assert dryrun.done(again["din|serve_p99|single"])
    assert again["din|serve_p99|multi"] == first["din|serve_p99|multi"]
