"""The port's training core against the JAX package's, on the CPU.

Same inputs on both sides (numpy draws; the JAX ``init_params`` weights
carried by ``params_from_reference``, optimizer states by
``opt_state_from_reference``):

* ``cross_entropy`` (one-hot mask-sum in f32, with and without a mask);
* the gradients of ``loss_fn`` against ``jax.value_and_grad`` of the
  reference's, in f32, on reduced gemma3-1b, deepseek-v3 with ``mtp`` on
  (routes pinned through ``router_bias``: a near tie flips an expert, and
  with it the gradient, on any rounding) and arctic: every leaf within
  1e-4 of the largest magnitude of the reference's gradient for that leaf
  (the sums run in another order; measured up to 1.5e-5), the loss and
  its metrics within 1e-5 relative;
* two steps of ``adamw``, ``adafactor`` and ``sgd`` under
  ``warmup_cosine`` with clipping, from the same gradients: every state
  and f32 parameter leaf within 1e-5 of its largest magnitude, bf16
  parameters within one bf16 ulp (their f32 masters may round to either
  neighbour when they differ in the last f32 bit);
* gradient accumulation (4 micro-batches) against the full batch, and
  against the reference's accumulation;
* ``compress_tree`` bf16 exactly, and int8 exactly given the reference's
  ``jax.random`` noise;
* ``make_train_step`` over 3 steps (momentum SGD, with bf16 gradient
  compression and without) against the reference's, within 1e-4.
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
from repro.runtime import compression as jcomp
from repro.training import optim as joptim
from repro.training import trainer as jtrainer

from repro_torch.configs.registry import reduced_config
from repro_torch.interop import opt_state_from_reference, params_from_reference
from repro_torch.models.common import cross_entropy
from repro_torch.models.transformer import model as tm
from repro_torch.runtime import compression as comp
from repro_torch.training import optim
from repro_torch.training.trainer import make_train_step, value_and_grad
from repro_torch.tree_util import flatten_with_paths, leaves, path_name

GRAD_TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _flat(tree) -> dict:
    """Leaf name -> f32 numpy, for a torch or a JAX tree."""
    if isinstance(leaves(tree)[0], torch.Tensor):
        return {path_name(p): _t2np(x) for p, x in flatten_with_paths(tree)}
    return {path_name(p): _np(x) for p, x in
            flatten_with_paths(jax.tree.map(np.asarray, tree))}


def _leaf_rel(got: np.ndarray, want: np.ndarray) -> float:
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err / scale if scale > 0 else err


def _models(arch: str, pin: bool = False):
    jcfg = dataclasses.replace(j_reduced_config(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(reduced_config(arch), dtype=torch.float32)
    jparams = jax.tree.map(np.asarray, jmc.init_params(
        jtm.param_defs(jcfg), jax.random.PRNGKey(0)))
    if pin:   # every token routed to experts 0..K-1 (scores lie in (0, 1))
        for g in jparams.values():
            if isinstance(g, dict) and "router_bias" in g:
                b = np.zeros_like(g["router_bias"])
                b[..., :cfg.moe.top_k] = 2.0
                g["router_bias"] = b
    params = params_from_reference(jparams, cfg, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, jparams), cfg, params


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype, masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, (3, 7))
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32" else
              (jnp.bfloat16, torch.bfloat16))
    want = jmc.cross_entropy(jnp.asarray(logits, jd), jnp.asarray(targets),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits).to(td),
                        torch.from_numpy(targets),
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    # the gold term is a gather, bit for bit
    gathered = (torch.logsumexp(torch.from_numpy(logits).to(td).float(), -1)
                - torch.from_numpy(logits).to(td).float().gather(
                    -1, torch.from_numpy(targets)[..., None])[..., 0])
    if mask is None:
        assert torch.equal(got, gathered.mean())


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v3-671b",
                                  "arctic-480b"])
def test_loss_grads_match_jax(arch):
    jcfg, jparams, cfg, params = _models(arch, pin=arch.startswith("deep"))
    assert cfg.mtp == arch.startswith("deep")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtm.loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    (loss, met), grads = value_and_grad(
        lambda p, b: tm.loss_fn(p, b, cfg), params,
        {"tokens": torch.from_numpy(tokens)})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for key in ("loss", "aux", "mtp"):
        assert abs(float(met[key]) - float(jmet[key])) <= \
            1e-5 * max(abs(float(jmet[key])), 1e-6), key
    want, got = _flat(jgrads), _flat(grads)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert _leaf_rel(got[name], w) <= GRAD_TOL, name
    if cfg.mtp:   # the mtp block is trained through the loss
        assert np.abs(got["mtp/mtp_proj"]).max() > 0


def _opt_tree(seed=0):
    """A small parameter tree with the leaf kinds optimizers branch on: a
    stacked 3-D and a 2-D matrix, a vector, a bf16 matrix; and gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (2, 5, 6), "n": (7,)}, "b": (4, 3), "h": (6, 4)}

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"a": {"w": draw(shapes["a"]["w"], 0.5),
                    "n": draw(shapes["a"]["n"], 0.5)},
              "b": draw(shapes["b"], 0.5), "h": draw(shapes["h"], 0.5)}
    grads = [{"a": {"w": draw(shapes["a"]["w"], 2.0),
                    "n": draw(shapes["a"]["n"], 2.0)},
              "b": draw(shapes["b"], 2.0), "h": draw(shapes["h"], 2.0)}
             for _ in range(2)]
    bf16 = {"h"}

    def to_jax(tree, cast):
        return {k: to_jax(v, cast) if isinstance(v, dict) else jnp.asarray(
            v, jnp.bfloat16 if cast and k in bf16 else jnp.float32)
            for k, v in tree.items()}

    def to_torch(tree, cast):
        return {k: to_torch(v, cast) if isinstance(v, dict) else
                torch.from_numpy(v).to(torch.bfloat16 if cast and k in bf16
                                       else torch.float32)
                for k, v in tree.items()}
    return (to_jax(params, True), [to_jax(g, True) for g in grads],
            to_torch(params, True), [to_torch(g, True) for g in grads])


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2, clip_norm=1.0)),
    ("adafactor", dict(lr=1e-2, clip_norm=1.0)),
    ("sgd", dict(lr=1e-2, clip_norm=0.5)),
])
def test_optimizer_steps_match_jax(name, kw):
    jparams, jgrads, params, grads = _opt_tree()
    jopt = joptim.OPTIMIZERS[name](
        **kw, schedule=joptim.warmup_cosine(kw["lr"], 1, 4))
    opt = optim.OPTIMIZERS[name](
        **kw, schedule=optim.warmup_cosine(kw["lr"], 1, 4))
    jstate = jopt[0](jparams)
    state = opt_state_from_reference(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    fresh = opt[0](params)
    assert _flat(fresh).keys() == _flat(state).keys()
    for key, v in _flat(fresh).items():
        assert np.array_equal(v, _flat(state)[key]), key
    assert state["step"].dtype == torch.int32
    for jg, g in zip(jgrads, grads):
        jparams, jstate = jopt[1](jg, jstate, jparams)
        params, state = opt[1](g, state, params)
    assert int(state["step"]) == int(jstate["step"]) == 2
    for tree, jtree in ((state, jstate), (params, jparams)):
        got, want = _flat(tree), _flat(jtree)
        assert set(got) == set(want)
        for key, w in want.items():
            tol = 2.0 ** -7 if key.endswith("h") and tree is params \
                else 1e-5
            assert _leaf_rel(got[key], w) <= tol, (name, key)
    assert params["h"].dtype == torch.bfloat16


def test_warmup_cosine_and_clip_match_jax():
    js = joptim.warmup_cosine(3e-4, 20, 200)
    ts = optim.warmup_cosine(3e-4, 20, 200)
    for step in (0, 1, 19, 20, 21, 100, 199, 200, 250):
        w = float(js(jnp.int32(step)))
        assert abs(float(ts(torch.tensor(step, dtype=torch.int32))) - w) <= \
            1e-6 * max(w, 1e-12), step
    jparams, jgrads, params, grads = _opt_tree()
    for mx in (0.1, 1e3):
        got, want = _flat(optim._clip(grads[0], mx)), _flat(
            joptim._clip(jgrads[0], mx))
        for key, w in want.items():
            assert _leaf_rel(got[key], w) <= (2.0 ** -8 if key == "h"
                                              else 1e-6), key
    assert abs(float(optim._global_norm(grads[0])) -
               float(joptim._global_norm(jgrads[0]))) <= 1e-5


def _gemma(steps_batch=8):
    jcfg, jparams, cfg, params = _models("gemma3-1b")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (steps_batch, 12))
    return jcfg, jparams, cfg, params, tokens


def test_accumulation_matches_full_batch_and_jax():
    """SGD without momentum or clipping is linear in the gradient: one step
    at ``accum_steps = 4`` equals the full batch's step when every
    micro-batch has as many tokens, and the reference's accumulated
    step."""
    jcfg, jparams, cfg, params, tokens = _gemma()
    kw = dict(lr=0.5, momentum=0.0, clip_norm=None)
    loss = (lambda p, b: tm.loss_fn(p, b, cfg))
    batch = {"tokens": torch.from_numpy(tokens)}
    out = {}
    for accum in (1, 4):
        opt = optim.sgd(**kw)
        step = make_train_step(loss, opt, accum_steps=accum)
        out[accum], _, met = step(params, opt[0](params), batch)
    jopt = joptim.sgd(**kw)
    jstep = jax.jit(jtrainer.make_train_step(
        lambda p, b: jtm.loss_fn(p, b, jcfg), jopt, accum_steps=4))
    jout, _, jmet = jstep(jparams, jopt[0](jparams),
                          {"tokens": jnp.asarray(tokens, jnp.int32)})
    full, acc, want = _flat(out[1]), _flat(out[4]), _flat(jout)
    start = _flat(params)
    for key in full:
        step_full = full[key] - start[key]
        assert _leaf_rel(acc[key] - start[key], step_full) <= 1e-4, key
        assert _leaf_rel(acc[key] - start[key],
                         want[key] - start[key]) <= 1e-4, key
    # metrics are the last micro-batch's
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        1e-5 * float(jmet["loss"])


def test_compression_matches_jax():
    jparams, jgrads, params, grads = _opt_tree(seed=4)
    jb = jcomp.compress_tree(jgrads[0], "bf16")
    b = comp.compress_tree(grads[0], "bf16")
    for key, w in _flat(jb["data"]).items():
        assert np.array_equal(_flat(b["data"])[key], w), key
    back = comp.decompress_tree(b, like=grads[0])
    assert all(x.dtype == torch.float32 for x in leaves(back))
    # int8: the reference's own draws (compress_tree's split of PRNGKey(0))
    ji = jcomp.compress_tree(jgrads[0], "int8")
    jleaves = jax.tree.leaves(jgrads[0])
    keys = jax.random.split(jax.random.PRNGKey(0), len(jleaves))
    noise = [np.array(jax.random.uniform(k, g.shape, jnp.float32, -0.5,
                                           0.5))
             for k, g in zip(keys, jleaves)]
    ti = comp.compress_tree(grads[0], "int8", noise=noise)
    for q, jq, s, js_ in zip(ti["q"], ji["q"], ti["scale"], ji["scale"]):
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js_)
    got = _flat(comp.decompress_tree(ti, like=grads[0]))
    want = _flat(jcomp.decompress_tree(ji, like=jgrads[0]))
    for key, w in want.items():
        assert np.array_equal(got[key], w), key
    # the port's own noise: seeded, unbiased rounding within one step
    a = comp.compress_tree(grads[0], "int8")
    b2 = comp.compress_tree(grads[0], "int8")
    assert all(torch.equal(x, y) for x, y in zip(a["q"], b2["q"]))
    for g, q, s in zip(leaves(grads[0]), a["q"], a["scale"]):
        assert float((q.float() * s - g.float()).abs().max()) <= \
            float(s) * (1 + 1e-6)


@pytest.mark.parametrize("compression", [None, "bf16"])
def test_make_train_step_three_steps_matches_jax(compression):
    jcfg, jparams, cfg, params, tokens = _gemma(steps_batch=6)
    kw = dict(lr=0.05, momentum=0.9, clip_norm=1.0)
    opt = optim.sgd(**kw, schedule=optim.warmup_cosine(0.05, 1, 3))
    jopt = joptim.sgd(**kw, schedule=joptim.warmup_cosine(0.05, 1, 3))
    step = make_train_step(lambda p, b: tm.loss_fn(p, b, cfg), opt,
                           grad_compression=compression)
    jstep = jax.jit(jtrainer.make_train_step(
        lambda p, b: jtm.loss_fn(p, b, jcfg), jopt,
        grad_compression=compression))
    state, jstate = opt[0](params), jopt[0](jparams)
    start = _flat(params)
    losses, jlosses = [], []
    for i in range(3):
        rows = slice(2 * i, 2 * i + 2)
        params, state, met = step(params, state, {
            "tokens": torch.from_numpy(tokens[rows])})
        jparams, jstate, jmet = jstep(jparams, jstate, {
            "tokens": jnp.asarray(tokens[rows], jnp.int32)})
        losses.append(float(met["loss"]))
        jlosses.append(float(jmet["loss"]))
    assert np.allclose(losses, jlosses, rtol=1e-5)
    if compression is None:
        for tree, jtree in ((params, jparams),
                            (state["mom"], jstate["mom"])):
            got, want = _flat(tree), _flat(jtree)
            for key, w in want.items():
                assert _leaf_rel(got[key], w) <= GRAD_TOL, key
    else:
        # a gradient element whose f32 values differ in the last bits may
        # round to either bf16 neighbour: the parameters' change from the
        # start is held to two bf16 ulps (2^-7) of its largest magnitude
        got, want = _flat(params), _flat(jparams)
        for key, w in want.items():
            assert _leaf_rel(got[key] - start[key], w - start[key]) <= \
                2.0 ** -7, key


def test_value_and_grad_leaves_params_untouched():
    _, _, cfg, params, tokens = _gemma(steps_batch=2)
    before = _flat(params)
    opt = optim.adamw(lr=1e-2)
    state = opt[0](params)
    new, new_state, _ = make_train_step(
        lambda p, b: tm.loss_fn(p, b, cfg), opt)(
        params, state, {"tokens": torch.from_numpy(tokens)})
    for key, v in _flat(params).items():
        assert np.array_equal(v, before[key]), key
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert all(not t.requires_grad for t in leaves(new))
    assert not np.array_equal(_flat(new)["embed"], before["embed"])


# ---------------------------------------------------------------------------
# the GNN and recsys families of the launcher and the registry
# ---------------------------------------------------------------------------

OTHER_ARCHS = ("gcn-cora", "gin-tu", "meshgraphnet", "dimenet", "din")


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_synth_batch_matches_reference(arch):
    """The same draws from one seed, in the same order: equal arrays, the
    reference's dtypes, and the generator left in the same state."""
    from repro.launch.train import synth_batch as j_synth_batch
    from repro_torch.launch.train import synth_batch

    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        want = j_synth_batch(arch, jcfg, jrng, 4, 8)
        got = synth_batch(arch, cfg, rng, 4, 8, device="cpu")
        assert got.keys() == want.keys()
        for key, w in want.items():
            w = np.asarray(w)
            g = got[key].numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), key
    assert rng.integers(0, 2 ** 31) == jrng.integers(0, 2 ** 31)


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_train_five_steps_match_reference_loop(arch, monkeypatch):
    """``train(arch, device="cpu")`` against the reference launcher's loop
    (``repro/launch/train.py::main``: reduced config, AdamW under
    ``warmup_cosine(lr, 20, steps)``, a fresh ``synth_batch`` a step from
    ``default_rng(0)``), from the reference's initial weights: each step's
    loss within 1e-5 relative."""
    from repro.configs.registry import get_arch as j_get_arch
    from repro.launch.train import make_loss as j_make_loss
    from repro.launch.train import synth_batch as j_synth_batch
    from repro_torch.launch import train as tr

    steps, lr = 5, 1e-2
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    loss_fn, defs = j_make_loss(arch, jcfg)
    jparams = jmc.init_params(defs, jax.random.PRNGKey(0))
    carried = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    opt = joptim.OPTIMIZERS[j_get_arch(arch)[1]](
        lr=lr, schedule=joptim.warmup_cosine(lr, 20, steps))
    state = opt[0](jparams)
    step_fn = jax.jit(jtrainer.make_train_step(loss_fn, opt))
    rng = np.random.default_rng(0)
    want = []
    for _ in range(steps):
        jparams, state, m = step_fn(jparams, state,
                                    j_synth_batch(arch, jcfg, rng, 4, 8))
        want.append(float(m["loss"]))

    monkeypatch.setattr(tr.mc, "init_params", lambda *a, **k: carried)
    got = tr.train(arch, steps=steps, batch=4, seq=8, lr=lr, device="cpu",
                   log=lambda *_: None)["losses"]
    assert len(got) == steps
    assert want[-1] != want[0]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)


def test_registry_lookups_match_reference():
    """``ARCH_IDS`` in the reference's order; ``family_of``,
    ``shapes_for``, ``get_arch`` and ``reduced_config`` equal to the
    reference's for every entry (configs field by field, dtypes by
    name, the GNN configs' mesh specs and ``gather_chunks`` too; the LM
    config's ``act_spec`` is not ported); the shape tables equal."""
    import repro.configs.registry as jreg
    import repro.configs.shapes as jshapes
    import repro_torch.configs.registry as reg
    import repro_torch.configs.shapes as shapes

    def fields(cfg) -> dict:
        out = {}
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if dataclasses.is_dataclass(v):
                v = fields(v)
            elif isinstance(v, torch.dtype):
                v = str(v).removeprefix("torch.")
            elif f.name in ("dtype", "act_dtype"):
                v = np.dtype(v).name
            out[f.name] = v
        return {"class": type(cfg).__name__, **out}

    assert reg.ARCH_IDS == jreg.ARCH_IDS
    for arch in jreg.ARCH_IDS:
        assert reg.family_of(arch) == jreg.family_of(arch)
        assert reg.shapes_for(arch) == jreg.shapes_for(arch)
        (cfg, opt), (jcfg, jopt) = reg.get_arch(arch), jreg.get_arch(arch)
        assert opt == jopt
        for a, b in ((cfg, jcfg), (reg.reduced_config(arch),
                                   jreg.reduced_config(arch))):
            a, b = fields(a), fields(b)
            # the LM config's mesh spec has no counterpart on one card
            extra = {"act_spec"} if reg.family_of(arch) == "lm" else set()
            assert b.keys() - a.keys() == extra, arch
            assert a == {k: v for k, v in b.items() if k not in extra}, arch
    for name in ("GNN_SHAPES", "RECSYS_SHAPES", "LM_SHAPES"):
        a, b = getattr(shapes, name), getattr(jshapes, name)
        assert {k: dataclasses.asdict(v) for k, v in a.items()} == \
            {k: dataclasses.asdict(v) for k, v in b.items()}
    assert shapes.GNN_SHAPES["molecule"].padded() == (512, 512)
    assert reg.get_arch("din")[0].d_item == 36
    for bad in (reg.family_of, reg.get_arch, reg.reduced_config,
                reg.shapes_for):
        with pytest.raises(KeyError):
            bad("no-such-arch")
