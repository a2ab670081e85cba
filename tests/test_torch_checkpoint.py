"""The port's checkpoints against the JAX package's, on the CPU.

``repro_torch.storage.checkpoint`` flattens trees as ``jax.tree_util``
does and writes the reference's keys, dtype names and blobs (bf16 leaves
as their bits under the name ``bfloat16``).  Held here, on a
``LogFileKV`` directory:

* a checkpoint of (params, AdamW state) of reduced gemma3-1b (bf16
  parameters, f32 moments and master, the int32 step) written by
  ``repro`` restores in ``repro_torch``, and one written by
  ``repro_torch`` restores in ``repro``, bit for bit, whole and row-sharded;
* a crash while a checkpoint is written keeps the previous one;
* the parameter-delta history (``save_param_delta`` /
  ``restore_param_history``, exact and lossy) gives the same trees in
  both packages, whichever wrote it;
* ``launch/train`` resumed after a crash reaches the parameters of an
  uninterrupted run, bit for bit; the GNN and recsys families raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced_config
from repro.models import common as jmc
from repro.models.transformer import model as jtm
from repro.storage import checkpoint as jck
from repro.storage.kv import LogFileKV as JLogFileKV
from repro.training import optim as joptim

from repro_torch.configs.registry import reduced_config
from repro_torch.interop import opt_state_from_reference, params_from_reference
from repro_torch.launch import train as tr
from repro_torch.storage import checkpoint as ck
from repro_torch.storage.kv import LogFileKV
from repro_torch.training import optim
from repro_torch.tree_util import flatten_with_paths, path_name


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf, for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.reshape(-1).numpy().view(np.uint8).copy()
    return np.asarray(x).reshape(-1).view(np.uint8).copy()


def _same(tree, jtree) -> None:
    got = {path_name(p): x for p, x in flatten_with_paths(tree)}
    want = {path_name(p): x for p, x in
            flatten_with_paths(jax.tree.map(np.asarray, jtree))}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == tuple(np.shape(w)), name
        assert str(g.dtype).removeprefix("torch.") == str(np.asarray(w).dtype)
        assert np.array_equal(_bits(g), _bits(w)), name


@pytest.fixture(scope="module")
def trees():
    """Reduced gemma3-1b (bf16) and its AdamW state after one step, in
    both packages (the port's carried from the reference's)."""
    jcfg, cfg = j_reduced_config("gemma3-1b"), reduced_config("gemma3-1b")
    jparams = jmc.init_params(jtm.param_defs(jcfg), jax.random.PRNGKey(0))
    jopt = joptim.adamw(lr=1e-2)
    jstate = jopt[0](jparams)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    jparams, jstate = jopt[1](grads, jstate, jparams)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    state = opt_state_from_reference(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    return jparams, jstate, params, state


@pytest.mark.parametrize("n_shards", [1, 3])
def test_reference_checkpoint_restores_in_port(trees, tmp_path, n_shards):
    jparams, jstate, params, state = trees
    store = JLogFileKV(str(tmp_path))
    jck.save_checkpoint(store, 7, (jparams, jstate), n_shards=n_shards,
                        extra={"data_cursor": 7})
    store.close()
    store = LogFileKV(str(tmp_path))
    assert ck.latest_step(store) == 7
    fresh = optim.adamw()[0](params)           # zeros to be overwritten
    (p, s), extra, step = ck.restore_checkpoint(store, like=(params, fresh))
    store.close()
    assert step == 7 and extra == {"data_cursor": 7}
    _same((p, s), (jparams, jstate))
    assert s["step"].dtype == torch.int32 and s["step"].shape == ()


@pytest.mark.parametrize("n_shards", [1, 3])
def test_port_checkpoint_restores_in_reference(trees, tmp_path, n_shards):
    jparams, jstate, params, state = trees
    store = LogFileKV(str(tmp_path))
    ck.save_checkpoint(store, 3, (params, state), n_shards=n_shards)
    store.close()
    store = JLogFileKV(str(tmp_path))
    assert jck.latest_step(store) == 3
    (jp, js), extra, step = jck.restore_checkpoint(
        store, like=(jparams, jstate))
    store.close()
    assert step == 3 and extra == {}
    _same((params, state), (jp, js))
    # and in the port itself, without a tree to follow: name -> tensor
    store = LogFileKV(str(tmp_path))
    flat, _, _ = ck.restore_checkpoint(store)
    store.close()
    assert flat["0/embed"].dtype == torch.bfloat16
    assert torch.equal(flat["0/embed"], params["embed"])


def test_crash_mid_checkpoint_keeps_the_previous(trees, tmp_path):
    jparams, jstate, params, state = trees
    store = LogFileKV(str(tmp_path))
    ck.save_checkpoint(store, 1, (params, state))
    later = {k: (v + 1 if k == "final_norm" else v)
             for k, v in params.items()}
    put, n = store.put, [0]

    def dying_put(key, value):
        n[0] += 1
        if n[0] == 5:
            raise OSError("disk gone")
        put(key, value)
    store.put = dying_put
    with pytest.raises(OSError):
        ck.save_checkpoint(store, 2, (later, state))
    store.close()
    store = LogFileKV(str(tmp_path))
    assert ck.latest_step(store) == 1
    (p, s), _, step = ck.restore_checkpoint(store, like=(params, state))
    store.close()
    assert step == 1 and torch.equal(p["final_norm"], params["final_norm"])


@pytest.mark.parametrize("atol", [0.0, 0.02])
def test_param_delta_history_matches_reference(tmp_path, atol):
    rng = np.random.default_rng(0)
    jtrees = []
    base = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "h": rng.standard_normal((4, 3)).astype(np.float32)}
    for i in range(3):
        tree = {k: v.copy() for k, v in base.items()}
        tree["w"][i, :2] += 0.5 * (i + 1)
        tree["h"][:, i] += 0.01
        jtrees.append({"w": jnp.asarray(tree["w"]),
                       "h": jnp.asarray(tree["h"], jnp.bfloat16)})
    trees = [{"w": torch.from_numpy(np.array(t["w"])),
              "h": torch.from_numpy(np.asarray(t["h"]).view(np.uint16)
                                    .copy()).view(torch.bfloat16)}
             for t in jtrees]
    steps = [10, 20, 30]
    for writer in ("port", "reference"):
        path = str(tmp_path / writer)
        kv, save, ts = ((LogFileKV, ck.save_param_delta, trees)
                        if writer == "port" else
                        (JLogFileKV, jck.save_param_delta, jtrees))
        store = kv(path)
        for i, (step, tree) in enumerate(zip(steps, ts)):
            save(store, step, steps[i - 1] if i else None, tree,
                 ts[i - 1] if i else None, atol=atol)
        store.close()
        store, jstore = LogFileKV(path), JLogFileKV(path)
        got = ck.restore_param_history(store, steps, trees[0])
        want = jck.restore_param_history(jstore, steps, jtrees[0])
        store.close()
        jstore.close()
        for i, step in enumerate(steps):
            _same(got[step], want[step])
            if atol == 0.0:
                _same(trees[i], want[step])


def _train(tmp, steps, data=None):
    return tr.train("gemma3-1b", steps=steps, batch=2, seq=12, lr=1e-2,
                    ckpt_dir=str(tmp), ckpt_every=2, device="cpu",
                    data=data, log=lambda *_: None)


def test_train_resume_matches_uninterrupted_run(tmp_path, monkeypatch):
    whole = _train(tmp_path / "whole", 6)
    assert whole["start"] == 0 and len(whole["losses"]) == 6
    draws = [0]
    synth = tr.synth_batch

    def crashing(*a, **k):
        draws[0] += 1
        if draws[0] == 4:                    # the batch of step index 3
            raise RuntimeError("preempted")
        return synth(*a, **k)
    monkeypatch.setattr(tr, "synth_batch", crashing)
    with pytest.raises(RuntimeError, match="preempted"):
        _train(tmp_path / "resumed", 6)
    monkeypatch.setattr(tr, "synth_batch", synth)
    resumed = _train(tmp_path / "resumed", 6)
    assert resumed["start"] == 2 and len(resumed["losses"]) == 4
    assert resumed["losses"] == whole["losses"][2:]
    for tree in ("params", "opt_state"):
        a = dict(flatten_with_paths(whole[tree]))
        b = dict(flatten_with_paths(resumed[tree]))
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(_bits(a[key]), _bits(b[key])), key


def test_train_other_families_wait_for_item_6_4():
    for arch in ("gcn-cora", "din"):
        with pytest.raises(NotImplementedError, match="6.4"):
            tr.train(arch, steps=1, device="cpu")
    with pytest.raises(KeyError):
        tr.train("no-such-arch", steps=1, device="cpu")
