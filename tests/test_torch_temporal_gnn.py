"""The port's temporal GCN example against the JAX package's, on the CPU.

``examples/pt_temporal_gnn_train.py`` and ``examples/temporal_gnn_train.py``
build the same ``churn_network`` history and ``GraphManager``, the same
64-point grid and ``SnapshotBatchLoader`` windows, and train the same GCN
(d_in 16, d_hidden 32, 2 layers, 2 classes) with AdamW at lr 5e-3.  From
the reference's initial weights (carried by ``params_from_reference``),
five steps of the port's loop give the reference loop's losses within 1e-5
relative, and the port's first loader window equals the reference's (the
edge and label masks and labels exactly, the degree features within
1e-6).  The port's checkpoint of the trained state restores bit for bit.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import GraphManager as JGraphManager
from repro.core import SnapshotBatchLoader as JSnapshotBatchLoader
from repro.data.generators import churn_network as j_churn_network
from repro.models import common as jmc
from repro.models.gnn import GCNConfig as JGCNConfig
from repro.models.gnn import gnn_loss as j_gnn_loss
from repro.models.gnn import gnn_param_defs as j_gnn_param_defs
from repro.training.optim import OPTIMIZERS as J_OPTIMIZERS
from repro.training.trainer import make_train_step as j_make_train_step

from repro_torch.interop import params_from_reference
from repro_torch.storage.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.storage.kv import LogFileKV
from repro_torch.tree_util import flatten_with_paths

ROOT = Path(__file__).resolve().parent.parent
STEPS = 5


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    ref = _example("temporal_gnn_train")
    pt = _example("pt_temporal_gnn_train")

    # the reference example's set-up (examples/temporal_gnn_train.py:main)
    uni, ev = j_churn_network(n_initial_edges=600, n_events=6000, seed=5)
    jgm = JGraphManager(uni, ev, L=400, k=4, diff_fn="balanced")
    tmax = int(ev.time[-1])
    jcfg = JGCNConfig(d_in=16, d_hidden=32, n_layers=2, n_classes=2)
    jparams = jmc.init_params(j_gnn_param_defs(jcfg), jax.random.PRNGKey(0))
    carried = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    pt.CFG, device="cpu")
    opt = J_OPTIMIZERS["adamw"](lr=5e-3)
    state = opt[0](jparams)
    step_fn = jax.jit(j_make_train_step(lambda p, b: j_gnn_loss(p, b, jcfg),
                                        opt))
    lo, hi = tmax // 4, int(tmax * 0.8)
    grid = sorted({int(t) for t in np.linspace(lo, hi, 64)})
    jloader = JSnapshotBatchLoader(jgm, grid, batch_size=4,
                                   label_horizon=tmax // 10, d_in=jcfg.d_in)
    jwindow = next(iter(jloader))
    stream = ref.snapshot_stream(jloader)
    want = []
    for _ in range(STEPS):
        jparams, state, m = step_fn(jparams, state, next(stream))
        want.append(float(m["loss"]))

    # the port's example loop, from the same weights
    gm, ptmax = pt.build_history("cpu")
    assert ptmax == tmax and pt.time_grid(ptmax) == grid
    loader = pt.make_loader(gm, pt.time_grid(ptmax), ptmax)
    window = next(iter(loader))
    opt_pt, step_pt = pt.make_step()
    params, opt_state, got = pt.train_steps(
        step_pt, carried, opt_pt[0](carried), pt.snapshot_stream(loader), 0,
        STEPS, log=lambda *_: None)
    gm.close()
    return {"want": want, "got": got, "jwindow": jwindow, "window": window,
            "params": params, "opt_state": opt_state}


def test_example_losses_match_reference(runs):
    got, want = runs["got"], runs["want"]
    assert len(got) == len(want) == STEPS
    assert np.all(np.isfinite(got))
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)


def test_example_window_matches_reference(runs):
    jb, b = runs["jwindow"], runs["window"]
    assert b["times"] == list(jb["times"])
    for key in ("edge_index", "edge_mask", "label_mask", "labels",
                "num_edges"):
        assert np.array_equal(b[key].numpy(), np.asarray(jb[key])), key
    assert np.allclose(b["x"].numpy(), np.asarray(jb["x"]), rtol=1e-6,
                       atol=1e-6)
    assert b["x"].device.type == "cpu"


def test_example_checkpoint_round_trip(runs, tmp_path):
    store = LogFileKV(str(tmp_path))
    save_checkpoint(store, STEPS, (runs["params"], runs["opt_state"]))
    store.close()
    store = LogFileKV(str(tmp_path))
    (p, s), _, step = restore_checkpoint(
        store, like=(runs["params"], runs["opt_state"]))
    store.close()
    assert step == STEPS
    for tree, back in ((runs["params"], p), (runs["opt_state"], s)):
        a, b = dict(flatten_with_paths(tree)), dict(flatten_with_paths(back))
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert torch.equal(a[key], b[key]), key
