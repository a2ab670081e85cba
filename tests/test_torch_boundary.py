"""The port's package boundary and its device default.

* Every ``repro_torch`` module, ``chip_smoke.py`` and
  ``examples/pt_temporal_gnn_train.py`` import in a fresh interpreter
  whose import system refuses ``jax`` and ``repro`` (exactly, or as a
  dotted prefix — ``repro_torch`` itself stays importable).
* Entry points called without ``device=`` run on the card; without one
  they raise instead of running on the CPU: retrieval (the rank-local
  sharded entry too, in a one-rank ``gloo`` group), LM serving, the model
  builders, and training (``launch/train``, its batches, the optimizer
  state carried from the reference); GNN and DIN training and DIN
  serving.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.core import DeltaGraph
from repro_torch.data.generators import random_history
from repro_torch.interop import params_from_reference
from repro_torch.kernels import attention
from repro_torch.kernels.policy import resolve_device
from repro_torch.launch import serve
from repro_torch.models.common import init_params
from repro_torch.models.transformer import model as tm
from repro_torch.runtime import torch_exec
from repro_torch.runtime.staging import DeviceStager
from repro_torch.storage.kv import MemKV

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        for banned in ("jax", "repro"):
            if name == banned or name.startswith(banned + "."):
                raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
missing = set(sys.argv[2].split(",")) - set(names)
assert not missing, missing
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
spec = importlib.util.spec_from_file_location(
    "pt_temporal_gnn_train",
    sys.argv[1] + "/examples/pt_temporal_gnn_train.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules
                if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
assert not loaded, loaded
print(len(names))
"""


# the training slice's modules, which the walk must reach
_TRAINING_MODULES = ("repro_torch.tree_util", "repro_torch.training.optim",
                     "repro_torch.training.trainer",
                     "repro_torch.runtime.compression",
                     "repro_torch.storage.checkpoint",
                     "repro_torch.launch.train")

# the GNN and DIN slice's modules
_GNN_DIN_MODULES = ("repro_torch.configs.shapes",
                    "repro_torch.configs.gnn_archs",
                    "repro_torch.models.gnn.models",
                    "repro_torch.models.recsys.din",
                    "repro_torch.models.recsys.embedding")


def test_port_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT),
                          ",".join(_TRAINING_MODULES + _GNN_DIN_MODULES)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25     # every module was walked


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.fixture(scope="module")
def small_index():
    uni, ev = random_history(60, 0, max_time_step=2)
    return DeltaGraph(uni, MemKV(), L=8, k=2).build(ev), int(ev.time[-1])


@pytest.mark.parametrize("entry", ["execute_singlepoint_torch",
                                   "execute_singlepoint_fused",
                                   "execute_multipoint_torch"])
def test_entry_points_default_to_the_card(no_card, small_index, entry):
    dg, tmax = small_index
    fn = getattr(torch_exec, entry)
    arg = [0, tmax] if entry == "execute_multipoint_torch" else tmax
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(dg, arg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceStager()
    assert isinstance(fn(dg, arg, device="cpu"), (tuple, dict))


def test_ir_entry_default_raises(no_card, small_index):
    dg, tmax = small_index
    ir = dg.plan_multipoint([0, tmax // 2, tmax])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_exec.execute_ir_torch(dg, ir)
    out = torch_exec.execute_ir_torch(dg, ir, device="cpu")
    assert all(isinstance(v[0], np.ndarray) for v in out.values())


@pytest.mark.parametrize("entry", ["serve_lm", "load_lm"])
def test_lm_serving_defaults_to_the_card(no_card, entry):
    args = ("gemma3-1b", 1, 4, 1) if entry == "serve_lm" else ("gemma3-1b",)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(serve, entry)(*args, reduced=True)
    out = getattr(serve, entry)(*args, reduced=True, device="cpu")
    assert out is not None


def _model_entry(name: str):
    """``(call, check)``: the model entry point ``name`` on a reduced
    gemma3-1b, and a check of what it returns on the CPU."""
    cfg = reduced_config("gemma3-1b")
    if name == "init_params":
        return (lambda **kw: init_params(tm.param_defs(cfg),
                                         torch.Generator(), **kw),
                lambda out: out["embed"].shape == (cfg.vocab, cfg.d_model))
    if name == "init_cache":
        return (lambda **kw: tm.init_cache(cfg, 2, 8, **kw),
                lambda out: out[0][0].shape[3] == 8)
    if name == "prompt_tokens":
        return (lambda **kw: serve.prompt_tokens(cfg, 2, 8, **kw),
                lambda out: out.shape == (2, 8))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(tm.param_defs(cfg32), torch.Generator(),
                         device="cpu")
    tree = {k: (v.numpy() if isinstance(v, torch.Tensor) else
                {n: w.numpy() for n, w in v.items()})
            for k, v in params.items()}
    return (lambda **kw: params_from_reference(tree, cfg32, **kw),
            lambda out: out["embed"].device.type == "cpu")


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "prompt_tokens", "params_from_reference"])
def test_model_entry_points_default_to_the_card(no_card, entry):
    call, ok = _model_entry(entry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert ok(call(device="cpu"))


def test_attention_inputs_default_to_the_card(no_card):
    """Tensors for ``attention`` placed on the default device raise here;
    placed on the CPU they run the plain version."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch.zeros(1, 1, 2, 8, device=resolve_device())
    x = torch.zeros(1, 1, 2, 8, device=resolve_device("cpu"))
    assert attention(x, x, x).shape == (1, 1, 2, 8)


def test_rank_local_entry_defaults_to_the_card(no_card, small_index):
    """The rank-local sharded entry in a one-rank gloo group: the default
    device raises before any collective; ``device="cpu"`` gives the
    one-launch path's masks."""
    import socket

    import torch.distributed as dist

    dg, tmax = small_index
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_exec.execute_singlepoint_sharded_rank(dg, tmax,
                                                        partitions=4)
        nm, em = torch_exec.execute_singlepoint_sharded_rank(
            dg, tmax, partitions=4, device="cpu")
    finally:
        dist.destroy_process_group()
    one = torch_exec.execute_singlepoint_sharded_torch(
        dg, tmax, partitions=4, device="cpu")
    assert np.array_equal(nm, one[0]) and np.array_equal(em, one[1])


def test_training_defaults_to_the_card(no_card):
    from repro_torch.launch import train
    from repro_torch.interop import opt_state_from_reference

    cfg = reduced_config("gemma3-1b")
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("gemma3-1b", steps=1, log=lambda *_: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.synth_batch("gemma3-1b", cfg, rng, 2, 8)
    state = {"step": np.zeros((), np.int32),
             "mom": {"w": np.zeros((2, 3), np.float32)}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt_state_from_reference(state)
    out = train.train("gemma3-1b", steps=1, batch=2, seq=8, device="cpu",
                      log=lambda *_: None)
    assert np.isfinite(out["losses"][0])
    assert train.synth_batch("gemma3-1b", cfg, rng, 2, 8, device="cpu")[
        "tokens"].shape == (2, 8)
    carried = opt_state_from_reference(state, device="cpu")
    assert carried["step"].shape == () and carried["step"].dtype == \
        torch.int32


@pytest.mark.parametrize("arch", ["gcn-cora", "din"])
def test_gnn_and_din_entry_points_default_to_the_card(no_card, arch):
    from repro_torch.launch import train

    cfg = reduced_config(arch)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(arch, steps=1, log=lambda *_: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.synth_batch(arch, cfg, rng, 2, 8)
    if arch == "din":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.serve_din(4, reduced=True)
        out = serve.serve_din(4, reduced=True, device="cpu", iters=1)
        assert out["scores"].shape == (4,)
    out = train.train(arch, steps=1, device="cpu", log=lambda *_: None)
    assert np.isfinite(out["losses"][0])
