"""The port's package boundary and its device default.

* Every ``repro_torch`` module, and ``chip_smoke.py``, imports in a fresh
  interpreter whose import system refuses ``jax`` and ``repro`` (exactly,
  or as a dotted prefix — ``repro_torch`` itself stays importable).
* Entry points called without ``device=`` run on the card; without one
  they raise instead of running on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import DeltaGraph
from repro_torch.data.generators import random_history
from repro_torch.runtime import torch_exec
from repro_torch.runtime.staging import DeviceStager
from repro_torch.storage.kv import MemKV

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

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
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT)],
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
