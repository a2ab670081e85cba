"""What the benchmark may import and read: no module under ``hgbench/``
imports ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (the
top-level name compared whole, so ``repro_torch`` passes); the reference
imports no ``repro_torch`` either; nothing names ``benchmarks/``, the
JAX package's benchmarks.  And the entry point: no card, or no program,
means a non-zero exit and no result."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from hgbench.tests import small

HG = small.ROOT / "hgbench"
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _sources():
    return sorted(p for p in HG.rglob("*.py") if "tests" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED, (path, name)


def test_metric_wraps_name_only_the_port():
    from hgbench import catalog
    for path in (HG / "metrics").glob("*.py"):
        for entry in getattr(catalog.load_module(path), "WRAPS", ()):
            assert entry[0].split(".")[0] == "repro_torch", (path, entry)


def test_reference_imports_no_program():
    for path in (HG / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED | {"repro_torch", "torch"}
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.module in (None, "replay", "history"), path


def test_nothing_reads_the_jax_benchmarks():
    for path in list(_sources()) + list(HG.rglob("*.json")):
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path
        if path.suffix == ".py":
            for name in _imports(path):
                assert name.split(".")[0] != "benchmarks", path


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "hgbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_no_card_no_result():
    r = _run(small.ROOT, "--workload", small.CELLS[0], "--seed",
             str(small.SEED), "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(small.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HG, tmp_path / "hgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "--workload", small.CELLS[0], "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""


def test_a_run_loads_no_jax():
    """A whole small run in a fresh process, with imports of JAX or the
    JAX package refused, holds none of them at the end."""
    code = (
        "import sys, importlib.abc\n"
        "class No(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in %r:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, No())\n"
        "sys.path[:0] = [%r, %r]\n"
        "from hgbench import harness\n"
        "from hgbench.tests import small\n"
        "r = harness.run(small.cell(%r), seed=3, seconds=0.1, traced=False,"
        " device='cpu')\n"
        "assert r.correct, r.checks\n"
        "assert harness.banned_modules() == [], harness.banned_modules()\n"
        % (sorted(BANNED), str(small.ROOT / "src"), str(small.ROOT),
           small.CELLS[1]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("name", ["jax.numpy", "repro.core", "flax"])
def test_banned_modules_compares_whole_names(name, monkeypatch):
    from hgbench import harness
    monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert name.split(".")[0] in harness.banned_modules()
    assert "repro_torch_fake" not in str(harness.banned_modules())
