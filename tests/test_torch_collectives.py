"""The dry run's collective term (``repro_torch.launch.sharding``) against
XLA's SPMD partitioner, and the sharding constraint it reads.

* (a) ``models.common.constrain``: an identity in value (a view of its
  input) and in gradient; no op at all in a trace when the spec is
  ``None``.  gemma3-1b's ``prefill_step`` (registry config, no
  ``act_spec``) dispatches 2,837 ops on ``meta`` at B 2 × 64, the count
  of the tree before the constraint existed.
* (b) Small programs on a 2×4 (``data`` × ``model``) mesh, their
  collective bytes per device exactly equal to XLA's, kind by kind: a
  product with its contracted dimension sharded, an FSDP gather of a
  ``data``-sharded weight, an ``index_add`` over edges sharded on
  ``(data, model)``, and constraints that reshard (all-to-all,
  all-gather, collective-permute).
* (c) Reduced cells on the same mesh, built by the registries'
  ``get_cell`` with their reduced configs (gemma3-1b's training step at
  B 16 × 32, deepseek-v3's prefill with MoE at B 4 × 32, meshgraphnet
  and DIN training): per device, the pass's total within 0.5-2× of
  XLA's, and every kind XLA emits present.  Two more on a 2×2×2
  (``pod`` × ``data`` × ``model``) mesh, where deepseek-v3's 2 MoE groups
  (B 8 × 32, prefill and training) do not divide the 4-way batch axes, as
  the production 16 do not divide 2×16×16's 32: XLA pads the groups'
  dimension, and so does the pass.  The LMs run in f32 on both
  sides: XLA's CPU backend moves bf16 values as f32 (its collectives on
  bf16 weights carry f32 shapes), so bf16 would compare elements at two
  bytes against four.  One kind is missing, by name: deepseek-v3's
  collective-permute, XLA's re-tiling of the router weight (1,024 of
  1,232,512 bytes; ``ROADMAP.md`` §3).
* (d) A 1×1 mesh moves nothing.
* (e) Thirteen production cells (the GNNs and DIN, which XLA lowers in
  seconds) at their registered shapes and widths on the 16×16 mesh, the
  pass's bytes against the reference's cell lowered on 256 faked
  devices, XLA's kinds present.  XLA's CPU backend forms no
  reduce-scatter: it all-reduces the whole sum and slices it, so here the
  pass's reduce-scatters are counted as that all-reduce
  (:class:`AsXlaCpu`, a test-side count; the record reports the pass's
  own); within 0.5-2×.

The XLA side is ``hlo_analysis.analyze(...)["collectives"]`` of the
reference's programs lowered on a faked CPU mesh, in two module-scoped
subprocesses (8 and 256 devices: ``XLA_FLAGS`` must be set before JAX
starts).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.configs.shapes import GNNShape, LMShape, RecSysShape
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import common as mc
from repro_torch.models.common import constrain
from repro_torch.models.transformer import model as tm

SRC = str(Path(__file__).resolve().parent.parent / "src")

# (name, fn source in both packages, [(shape, spec, dtype)])
SMALL = {
    "contracted": ("x @ w", "(None, None)",
                   [((8, 16), (None, "model")), ((16, 12), ("model", None))]),
    "fsdp": ("x @ w", '("data", "model")',
             [((8, 16), ("data", None)), ((16, 12), ("data", "model"))]),
    "index_add": ("scatter(x, w)", "(None, None)",
                  [((64, 8), (("data", "model"), None)),
                   ((64,), (("data", "model"),), "int32")]),
    "reshard_a2a": ("x * 2", '(None, "data")', [((16, 32), ("data", None))]),
    "reshard_gather": ("x * 2", "(None, None)",
                       [((16, 32), (None, "model"))]),
    "reshard_permute": ("x * 2", '("model", None)',
                        [((16, 32), ("data", None))]),
}

# reduced cells: case -> (arch, shape id, the shape, MoE groups or None
# for the config's, mesh: None for MESH, else (dims, axis names); a
# three-axis mesh is a multi-pod one)
PODS = ((2, 2, 2), ("pod", "data", "model"))
CELLS = {
    "gemma3-1b": ("gemma3-1b", "t_train", LMShape("t_train", 32, 16,
                                                  "train"), None, None),
    "deepseek-v3-671b": ("deepseek-v3-671b", "t_prefill",
                         LMShape("t_prefill", 32, 4, "prefill"), None, None),
    "meshgraphnet": ("meshgraphnet", "t_graph",
                     GNNShape("t_graph", 1000, 4000, 4, "full", n_classes=2),
                     None, None),
    "din": ("din", "t_train", RecSysShape("t_train", 64, "train"), None,
            None),
    "deepseek-v3-671b|uneven_prefill": (
        "deepseek-v3-671b", "t_uneven", LMShape("t_uneven", 32, 8,
                                                "prefill"), 2, PODS),
    "deepseek-v3-671b|uneven_train": (
        "deepseek-v3-671b", "t_uneven", LMShape("t_uneven", 32, 8, "train"),
        2, PODS),
}
# kinds XLA emits that the pass does not, by case (ROADMAP.md §3)
MISSING = {"deepseek-v3-671b": {"collective-permute"}}

_XLA = r"""
import json, os, dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry as jreg
from repro.configs.shapes import GNNShape, LMShape, RecSysShape
from repro.launch import hlo_analysis
from repro.runtime import compat

MESH = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
SMALL, CELLS = json.loads(os.environ["SMALL"]), json.loads(os.environ["CELLS"])


def lowered(fn, args, specs, mesh=MESH):
    shard = jax.tree.map(
        lambda sp: NamedSharding(mesh, sp if isinstance(sp, P) else P()),
        specs, is_leaf=lambda x: isinstance(x, P) or x is None)
    with compat.set_mesh(mesh):
        c = jax.jit(fn, in_shardings=shard).lower(*args).compile()
    return hlo_analysis.analyze(c.as_text())["collectives"]


def scatter(m, dst):
    return jnp.zeros((16, 8), jnp.float32).at[dst].add(m)


out = {}
for name, (expr, target, inputs) in SMALL.items():
    body = eval("lambda x, w=None: jax.lax.with_sharding_constraint("
                + expr + ", P(*" + target + "))")
    args = [jax.ShapeDtypeStruct(tuple(s), getattr(jnp, d[0]) if d
                                 else jnp.float32) for s, sp, *d in inputs]
    specs = [P(*[tuple(e) if isinstance(e, list) else e for e in sp])
             for s, sp, *d in inputs]
    out[name] = lowered(body, args, specs)

kinds = {"LMShape": LMShape, "GNNShape": GNNShape,
         "RecSysShape": RecSysShape}
for case, (arch, sid, cls, fields, groups, grid) in CELLS.items():
    fam = jreg.family_of(arch)
    shape = kinds[cls](**fields)
    table = {"lm": jreg.LM_SHAPES, "gnn": jreg.GNN_SHAPES,
             "recsys": jreg.RECSYS_SHAPES}[fam]
    table[sid] = shape
    archs = {"lm": jreg.LM_ARCHS, "gnn": jreg.GNN_ARCHS,
             "recsys": jreg.RECSYS_ARCHS}[fam]
    cfg, opt = archs[arch]
    small = jreg.reduced_config(arch)
    if fam == "lm":
        small = dataclasses.replace(small, dtype=jnp.float32)
    if groups is not None:
        small = dataclasses.replace(small, moe=dataclasses.replace(
            small.moe, n_groups=groups))
    archs[arch] = (small, opt)
    mesh = MESH if grid is None else Mesh(
        np.asarray(jax.devices()).reshape(grid[0]), tuple(grid[1]))
    cell = jreg.get_cell(arch, sid, mesh, grid is not None)
    out[case] = lowered(cell.fn, cell.args, cell.pspecs, mesh)
    archs[arch] = (cfg, opt)
print(json.dumps(out))
"""


# production cells lowered on the 16 x 16 mesh (256 faked devices)
FULL = ("gcn-cora|full_graph_sm", "gcn-cora|minibatch_lg",
        "gcn-cora|molecule", "gin-tu|full_graph_sm", "gin-tu|molecule",
        "meshgraphnet|full_graph_sm", "meshgraphnet|molecule",
        "dimenet|full_graph_sm", "dimenet|molecule", "din|train_batch",
        "din|serve_p99", "din|serve_bulk", "din|retrieval_cand")

_XLA_FULL = r"""
import json, os
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry as jreg
from repro.launch import hlo_analysis
from repro.runtime import compat

mesh = Mesh(np.asarray(jax.devices()).reshape(16, 16), ("data", "model"))
out = {}
for key in json.loads(os.environ["FULL"]):
    cell = jreg.get_cell(*key.split("|"), mesh, False)
    shard = jax.tree.map(
        lambda sp: NamedSharding(mesh, sp if isinstance(sp, P) else P()),
        cell.pspecs, is_leaf=lambda x: isinstance(x, P) or x is None)
    with compat.set_mesh(mesh):
        c = jax.jit(cell.fn, in_shardings=shard).lower(*cell.args).compile()
    out[key] = hlo_analysis.analyze(c.as_text())["collectives"]
print(json.dumps(out))
"""


def _jsonable(shape) -> list:
    fields = dataclasses.asdict(shape)
    return [type(shape).__name__, fields]


def _lower(code: str, devices: int, **env) -> dict:
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           **env}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def xla() -> dict:
    return _lower(_XLA, 8, SMALL=json.dumps(SMALL), CELLS=json.dumps(
        {c: [a, sid, *_jsonable(s), g, m]
         for c, (a, sid, s, g, m) in CELLS.items()}))


@pytest.fixture(scope="module")
def xla_full() -> dict:
    return _lower(_XLA_FULL, 256, FULL=json.dumps(FULL))


MESH = make_mesh((2, 4), ("data", "model"))


def _meta(shape, dtype="float32"):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _pass(fn, args, specs, mesh=MESH) -> dict:
    acct = analyze(fn, *args, record=True)
    got = sharding.partition(acct.program, specs, mesh)
    assert got["unmodeled"] == {}
    return got


# ---------------------------------------------------------------------------
# (a) the constraint
# ---------------------------------------------------------------------------

def test_constrain_is_an_identity_in_value_and_gradient():
    x = torch.randn(6, 4, dtype=torch.float64, requires_grad=True)
    y = constrain(x * 3, (("data", "model"), None))
    assert y.shape == x.shape and torch.equal(y, x * 3)
    (g,) = torch.autograd.grad((y * y).sum(), [x])
    assert torch.allclose(g, 18 * x)
    z = x.detach()
    v = constrain(z, ("data",))
    assert v.data_ptr() == z.data_ptr()         # a view: nothing copied
    assert constrain(z, None) is z


def test_constrain_gradient_carries_the_spec():
    """The backward holds the gradient to the same spec: the recorded
    program has the constraint twice, once each way."""
    x = _meta((8, 4))

    def step(x):
        x = x.detach().requires_grad_(True)
        y = constrain(x * 2, ("data",))
        return torch.autograd.grad(y.sum(), [x])

    acct = analyze(step, x, record=True)
    specs = [args[1] for op, ins, outs, args, kw in acct.program.ops
             if not isinstance(op, tuple)
             and str(op.overloadpacket) == "repro_torch.constrain"]
    assert specs == ["data", "data"]


def test_no_constraint_without_a_spec():
    """``act_spec=None`` (serving, training, every path the card times)
    emits no constraint: gemma3-1b's prefill dispatches the ops it did
    before the constraint existed."""
    cfg, _ = reg.get_arch("gemma3-1b")
    assert cfg.act_spec is None
    params = mc.abstract_params(tm.param_defs(cfg))
    tokens = _meta((2, 64), "int32")
    acct = analyze(lambda p, t: tm.prefill_step(p, t, cfg), params, tokens,
                   record=True)
    names = [str(op.overloadpacket) for op, *_ in acct.program.ops
             if not isinstance(op, tuple)]
    assert "repro_torch.constrain" not in names
    assert len(names) == 2837
    spec_cfg = dataclasses.replace(cfg, act_spec=(("data",), "model", None))
    acct = analyze(lambda p, t: tm.prefill_step(p, t, spec_cfg), params,
                   tokens, record=True)
    n = sum(str(op.overloadpacket) == "repro_torch.constrain"
            for op, *_ in acct.program.ops if not isinstance(op, tuple))
    assert n == 2 * cfg.n_layers + 1     # a layer's output and its FFN's
                                         # inner activations; the logits


# ---------------------------------------------------------------------------
# (b) small programs, exactly
# ---------------------------------------------------------------------------

def _scatter(x, w):
    return torch.zeros((16, 8), device=x.device).index_add(0, w, x)


@pytest.mark.parametrize("name", list(SMALL))
def test_small_program_equals_xla(name, xla):
    expr, target, inputs = SMALL[name]
    fn = eval("lambda x, w=None: constrain(" + expr + ", " + target + ")",
              {"constrain": constrain, "scatter": _scatter})
    args = [_meta(s, *d) for s, sp, *d in inputs]
    got = _pass(fn, args, [sp for s, sp, *d in inputs])
    assert got["collectives"] == xla[name]
    assert got["collectives"]                # each moves something


# ---------------------------------------------------------------------------
# (c) reduced cells, within 0.5-2x
# ---------------------------------------------------------------------------

def _reduced_cell(case, monkeypatch, one_device=False):
    """The case's reduced cell on its mesh (``one_device``: every axis of
    that mesh at size 1)."""
    arch, sid, shape, groups, grid = CELLS[case]
    dims, names = grid or (MESH.shape.values(), MESH.axis_names)
    mesh = make_mesh(tuple(1 if one_device else n for n in dims),
                     tuple(names))
    fam = reg.family_of(arch)
    table = {"lm": reg.LM_SHAPES, "gnn": reg.GNN_SHAPES,
             "recsys": reg.RECSYS_SHAPES}[fam]
    archs = {"lm": reg.LM_ARCHS, "gnn": reg.GNN_ARCHS,
             "recsys": reg.RECSYS_ARCHS}[fam]
    monkeypatch.setitem(table, sid, shape)
    cfg, opt = archs[arch]
    small = reg.reduced_config(arch)
    if fam == "lm":
        small = dataclasses.replace(small, dtype=torch.float32)
    if groups is not None:
        small = dataclasses.replace(small, moe=dataclasses.replace(
            small.moe, n_groups=groups))
    monkeypatch.setitem(archs, arch, (small, opt))
    return reg.get_cell(arch, sid, mesh, grid is not None), mesh


@pytest.mark.parametrize("case", list(CELLS))
def test_reduced_cell_within_band_of_xla(case, xla, monkeypatch):
    cell, mesh = _reduced_cell(case, monkeypatch)
    got = _pass(cell.fn, cell.args,
                sharding.flatten_specs(cell.args, cell.pspecs), mesh)
    want = xla[case]
    total = sum(want.values())
    ratio = got["collective_bytes"] / total
    print(f"{case}: {ratio:.4f} of XLA's bytes")      # shown under -s
    assert 0.5 <= ratio <= 2.0, (ratio, got["collectives"], want)
    missing = set(want) - set(got["collectives"])
    assert missing == MISSING.get(case, set()), (got["collectives"], want)
    assert sum(want[k] for k in missing) <= 0.01 * total


# ---------------------------------------------------------------------------
# (d) one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CELLS))
def test_one_device_moves_nothing(case, monkeypatch):
    cell, one = _reduced_cell(case, monkeypatch, one_device=True)
    got = _pass(cell.fn, cell.args,
                sharding.flatten_specs(cell.args, cell.pspecs), one)
    assert got["collective_bytes"] == 0 and got["collectives"] == {}


# ---------------------------------------------------------------------------
# (e) production cells, full size
# ---------------------------------------------------------------------------

class AsXlaCpu(sharding.Partitioner):
    """The pass, each reduce-scatter counted as what XLA's CPU backend
    runs in its place: an all-reduce of the whole sum (the scattered
    axes' shards times the scatter's output), then a slice."""

    def reshard(self, i, target):
        partial = self.get(i)[1]
        self._scatter = self.shards(
            a for a in partial if any(a in e for e in target))
        super().reshard(i, target)

    def count(self, kind, nbytes):
        if kind == "reduce-scatter":
            kind, nbytes = "all-reduce", nbytes * self._scatter
        super().count(kind, nbytes)


@pytest.mark.parametrize("key", FULL)
def test_production_cell_within_band_of_xla(key, xla_full):
    from repro_torch.launch.mesh import make_production_mesh
    arch, shape = key.split("|")
    mesh = make_production_mesh()
    cell = reg.get_cell(arch, shape, mesh)
    specs = sharding.flatten_specs(cell.args, cell.pspecs)
    program = analyze(cell.fn, *cell.args, record=True).program
    got = sharding.partition(program, specs, mesh)
    assert got["unmodeled"] == {}
    cpu = AsXlaCpu(program, mesh).run(specs)
    assert cpu["collective_bytes"] >= got["collective_bytes"]
    want = xla_full[key]
    ratio = cpu["collective_bytes"] / sum(want.values())
    print(f"{key}: {ratio:.4f} of XLA's bytes as XLA:CPU moves them, "
          f"{got['collective_bytes'] / sum(want.values()):.4f} as the "
          f"record counts them")                          # shown under -s
    assert 0.5 <= ratio <= 2.0, (ratio, cpu["collectives"], want)
    assert set(want) <= set(got["collectives"])
