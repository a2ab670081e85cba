"""The port's cells (``repro_torch.configs.registry``) against the JAX
package's (``repro.configs.registry``).

* The same 40 (architecture, shape) cells in the same order.
* Each cell's parameter count, active parameters, model FLOPs, step kind
  and skip reason equal the reference's ``get_cell`` on a 1×1 mesh,
  exactly (the reference's own call, as ``tests/test_registry_cells.py``
  makes it).
* Each cell's spec trees (parameters, optimizer state, batch; a decode
  cell's caches and tokens) equal the reference's ``PartitionSpec``s on
  the 16×16 and 2×16×16 production meshes.  The reference is given a
  stand-in with only ``.shape``, all its ``_divides`` reads; a
  ``PartitionSpec`` writes a one-name tuple as the bare name, so both
  sides are compared in that form.
* Every argument is a ``meta`` tensor, and the argument and spec trees
  match leaf for leaf.
* ``models.common.param_pspecs`` and ``abstract_params`` equal the
  reference's for each architecture's parameter tree, under both meshes'
  rules.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import registry as jreg
from repro.models import common as jmc
from repro.models.gnn import gnn_param_defs as j_gnn_defs
from repro.models.recsys.din import din_param_defs as j_din_defs
from repro.models.transformer import model as jtm

from repro_torch.configs import registry as reg
from repro_torch.models import common as mc
from repro_torch.models.gnn import gnn_param_defs
from repro_torch.models.recsys.din import din_param_defs
from repro_torch.models.transformer import model as tm
from repro_torch.launch.mesh import make_mesh, make_production_mesh

CELLS = reg.list_cells()


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


class _StandIn:
    """The reference's mesh as its ``_divides`` sees it: ``.shape``."""

    def __init__(self, mesh):
        self.shape = mesh.shape


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _norm(tree):
    """A spec tree in one form: each spec a tuple of entries, one-name
    tuples written as the name."""
    if isinstance(tree, P):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_norm(v) for v in tree]
    return tree


def _norm_port(tree, args):
    """The port's spec tree in :func:`_norm`'s form, walked by its
    argument tree (a spec is a tuple where the argument is a tensor)."""
    if isinstance(args, torch.Tensor):
        return tuple(_entry(e) for e in tree)
    if isinstance(args, dict):
        return {k: _norm_port(tree[k], args[k]) for k in args}
    return [_norm_port(s, a) for s, a in zip(tree, args)]


def test_cells_are_the_reference_cells():
    assert CELLS == jreg.list_cells()
    assert len(CELLS) == 40 and len({a for a, _ in CELLS}) == 10
    assert reg.ARCH_IDS == jreg.ARCH_IDS


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_param_pspecs_and_abstract_params(arch, multi_pod):
    """``param_pspecs`` (the logical axes through the rules, undivided)
    and ``abstract_params`` against the reference's, leaf for leaf."""
    fam = reg.family_of(arch)
    defs_fn, j_defs_fn = {"lm": (tm.param_defs, jtm.param_defs),
                          "gnn": (gnn_param_defs, j_gnn_defs),
                          "recsys": (din_param_defs, j_din_defs)}[fam]
    defs = defs_fn(reg.get_arch(arch)[0])
    j_defs = j_defs_fn(jreg.get_arch(arch)[0])
    rules = reg.mesh_rules(None, multi_pod)
    assert rules == jreg.mesh_rules(None, multi_pod)
    got, want = mc.param_pspecs(defs, rules), jmc.param_pspecs(j_defs, rules)
    abstract, j_abstract = mc.abstract_params(defs), jmc.abstract_params(
        j_defs)

    def walk(g, w, a, ja):
        if isinstance(w, P):
            assert tuple(_entry(e) for e in g) == _norm(w)
            assert a.is_meta and tuple(a.shape) == ja.shape
            assert str(a.dtype).removeprefix("torch.") == str(ja.dtype)
            return 1
        assert set(g) == set(w)
        return sum(walk(g[k], w[k], a[k], ja[k]) for k in w)

    assert walk(got, want, abstract, j_abstract) > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_counts_equal_the_reference(arch, shape, jmesh):
    want = jreg.get_cell(arch, shape, jmesh, multi_pod=False)
    got = reg.get_cell(arch, shape, make_mesh((1, 1), ("data", "model")))
    assert got.n_params == want.n_params
    assert got.n_params_active == want.n_params_active
    assert got.flops_model == want.flops_model
    assert got.step_kind == want.step_kind
    assert got.skip_reason == want.skip_reason
    assert (got.fn is None) == (want.fn is None)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_equal_the_reference(arch, shape, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    want = jreg.get_cell(arch, shape, _StandIn(mesh), multi_pod)
    got = reg.get_cell(arch, shape, mesh, multi_pod)
    if want.skip_reason:
        assert got.pspecs is None and got.args is None
        return
    ref = _norm(want.pspecs)
    mine = _norm_port(got.pspecs, got.args)
    if got.step_kind == "decode":     # the reference's traced cache_len
        assert ref[3] == ()
        ref = ref[:3]
    assert mine == ref
    # parameters and optimizer state: every leaf, explicitly
    assert mine[0] == ref[0]
    if got.step_kind == "train":
        assert mine[1] == ref[1]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arguments_are_meta(arch, shape):
    cell = reg.get_cell(arch, shape, make_production_mesh())
    if cell.skip_reason:
        assert shape == "long_500k" and cell.args is None
        return

    def walk(args, specs):
        if isinstance(args, torch.Tensor):
            assert args.is_meta and isinstance(specs, tuple)
            assert len(specs) <= args.dim()
            return 1
        if isinstance(args, dict):
            assert set(args) == set(specs)
            return sum(walk(args[k], specs[k]) for k in args)
        assert len(args) == len(specs)
        return sum(walk(a, s) for a, s in zip(args, specs))

    assert walk(cell.args, cell.pspecs) > 0
