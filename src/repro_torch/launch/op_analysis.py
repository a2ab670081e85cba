"""Op-by-op roofline accounting of one traced step: the port's counterpart
of ``repro/launch/hlo_analysis.py``.

The reference reads its roofline inputs from the optimized HLO text of a
lowered step.  Eager PyTorch has no such program: :class:`OpAnalysis` is a
``TorchDispatchMode`` that watches every aten op of a step as it runs
(on the ``meta`` device in the dry run, so nothing is allocated or
computed) and accounts

* **flops**, by dtype: matmul-class ops (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, the fused attention ops) by ``torch.utils.flop_counter``'s
  formulas, plus the work each hand-written kernel's shape-only route
  reports (:func:`repro_torch.kernels.policy.report_meta_work`; the
  attention routes count the unmasked (query, key) pairs, where the
  reference's XLA path computes every key chunk);
* **hbm bytes**: inputs and outputs of every op that is not a view or an
  allocation.  Eager PyTorch fuses nothing, so every op is top level, as
  every fusion and top-level op is in ``hlo_analysis.py``; a gather
  counts the rows it reads (its output's bytes) where the reference
  counts its whole source, and a kernel route counts its own inputs and
  outputs once;
* **peak live bytes**: storages alive at once, each counted once however
  many views share it, from the step's arguments (parameters, optimizer
  state, batch; :meth:`OpAnalysis.track_arguments`) through every output
  an op creates, freed when the storage dies (autograd's saved tensors
  keep theirs alive, as on the card);
* **a per-op breakdown** (calls, bytes, flops by op name) and the calls
  per kernel route (``launches``: what the card would launch);
* with ``record=True``, **the program** (:class:`Program`): every op as
  ``(op, input ids, output ids, arguments)``, a kernel route's call as
  one entry too, and each tensor's shape and element size, for the
  sharding pass (``launch/sharding.py``) to replay under a mesh.

No trip-count logic is needed: the Python layer loop shows every op, and
``torch.utils.checkpoint``'s recompute runs (and is counted) in the
backward, as the reference's rematerialised HLO counts it.  The
collective term, which the reference reads from its partitioned HLO, is
the sharding pass's: one traced program has no partitioner.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that move no data: allocations without a fill, a reshape of a fresh
# tensor (``_unsafe_view``, not marked a view), and bookkeeping
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.lift_fresh.default,
               aten._unsafe_view.default, aten._local_scalar_dense.default}
# gathers read the rows they return, not the whole source (an embedding
# table): their source counts as the output's bytes
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensors(args, kwargs):
    """The tensors among an op's arguments, one level into lists (``cat``,
    ``index_put_``'s indices)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, torch.Tensor):
                    yield x


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return (out,)
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return ()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Ref(int):
    """A tensor argument of a recorded op: its id in the program."""
    __slots__ = ()


@dataclasses.dataclass
class Program:
    """One traced step as the sharding pass reads it.  ``ops``: ``(op,
    input ids, output ids, args, kwargs)``, ``op`` an aten overload or
    ``("kernel", route)``, tensors in ``args`` / ``kwargs`` as
    :class:`Ref`; ``shapes``: id -> ``(shape, element size)``;
    ``arguments``: the step's argument ids, in the order of its argument
    tree; ``outputs``: the ids of what it returns."""
    ops: list = dataclasses.field(default_factory=list)
    shapes: dict = dataclasses.field(default_factory=dict)
    arguments: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)


def _leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


class OpAnalysis(TorchDispatchMode):
    """Accounts every op run while it is active (``with OpAnalysis() as
    a: step(*args)``); :meth:`summary` reports."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.program = Program() if record else None
        # a tensor's id by its view of memory (storage, offset, shape,
        # strides, dtype): a saved tensor unpacked by autograd is a new
        # tensor object over the same view, and keeps its id.  The views
        # of a storage are forgotten when it dies: a later storage at the
        # same address (a wrapped Python number, made outside the mode)
        # is a new tensor
        self._ids: dict[tuple, int] = {}
        self._views: dict[int, list] = defaultdict(list)
        self.flops: dict[str, float] = defaultdict(float)
        self.hbm_bytes = 0.0
        self.ops: dict[str, list] = {}        # name -> [calls, bytes, flops]
        self.kernels: dict[str, dict] = {}    # route -> launches, flops, bytes
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}       # storage -> bytes
        self._kinds: dict = {}                # op -> _kind(op)

    # -- live memory ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until it dies; its bytes if new."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return 0
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key).atexit = False
        return n

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)
        for view in self._views.pop(key, ()):
            self._ids.pop(view, None)

    def track_arguments(self, tree) -> None:
        """Count every tensor of ``tree`` (dicts, lists, tuples) as an
        argument of the step, live from the start."""
        for t in _leaves(tree):
            self.argument_bytes += self._track(t)
            if self.program is not None:
                self.program.arguments.append(self._id(t))

    # -- the program ---------------------------------------------------------
    @staticmethod
    def _view_key(t: torch.Tensor) -> tuple:
        return (t.untyped_storage()._cdata, t.storage_offset(), t.shape,
                t.stride(), t.dtype)

    def _id(self, t: torch.Tensor) -> int:
        """``t``'s id; a tensor not seen before gets a new one."""
        key = self._view_key(t)
        i = self._ids.get(key)
        if i is None:
            i = self._new_id(t, key)
        return i

    def _new_id(self, t: torch.Tensor, key: tuple | None = None) -> int:
        prog = self.program
        i = len(prog.shapes)
        prog.shapes[i] = (tuple(t.shape), t.element_size())
        key = key or self._view_key(t)
        self._ids[key] = i
        self._views[key[0]].append(key)
        return i

    def _ref(self, a, in_ids: list):
        """``a`` with its tensors as :class:`Ref` (their ids appended to
        ``in_ids``, in the order :func:`_tensors` yields them)."""
        if isinstance(a, torch.Tensor):
            r = Ref(self._id(a))
            in_ids.append(r)
            return r
        if isinstance(a, (list, tuple)) and any(
                isinstance(x, torch.Tensor) for x in a):
            out = []
            for x in a:
                if isinstance(x, torch.Tensor):
                    x = Ref(self._id(x))
                    in_ids.append(x)
                out.append(x)
            return out
        return a

    def _record(self, op, args, kwargs, outs) -> None:
        in_ids: list = []
        rargs = tuple(self._ref(a, in_ids) for a in args)
        rkw = {k: self._ref(v, in_ids) for k, v in kwargs.items()} \
            if kwargs else kwargs
        out_ids = tuple(self._new_id(t) for t in outs)
        self.program.ops.append((op, tuple(in_ids), out_ids, rargs, rkw))

    def mark_outputs(self, tree) -> None:
        """Note the step's outputs (``tree``'s tensors)."""
        if self.program is not None:
            self.program.outputs = [self._id(t) for t in _leaves(tree)]

    # -- work ----------------------------------------------------------------
    def _add(self, name: str, nbytes: float, flops: float,
             dtype: torch.dtype | None) -> None:
        row = self.ops.get(name)
        if row is None:
            row = self.ops[name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += nbytes
        row[2] += flops
        self.hbm_bytes += nbytes
        if flops:
            self.flops[dtype_name(dtype)] += flops

    def record_kernel(self, route: str, *, flops: float, nbytes: float,
                      dtype: torch.dtype, inputs=(), outputs=()) -> None:
        """One hand-written kernel's call, from its shape-only route
        (``inputs`` and ``outputs``: its tensors, for the program)."""
        k = self.kernels.setdefault(route, {"launches": 0, "flops": 0.0,
                                            "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self._add(route, nbytes, flops, dtype)
        if self.program is not None:
            self._record(("kernel", route), tuple(inputs), {}, outputs)

    def _kind(self, func) -> tuple:
        """``(name, moves data, a gather, flop formula or None)`` of an
        op."""
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = (
                str(func.overloadpacket),
                not (func.is_view or func in _NO_TRAFFIC), func in _GATHERS,
                flop_registry.get(func.overloadpacket))
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _outputs(out)
        for t in outs:
            self._track(t)
        if self.program is not None:
            self._record(func, args, kwargs, outs)
        name, moves, gather, count = self._kind(func)
        if not moves:
            return out
        ins = list(_tensors(args, kwargs))
        out_bytes = sum(_nbytes(t) for t in outs)
        nbytes = sum(_nbytes(t) for t in ins) + out_bytes
        if gather:
            nbytes += out_bytes - _nbytes(ins[0])
        flops, dtype = 0.0, None
        if count is not None:
            flops = float(count(*args, **kwargs, out_val=out))
            dtype = ins[0].dtype
        self._add(name, float(nbytes), flops, dtype)
        return out

    # -- report --------------------------------------------------------------
    def summary(self, top: int = 10) -> dict:
        """``flops`` by dtype, ``hbm_bytes``, ``peak_bytes`` (arguments
        included), ``argument_bytes``, the ``kernels`` by route, and the
        ``top`` ops by bytes and by flops."""
        def rows(col):
            ranked = sorted(self.ops.items(), key=lambda kv: -kv[1][col])
            return [{"op": name, "calls": c, "bytes": b, "flops": f}
                    for name, (c, b, f) in ranked[:top] if (b, f)[col - 1]]
        return {"flops": dict(self.flops),
                "flops_total": sum(self.flops.values()),
                "hbm_bytes": self.hbm_bytes,
                "peak_bytes": self.peak_bytes,
                "argument_bytes": self.argument_bytes,
                "ops": sum(r[0] for r in self.ops.values()),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "top_by_bytes": rows(1), "top_by_flops": rows(2)}


def analyze(fn, *args, record: bool = False) -> OpAnalysis:
    """Run ``fn(*args)`` under an :class:`OpAnalysis` with ``args``
    counted as arguments (``record``: and the program kept); the output
    is dropped inside the count (its bytes were live at the peak)."""
    mode = OpAnalysis(record)
    mode.track_arguments(args)
    with mode:
        out = fn(*args)
        mode.mark_outputs(out)
        del out
    return mode
