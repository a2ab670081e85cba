"""A sharding-propagation pass over a traced step: the collective term of
the dry run, the port's counterpart of what XLA's SPMD partitioner does
for the reference (``repro/launch/dryrun.py:80-101``, collectives read by
``hlo_analysis.py``).

``launch/op_analysis.py`` records the step once
(:class:`~repro_torch.launch.op_analysis.Program`).  :func:`partition`
replays that op list under one mesh, starting from the arguments' spec
trees (``configs/registry.py``'s ``pspecs``).  Every tensor gets a spec,
the mesh axes of each of its dimensions, and the axes over which it is
still a partial sum.  The rules follow GSPMD's:

* a fresh tensor (``zeros``, ``empty``, ``arange``, ``ones_like``, …)
  is free: it takes whatever spec its first reader gives it, at no cost,
  as XLA shards a broadcast constant where it is used; so are the
  dimensions ``expand`` broadcasts (every device makes its block of
  them), through views and copies, and a reshape that merges one into a
  sharded dimension keeps the sharding (torch's ``matmul`` merges a
  broadcast batch dimension that XLA's ``dot_general`` keeps apart);
* elementwise ops take the spec of the operand that is sharded over the
  most devices (the largest among those) and reshard the others to it
  (broadcast dimensions replicated); a product, a quotient by a whole
  divisor, a sum of partial sums, a cast or a view of a partial sum stays
  one;
* a product (``mm``, ``bmm``) places each mesh axis where it costs the
  least to keep: on a batch or free dimension, or on the contracted
  dimension of both operands, which leaves a partial sum; an operand that
  disagrees is resharded, an axis that cannot be kept is gathered from
  the operand where that moves fewer bytes;
* a reduction over a sharded dimension gives a partial sum (a sum, a
  mean) or reduces across it at once (a maximum; softmax's two and its
  gradient's one reductions);
* views carry a spec while the sharded dimension stays major (a reshape
  whose blocks stay contiguous), and gather it otherwise; a slice that
  cuts a sharded dimension at one end shifts the halo between
  neighbours (collective-permute), a slice inside it gathers it;
* gathers (``index_select``, ``index``, ``embedding``, ``gather``) from
  a sharded dimension, and ``index_add`` / ``scatter_add`` / ``index_put``
  (accumulating) from a sharded source dimension, give a partial sum;
  where the indices use the same mesh axis the operand is gathered;
* ``sort``, ``topk``, ``cumsum`` along a sharded dimension gather it;
* the attention kernels' shape-only route keeps batch, heads and queries
  where the queries have them and gathers keys sharded on the sequence;
* a partial sum is made whole where it is consumed or at a constraint:
  a reduce-scatter onto the dimensions the target shards over its axes
  (after the target's free slices), an all-reduce over the rest;
* a ``repro_torch::constrain`` reshards to its spec: slices are free,
  axes it drops are all-gathered, axes that move between dimensions go
  through an all-to-all, a dimension's axes in another order through a
  collective-permute;
* an axis that does not divide its dimension stays where a constraint
  puts it or an operand already holds it, as XLA pads the dimension to
  whole blocks (bytes count the padded block: deepseek-v3's 16 MoE groups
  on the 32-way batch axes of 2×16×16), and is dropped elsewhere.

Each collective is counted by its **output bytes per device**, under the
reference's five kind names (``hlo_analysis.py:38``).  The backward and
the optimizer come out of the same rules: a gradient left partial over
``data`` meets its parameter's spec at the update.  An op without a rule
gathers its operands and is listed in ``unmodeled``.  What differs from
XLA's partitioner is in ``ROADMAP.md`` §3.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict

import torch

from ..models.common import decode_spec
from .op_analysis import Program, Ref

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

def _entry(ax) -> tuple:
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def flatten_specs(args, specs) -> list:
    """The spec tuple of each tensor of ``args``, in the order
    :meth:`OpAnalysis.track_arguments` numbers them (``specs`` is the
    same tree, a spec tuple at each tensor)."""
    out: list = []

    def walk(a, s):
        if isinstance(a, torch.Tensor):
            out.append(tuple(s) if s is not None else ())
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
        elif isinstance(a, (list, tuple)):
            for x, y in zip(a, s):
                walk(x, y)
    walk(args, specs)
    return out


class Partitioner:
    """The pass over one :class:`Program` under one mesh (``mesh.shape``:
    axis name -> size)."""

    def __init__(self, program: Program, mesh):
        self.prog = program
        self.sizes: dict[str, int] = dict(mesh.shape)
        self.shapes = program.shapes
        self.state: dict[int, tuple] = {}   # id -> (spec, partial axes)
        self.free: set[int] = set()         # fresh: any spec at no cost
        self.made: set[tuple] = set()       # (id, spec) already resharded
        # id -> {dim: copies}: a dimension of n made of ``copies``
        # broadcast copies (major) of n / copies elements of data
        self.bcast: dict[int, dict] = {}
        self.bytes: dict[str, float] = defaultdict(float)
        self.by_op: dict[str, float] = defaultdict(float)
        self.unmodeled: Counter = Counter()
        self._op = ""
        self.hints: dict[int, tuple] = {}
        self.root: dict[int, int] = {}      # a partial copy -> its source
        # views that an in-place op writes into: a window of a sharded
        # dimension written on the shards that hold it moves nothing
        inplace: dict = {}
        self.written = set()
        # the batched products' operands: a reshape that merges their
        # batch dimensions may keep a strided layout (``strided``: id ->
        # the merged dimensions' sizes and axes), as the batch dimensions
        # of XLA's dot_general stay apart
        self.batch_operands: set[int] = set()
        self.strided: dict[int, list] = {}
        for op, ins, outs, args, kwargs in program.ops:
            if isinstance(op, tuple):
                continue
            if len(ins) >= 2 and op.__name__.startswith(("bmm", "baddbmm")):
                self.batch_operands.update(ins[-2:])
            if not args or not isinstance(args[0], Ref):
                continue
            w = inplace.get(id(op))
            if w is None:
                w = inplace[id(op)] = op._schema.name.endswith("_")
            if w:
                self.written.add(args[0])

    # -- specs ---------------------------------------------------------------
    def get(self, i: int) -> tuple:
        st = self.state.get(i)
        if st is None:
            st = (((),) * len(self.shapes[i][0]), frozenset())
        return st

    def shards(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def local(self, i: int, spec) -> float:
        """Bytes of tensor ``i`` on one device under ``spec`` (a broadcast
        dimension counts once: its copies are not data)."""
        shape, isz = self.shapes[i]
        copies = self.bcast.get(i, {})
        n = float(isz)
        for d, (size, axes) in enumerate(zip(shape, spec)):
            size //= copies.get(d, 1)
            n *= -(-size // self.shards(axes)) if axes else size
        return n

    def normalize(self, shape, spec, uneven=()) -> tuple:
        """``spec`` with the axes that an earlier dimension already uses,
        or that the mesh lacks (or has at size 1), dropped, and those that
        do not divide their dimension unless ``uneven`` (a spec) has them
        there: XLA pads such a dimension to a whole number of blocks
        (:meth:`local` counts the padded block), where a constraint asks
        for it or an operand already holds it."""
        used, out = set(), []
        for d, (size, axes) in enumerate(zip(shape, spec)):
            keep = []
            n = 1
            pad = uneven[d] if d < len(uneven) else ()
            for a in axes:
                if a in used or self.sizes.get(a, 1) == 1:
                    continue
                if size % (n * self.sizes[a]) == 0 or a in pad:
                    keep.append(a)
                    used.add(a)
                    n *= self.sizes[a]
            out.append(tuple(keep))
        return tuple(out)

    def count(self, kind: str, nbytes: float) -> None:
        self.bytes[kind] += nbytes
        self.by_op[f"{self._op} {kind}"] += nbytes

    # -- resharding ----------------------------------------------------------
    def reshard(self, i: int, target: tuple) -> None:
        """Count what bringing tensor ``i`` (and its partial sum) to
        ``target`` moves; ``i``'s own state changes only where its partial
        sum is made whole."""
        spec, partial = self.get(i)
        if (spec == target and not partial) or i in self.free:
            return
        copies = self.bcast.get(i)
        if copies:      # a broadcast copy's blocks are made locally
            spec, target = _unbroadcast(self, i, spec, target, copies)
            if spec == target and not partial:
                return
        # one value resharded the same way twice is one collective (XLA
        # shares the first)
        if (i, target) in self.made:
            if partial:
                self.state[i] = (target, frozenset())
            return
        self.made.add((i, target))
        cur = [list(e) for e in spec]
        where = {a: d for d, e in enumerate(cur) for a in e}
        dest = {a: d for d, e in enumerate(target) for a in e}
        # free slices first: axes the target adds that nothing holds
        for a, d in dest.items():
            if a not in where and a not in partial:
                cur[d].append(a)
                where[a] = d
        if partial:
            # in the target's order (a frozenset's order varies with the
            # process's string hashes)
            scatter = [a for e in target for a in e if a in partial]
            for a in scatter:
                cur[dest[a]].append(a)
                where[a] = dest[a]
            if scatter:
                self.count("reduce-scatter", self.local(i, cur))
            if len(scatter) < len(partial):
                self.count("all-reduce", self.local(i, cur))
            # the sum is made once: later readers find it whole, and so
            # do readers of the copy it was made from
            whole = (tuple(tuple(e) for e in cur), frozenset())
            self.state[i] = whole
            r = self.root.get(i)
            if r is not None and self.shapes[r][0] == self.shapes[i][0] \
                    and self.state.get(r, whole)[1]:
                self.state[r] = whole
        gone = [a for a, d in where.items() if a not in dest]
        if gone:
            # a dimension cut finer than it was, over other axes: each
            # device's new block lies inside one old block, which another
            # device sends it (collective-permute); else all-gather
            fine = {where[a] for a in gone if target[where[a]] and
                    self.shards(target[where[a]]) %
                    self.shards(spec[where[a]]) == 0}
            gathered = False
            for a in gone:
                d = where.pop(a)
                cur[d].remove(a)
                gathered |= d not in fine
            if gathered:
                self.count("all-gather", self.local(i, cur))
            if fine:
                self.count("collective-permute", self.local(i, cur))
        moved = [a for a, d in where.items() if dest[a] != d]
        if moved:
            for a in moved:
                cur[where[a]].remove(a)
                cur[dest[a]].append(a)
            self.count("all-to-all", self.local(i, cur))
        if any(tuple(c) != t for c, t in zip(cur, target)):
            self.count("collective-permute", self.local(i, target))

    def whole(self, i: int) -> tuple:
        """Tensor ``i``'s spec with its partial sum made whole (an
        all-reduce where it is partial)."""
        spec, partial = self.get(i)
        if partial:
            hint = self.hints.get(i)
            self.reshard(i, hint if hint is not None and
                         len(hint) == len(spec) else spec)
            return self.get(i)[0]
        return spec

    def gathered(self, i: int, dims) -> tuple:
        """Tensor ``i`` made whole with dimensions ``dims`` gathered."""
        spec = list(self.whole(i))
        if any(spec[d] for d in dims):
            for d in dims:
                spec[d] = ()
            spec = tuple(spec)
            self.reshard(i, spec)
        return tuple(spec)

    def set(self, i: int, spec, partial=frozenset(), free=False,
            bcast=None) -> None:
        self.state[i] = (tuple(spec), frozenset(partial))
        if free:
            self.free.add(i)
        else:
            self.free.discard(i)
        if bcast:
            self.bcast[i] = {d: c for d, c in bcast.items() if c > 1}
        else:
            self.bcast.pop(i, None)

    def replicate(self, name: str, ins) -> None:
        """The fallback: every operand gathered and made whole (the
        outputs, given no state, are replicated); ``name`` noted as
        unmodeled."""
        self.unmodeled[name] += 1
        for i in ins:
            self.reshard(i, ((),) * len(self.shapes[i][0]))

    # -- the replay ----------------------------------------------------------
    def run(self, arg_specs: list, top_ops: int = 8) -> dict:
        prog = self.prog
        for i, spec in zip(prog.arguments, arg_specs):
            shape = self.shapes[i][0]
            spec = tuple(_entry(e) for e in spec)
            spec = spec + ((),) * (len(shape) - len(spec))
            self.set(i, self.normalize(shape, spec))
        self.hints = _hints(self, {i: self.state[i][0]
                                   for i in prog.arguments})
        for op, ins, outs, args, kwargs in prog.ops:
            if isinstance(op, tuple):
                self._op = op[1]
                _kernel(self, ins, outs)
                continue
            self._op = op.__name__
            rule = _rule(op)
            if rule is None:
                self.replicate(str(op.overloadpacket), ins)
            else:
                rule(self, op, ins, outs, args, kwargs)
        self._op = "output"
        for i in prog.outputs:          # what the step returns is whole
            self.whole(i)
        total = sum(self.bytes.values())
        top = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:top_ops]
        return {"collective_bytes": total,
                "collectives": {k: self.bytes[k] for k in KINDS
                                if self.bytes.get(k)},
                "top_collectives": [{"op": k, "bytes": v} for k, v in top],
                "unmodeled": dict(self.unmodeled)}


_HINT_THROUGH = {"aten.view", "aten._unsafe_view", "aten.reshape",
                 "aten._to_copy", "aten.clone", "aten.alias", "aten.detach",
                 "aten.add", "aten.sub", "aten.mul", "aten.div", "aten.neg"}


_SEED = {"aten.add", "aten.sub", "aten.mul", "aten.div", "aten.where",
         "aten.addcmul", "aten.lerp", "aten.maximum", "aten.minimum"}


def _hints(p: Partitioner, arguments: dict[int, tuple]) -> dict[int, tuple]:
    """The spec a tensor's readers will ask of it, carried back through
    views and elementwise ops to where it is made: GSPMD propagates
    shardings both ways.  Seeds: a constraint's spec, and the spec of an
    argument (followed forward through casts, copies and products by
    scalars) where an elementwise op meets it with another tensor of its
    shape (a gradient meeting its optimizer state).  A product whose
    result is constrained lays its axes out for the constraint; a partial
    sum is made whole onto its hint (a gradient, sharded like its
    parameter)."""
    names: dict = {}

    def name_of(op):
        n = names.get(id(op))
        if n is None:
            n = names[id(op)] = str(op.overloadpacket)
        return n

    follows = dict(arguments)
    for op, ins, outs, args, kwargs in p.prog.ops:
        if isinstance(op, tuple) or not ins or not outs or \
                name_of(op) not in _HINT_THROUGH:
            continue
        held = [i for i in ins if p.shapes[i][0]]
        if len(held) == 1 and held[0] in follows and \
                p.shapes[outs[0]][0] == p.shapes[held[0]][0]:
            follows[outs[0]] = follows[held[0]]
    hints: dict[int, tuple] = {}
    for op, ins, outs, args, kwargs in reversed(p.prog.ops):
        if isinstance(op, tuple) or not ins:
            continue
        name = name_of(op)
        if name == "repro_torch.constrain":
            shape = p.shapes[ins[0]][0]
            spec = decode_spec(args[1], len(shape))
            hints[ins[0]] = p.normalize(shape, spec, uneven=spec)
            continue
        if name in _SEED and outs:
            oshape = p.shapes[outs[0]][0]
            seed = next((follows[i] for i in ins if i in follows and
                         p.shapes[i][0] == oshape), None)
            if seed is not None:
                for i in ins:
                    if i not in follows and p.shapes[i][0] == oshape:
                        hints.setdefault(i, seed)
        hint = hints.get(outs[0]) if outs else None
        if hint is None or name not in _HINT_THROUGH:
            continue
        oshape = p.shapes[outs[0]][0]
        for i in ins:
            ishape = p.shapes[i][0]
            if ishape == oshape:
                hints.setdefault(i, hint)
            elif name in ("aten.view", "aten._unsafe_view", "aten.reshape"):
                got = _reshape_spec(p, oshape, hint, ishape)
                if got is not None:
                    hints.setdefault(i, got[1])
    return hints


def _unbroadcast(p: Partitioner, i: int, spec, target, copies) -> tuple:
    """``spec`` and ``target`` without what indexes broadcast copies: a
    whole broadcast dimension's axes, and the leading axes of the target
    on a dimension of ``c`` copies whose sizes multiply to a divisor of
    ``c`` (they select copies, which every device makes)."""
    shape = p.shapes[i][0]
    spec, target = list(spec), list(target)
    for d, c in copies.items():
        if c >= shape[d]:
            spec[d], target[d] = (), ()
            continue
        k, n = 0, 1
        while k < len(target[d]) and \
                c % (n * p.sizes[target[d][k]]) == 0:
            n *= p.sizes[target[d][k]]
            k += 1
        target[d] = tuple(target[d][k:])
    return tuple(spec), tuple(target)


def partition(program: Program, arg_specs: list, mesh) -> dict:
    """``collective_bytes`` (per device), ``collectives`` by kind, the
    ``top_collectives`` (op and kind) and the ``unmodeled`` ops (name ->
    calls) of ``program`` under ``mesh``, its arguments laid out by
    ``arg_specs`` (:func:`flatten_specs`)."""
    return Partitioner(program, mesh).run(arg_specs)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _dim(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


def _elementwise(p: Partitioner, op, ins, outs, args, kwargs) -> None:
    """Broadcasting n-ary ops: the operand sharded over the most devices
    (then the largest) leads; an in-place op's target leads unless it is
    fresh, when it takes the leader's spec."""
    if not outs:
        return
    oshape = p.shapes[outs[0]][0]
    held = [i for i in ins if i not in p.free]
    if not held:
        for o in outs:
            p.set(o, ((),) * len(p.shapes[o][0]), free=True)
        return
    inplace = op._schema.name.endswith("_")

    def rank(i):
        spec = p.get(i)[0]
        return (p.shapes[i][0] == oshape, p.shards(a for e in spec for a in e),
                math.prod(p.shapes[i][0]))
    lead = max(held, key=rank)
    if inplace and ins[0] not in p.free:
        lead = ins[0]
    spec, partial = p.get(lead)
    if len(spec) != len(oshape) or p.shapes[lead][0] != oshape:
        lshape = p.shapes[lead][0]
        off = len(oshape) - len(lshape)
        spec = ((),) * off + tuple(spec[d] if lshape[d] == oshape[off + d]
                                   else () for d in range(len(lshape)))
        partial = frozenset()
        p.whole(lead)
    partial = _keeps_partial(p, op.overloadpacket, ins, lead, partial, args)
    if not partial and p.get(lead)[1]:
        spec = p.whole(lead)
    nd = len(oshape)
    for i in ins:
        if i == lead:
            continue
        ishape = p.shapes[i][0]
        off = nd - len(ishape)
        target = tuple(spec[off + d] if ishape[d] == oshape[off + d] else ()
                       for d in range(len(ishape)))
        if partial and p.get(i)[1] == partial and p.get(i)[0] == target:
            continue
        p.reshard(i, target)
    for o in outs:
        p.set(o, spec if p.shapes[o][0] == oshape else
              ((),) * len(p.shapes[o][0]), partial)


_LINEAR_UNARY = {"neg", "_to_copy", "clone", "copy", "alias", "detach",
                 "contiguous", "lift_fresh", "view_as_real"}


def _keeps_partial(p, name, ins, lead, partial, args) -> frozenset:
    """The partial axes the result of an elementwise op still sums over:
    linear in the partial operand, the others whole."""
    if not partial:
        return frozenset()
    name = str(name).removeprefix("aten.").rstrip("_")
    # a fresh operand (zeros) adds nothing to the sum
    others = [i for i in ins if i != lead and i not in p.free]
    if name in _LINEAR_UNARY and not others:
        return partial
    if name in ("mul", "div"):
        if name == "div" and args and isinstance(args[0], Ref) and \
                args[0] != lead:
            return frozenset()
        if all(not p.get(i)[1] for i in others):
            return partial
        return frozenset()
    if name in ("add", "sub") and all(p.get(i)[1] == partial
                                      for i in others):
        return partial
    return frozenset()


def _factory(p, op, ins, outs, args, kwargs) -> None:
    """Fresh tensors (``zeros``, ``empty``, ``arange``, ``ones_like``,
    ``new_zeros``, …): free."""
    for o in outs:
        p.set(o, ((),) * len(p.shapes[o][0]), free=True)


def _same(p, op, ins, outs, args, kwargs) -> None:
    """Aliases and copies of one tensor: its spec and partial sum."""
    spec, partial = p.get(ins[0])
    hint = p.hints.get(ins[0])
    for o in outs:
        p.set(o, spec, partial, free=ins[0] in p.free,
              bcast=p.bcast.get(ins[0]))
        if partial:
            p.root[o] = p.root.get(ins[0], ins[0])
        if hint is not None:
            p.hints.setdefault(o, hint)
        if ins[0] in p.strided:
            p.strided[o] = p.strided[ins[0]]


def _copy_into(p, op, ins, outs, args, kwargs) -> None:
    """``copy_(self, src)``: ``src`` brought to ``self``'s spec (a fresh
    ``self`` takes ``src``'s)."""
    if ins[0] in p.free and len(ins) > 1 and \
            p.shapes[ins[1]][0] == p.shapes[ins[0]][0]:
        spec = p.whole(ins[1])
        free = ins[1] in p.free
        for o in outs:
            p.set(o, spec, free=free)
        return
    spec = p.whole(ins[0])
    if len(ins) > 1:
        sshape = p.shapes[ins[1]][0]
        off = len(spec) - len(sshape)
        p.reshard(ins[1], tuple(spec[off + d] if sshape[d] ==
                                p.shapes[ins[0]][0][off + d] else ()
                                for d in range(len(sshape))))
    for o in outs:
        p.set(o, spec)


def _fill(p, op, ins, outs, args, kwargs) -> None:
    spec = p.get(ins[0])[0]
    for i in ins[1:]:
        p.whole(i)
    for o in outs:
        p.set(o, spec, free=ins[0] in p.free)


# -- views ---------------------------------------------------------------------

def _groups(a, b):
    """Pairs of dimension groups of ``a`` and ``b`` with equal products."""
    res, i, j = [], 0, 0
    while i < len(a) or j < len(b):
        ia, jb, pa, pb = [], [], 1, 1
        if i < len(a):
            ia.append(i)
            pa *= a[i]
            i += 1
        if j < len(b):
            jb.append(j)
            pb *= b[j]
            j += 1
        while pa != pb:
            if pa < pb and i < len(a):
                ia.append(i)
                pa *= a[i]
                i += 1
            elif j < len(b):
                jb.append(j)
                pb *= b[j]
                j += 1
            else:
                return None
        res.append((ia, jb))
    return res


def _fresh_view(p: Partitioner, ins, outs) -> bool:
    """A view of a fresh tensor is fresh."""
    if ins and ins[0] in p.free:
        for o in outs:
            p.set(o, ((),) * len(p.shapes[o][0]), free=True)
        return True
    return False


def _reshape_spec(p: Partitioner, ishape, spec, oshape, copies=None):
    """``(input spec kept, output spec)`` of a reshape: in each group of
    dimensions with equal products, a device's block stays contiguous
    while every dimension after a partly held one is whole; the kept
    axes are laid on the output dimensions major first, and an axis that
    does not divide what is left there is dropped with the axes after it
    (``None`` when the shapes do not group).  Whole broadcast dimensions
    (``copies``: dim -> copies) hold no data of their own and break no
    block; a group's copies go to its major output dimensions (third
    item, dim -> copies).  An axis that does not divide what is left of
    its dimension but divides a later one moves there (fourth item: an
    all-to-all is owed)."""
    copies = copies or {}
    if not copies and not any(spec):
        return spec, ((),) * len(oshape), {}, False
    groups = _groups(ishape, oshape)
    if groups is None:
        return None
    keep = [list(e) for e in spec]
    ospec = [[] for _ in oshape]
    ocopies = {}
    moved = False
    for ia, jb in groups:
        axes, solid = [], True
        c = math.prod(copies.get(d, 1) for d in ia)
        for j in jb:
            if c > 1 and c % oshape[j] == 0:
                ocopies[j] = oshape[j]
                c //= oshape[j]
            elif c > 1:
                ocopies[j] = c
                c = 1
        if len(ia) == len(jb) == 1 and ia[0] not in copies:
            ospec[jb[0]] = list(keep[ia[0]])     # the dimension as it was
            continue
        for d in ia:
            if copies.get(d, 1) >= ishape[d] > 1:
                keep[d] = []
                continue
            if not solid:
                keep[d] = []
                continue
            axes += keep[d]
            if ishape[d] // p.shards(keep[d]) > 1:
                solid = False
        k = 0
        rem = oshape[jb[0]] if jb else 1
        for n, a in enumerate(axes):
            s = p.sizes[a]
            while rem == 1 and k + 1 < len(jb):
                k += 1
                rem = oshape[jb[k]]
            if k < len(jb) and rem % s == 0:
                ospec[jb[k]].append(a)
                rem //= s
                continue
            # the block layout breaks here: the axis moves to a later
            # dimension that it divides (an all-to-all), or it and the
            # later axes are gathered
            later = next((j for j in range(k + 1, len(jb))
                          if oshape[jb[j]] % s == 0), None)
            if later is not None:
                moved = True
                k, rem = later, oshape[jb[later]] // s
                ospec[jb[k]].append(a)
                continue
            for b in axes[n:]:
                for d in ia:
                    if b in keep[d]:
                        keep[d].remove(b)
            break
    return (tuple(tuple(e) for e in keep), tuple(tuple(e) for e in ospec),
            ocopies, moved)


def _reshape(p, op, ins, outs, args, kwargs) -> None:
    if _fresh_view(p, ins, outs):
        return
    src, out = ins[0], outs[0]
    spec, partial = p.get(src)
    if _strided(p, src, out, spec, partial):
        return
    got = _reshape_spec(p, p.shapes[src][0], spec, p.shapes[out][0],
                        p.bcast.get(src))
    if got is None:
        p.replicate(str(op.overloadpacket), ins)
        p.set(out, ((),) * len(p.shapes[out][0]))
        return
    keep, ospec, obcast, moved = got
    if keep != spec:
        p.reshard(src, keep)
        partial = frozenset()
    if moved:
        p.whole(src)
        p.count("all-to-all", p.local(src, keep))
        partial = frozenset()
    p.set(out, ospec, partial, bcast=obcast)


def _strided(p: Partitioner, src: int, out: int, spec, partial) -> bool:
    """A batched product's operand whose leading dimensions merge into
    its batch dimension keeps their axes, in a strided layout; the
    product's result split back into those dimensions gets them back.
    True where this applies."""
    ishape, oshape = p.shapes[src][0], p.shapes[out][0]
    rec = p.strided.get(src)
    if rec is not None:                 # split back
        m = len(rec)
        if tuple(oshape[:m]) == tuple(n for n, _ in rec) and \
                tuple(oshape[m:]) == tuple(ishape[1:]) and \
                spec[0] == tuple(a for _, e in rec for a in e):
            p.set(out, tuple(e for _, e in rec) + tuple(spec[1:]), partial)
            return True
        return False
    if out not in p.batch_operands:
        return False
    m = len(ishape) - len(oshape) + 1
    if m < 2 or tuple(oshape[1:]) != tuple(ishape[m:]) or \
            sum(1 for e in spec[:m] if e) < 2:
        return False
    copies = p.bcast.get(src, {})
    rec = [(ishape[d], () if copies.get(d, 1) >= ishape[d] else spec[d])
           for d in range(m)]
    p.strided[out] = rec
    c = math.prod(copies.get(d, 1) for d in range(m))
    p.set(out, (tuple(a for _, e in rec for a in e),) + tuple(spec[m:]),
          partial, bcast={0: c} if c > 1 else None)
    return True


def _permute(p, op, ins, outs, args, kwargs) -> None:
    if _fresh_view(p, ins, outs):
        return
    spec, partial = p.get(ins[0])
    nd = len(spec)
    name = str(op.overloadpacket)
    if name == "aten.t":
        order = list(range(nd))[::-1]
    elif name == "aten.permute":
        order = [_dim(d, nd) for d in args[1]]
    else:
        order = list(range(nd))
        a, b = _dim(args[1], nd), _dim(args[2], nd)
        order[a], order[b] = order[b], order[a]
    copies = p.bcast.get(ins[0], {})
    p.set(outs[0], tuple(spec[d] for d in order), partial,
          bcast={k: copies[d] for k, d in enumerate(order) if d in copies})
    rec = p.strided.get(ins[0])
    if rec is not None and order[0] == 0:   # the merged batch stays first
        p.strided[outs[0]] = rec


def _expand(p, op, ins, outs, args, kwargs) -> None:
    if _fresh_view(p, ins, outs):
        return
    spec, partial = p.get(ins[0])
    ishape, oshape = p.shapes[ins[0]][0], p.shapes[outs[0]][0]
    off = len(oshape) - len(ishape)
    out = [()] * off + [spec[d] if ishape[d] == oshape[off + d] else ()
                        for d in range(len(ishape))]
    copies = p.bcast.get(ins[0], {})
    bcast = {}
    for d in range(len(oshape)):
        if d < off or ishape[d - off] != oshape[d]:
            bcast[d] = oshape[d]
        elif (d - off) in copies:
            bcast[d] = copies[d - off]
    p.set(outs[0], out, partial, bcast=bcast)


def _unsqueeze(p, op, ins, outs, args, kwargs) -> None:
    if _fresh_view(p, ins, outs):
        return
    spec, partial = p.get(ins[0])
    d = _dim(args[1], len(spec) + 1)
    copies = p.bcast.get(ins[0], {})
    p.set(outs[0], spec[:d] + ((),) + spec[d:], partial,
          bcast={k + (k >= d): c for k, c in copies.items()})


def _squeeze(p, op, ins, outs, args, kwargs) -> None:
    if _fresh_view(p, ins, outs):
        return
    spec, partial = p.get(ins[0])
    ishape = p.shapes[ins[0]][0]
    if len(args) > 1:
        dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        dims = {_dim(d, len(ishape)) for d in dims}
    else:
        dims = set(range(len(ishape)))
    p.set(outs[0], tuple(s for d, s in enumerate(spec)
                         if not (d in dims and ishape[d] == 1)), partial)


def _cut(p: Partitioner, i: int, d: int, start: int, stop: int,
         out: int) -> tuple:
    """Tensor ``i`` cut to ``[start, stop)`` along ``d`` as view ``out``:
    the view's spec.  On a sharded dimension the window stays tiled where
    it is at least a block a device long: a cut of less than a block at
    one end shifts the halo to the neighbours, any other window takes each
    device's new block from the one or two that hold it (both a
    collective-permute); a shorter window is gathered (an all-gather of
    the window); a window that is only written into moves nothing (the
    shards that hold it write it)."""
    spec, partial = p.get(i)
    size = p.shapes[i][0][d]
    if not spec[d] or (start <= 0 and stop >= size):
        return spec
    n = p.shards(spec[d])
    length = stop - start
    window = spec[:d] + ((),) + spec[d + 1:]
    if out in p.written:
        return window
    block = -(-size // n)
    if (start <= 0 or stop >= size) and size - length < block:
        halo = p.local(i, spec) / block * (size - length)
        p.count("collective-permute", halo)
        return spec
    if length >= n:
        p.whole(i)
        p.count("collective-permute", p.local(out, spec))
        return spec
    p.whole(i)
    p.count("all-gather", p.local(out, window))
    return window


def _slice(p, op, ins, outs, args, kwargs) -> None:
    if _fresh_view(p, ins, outs):
        return
    nd = len(p.shapes[ins[0]][0])
    d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
    size = p.shapes[ins[0]][0][d]
    start = args[2] if len(args) > 2 and args[2] is not None else 0
    stop = args[3] if len(args) > 3 and args[3] is not None else size
    start = max(0, _dim(start, size) if start < 0 else start)
    stop = min(size, _dim(stop, size) if stop < 0 else stop)
    spec = _cut(p, ins[0], d, start, stop, outs[0])
    partial = p.get(ins[0])[1] if spec == p.get(ins[0])[0] else frozenset()
    p.set(outs[0], spec, partial)


def _split(p, op, ins, outs, args, kwargs) -> None:
    if _fresh_view(p, ins, outs):
        return
    nd = len(p.shapes[ins[0]][0])
    d = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0), nd)
    start = 0
    for o in outs:
        n = p.shapes[o][0][d]
        spec = _cut(p, ins[0], d, start, start + n, o)
        partial = p.get(ins[0])[1] if spec == p.get(ins[0])[0] else \
            frozenset()
        p.set(o, spec, partial)
        start += n


def _select(p, op, ins, outs, args, kwargs) -> None:
    """One index of a dimension: where that dimension is sharded the row
    lives on one shard and is broadcast (an all-reduce of the masked
    row)."""
    if _fresh_view(p, ins, outs):
        return
    spec, partial = p.get(ins[0])
    nd = len(spec)
    name = str(op.overloadpacket)
    d = 0 if name == "aten.unbind" else _dim(args[1], nd)
    if name == "aten.unbind" and len(args) > 1:
        d = _dim(args[1], nd)
    out = spec[:d] + spec[d + 1:]
    if spec[d]:
        for o in outs:
            p.count("all-reduce", p.local(o, out))
        partial = frozenset()
    for o in outs:
        p.set(o, out, partial)


def _select_backward(p, op, ins, outs, args, kwargs) -> None:
    """The gradient of ``select`` / ``slice``: zeros of the input's shape
    around the gradient; its spec with the selected dimension's
    inserted (``select``), or kept (a slice, shifted back across a
    sharded dimension: collective-permute)."""
    if _fresh_view(p, ins, outs):
        return
    spec, partial = p.get(ins[0])
    oshape = p.shapes[outs[0]][0]
    d = _dim(args[2], len(oshape))
    if str(op.overloadpacket) == "aten.select_backward":
        p.set(outs[0], spec[:d] + ((),) + spec[d:], partial)
        return
    if spec[d]:
        gshape = p.shapes[ins[0]][0]
        local = p.local(ins[0], spec)
        n = -(-gshape[d] // p.shards(spec[d]))
        p.count("collective-permute", local / n * (oshape[d] - gshape[d]))
    p.set(outs[0], spec, partial)


def _stack(p, op, ins, outs, args, kwargs) -> None:
    tens = [t for t in args[0] if isinstance(t, Ref)]
    nd = len(p.shapes[outs[0]][0])
    d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
    held = [t for t in tens if t not in p.free] or tens
    lead = max(held, key=lambda t: p.shards(a for e in p.get(t)[0]
                                            for a in e))
    spec = p.whole(lead)
    for t in tens:
        p.reshard(t, spec)
    p.set(outs[0], spec[:d] + ((),) + spec[d:])


def _constrain(p, op, ins, outs, args, kwargs) -> None:
    shape = p.shapes[ins[0]][0]
    spec = decode_spec(args[1], len(shape))
    target = p.normalize(shape, spec, uneven=spec)
    p.reshard(ins[0], target)
    p.set(outs[0], target)


# -- products ------------------------------------------------------------------

def _dot(p: Partitioner, lhs: int, rhs: int, llab: str, rlab: str,
         olab: str, out: int | None = None) -> tuple:
    """The product of ``lhs`` and ``rhs`` with dimension labels (a label
    in both and not in ``olab`` is contracted): each mesh axis kept where
    it moves the fewest bytes.  Returns ``(out spec, partial axes)``."""
    L, R = list(p.whole(lhs)), list(p.whole(rhs))
    pos_l = {a: llab[d] for d, e in enumerate(L) for a in e}
    pos_r = {a: rlab[d] for d, e in enumerate(R) for a in e}

    def drop(spec, a):
        return [tuple(x for x in e if x != a) for e in spec]

    def gather_cost(i, spec, a):
        return p.local(i, drop(spec, a))

    # the output on one device under the operands' free and batch axes:
    # what an all-reduce of a partial sum would move
    oshape = [p.shapes[lhs][0][llab.index(c)] if c in llab else
              p.shapes[rhs][0][rlab.index(c)] for c in olab]
    held = {a for spec, labs in ((L, llab), (R, rlab))
            for d, e in enumerate(spec) if labs[d] in olab for a in e}
    out_local = p.shapes[lhs][1] * math.prod(oshape) / p.shards(held)

    hint = p.hints.get(out) if out is not None else None
    hinted = {} if hint is None else {a: olab[d] for d, e in enumerate(hint)
                                      for a in e}

    def later(a, lab):
        """What the result's constraint will move for axis ``a`` placed
        on ``lab`` (``None``: nowhere)."""
        want = hinted.get(a)
        if lab is None or lab == want:
            return 0.0
        if lab not in olab:     # a partial sum: scattered or reduced
            return out_local / p.sizes[a] if want else out_local
        return out_local if hint is not None else 0.0

    keep_l, keep_r = [list(e) for e in L], [list(e) for e in R]
    partial = set()
    for a in sorted(set(pos_l) | set(pos_r)):
        pl, pr = pos_l.get(a), pos_r.get(a)
        options = [((gather_cost(lhs, L, a) if pl else 0.0) +
                    (gather_cost(rhs, R, a) if pr else 0.0), None)]
        for lab, other, pos_o, spec_o, i_o, labs_o in (
                (pl, "r", pr, R, rhs, rlab), (pr, "l", pl, L, lhs, llab)):
            if lab is None:
                continue
            cost = 0.0
            if lab in labs_o:       # batch or contracted: the other matches
                if pos_o is not None and pos_o != lab:
                    cost += gather_cost(i_o, spec_o, a)
            elif pos_o is not None:  # a free dim: the other must not hold a
                cost += gather_cost(i_o, spec_o, a)
            options.append((cost + later(a, lab), lab))
        cost, lab = min(options, key=lambda o: o[0])
        for labs, keep in ((llab, keep_l), (rlab, keep_r)):
            for d, e in enumerate(keep):
                if a in e and labs[d] != lab:
                    e.remove(a)
            if lab is not None and lab in labs:
                d = labs.index(lab)
                if a not in keep[d]:
                    keep[d].append(a)
        if lab is not None and lab not in olab:
            partial.add(a)
    for d, lab in enumerate(rlab):      # shared dims in one axis order
        if lab in llab:
            ref = keep_l[llab.index(lab)]
            if set(ref) == set(keep_r[d]):
                keep_r[d] = list(ref)
    tl = p.normalize(p.shapes[lhs][0], keep_l, uneven=L)
    tr = p.normalize(p.shapes[rhs][0], keep_r, uneven=R)
    p.reshard(lhs, tl)
    p.reshard(rhs, tr)
    out = []
    for lab in olab:
        src = tl[llab.index(lab)] if lab in llab else tr[rlab.index(lab)]
        out.append(src)
    partial = {a for a in partial if any(a in tl[d] for d, lab in
                                         enumerate(llab) if lab not in olab)}
    return tuple(out), frozenset(partial)


def _mm(p, op, ins, outs, args, kwargs) -> None:
    name = str(op.overloadpacket)
    if name in ("aten.addmm", "aten.baddbmm"):
        bias, a, b = args[0], args[1], args[2]
    else:
        bias, a, b = None, args[0], args[1]
    out = outs[0]
    if len(p.shapes[a][0]) == 3:
        spec, partial = _dot(p, a, b, "bmk", "bkn", "bmn", out)
    else:
        spec, partial = _dot(p, a, b, "mk", "kn", "mn", out)
    if bias is not None:
        if partial:
            p.count("all-reduce", p.local(out, spec))
            partial = frozenset()
        bshape = p.shapes[bias][0]
        off = len(spec) - len(bshape)
        p.reshard(bias, tuple(spec[off + d] if bshape[d] > 1 else ()
                              for d in range(len(bshape))))
    p.set(out, spec, partial)
    rec = p.strided.get(a) or p.strided.get(b)
    if rec is not None and len(spec) == 3 and \
            spec[0] == tuple(x for _, e in rec for x in e):
        p.strided[out] = rec


# -- reductions ----------------------------------------------------------------

def _named(op, args, kwargs) -> dict:
    """An op's arguments by their schema names."""
    named = {a.name: v for a, v in zip(op._schema.arguments, args)}
    named.update(kwargs)
    return named


def _reduced_dims(op, args, kwargs, nd) -> tuple[list[int], bool]:
    named = _named(op, args, kwargs)
    dims = named.get("dim")
    keep = bool(named.get("keepdim", False))
    if dims is None or dims == []:
        dims = list(range(nd))
    elif isinstance(dims, int):
        dims = [dims]
    return [_dim(d, nd) for d in dims], keep


def _reduce_spec(spec, dims, keep) -> tuple:
    if keep:
        return tuple(() if d in dims else s for d, s in enumerate(spec))
    return tuple(s for d, s in enumerate(spec) if d not in dims)


def _sum(p, op, ins, outs, args, kwargs) -> None:
    """Linear reductions: a sharded reduced dimension leaves a partial
    sum."""
    spec, partial = p.get(ins[0])
    dims, keep = _reduced_dims(op, args, kwargs, len(spec))
    partial = set(partial)
    for d in dims:
        partial.update(spec[d])
    for o in outs:
        p.set(o, _reduce_spec(spec, dims, keep), partial)


def _reduce(p, op, ins, outs, args, kwargs) -> None:
    """Other reductions: reduced across a sharded dimension at once (an
    all-reduce of the result)."""
    spec = p.whole(ins[0])
    dims, keep = _reduced_dims(op, args, kwargs, len(spec))
    out = _reduce_spec(spec, dims, keep)
    if any(spec[d] for d in dims):
        for o in outs:
            p.count("all-reduce", p.local(o, out))
    for o in outs:
        p.set(o, out)


def _softmax(p, op, ins, outs, args, kwargs) -> None:
    """softmax and log-softmax along a sharded dimension: a max and a sum
    across it (two all-reduces of the reduced shape); their gradients one
    sum."""
    name = str(op.overloadpacket)
    spec = p.whole(ins[0])
    for i in ins[1:]:
        p.reshard(i, spec)
    d = _dim(args[1] if name.endswith("backward_data") is False else
             args[2], len(spec))
    if spec[d]:
        n = 1 if name.endswith("backward_data") else 2
        row = p.local(ins[0], spec) / -(-p.shapes[ins[0]][0][d] //
                                        p.shards(spec[d]))
        p.count("all-reduce", n * row)
    for o in outs:
        p.set(o, spec)


def _along(p, op, ins, outs, args, kwargs) -> None:
    """sort, topk, cumsum and kin: the dimension gathered first."""
    nd = len(p.shapes[ins[0]][0])
    name = str(op.overloadpacket)
    if name == "aten.topk":
        d = args[2] if len(args) > 2 else kwargs.get("dim", -1)
    elif name == "aten.sort":
        d = args[1] if len(args) > 1 else kwargs.get("dim", -1)
    else:
        d = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    d = _dim(d, nd)
    spec = p.gathered(ins[0], [d])
    for o in outs:
        p.set(o, spec if len(p.shapes[o][0]) == nd else
              ((),) * len(p.shapes[o][0]))


# -- gathers and scatters ------------------------------------------------------

def _take(p: Partitioner, src: int, dims: list[int], idx_spec: tuple,
          out: int, at: int, parallel=()) -> None:
    """``src`` read at indices along ``dims`` (their broadcast spec
    ``idx_spec``, placed at output dimension ``at``): a sharded indexed
    dimension gives a partial sum, unless the indices use its axis, which
    is then gathered from ``src``; the other dimensions keep their spec
    where the indices leave the axis free.  A dimension indexed by a
    fresh index (an ``arange``: GSPMD's iota) is a parallel one: it keeps
    its axes."""
    spec = list(p.whole(src))
    used = {a for e in idx_spec for a in e}
    gather, partial = set(), set()
    for d in dims:
        if d in parallel:
            continue
        for a in spec[d]:
            (gather if a in used else partial).add(a)
    rest = [d for d in range(len(spec)) if d not in dims]
    for d in rest:
        for a in spec[d]:
            if a in used:
                gather.add(a)
    if gather:
        target = tuple(tuple(a for a in e if a not in gather) for e in spec)
        p.reshard(src, target)
        spec = list(target)
    out_spec = [spec[d] for d in rest]
    out_spec[at:at] = list(idx_spec)
    p.set(out, tuple(out_spec[:len(p.shapes[out][0])]), partial)


def _index_select(p, op, ins, outs, args, kwargs) -> None:
    name = str(op.overloadpacket)
    if name == "aten.embedding":
        src, idx, d = args[0], args[1], 0
    else:
        src, idx = args[0], args[2]
        d = _dim(args[1], len(p.shapes[src][0]))
    idx_spec = p.whole(idx)
    _take(p, src, [d], idx_spec, outs[0], d)


def _index(p, op, ins, outs, args, kwargs) -> None:
    """``self[i0, i1, ...]`` (``aten.index.Tensor``): the index tensors'
    broadcast spec takes the indexed dimensions' place (or leads, when
    they are not adjacent)."""
    src, indices = args[0], args[1]
    dims = [d for d, t in enumerate(indices) if t is not None]
    ids = [t for t in indices if t is not None]
    oshape = p.shapes[outs[0]][0]
    bshape = torch.broadcast_shapes(*(p.shapes[i][0] for i in ids))
    lead = max(ids, key=lambda i: math.prod(p.shapes[i][0]))
    lspec = p.whole(lead)
    off = len(bshape) - len(lspec)
    idx_spec = ((),) * off + lspec
    for i in ids:
        if i != lead:
            ishape = p.shapes[i][0]
            o = len(bshape) - len(ishape)
            p.reshard(i, tuple(idx_spec[o + d] if ishape[d] == bshape[o + d]
                               else () for d in range(len(ishape))))
    adjacent = dims == list(range(dims[0], dims[0] + len(dims)))
    at = dims[0] if adjacent else 0
    parallel = {d for d, t in zip(dims, ids) if t in p.free}
    _take(p, src, dims, idx_spec, outs[0], at, parallel)
    spec, partial = p.get(outs[0])
    if len(spec) != len(oshape):
        p.set(outs[0], ((),) * len(oshape))


def _gather_dim(p, op, ins, outs, args, kwargs) -> None:
    """``gather(self, dim, index)``: the index's spec; a sharded ``dim``
    of ``self`` gives a partial sum (or is gathered where the index uses
    its axis)."""
    src, idx = args[0], args[2]
    nd = len(p.shapes[src][0])
    d = _dim(args[1], nd)
    ispec = p.whole(idx)
    sspec = p.whole(src)
    used = {a for e in ispec for a in e}
    target, partial = [], set()
    for k in range(nd):
        if k == d:
            keep = tuple(a for a in sspec[k] if a not in used)
            partial.update(keep)
            target.append(keep)
        else:
            target.append(ispec[k] if p.shapes[src][0][k] ==
                          p.shapes[idx][0][k] else ())
    p.reshard(src, tuple(target))
    p.set(outs[0], ispec, partial)


def _scatter(p, op, ins, outs, args, kwargs) -> None:
    """``index_add``, ``scatter_add``, ``index_put``,
    ``embedding_dense_backward`` and kin into ``self``: ``self`` keeps its
    spec (a fresh ``self`` takes the source's, but for the written
    dimensions); source rows sharded over axes ``self`` does not use
    leave a partial sum (accumulating forms; others gather them); the
    source's other dimensions follow ``self``."""
    name = str(op.overloadpacket).removeprefix("aten.").rstrip("_")
    dest = args[0]
    if name in ("index_put", "_index_put_impl"):
        written = [d for d, t in enumerate(args[1]) if t is not None]
        index = [t for t in args[1] if t is not None]
        src = args[2]
        accumulate = bool(args[3]) if len(args) > 3 else \
            bool(kwargs.get("accumulate", False))
        nd = len(p.shapes[dest][0])
        nrows = len(p.shapes[src][0]) - (nd - len(args[1])) \
            if isinstance(src, Ref) else 0
        rows = list(range(nrows))
        dmap = {k: k - len(args[1]) + nrows for k in range(len(args[1]), nd)}
    elif name == "embedding_dense_backward":
        dest, src, index = None, args[0], [args[1]]
        accumulate, written = True, [0]
        nrows = len(p.shapes[args[1]][0])
        rows, dmap = list(range(nrows)), {1: nrows}
    else:
        nd = len(p.shapes[dest][0])
        d = _dim(args[1], nd)
        index, src = [args[2]], args[3] if len(args) > 3 else None
        accumulate = name in ("index_add", "scatter_add") or \
            kwargs.get("reduce") == "add"
        written, rows = [d], [d]
        dmap = {k: k for k in range(nd) if k != d}
    oshape = p.shapes[outs[0]][0]
    sspec = p.whole(src) if isinstance(src, Ref) else None
    fresh = dest is None or dest in p.free
    if fresh and not accumulate and sspec is not None and rows:
        # rows placed once each into a fresh buffer: assumed placed where
        # the source holds them (the flat MoE dispatch index hides the
        # reference's group dimension)
        place = {written[0]: sspec[rows[0]]}
    else:
        place = {}
    if fresh:
        dspec = [()] * len(oshape)
        same = [()] * len(oshape)
        if sspec is not None:
            sshape = p.shapes[src][0]
            for k, sk in dmap.items():
                dspec[k] = tuple(a for a in sspec[sk]
                                 if not any(a in sspec[r] for r in rows))
                if oshape[k] == sshape[sk]:
                    same[k] = dspec[k]
            for k, e in place.items():
                dspec[k] = e
                if oshape[k] == sshape[rows[0]]:
                    same[k] = e
        # an uneven axis of the source stays where the buffer's dimension
        # has the source's extent: the same padded blocks
        dspec = p.normalize(oshape, dspec, uneven=same)
    else:
        dspec = p.whole(dest)
    used = {a for e in dspec for a in e}
    partial = set()
    if sspec is not None:
        target = [()] * len(sspec)
        for r in rows:
            if place and r == rows[0]:
                target[r] = sspec[r]
                continue
            keep = tuple(a for a in sspec[r] if a not in used) \
                if accumulate else ()
            partial.update(keep)
            target[r] = keep
        for k, sk in dmap.items():
            target[sk] = dspec[k]
        target = p.normalize(p.shapes[src][0], target, uneven=sspec)
        p.reshard(src, target)
        for i in index:
            ishape = p.shapes[i][0]
            if name in ("scatter_add", "scatter"):
                itarget = target
            else:
                itarget = ((),) * (len(ishape) - len(rows)) + tuple(
                    target[r] for r in rows)[-len(ishape):]
            p.reshard(i, p.normalize(ishape, itarget[:len(ishape)]))
    else:
        for i in index:
            p.whole(i)
    for o in outs:
        p.set(o, dspec, partial)


def _cat(p, op, ins, outs, args, kwargs) -> None:
    tens = [t for t in args[0] if isinstance(t, Ref)]
    nd = len(p.shapes[outs[0]][0])
    d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
    tens = [t for t in tens if len(p.shapes[t][0]) == nd]
    lead = max(tens, key=lambda t: math.prod(p.shapes[t][0]))
    spec = list(p.whole(lead))
    spec[d] = ()
    spec = tuple(spec)
    for t in tens:
        p.reshard(t, spec)
    p.set(outs[0], spec)


def _pad(p, op, ins, outs, args, kwargs) -> None:
    """``constant_pad_nd``: padded dimensions gathered."""
    pads = args[1]
    nd = len(p.shapes[ins[0]][0])
    dims = [nd - 1 - k // 2 for k in range(0, len(pads), 2)
            if pads[k] or pads[k + 1]]
    spec = p.gathered(ins[0], dims)
    p.set(outs[0], spec)


def _scalar(p, op, ins, outs, args, kwargs) -> None:
    for i in ins:
        p.whole(i)


# -- the attention kernels' shape-only route -----------------------------------

def _kernel(p: Partitioner, ins, outs) -> None:
    """q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] -> out
    [B, Hq, Sq, Dv] (+ m, l [B, Hq, Sq]): batch, heads and queries where
    q has them, D gathered; k and v share q's head axes where their heads
    divide over them; the batch follows the keys where they are the
    larger operand.  Keys sharded on the sequence either stay split,
    each device attending to its keys and the rows' outputs and
    statistics combined across them (flash decoding across devices: an
    all-reduce of the output and two of the statistics; q gives up those
    axes if it holds them), or are gathered, whichever moves less."""
    q, k, v = ins[:3]
    qs = p.gathered(q, [3])
    kb = p.whole(k)[0]
    if kb != qs[0] and p.local(k, p.get(k)[0]) > p.local(q, qs):
        # the batch's axes from the keys, the larger operand
        qs = p.normalize(p.shapes[q][0], (kb,) + tuple(
            tuple(a for a in e if a not in kb) for e in qs[1:]))
        p.reshard(q, qs)
    hkv = p.shapes[k][0][1]

    def heads_of(spec):
        return spec[1] if hkv % p.shards(spec[1]) == 0 else ()

    split = tuple(a for a in p.whole(k)[2] if a not in qs[0])
    if split:
        qsplit = tuple(tuple(a for a in e if a not in split) for e in qs)
        out_spec = qsplit[:3] + ((),)
        rows = p.local(outs[0], out_spec) / p.shapes[outs[0]][0][3] * 4
        cost_split = p.local(outs[0], out_spec) + 2 * rows + (
            p.local(q, qsplit) if qsplit != qs else 0.0)
        cost_gather = sum(p.local(t, p.normalize(
            p.shapes[t][0], (qs[0], heads_of(qs), (), ()))) for t in (k, v))
        if cost_split < cost_gather:
            p.reshard(q, qsplit)
            for t in (k, v):
                p.reshard(t, p.normalize(p.shapes[t][0], (
                    qsplit[0], heads_of(qsplit), split, ())))
            p.count("all-reduce", p.local(outs[0], out_spec) + 2 * rows)
            for o in outs:
                p.set(o, qsplit[:3] + ((),) * (len(p.shapes[o][0]) - 3))
            return
    for t in (k, v):
        p.reshard(t, p.normalize(p.shapes[t][0],
                                 (qs[0], heads_of(qs), (), ())))
    for o in outs:
        p.set(o, qs[:3] + ((),) * (len(p.shapes[o][0]) - 3))


# -- the table -----------------------------------------------------------------

_BY_NAME = {
    "aten.mm": _mm, "aten.bmm": _mm, "aten.addmm": _mm,
    "aten.baddbmm": _mm,
    "aten.view": _reshape, "aten._unsafe_view": _reshape,
    "aten.reshape": _reshape, "aten._reshape_alias": _reshape,
    "aten.view_as_real": _reshape,
    "aten.permute": _permute, "aten.transpose": _permute, "aten.t": _permute,
    "aten.expand": _expand, "aten.unsqueeze": _unsqueeze,
    "aten.squeeze": _squeeze,
    "aten.slice": _slice, "aten.narrow": _slice,
    "aten.split": _split, "aten.split_with_sizes": _split,
    "aten.select": _select, "aten.unbind": _select,
    "aten.alias": _same, "aten.detach": _same, "aten.clone": _same,
    "aten.contiguous": _same, "aten.lift_fresh": _same,
    "aten._to_copy": _same, "aten.view_as": _same,
    "aten.copy_": _copy_into, "aten.copy": _copy_into,
    "aten.fill_": _fill, "aten.zero_": _fill,
    "aten.zeros_like": _factory, "aten.ones_like": _factory,
    "aten.empty_like": _factory, "aten.full_like": _factory,
    "aten.rand_like": _factory, "aten.randn_like": _factory,
    "aten.arange": _factory, "aten.zeros": _factory, "aten.ones": _factory,
    "aten.empty": _factory, "aten.full": _factory,
    "aten.scalar_tensor": _factory, "aten.empty_strided": _factory,
    "aten.new_zeros": _factory, "aten.new_ones": _factory,
    "aten.new_empty": _factory, "aten.new_full": _factory,
    "aten.new_empty_strided": _factory,
    "aten.sum": _sum, "aten.mean": _sum,
    "aten.amax": _reduce, "aten.amin": _reduce, "aten.max": _reduce,
    "aten.min": _reduce, "aten.argmax": _reduce, "aten.argmin": _reduce,
    "aten.logsumexp": _reduce, "aten.var": _reduce, "aten.std": _reduce,
    "aten.prod": _reduce, "aten.any": _reduce, "aten.all": _reduce,
    "aten.linalg_vector_norm": _reduce, "aten.norm": _reduce,
    "aten._softmax": _softmax, "aten._log_softmax": _softmax,
    "aten._softmax_backward_data": _softmax,
    "aten._log_softmax_backward_data": _softmax,
    "aten.sort": _along, "aten.topk": _along, "aten.cumsum": _along,
    "aten.cumprod": _along,
    "aten.embedding": _index_select, "aten.index_select": _index_select,
    "aten.index": _index, "aten.gather": _gather_dim,
    "aten.index_add": _scatter, "aten.index_add_": _scatter,
    "aten.scatter_add": _scatter, "aten.scatter_add_": _scatter,
    "aten.scatter": _scatter, "aten.scatter_": _scatter,
    "aten.index_put": _scatter, "aten.index_put_": _scatter,
    "aten._index_put_impl_": _scatter,
    "aten.embedding_dense_backward": _scatter,
    "aten.cat": _cat, "aten.stack": _stack, "aten.constant_pad_nd": _pad,
    "aten.select_backward": _select_backward,
    "aten.slice_backward": _select_backward,
    "aten.floor_divide": _elementwise, "aten.remainder": _elementwise,
    "aten._local_scalar_dense": _scalar,
    "repro_torch.constrain": _constrain,
}
_RULES: dict = {}


def _rule(op):
    rule = _RULES.get(id(op), False)
    if rule is False:
        name = str(op.overloadpacket)
        rule = _BY_NAME.get(name)
        if rule is None:
            if not any("Tensor" in str(a.type)
                       for a in op._schema.arguments):
                rule = _factory
            elif torch.Tag.pointwise in op.tags:
                rule = _elementwise
        _RULES[id(op)] = rule      # overloads live as long as torch
    return rule
