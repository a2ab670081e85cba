"""Unified retrieval-plan IR.

Every retrieval — singlepoint, multipoint, node materialization, host or
device backend — is one **DAG of typed steps**:

* :class:`Fetch`        — pull a payload's columnar components from the KV
  store (one node per ``(kind, pid)``, so a payload shared by several apply
  steps — e.g. one leaf-eventlist serving chained targets — is fetched
  exactly once, and the async prefetcher can overlap it with application);
* :class:`Source`       — a distance-0 plan source: the empty graph, a
  materialized GraphPool graph, or the current graph;
* :class:`ApplyDelta`   — apply a persisted delta (either direction);
* :class:`ApplyElist`   — apply a (possibly partial) leaf-eventlist;
* :class:`ApplyRecent`  — apply a slice of the in-memory recent eventlist;
* :class:`Noop`         — pass a state through unchanged;
* :class:`Fork`         — a state consumed by ≥ 2 branches; executors use
  it as the batching point (the device backend runs sibling branches as one
  batched ``delta_apply_chain`` call);
* :class:`Materialize`  — emit a state as a query result.

The IR stays **backend-neutral**: it references payload ids, pool graph
ids and time ranges, never raw bytes or arrays.  ``PlanIR.steps`` exposes
the state-producing nodes in topological order with the legacy
``(key, parent, action, weight)`` surface, so existing callers (tests,
benchmarks, the sharded lowering) keep working unchanged.

:func:`merge_irs` is the shared-prefix batch optimizer: concurrent plans
are merged into one DAG by structural signature — two nodes collapse when
their op and their (recursively merged) dependencies coincide — so common
subpaths fetch and apply exactly once for the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

# ---------------------------------------------------------------------------
# typed steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fetch:
    """Fetch a payload's components from the KV store.

    ``parts`` restricts the fetch to a subset of the index's storage
    partitions (``None`` = all): the sharded scatter (:func:`scatter_ir`)
    rewrites every Fetch so each shard pulls only the sub-payloads whose
    slots it owns."""
    kind: str                       # 'delta' | 'elist'
    pid: int
    parts: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class Source:
    """A distance-0 source state."""
    kind: str                       # 'empty' | 'mat' | 'current'
    gid: int | None = None          # GraphPool graph id for 'mat'


@dataclasses.dataclass(frozen=True)
class ApplyDelta:
    pid: int
    forward: bool


@dataclasses.dataclass(frozen=True)
class ApplyElist:
    pid: int
    forward: bool
    rng: tuple[int, int] | None     # apply rows with lo < time <= hi


@dataclasses.dataclass(frozen=True)
class ApplyRecent:
    forward: bool
    rng: tuple[int, int] | None


@dataclasses.dataclass(frozen=True)
class Noop:
    pass


@dataclasses.dataclass(frozen=True)
class Fork:
    fanout: int


@dataclasses.dataclass(frozen=True)
class Materialize:
    target: Any                     # query target (t, or ("node", nid))


APPLY_OPS = (ApplyDelta, ApplyElist, ApplyRecent, Noop)
STATE_OPS = (Source, Fork) + APPLY_OPS


# ---------------------------------------------------------------------------
# DAG nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IRNode:
    nid: int
    op: Any
    deps: tuple[int, ...] = ()      # DAG dependencies (node ids)
    key: Any = None                 # state key produced (state ops only)
    parent_key: Any = None          # state key consumed (legacy surface)
    weight: float = 0.0

    # -- legacy PlanStep surface -------------------------------------------
    @property
    def parent(self) -> Any:
        return self.parent_key

    @property
    def action(self) -> tuple:
        op = self.op
        if isinstance(op, Source):
            if op.kind == "mat":
                return ("mat", op.gid)
            return (op.kind,)
        if isinstance(op, ApplyDelta):
            return ("delta", op.pid, op.forward, None)
        if isinstance(op, ApplyElist):
            return ("elist", op.pid, op.forward, op.rng)
        if isinstance(op, ApplyRecent):
            return ("recent", None, op.forward, op.rng)
        if isinstance(op, Noop):
            return ("noop", None, True, None)
        if isinstance(op, Fork):
            return ("fork", op.fanout)
        if isinstance(op, Fetch):
            if op.parts is not None:
                return ("fetch", op.kind, op.pid, op.parts)
            return ("fetch", op.kind, op.pid)
        if isinstance(op, Materialize):
            return ("materialize", op.target)
        raise ValueError(op)  # pragma: no cover


@dataclasses.dataclass
class PlanIR:
    """A retrieval plan: typed-step DAG in topological order."""

    nodes: list[IRNode]
    targets: dict[Any, int]         # query target -> producing node id
    total_weight: float
    payload_fetches: int = 0

    # -- legacy Plan surface -----------------------------------------------
    @property
    def steps(self) -> list[IRNode]:
        """State-producing nodes (sans Fork) in topo order — the legacy
        linear-plan view used by tests, benchmarks and the chain lowering."""
        return [n for n in self.nodes
                if isinstance(n.op, STATE_OPS) and not isinstance(n.op, Fork)]

    def source_nids(self) -> set:
        """Skeleton keys of materialized sources this plan routes through
        (cache-dependency tracking: evicting one invalidates the entry)."""
        return {n.key for n in self.nodes
                if isinstance(n.op, Source) and n.op.kind == "mat"}

    def per_target_source_nids(self) -> dict[Any, set]:
        """Materialized-source skeleton nids on each *target's* backward
        slice of the DAG — exact per-entry cache dependencies for batched
        plans (a target whose branch never touched a pin must not be
        invalidated when that pin is evicted)."""
        memo: dict[int, set] = {}
        for n in self.nodes:            # topo order: deps precede node
            s: set = set()
            if isinstance(n.op, Source) and n.op.kind == "mat":
                s.add(n.key)
            for d in n.deps:
                s |= memo[d]
            memo[n.nid] = s
        return {tgt: memo[nid] for tgt, nid in self.targets.items()}

    def state_keys(self) -> list:
        return [n.key for n in self.nodes
                if isinstance(n.op, STATE_OPS) and not isinstance(n.op, Fork)]

    def cost_summary(self) -> dict:
        """Planner-side execution stats for the :class:`QueryResult`
        envelope: total decode-aware cost, distinct payload fetches, and
        state-producing step count."""
        return {"plan_cost": float(self.total_weight),
                "payload_fetches": int(self.payload_fetches),
                "plan_steps": len(self.steps),
                "targets": len(self.targets)}


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


def _action_to_op(action: tuple):
    kind = action[0]
    if kind in ("empty", "current"):
        return Source(kind)
    if kind == "mat":
        return Source("mat", int(action[1]))
    if kind == "delta":
        return ApplyDelta(int(action[1]), bool(action[2]))
    if kind == "elist":
        rng = tuple(action[3]) if action[3] is not None else None
        return ApplyElist(int(action[1]), bool(action[2]), rng)
    if kind == "recent":
        rng = tuple(action[3]) if action[3] is not None else None
        return ApplyRecent(bool(action[2]), rng)
    if kind == "noop":
        return Noop()
    raise ValueError(f"unknown action {action}")


class PlanBuilder:
    """Accumulates planner output (source + apply chains keyed by state)
    into a :class:`PlanIR`; inserts Fetch and Fork nodes automatically."""

    def __init__(self) -> None:
        self._nodes: list[IRNode] = []
        self._by_key: dict[Any, int] = {}       # state key -> node id
        self._fetches: dict[tuple, int] = {}    # (kind, pid) -> node id
        self._targets: dict[Any, Any] = {}      # target -> state key
        self._next = 0

    def _add(self, node: IRNode) -> int:
        self._nodes.append(node)
        return node.nid

    def _new(self, op, deps=(), key=None, parent_key=None, weight=0.0) -> int:
        nid = self._next
        self._next += 1
        return self._add(IRNode(nid, op, tuple(deps), key, parent_key, weight))

    def has_state(self, key: Any) -> bool:
        return key in self._by_key

    def source(self, key: Any, action: tuple) -> int:
        if key in self._by_key:
            return self._by_key[key]
        nid = self._new(_action_to_op(action), key=key)
        self._by_key[key] = nid
        return nid

    def _fetch(self, kind: str, pid: int) -> int:
        fk = (kind, pid)
        if fk not in self._fetches:
            self._fetches[fk] = self._new(Fetch(kind, pid))
        return self._fetches[fk]

    def apply(self, key: Any, parent_key: Any, action: tuple,
              weight: float = 0.0) -> int:
        if key in self._by_key:
            return self._by_key[key]
        op = _action_to_op(action)
        deps = [self._by_key[parent_key]]
        if isinstance(op, ApplyDelta):
            deps.append(self._fetch("delta", op.pid))
        elif isinstance(op, ApplyElist):
            deps.append(self._fetch("elist", op.pid))
        nid = self._new(op, deps, key=key, parent_key=parent_key,
                        weight=float(weight))
        self._by_key[key] = nid
        return nid

    def target(self, tgt: Any, key: Any) -> None:
        self._targets[tgt] = key

    def build(self) -> PlanIR:
        nodes = list(self._nodes)
        targets = {}
        for tgt, key in self._targets.items():
            dep = self._by_key[key]
            nid = self._next
            self._next += 1
            nodes.append(IRNode(nid, Materialize(tgt), (dep,), key=key,
                                parent_key=key))
            targets[tgt] = dep
        ir = PlanIR(nodes, targets,
                    total_weight=sum(n.weight for n in nodes),
                    payload_fetches=len(self._fetches))
        return _insert_forks(ir)


# ---------------------------------------------------------------------------
# fork insertion / merging
# ---------------------------------------------------------------------------


def _strip_forks(ir: PlanIR) -> PlanIR:
    """Remove Fork pass-through nodes, re-pointing consumers at the fork's
    state parent (inverse of :func:`_insert_forks`)."""
    fwd: dict[int, int] = {}
    for n in ir.nodes:
        if isinstance(n.op, Fork):
            fwd[n.nid] = n.deps[0]

    def chase(nid: int) -> int:
        while nid in fwd:
            nid = fwd[nid]
        return nid

    nodes = []
    for n in ir.nodes:
        if isinstance(n.op, Fork):
            continue
        if any(d in fwd for d in n.deps):
            n = dataclasses.replace(n, deps=tuple(chase(d) for d in n.deps))
        nodes.append(n)
    targets = {t: chase(nid) for t, nid in ir.targets.items()}
    return PlanIR(nodes, targets, ir.total_weight, ir.payload_fetches)


def _insert_forks(ir: PlanIR) -> PlanIR:
    """Insert a Fork after every state node consumed by ≥ 2 apply steps."""
    consumers: dict[int, list[int]] = {}
    byid = {n.nid: n for n in ir.nodes}
    for n in ir.nodes:
        if isinstance(n.op, APPLY_OPS):
            for d in n.deps:
                if isinstance(byid[d].op, STATE_OPS):
                    consumers.setdefault(d, []).append(n.nid)
    fork_after = {nid: len(c) for nid, c in consumers.items() if len(c) >= 2}
    if not fork_after:
        return ir
    next_id = max(n.nid for n in ir.nodes) + 1
    fork_of: dict[int, int] = {}
    nodes: list[IRNode] = []
    for n in ir.nodes:
        if any(d in fork_of for d in n.deps) and isinstance(n.op, APPLY_OPS):
            n = dataclasses.replace(
                n, deps=tuple(fork_of.get(d, d) if isinstance(byid[d].op, STATE_OPS)
                              else d for d in n.deps))
        nodes.append(n)
        if n.nid in fork_after:
            f = IRNode(next_id, Fork(fork_after[n.nid]), (n.nid,),
                       key=n.key, parent_key=n.key)
            next_id += 1
            fork_of[n.nid] = f.nid
            nodes.append(f)
    return PlanIR(nodes, dict(ir.targets), ir.total_weight,
                  ir.payload_fetches)


def merge_irs(irs: Sequence[PlanIR]) -> PlanIR:
    """Merge concurrent plans into one batched DAG.

    Nodes are deduplicated by structural signature — ``(op, merged dep
    ids)`` — so any prefix two plans share (same source, same payload
    applies in the same order) becomes a single subpath that fetches and
    applies once.  Fork nodes are recomputed over the merged consumer
    counts."""
    if len(irs) == 1:
        return irs[0]
    sig_to_nid: dict[tuple, int] = {}
    nodes: list[IRNode] = []
    targets: dict[Any, int] = {}
    next_id = 0
    total = 0.0
    for ir in irs:
        flat = _strip_forks(ir)
        old2new: dict[int, int] = {}
        for n in flat.nodes:
            if isinstance(n.op, Materialize):
                targets[n.op.target] = old2new[n.deps[0]]
                continue
            sig = (n.op, tuple(old2new[d] for d in n.deps))
            nid = sig_to_nid.get(sig)
            if nid is None:
                nid = next_id
                next_id += 1
                sig_to_nid[sig] = nid
                nodes.append(dataclasses.replace(
                    n, nid=nid, deps=tuple(old2new[d] for d in n.deps)))
                total += n.weight
            old2new[n.nid] = nid
    byid = {n.nid: n for n in nodes}
    for tgt, dep in targets.items():
        n = IRNode(next_id, Materialize(tgt), (dep,), key=byid[dep].key,
                   parent_key=byid[dep].key)
        next_id += 1
        nodes.append(n)
    fetches = sum(1 for n in nodes if isinstance(n.op, Fetch))
    return _insert_forks(PlanIR(nodes, targets, total, fetches))


# ---------------------------------------------------------------------------
# cross-shard scatter
# ---------------------------------------------------------------------------


def scatter_ir(ir: PlanIR, parts_by_shard: dict[Any, tuple[int, ...]],
               total_parts: int) -> dict[Any, PlanIR]:
    """Scatter one plan into per-shard plan IRs.

    The DAG topology is shared — every shard applies the same step
    sequence — but each shard's Fetch nodes are restricted to the storage
    partitions it owns, so a shard pulls (and decodes) only the
    sub-payloads whose slots it is responsible for.  Apply weights are
    scaled by the shard's partition fraction: the sum of the per-shard
    costs equals the unsharded plan's cost.

    Correctness of the later gather rests on the partitioner contract:
    events for slot ``s`` are stored only under partition ``h_p(s)``, so a
    shard executing the restricted plan computes exactly the unsharded
    result on the slots it owns (other slots may be stale and are dropped
    at gather time)."""
    out: dict[Any, PlanIR] = {}
    for shard, parts in parts_by_shard.items():
        parts = tuple(sorted(int(p) for p in parts))
        frac = len(parts) / max(int(total_parts), 1)
        nodes = []
        for n in ir.nodes:
            if isinstance(n.op, Fetch):
                nodes.append(dataclasses.replace(
                    n, op=Fetch(n.op.kind, n.op.pid, parts)))
            elif n.weight:
                nodes.append(dataclasses.replace(n, weight=n.weight * frac))
            else:
                nodes.append(n)
        out[shard] = PlanIR(nodes, dict(ir.targets),
                            ir.total_weight * frac, ir.payload_fetches)
    return out
