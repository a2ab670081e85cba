"""QueryCompiler: one lowering from GraphQuery documents onto the engine.

Every document kind compiles to a :class:`CompiledQuery` with two halves:

* ``point_times`` / ``point_group`` — the snapshot timepoints the document
  needs retrieved, if any, keyed by the execution parameters that make two
  documents co-plannable.  The :class:`~repro_torch.api.service.QueryService`
  unions the timepoints of every co-batched document in a group and
  retrieves them through **one** merged Steiner plan (exactly what
  ``GraphManager.get_snapshots`` does for a plain time batch) — so a batch
  of mixed snapshot / multipoint / expr documents shares prefix fetches
  and applies across documents.
* ``finish(service, states)`` — turns retrieved states (or, for
  interval/evolve kinds, a direct engine call) into the document's result
  payload.

Compilation is where *semantic* validation happens, with the typed error
taxonomy (:mod:`repro_torch.core.errors`): attribute names are resolved against
the universe, TimeExpressions are parsed, named evolve operators are
checked against the registry — so a malformed wire document fails before
any KV traffic, with a structured error.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import numpy as np

from ..core.errors import DocumentError
from ..core.query import AttrOptions, TimeExpression, parse_attr_options
from .document import GraphQuery

if TYPE_CHECKING:  # pragma: no cover
    from ..core.events import GraphUniverse, MaterializedState
    from .service import QueryService


def expr_state(tex: TimeExpression, states: dict[int, "MaterializedState"],
               ) -> "MaterializedState":
    """Evaluate a Boolean TimeExpression over retrieved per-time states
    (paper §3.2.1): the element set satisfying the expression; attributes
    come from the latest queried time point at which the element exists."""
    from ..core.events import MaterializedState
    ordered = [states[t] for t in tex.times]
    nmask = tex.evaluate([s.node_mask for s in ordered])
    emask = tex.evaluate([s.edge_mask for s in ordered])
    na = np.full_like(ordered[0].node_attrs, np.nan)
    ea = np.full_like(ordered[0].edge_attrs, np.nan)
    for s in ordered:  # later time points override
        take = s.node_mask & nmask
        na[take] = s.node_attrs[take]
        take_e = s.edge_mask & emask
        ea[take_e] = s.edge_attrs[take_e]
    return MaterializedState(nmask, emask, na, ea)


@dataclasses.dataclass
class CompiledQuery:
    """A validated, universe-resolved document ready to execute."""

    doc: GraphQuery
    options: AttrOptions
    tex: TimeExpression | None = None

    @property
    def kind(self) -> str:
        return self.doc.kind

    @property
    def point_times(self) -> tuple[int, ...]:
        """Snapshot timepoints this document needs (empty for kinds the
        engine retrieves internally)."""
        d = self.doc
        if d.kind == "snapshot":
            return (d.t,)
        if d.kind in ("multipoint", "expr"):
            return d.times
        return ()

    @property
    def point_group(self) -> tuple | None:
        """Co-batching key: documents with the same group key can share
        one merged Steiner plan."""
        if not self.point_times:
            return None
        return (self.options.node_cols, self.options.edge_cols,
                self.doc.use_current, self.doc.no_cache)

    def finish(self, service: "QueryService",
               states: dict[int, "MaterializedState"] | None,
               dg=None) -> Any:
        """Produce the result payload from retrieved ``states`` (point
        kinds) or by calling the engine directly (interval / evolve).
        ``dg`` is the epoch-pinned index version the whole document must
        resolve against (defaults to the manager's current one)."""
        d = self.doc
        if d.kind == "snapshot":
            return states[d.t]
        if d.kind == "multipoint":
            return {t: states[t] for t in d.times}
        if d.kind == "expr":
            return expr_state(self.tex, states)
        gm = service.gm
        if dg is None:
            dg = gm.dg
        if d.kind == "interval":
            return dg.get_interval(d.ts, d.te)
        # evolve: the temporal engine plans/retrieves its first snapshot
        # itself (through the service shims, so cache/advisor apply)
        return service.temporal_engine().evolve(
            list(d.times), d.op, attr_options=self.options,
            use_current=d.use_current, incremental=d.incremental,
            dg=dg, **d.op_kwargs)


class QueryCompiler:
    """Compiles documents against one universe (attribute tables)."""

    def __init__(self, universe: "GraphUniverse") -> None:
        self.universe = universe
        # spec-string -> AttrOptions memo: the legacy shims route every
        # retrieval through here, so repeated specs (the common case on a
        # serving hot path) must not re-run the regex parse per query.
        # Keyed on the attribute-table sizes too: live updates can add
        # columns, and a memoized ``+node:all`` must re-resolve then.
        self._opt_memo: dict[tuple, AttrOptions] = {}

    def parse_attrs(self, spec: str) -> AttrOptions:
        key = (spec, self.universe.num_node_attrs,
               self.universe.num_edge_attrs)
        opts = self._opt_memo.get(key)
        if opts is None:
            opts = parse_attr_options(spec, self.universe)
            if len(self._opt_memo) < 4096:   # bound pathological streams
                self._opt_memo[key] = opts
        return opts

    def compile(self, doc: GraphQuery) -> CompiledQuery:
        doc.validate()
        if isinstance(doc.attrs, AttrOptions):
            options = doc.attrs
        elif isinstance(doc.attrs, str):
            options = self.parse_attrs(doc.attrs)
        else:
            raise DocumentError(f"'attrs' must be a spec string or "
                                f"AttrOptions, got {type(doc.attrs).__name__}",
                                position="attrs")
        tex = None
        if doc.kind == "expr":
            tex = doc.time_expression()
        if doc.kind == "evolve" and isinstance(doc.op, str):
            from ..core.temporal import resolve_op
            resolve_op(doc.op, {})   # registry check -> UnknownOperatorError
        return CompiledQuery(doc, options, tex)


# ---------------------------------------------------------------------------
# cross-shard planning
# ---------------------------------------------------------------------------


def scatter_plans(irs, parts_by_shard: dict[Any, tuple[int, ...]],
                  total_parts: int) -> dict[Any, Any]:
    """Scatter one or more compiled plan IRs across shards.

    Each plan is scattered (:func:`repro_torch.core.planir.scatter_ir`) so a
    shard's Fetch nodes pull only the storage partitions it owns; a shard
    handed several plans (a co-batched document group) gets them merged
    back into one DAG with :func:`repro_torch.core.planir.merge_irs`, so shared
    prefixes still fetch and apply once *per shard*.  Returns
    ``{shard: PlanIR}``; the per-shard slot results are unioned by the
    sharded retriever's gather step."""
    from ..core.planir import merge_irs, scatter_ir

    per_shard: dict[Any, list] = {s: [] for s in parts_by_shard}
    for ir in irs:
        for s, sir in scatter_ir(ir, parts_by_shard, total_parts).items():
            per_shard[s].append(sir)
    return {s: (merge_irs(plans) if len(plans) > 1 else plans[0])
            for s, plans in per_shard.items()}
