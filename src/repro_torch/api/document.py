"""The declarative GraphQuery document (schema v1) and its fluent builder.

A :class:`GraphQuery` is the *serializable* form of every retrieval and
analytics request the system answers — the wire protocol a client puts on
a socket, a queue, or a file.  One document, one ``kind``:

======================  ====================================================
kind                    fields
======================  ====================================================
``snapshot``            ``t``  — the paper's ``GetHistGraph(t)``
``multipoint``          ``times`` — batched retrieval (one Steiner plan)
``expr``                ``expr`` (infix TimeExpression) + ``times``
``interval``            ``ts``, ``te`` — elements added during ``[ts, te)``
``evolve``              ``times`` + ``op`` (+ ``op_kwargs``,
                        ``incremental``) — temporal analytics
======================  ====================================================

Common fields: ``attrs`` (an attr_options spec string, Table 1),
``use_current`` (may the planner route through the live current graph),
``no_cache`` (consistency hint: bypass the snapshot cache), ``reply``
(``"summary"``, ``"full"``, or — under the socket server — ``"lease"``:
overlay the result in the GraphPool and return lease gids instead of
slot lists), ``id`` (opaque client correlation token, echoed verbatim in
the result envelope — the cross-wiring oracle under concurrent serving),
``deadline_ms`` (SLO budget from arrival; the scheduler rejects the
request with a typed ``deadline`` error envelope once the planner's cost
estimate says it cannot be met — see ``api/scheduler.py``), ``v``
(schema version, currently 1).

``GraphQuery.from_dict`` / :meth:`GraphQuery.to_dict` round-trip the JSON
form losslessly (property-tested in ``tests/test_api.py``); malformed
documents raise :class:`~repro_torch.core.errors.DocumentError` with the
offending field name as ``position``.

Programmatic construction goes through :class:`Q`::

    Q.at(1966).attrs("+node:papers").build()
    Q.at(1963, 1969, 1973).build()                      # multipoint
    Q.expr("t0 & ~t1", [1969, 1973]).build()
    Q.between(1970, 1973).build()                       # interval
    Q.between(ts, te).compute("pagerank").build()       # evolve
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence

from ..core.errors import DocumentError
from ..core.query import AttrOptions, TimeExpression

SCHEMA_VERSION = 1

KINDS = ("snapshot", "multipoint", "expr", "interval", "evolve")

# fields meaningful per kind (beyond the common ones); anything else set to
# a non-default value makes the document invalid — strictness keeps the
# wire form canonical and the JSON round-trip exact
_KIND_FIELDS = {
    "snapshot": ("t",),
    "multipoint": ("times",),
    "expr": ("expr", "times"),
    "interval": ("ts", "te"),
    "evolve": ("times", "op", "op_kwargs", "incremental"),
}
_COMMON_FIELDS = ("attrs", "use_current", "no_cache", "reply", "id",
                  "deadline_ms")
_ALL_FIELDS = ("kind", "v", "t", "times", "ts", "te", "expr", "op",
               "op_kwargs", "incremental") + _COMMON_FIELDS


def _as_int(v: Any, field: str) -> int:
    if isinstance(v, bool) or not isinstance(v, (int, float)) or int(v) != v:
        raise DocumentError(f"field {field!r} must be an integer, "
                            f"got {v!r}", position=field)
    return int(v)


@dataclasses.dataclass(frozen=True)
class GraphQuery:
    """One serializable query document (see module docstring).

    ``attrs`` is normally an attr_options spec *string*; legacy
    programmatic callers may pass a pre-parsed
    :class:`~repro_torch.core.query.AttrOptions` (and ``op`` an
    :class:`~repro_torch.core.temporal.EvolveOp` instance or callable) — such
    documents execute normally but refuse to serialize."""

    kind: str
    t: int | None = None
    times: tuple[int, ...] | None = None
    ts: int | None = None
    te: int | None = None
    expr: str | None = None
    op: Any = None
    op_kwargs: dict = dataclasses.field(default_factory=dict)
    attrs: Any = ""
    use_current: bool = True
    no_cache: bool = False
    reply: str = "summary"
    v: int = SCHEMA_VERSION
    incremental: bool = True
    id: Any = None
    deadline_ms: float | None = None

    def __post_init__(self) -> None:
        # normalize so that equality and the JSON round-trip are canonical
        if self.times is not None:
            seq = (self.times if isinstance(self.times, (list, tuple))
                   else [self.times])
            norm = [_as_int(x, "times") for x in seq]
            if self.kind != "expr":   # expr indices (t0, t1, ...) are
                norm = list(dict.fromkeys(norm))  # positional — keep dups
            object.__setattr__(self, "times", tuple(norm))
        for f in ("t", "ts", "te"):
            val = getattr(self, f)
            if val is not None:
                object.__setattr__(self, f, _as_int(val, f))

    # -- validation ---------------------------------------------------------
    def validate(self) -> "GraphQuery":
        """Structural validation (kind, required/forbidden fields, basic
        types).  Semantic validation — attribute names against a universe,
        TimeExpression syntax, operator registry — happens in the
        compiler.  Returns ``self`` so call sites can chain."""
        if self.v != SCHEMA_VERSION:
            raise DocumentError(f"unsupported document version {self.v!r} "
                                f"(this build speaks v{SCHEMA_VERSION})",
                                position="v")
        if self.kind not in KINDS:
            raise DocumentError(f"unknown query kind {self.kind!r}; "
                                f"choose from {list(KINDS)}", position="kind")
        allowed = set(_KIND_FIELDS[self.kind])
        for f in ("t", "times", "ts", "te", "expr", "op"):
            if f not in allowed and getattr(self, f) is not None:
                raise DocumentError(
                    f"field {f!r} does not apply to kind {self.kind!r}",
                    position=f)
        if "op_kwargs" not in allowed and self.op_kwargs:
            raise DocumentError("field 'op_kwargs' only applies to evolve "
                                "documents", position="op_kwargs")
        if self.kind == "snapshot" and self.t is None:
            raise DocumentError("snapshot document needs 't'", position="t")
        if self.kind in ("multipoint", "expr", "evolve") and not self.times:
            raise DocumentError(f"{self.kind} document needs a non-empty "
                                f"'times' list", position="times")
        if self.kind == "expr":
            if not isinstance(self.expr, str) or not self.expr.strip():
                raise DocumentError("expr document needs a TimeExpression "
                                    "infix string in 'expr'", position="expr")
        if self.kind == "interval":
            if self.ts is None or self.te is None:
                raise DocumentError("interval document needs 'ts' and 'te'",
                                    position="ts" if self.ts is None else "te")
        if self.kind == "evolve" and not isinstance(self.op_kwargs, dict):
            raise DocumentError("'op_kwargs' must be an object",
                                position="op_kwargs")
        if self.kind != "evolve" and self.incremental is not True:
            raise DocumentError("field 'incremental' only applies to "
                                "evolve documents", position="incremental")
        if self.reply not in ("summary", "full", "lease"):
            raise DocumentError(f"'reply' must be 'summary', 'full' or "
                                f"'lease', got {self.reply!r}",
                                position="reply")
        if self.reply == "lease" and self.kind not in ("snapshot",
                                                       "multipoint", "expr"):
            raise DocumentError(f"reply='lease' only applies to state-"
                                f"returning kinds, not {self.kind!r}",
                                position="reply")
        for f in ("use_current", "no_cache", "incremental"):
            if not isinstance(getattr(self, f), bool):
                raise DocumentError(f"field {f!r} must be a boolean",
                                    position=f)
        if self.id is not None and not isinstance(self.id, (str, int)):
            raise DocumentError("'id' must be a string or integer",
                                position="id")
        if isinstance(self.id, bool):
            raise DocumentError("'id' must be a string or integer",
                                position="id")
        if self.deadline_ms is not None:
            d = self.deadline_ms
            if isinstance(d, bool) or not isinstance(d, (int, float)) \
                    or not d > 0:
                raise DocumentError("'deadline_ms' must be a positive "
                                    "number", position="deadline_ms")
        return self

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """Canonical wire dict: ``v`` + ``kind`` + the kind's fields, with
        common fields included only when they differ from the default.
        Documents carrying non-serializable programmatic payloads
        (AttrOptions / EvolveOp instances) raise
        :class:`~repro_torch.core.errors.DocumentError`."""
        self.validate()
        if not isinstance(self.attrs, str):
            raise DocumentError(
                "document holds a pre-parsed AttrOptions; only attr-spec "
                "strings serialize — build with the spec string instead",
                position="attrs")
        out: dict[str, Any] = {"v": self.v, "kind": self.kind}
        for f in _KIND_FIELDS[self.kind]:
            val = getattr(self, f)
            if f == "op":
                if val is None:
                    continue
                if not isinstance(val, str):
                    raise DocumentError(
                        "only named operators serialize; EvolveOp instances "
                        "and callables are programmatic-only", position="op")
            if f == "op_kwargs" and not val:
                continue
            if f == "times":
                val = list(val)
            out[f] = val
        defaults = {"attrs": "", "use_current": True, "no_cache": False,
                    "reply": "summary", "id": None, "deadline_ms": None}
        for f, dflt in defaults.items():
            if getattr(self, f) != dflt:
                out[f] = getattr(self, f)
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Any) -> "GraphQuery":
        if not isinstance(d, dict):
            raise DocumentError(f"query document must be a JSON object, "
                                f"got {type(d).__name__}")
        unknown = set(d) - set(_ALL_FIELDS)
        if unknown:
            raise DocumentError(f"unknown document field(s) "
                                f"{sorted(unknown)}",
                                position=sorted(unknown)[0])
        if "kind" not in d:
            raise DocumentError("document needs a 'kind'", position="kind")
        kw = dict(d)
        kind = kw.pop("kind")
        if not isinstance(kind, str):
            raise DocumentError("'kind' must be a string", position="kind")
        if "op_kwargs" in kw and kw["op_kwargs"] is None:
            kw.pop("op_kwargs")
        if kind == "evolve" and kw.get("op") is None:
            kw["op"] = "masks"     # the engine's default operator
        if "attrs" in kw and not isinstance(kw["attrs"], str):
            raise DocumentError("'attrs' must be an attr_options spec "
                                "string on the wire", position="attrs")
        try:
            doc = cls(kind=kind, **kw)
        except TypeError as e:  # pragma: no cover - guarded by unknown check
            raise DocumentError(str(e)) from e
        return doc.validate()

    @classmethod
    def from_json(cls, text: str) -> "GraphQuery":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise DocumentError(f"invalid JSON: {e.msg}",
                                position=e.pos) from e
        return cls.from_dict(d)

    # -- helpers ------------------------------------------------------------
    def time_expression(self) -> TimeExpression:
        """Parse ``expr`` against ``times`` (expr documents only)."""
        return TimeExpression.parse(self.expr, list(self.times))


# ---------------------------------------------------------------------------
# fluent builder
# ---------------------------------------------------------------------------


class _Builder:
    """Accumulates fields; :meth:`build` produces a validated document."""

    def __init__(self, **fields: Any) -> None:
        self._f = fields

    def _set(self, **kw: Any) -> "_Builder":
        self._f.update(kw)
        return self

    def attrs(self, spec: str | AttrOptions) -> "_Builder":
        """Attribute selection — a Table-1 spec string like
        ``"+node:all-node:salary"`` (or a pre-parsed AttrOptions for
        programmatic, non-wire use)."""
        return self._set(attrs=spec)

    def use_current(self, flag: bool = True) -> "_Builder":
        return self._set(use_current=bool(flag))

    def fresh(self) -> "_Builder":
        """Consistency hint: bypass the snapshot cache for this query."""
        return self._set(no_cache=True)

    def full(self) -> "_Builder":
        """Request the full (slot-list) result payload on the wire."""
        return self._set(reply="full")

    def lease(self) -> "_Builder":
        """Request a GraphPool lease instead of a payload: the server
        overlays the retrieved snapshot(s) and returns lease gids the
        session holds (and must ``release``) — see ``launch/server.py``."""
        return self._set(reply="lease")

    def tag(self, id: str | int) -> "_Builder":
        """Attach a client correlation ``id``, echoed in the envelope."""
        return self._set(id=id)

    def deadline(self, ms: float) -> "_Builder":
        """SLO budget in milliseconds from arrival; the serving scheduler
        sheds the request with a ``deadline`` error envelope rather than
        executing it late (``api/scheduler.py``)."""
        return self._set(deadline_ms=float(ms))

    def compute(self, op: Any, *, incremental: bool = True,
                **op_kwargs: Any) -> "_Builder":
        """Turn the query into an evolve (temporal-analytics) document
        running ``op`` over its timepoints.  On a ``between(ts, te)``
        builder the window is sampled at up to 32 evenly spaced integer
        timepoints unless :meth:`step` / :meth:`points` chose otherwise."""
        f = self._f
        if f.get("kind") == "snapshot":
            f["times"] = (f.pop("t"),)
        if f.get("kind") == "interval":
            ts, te = f.pop("ts"), f.pop("te")
            step = f.pop("_step", None)
            npts = f.pop("_points", None)
            if step is not None:
                times = tuple(range(ts, te + 1, max(int(step), 1)))
            else:
                n = min(te - ts + 1, int(npts) if npts else 32)
                n = max(n, 1)
                times = tuple(dict.fromkeys(
                    ts + round(i * (te - ts) / max(n - 1, 1))
                    for i in range(n)))
            f["times"] = times
        return self._set(kind="evolve", op=op, op_kwargs=dict(op_kwargs),
                         incremental=bool(incremental))

    def step(self, dt: int) -> "_Builder":
        """Sample a ``between`` window every ``dt`` time units (only
        meaningful before :meth:`compute`)."""
        return self._set(_step=int(dt))

    def points(self, n: int) -> "_Builder":
        """Sample a ``between`` window at ``n`` evenly spaced timepoints
        (only meaningful before :meth:`compute`)."""
        return self._set(_points=int(n))

    def build(self) -> GraphQuery:
        f = {k: v for k, v in self._f.items() if not k.startswith("_")}
        return GraphQuery(**f).validate()


class Q:
    """Entry points of the fluent builder (see module docstring)."""

    @staticmethod
    def at(*times: int | Sequence[int]) -> _Builder:
        """``Q.at(t)`` → snapshot; ``Q.at(t1, t2, ...)`` or
        ``Q.at([t1, t2])`` → multipoint."""
        flat: list[int] = []
        for t in times:
            if isinstance(t, (list, tuple)):
                flat.extend(int(x) for x in t)
            else:
                flat.append(int(t))
        if not flat:
            raise DocumentError("Q.at() needs at least one timepoint",
                                position="times")
        if len(flat) == 1:
            return _Builder(kind="snapshot", t=flat[0])
        return _Builder(kind="multipoint", times=tuple(flat))

    @staticmethod
    def between(ts: int, te: int) -> _Builder:
        """``[ts, te)`` interval query; chain :meth:`_Builder.compute` to
        make it an evolve document over the window instead."""
        return _Builder(kind="interval", ts=int(ts), te=int(te))

    @staticmethod
    def expr(text: str, times: Sequence[int]) -> _Builder:
        """Boolean TimeExpression over ``times``, e.g.
        ``Q.expr("t0 & ~t1", [1969, 1973])``."""
        return _Builder(kind="expr", expr=str(text),
                        times=tuple(int(t) for t in times))

    @staticmethod
    def evolve(times: Sequence[int], op: Any = "masks",
               **op_kwargs: Any) -> _Builder:
        """Evolve document over explicit timepoints."""
        return _Builder(kind="evolve", times=tuple(int(t) for t in times),
                        op=op, op_kwargs=dict(op_kwargs))
