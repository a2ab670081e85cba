"""Typed query-error taxonomy.

Every error a query document (or a legacy entry point) can produce on the
way from wire bytes to an executed plan is a :class:`QueryError` carrying
a stable machine-readable ``code``, a human message, and — for parse
errors — the offending position.  Subclasses *also* derive from the
built-in exception the pre-taxonomy code raised (``ValueError`` /
``KeyError``), so existing callers catching the bare built-ins keep
working while wire-facing code can map any failure to a structured
envelope via :meth:`QueryError.to_dict`.
"""
from __future__ import annotations

from typing import Any


class QueryError(Exception):
    """Base of the taxonomy: ``code`` (stable kind slug), ``message``,
    and optional ``position`` (character offset or field name)."""

    code = "query-error"

    def __init__(self, message: str, *, position: Any = None) -> None:
        super().__init__(message)
        self.message = str(message)
        self.position = position

    def __str__(self) -> str:  # KeyError would repr()-quote the message
        return self.message

    def to_dict(self) -> dict:
        """The wire form embedded in error envelopes."""
        return {"kind": self.code, "message": self.message,
                "position": self.position}


class AttrOptionsError(QueryError, ValueError):
    """Malformed ``attr_options`` syntax (paper Table 1 sub-options)."""

    code = "attr-options"


class UnknownAttributeError(QueryError, KeyError):
    """``attr_options`` names an attribute the universe doesn't have."""

    code = "unknown-attribute"


class TimeExpressionError(QueryError, ValueError):
    """Malformed ``TimeExpression`` infix text (or time index overflow)."""

    code = "time-expression"


class DocumentError(QueryError, ValueError):
    """A ``GraphQuery`` document (the query API, not yet ported) is
    structurally invalid: unknown kind/field, missing required field, bad
    type, or an unsupported schema version.  ``position`` is the field name."""

    code = "document"


class UnknownOperatorError(QueryError, ValueError):
    """An evolve document names an operator the temporal engine doesn't
    register."""

    code = "unknown-operator"


class ExecutionError(QueryError, RuntimeError):
    """A validated document failed during plan execution; wraps the
    underlying exception (``__cause__``) for the wire envelope."""

    code = "execution"


class DeadlineError(QueryError, TimeoutError):
    """A request carrying ``deadline_ms`` cannot meet it: either it
    expired while queued, or the planner's decode-aware cost estimate for
    its retrieval already exceeds the remaining budget.  Raised *before*
    execution — a deadline-rejected request performs no KV gets."""

    code = "deadline"


class OverloadedError(QueryError, RuntimeError):
    """Admission control shed this request: queued work (queue depth x
    estimated plan cost) exceeds the scheduler's drain-horizon capacity.
    Clients should back off and retry."""

    code = "overloaded"


class BackpressureError(QueryError, RuntimeError):
    """The session holds too many in-flight pooled snapshots (``lease``
    replies) against its GraphPool byte budget; release leases (or
    disconnect) before issuing more queries."""

    code = "backpressure"
