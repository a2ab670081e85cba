"""Query-side option parsing (paper §3.2.1, Table 1) and TimeExpressions.

``attr_options`` strings concatenate sub-options; the default is *no*
attributes::

    "+node:all-node:salary+edge:name"

selects every node attribute except ``salary`` plus the edge attribute
``name``.  A :class:`TimeExpression` is a multinomial Boolean expression
over k time points, e.g. ``t1 ∧ ¬t2`` → components valid at t1 but not t2.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence

import numpy as np

from .errors import (AttrOptionsError, TimeExpressionError,
                     UnknownAttributeError)
from .events import GraphUniverse

_OPT_RE = re.compile(r"([+-])(node|edge):([A-Za-z0-9_.]+|all)")


@dataclasses.dataclass(frozen=True)
class AttrOptions:
    """Resolved attribute column selections.  ``None`` ⇒ all columns."""

    node_cols: tuple[int, ...]
    edge_cols: tuple[int, ...]

    @property
    def wants_node(self) -> bool:
        return len(self.node_cols) > 0

    @property
    def wants_edge(self) -> bool:
        return len(self.edge_cols) > 0

    @property
    def wants_attrs(self) -> bool:
        return self.wants_node or self.wants_edge

    def node_col_array(self) -> np.ndarray:
        return np.asarray(self.node_cols, np.int16)

    def edge_col_array(self) -> np.ndarray:
        return np.asarray(self.edge_cols, np.int16)


def parse_attr_options(spec: str, universe: GraphUniverse) -> AttrOptions:
    """Parse an attr_options string against the universe's attribute tables.

    Later sub-options override earlier ones for a specific attribute, and
    specific attributes override ``all`` (Table 1).

    Errors are typed (:mod:`repro_torch.core.errors`): syntax problems raise
    :class:`AttrOptionsError` and unknown attribute names raise
    :class:`UnknownAttributeError`, both carrying the character position —
    and both still catchable as the pre-taxonomy ``ValueError`` /
    ``KeyError``.
    """
    node_sel: dict[int, bool] = {}
    edge_sel: dict[int, bool] = {}
    node_all = False
    edge_all = False
    pos = 0
    for m in _OPT_RE.finditer(spec or ""):
        if m.start() != pos:
            raise AttrOptionsError(f"bad attr_options near {spec[pos:]!r}",
                                   position=pos)
        pos = m.end()
        sign, kind, name = m.group(1) == "+", m.group(2), m.group(3)
        table = (universe.node_attr_cols if kind == "node"
                 else universe.edge_attr_cols)
        sel = node_sel if kind == "node" else edge_sel
        if name == "all":
            if kind == "node":
                node_all = sign
            else:
                edge_all = sign
            sel.clear()  # `all` resets prior per-attribute overrides
        else:
            if name not in table:
                raise UnknownAttributeError(
                    f"unknown {kind} attribute {name!r}",
                    position=m.start(3))
            sel[table[name]] = sign
    if pos != len(spec or ""):
        raise AttrOptionsError(f"bad attr_options near {spec[pos:]!r}",
                               position=pos)

    def resolve(all_flag: bool, sel: dict[int, bool], n: int) -> tuple[int, ...]:
        cols = set(range(n)) if all_flag else set()
        for c, s in sel.items():
            (cols.add if s else cols.discard)(c)
        return tuple(sorted(cols))

    return AttrOptions(resolve(node_all, node_sel, universe.num_node_attrs),
                       resolve(edge_all, edge_sel, universe.num_edge_attrs))


NO_ATTRS = AttrOptions((), ())


# ---------------------------------------------------------------------------
# TimeExpression (paper §3.2.1): Boolean expression over k time points
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TimeExpression:
    """``times`` is the list [t_1..t_k]; ``expr`` is a nested tuple tree:
    ``("and"|"or", e1, e2)`` / ``("not", e)`` / ``("t", i)``.

    ``TimeExpression.parse("t0 & ~t1", [t0, t1])`` builds one from infix
    syntax (&, |, ~, parentheses).
    """

    times: Sequence[int]
    expr: tuple

    def to_infix(self) -> str:
        """Render back to the infix syntax :meth:`parse` accepts, with
        minimal parentheses (``~`` binds tightest, then ``&``, then ``|``;
        both binary operators are left-associative).  Round-trip law —
        pinned by the property tests in ``tests/test_query_parse.py``::

            TimeExpression.parse(tex.to_infix(), tex.times).expr == tex.expr
        """
        def go(e: tuple, prec: int) -> str:
            op = e[0]
            if op == "t":
                return f"t{e[1]}"
            if op == "not":
                return "~" + go(e[1], 3)
            sym, p = ("&", 2) if op == "and" else ("|", 1)
            s = go(e[1], p) + sym + go(e[2], p + 1)
            return f"({s})" if p < prec else s
        return go(self.expr, 0)

    def evaluate(self, masks: Sequence[np.ndarray]) -> np.ndarray:
        def ev(e) -> np.ndarray:
            op = e[0]
            if op == "t":
                return masks[e[1]]
            if op == "not":
                return ~ev(e[1])
            a, b = ev(e[1]), ev(e[2])
            return (a & b) if op == "and" else (a | b)
        return ev(self.expr)

    @staticmethod
    def parse(text: str, times: Sequence[int]) -> "TimeExpression":
        """Parse infix syntax.  Errors raise
        :class:`~repro_torch.core.errors.TimeExpressionError` (a ``ValueError``
        subclass) carrying the character position in the de-spaced input.
        """
        src = text.replace(" ", "")
        tokens: list[str] = []
        spans: list[int] = []          # start offset of each token in src
        scan = 0
        for m in re.finditer(r"t\d+|[()&|~]", src):
            if m.start() != scan:
                raise TimeExpressionError(
                    f"bad TimeExpression {text!r}", position=scan)
            tokens.append(m.group(0))
            spans.append(m.start())
            scan = m.end()
        if scan != len(src):
            raise TimeExpressionError(f"bad TimeExpression {text!r}",
                                      position=scan)
        pos = 0

        def peek():
            return tokens[pos] if pos < len(tokens) else None

        def eat(tok=None):
            nonlocal pos
            if pos >= len(tokens):  # truncated input, e.g. "(t0"
                raise TimeExpressionError(
                    f"unexpected end of TimeExpression {text!r}"
                    + (f" (expected {tok})" if tok else ""),
                    position=len(src))
            t = tokens[pos]
            if tok and t != tok:
                raise TimeExpressionError(f"expected {tok} got {t}",
                                          position=spans[pos])
            pos += 1
            return t

        def atom():
            t = peek()
            if t == "(":
                eat("(")
                e = expr()
                eat(")")
                return e
            if t == "~":
                eat("~")
                return ("not", atom())
            if t and t.startswith("t"):
                at = spans[pos]
                eat()
                i = int(t[1:])
                if i >= len(times):
                    raise TimeExpressionError(f"time index {t} out of range",
                                              position=at)
                return ("t", i)
            raise TimeExpressionError(
                f"unexpected token {t!r}",
                position=spans[pos] if pos < len(tokens) else len(src))

        def conj():
            e = atom()
            while peek() == "&":
                eat("&")
                e = ("and", e, atom())
            return e

        def expr():
            e = conj()
            while peek() == "|":
                eat("|")
                e = ("or", e, conj())
            return e

        tree = expr()
        if pos != len(tokens):
            raise TimeExpressionError(f"trailing tokens in {text!r}",
                                      position=spans[pos])
        return TimeExpression(times, tree)
