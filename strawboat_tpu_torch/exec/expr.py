"""Tiny expression DSL for predicates/projections over a DeviceTable.

Counterpart of ``strawboat_tpu/exec/expr.py``.  An expression evaluates to
``(values, validity | None)`` torch tensors; three-valued logic collapses to
"null = filtered out" in :meth:`Expr.mask`.  String literals compare through
the column's sorted host dictionary, so no per-row string work happens.

A column-vs-number comparison carries a zone-map pruning atom
(``pruning.Comparison``), and ``&`` concatenates them; every other
composition clears them, and string comparisons make none, as in the
reference.  ``Query`` hands a filter's atoms to the file scan.

``col``, ``lit`` and every binary operator also record a read-only
description of their node (``Expr.node``: ``("col", name)``, ``("lit",
value)`` or ``(op, left node, right node)``), built on the host with the
expression; nothing evaluates it.  :func:`product_factors` maps one to the
factor form kernel K9 (``kernels/keyed_add.py``) takes.
"""

from __future__ import annotations

import bisect
import operator
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .pruning import Comparison

_OP_NAMES = {
    operator.gt: "gt", operator.ge: "ge", operator.lt: "lt",
    operator.le: "le", operator.eq: "eq", operator.ne: "ne",
}


@dataclass(frozen=True)
class Expr:
    # evaluate → (values, validity|None)
    fn: Callable[[Any], Tuple[Any, Optional[torch.Tensor]]]
    # column names this expression reads (projection pushdown)
    refs: tuple = ()
    # prunable conjunctive atoms (column-vs-literal comparisons); sound
    # only under AND, so every other composition clears them
    atoms: tuple = ()
    # the node's description: ("col", name), ("lit", value) or (op, left
    # node, right node) with op a name of _NODE_NAMES; () where none is kept
    node: tuple = ()

    def _bin(self, other, op) -> "Expr":
        other_e = _as_expr(other)

        def f(t):
            va, ma = self.fn(t)
            vb, mb = other_e.fn(t)
            return op(va, vb), _and_mask(ma, mb)

        atoms = ()
        if (
            op in _OP_NAMES
            and isinstance(self, ColExpr)
            and not isinstance(other, Expr)
            and isinstance(other, (int, float))
        ):
            # the literal keeps its type: an int compares exactly
            atoms = (Comparison(self.name, _OP_NAMES[op], other),)
        if op is _logical_and:
            atoms = self.atoms + other_e.atoms
        return Expr(f, self.refs + other_e.refs, atoms, (_NODE_NAMES[op], self.node, other_e.node))

    def __gt__(self, o):
        return self._bin(o, operator.gt)

    def __ge__(self, o):
        return self._bin(o, operator.ge)

    def __lt__(self, o):
        return self._bin(o, operator.lt)

    def __le__(self, o):
        return self._bin(o, operator.le)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin(o, operator.eq)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin(o, operator.ne)

    def __add__(self, o):
        return self._bin(o, operator.add)

    def __radd__(self, o):
        return _as_expr(o)._bin(self, operator.add)

    def __sub__(self, o):
        return self._bin(o, operator.sub)

    def __rsub__(self, o):
        return _as_expr(o)._bin(self, operator.sub)

    def __mul__(self, o):
        return self._bin(o, operator.mul)

    def __rmul__(self, o):
        return _as_expr(o)._bin(self, operator.mul)

    def __truediv__(self, o):
        return self._bin(o, operator.truediv)

    def __rtruediv__(self, o):
        return _as_expr(o)._bin(self, operator.truediv)

    def __and__(self, o):
        return self._bin(o, _logical_and)

    def __or__(self, o):
        return self._bin(o, _logical_or)

    def __invert__(self):
        def f(t):
            v, m = self.fn(t)
            return torch.logical_not(torch.as_tensor(v)), m

        return Expr(f, refs=self.refs)

    def is_null(self) -> "Expr":
        def f(t):
            v, m = self.fn(t)
            if m is None:
                return torch.zeros_like(torch.as_tensor(v), dtype=torch.bool), None
            return torch.logical_not(m), None

        return Expr(f, refs=self.refs)

    def evaluate(self, table):
        v, _ = self.fn(table)
        return v

    def mask(self, table) -> torch.Tensor:
        """Predicate → boolean selection mask (nulls excluded)."""
        v, m = self.fn(table)
        v = torch.as_tensor(v).to(torch.bool)
        return v if m is None else torch.logical_and(v, m)


def _logical_and(a, b):
    return torch.logical_and(torch.as_tensor(a), torch.as_tensor(b))


def _logical_or(a, b):
    return torch.logical_or(torch.as_tensor(a), torch.as_tensor(b))


_NODE_NAMES = {
    **_OP_NAMES, operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "truediv", _logical_and: "and", _logical_or: "or",
}


def _and_mask(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


def _as_expr(x) -> Expr:
    if isinstance(x, Expr):
        return x
    return lit(x)


def col(name: str) -> "ColExpr":
    def f(t):
        c = t[name]
        return c.values, c.validity

    return ColExpr(f, refs=(name,), node=("col", name), name=name)


def _as_bytes(v):
    return v.encode() if isinstance(v, str) else v


def _dict_bytes(dictionary: np.ndarray) -> list:
    """Dictionary values as bytes: literals compare byte-wise, as arrow's
    binary compare does in the reference."""
    return [_as_bytes(v) for v in dictionary]


@dataclass(frozen=True)
class ColExpr(Expr):
    """Column reference; translates string literals through the column's
    host dictionary into code comparisons."""

    name: str = ""

    def _str_cmp(self, literal, negate: bool) -> Expr:
        def f(t):
            c = t[self.name]
            code = -1
            if c.dictionary is not None:
                try:
                    code = _dict_bytes(c.dictionary).index(_as_bytes(literal))
                except ValueError:
                    code = -1
            if code < 0:
                eq = torch.zeros(c.values.shape, dtype=torch.bool, device=c.values.device)
            else:
                eq = c.values == code
            return (torch.logical_not(eq) if negate else eq), c.validity

        return Expr(f, refs=(self.name,))

    def __eq__(self, o):  # type: ignore[override]
        if isinstance(o, (str, bytes)):
            return self._str_cmp(o, negate=False)
        return super().__eq__(o)

    def __ne__(self, o):  # type: ignore[override]
        if isinstance(o, (str, bytes)):
            return self._str_cmp(o, negate=True)
        return super().__ne__(o)

    def _str_range(self, literal, op: str) -> Expr:
        """Lexical <, <=, >, >= against a string literal: codes remap through
        the dictionary's sorted rank and the literal becomes a rank
        threshold."""

        def f(t):
            c = t[self.name]
            if c.dictionary is None:
                raise NotImplementedError(
                    f"string comparison on non-dictionary column {self.name!r}"
                )
            d = _dict_bytes(c.dictionary)
            order = sorted(range(len(d)), key=d.__getitem__)
            rank = np.empty(len(d), dtype=np.int32)
            rank[order] = np.arange(len(d), dtype=np.int32)
            sorted_vals = [d[i] for i in order]
            lit_b = _as_bytes(literal)
            lo = bisect.bisect_left(sorted_vals, lit_b)
            hi = bisect.bisect_right(sorted_vals, lit_b)
            rank_t = torch.from_numpy(rank).to(c.values.device)
            r = rank_t[c.values.long().clamp(0, len(rank) - 1)]
            if op == "lt":
                m = r < lo
            elif op == "le":
                m = r < hi
            elif op == "gt":
                m = r >= hi
            else:  # ge
                m = r >= lo
            return m, c.validity

        return Expr(f, refs=(self.name,))

    def __lt__(self, o):
        if isinstance(o, (str, bytes)):
            return self._str_range(o, "lt")
        return super().__lt__(o)

    def __le__(self, o):
        if isinstance(o, (str, bytes)):
            return self._str_range(o, "le")
        return super().__le__(o)

    def __gt__(self, o):
        if isinstance(o, (str, bytes)):
            return self._str_range(o, "gt")
        return super().__gt__(o)

    def __ge__(self, o):
        if isinstance(o, (str, bytes)):
            return self._str_range(o, "ge")
        return super().__ge__(o)

    def isin(self, values) -> Expr:
        def f(t):
            c = t[self.name]
            if c.dictionary is not None:
                lits = {_as_bytes(v) for v in values}
                codes = [i for i, v in enumerate(_dict_bytes(c.dictionary)) if v in lits]
                if not codes:
                    m = torch.zeros(c.values.shape, dtype=torch.bool, device=c.values.device)
                    return m, c.validity
                codes_t = torch.tensor(codes, dtype=c.values.dtype, device=c.values.device)
                return torch.isin(c.values, codes_t), c.validity
            m = torch.zeros(c.values.shape, dtype=torch.bool, device=c.values.device)
            for v in values:
                m = torch.logical_or(m, c.values == v)
            return m, c.validity

        return Expr(f, refs=(self.name,))


def lit(value) -> Expr:
    """A literal: a Python scalar, which torch broadcasts in every op."""

    def f(t):
        return value, None

    return Expr(f, node=("lit", value))


def _int_literal(node) -> bool:
    return node[:1] == ("lit",) and type(node[1]) is int


def _factor(node):
    """One factor of :func:`product_factors`, or None."""
    if node[:1] == ("col",):
        return ("col", 0, node[1])
    if len(node) == 3 and node[0] in ("add", "sub"):
        op, a, b = node
        if _int_literal(a) and b[:1] == ("col",):
            return (op, a[1], b[1])
        if op == "add" and a[:1] == ("col",) and _int_literal(b):
            return ("add", b[1], a[1])
    return None


def product_factors(node: tuple):
    """K9's factor form of a summed value's description (``Expr.node``):
    a product of one or two factors, each ``("col", 0, name)`` (the
    column), ``("sub", literal, name)`` (literal − column) or ``("add",
    literal, name)`` (literal + column), the literal a Python int; None
    for any other shape."""
    parts = (node[1], node[2]) if node[:1] == ("mul",) else (node,)
    factors = tuple(_factor(p) for p in parts)
    return None if None in factors else factors
