"""Recursive-descent SQL parser → a small AST (``sql/binder.py`` binds it
against a catalog schema into ``plan/ir.py`` trees); the JAX package's
``sql/parser.py``, copied.

Grammar (the supported dialect)::

    query       := select (UNION ALL select)*
    select      := SELECT [DISTINCT] item (',' item)*
                   FROM table_ref join*
                   [WHERE pred] [GROUP BY group_spec] [HAVING pred]
                   [ORDER BY order_key (',' order_key)*] [LIMIT int]
    item        := '*' | column [AS? alias] | agg_fn [AS? alias]
                 | win_fn OVER '(' [PARTITION BY columns]
                                  [ORDER BY order_keys] ')' [AS? alias]
    table_ref   := name [AS? alias] | '(' query ')' [AS? alias]
    join        := [INNER | LEFT [OUTER] | LEFT SEMI | LEFT ANTI] JOIN
                   table_ref ON column '=' column (AND column '=' column)*
    group_spec  := columns | ROLLUP '(' columns ')' | CUBE '(' columns ')'
                 | GROUPING SETS '(' set (',' set)* ')'     set := '(' columns? ')'
    agg_fn      := (SUM|COUNT|AVG|MIN|MAX|STD|STDDEV|FIRST|LAST) '(' column ')'
                 | COUNT '(' DISTINCT column ')'
    win_fn      := (ROW_NUMBER|RANK|DENSE_RANK) '(' ')'
                 | (SUM|LAG|LEAD) '(' column ')'
    pred        := or_pred;  or_pred := and_pred (OR and_pred)*
    and_pred    := term (AND term)*
    term        := '(' pred ')' | column BETWEEN value AND value
                 | column [NOT] IN '(' value (',' value)* ')'
                 | column cmp scalar
    scalar      := scalar_term ('*' scalar_term)*
    scalar_term := value | agg_fn          -- agg only meaningful in HAVING
    value       := number | string | ':' name
    cmp         := '=' | '!=' | '<>' | '<' | '<=' | '>' | '>='

Keywords are case-insensitive; every AST node carries the 1-based
``(line, col)`` of its anchor token so the binder's errors point carets
at the offending name.  :func:`to_sql` renders an AST back to text that
re-parses to an equivalent AST (the round-trip tests pin this).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from .tokenizer import (EOF, IDENT, NUMBER, OP, PARAM, STRING, SqlError,
                        Token, tokenize)

# words that terminate an implicit alias position
_RESERVED = {
    "SELECT", "DISTINCT", "FROM", "JOIN", "INNER", "LEFT", "OUTER", "SEMI",
    "ANTI", "ON", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "UNION", "ALL", "AND", "OR", "NOT", "IN", "BETWEEN", "AS", "ASC",
    "DESC", "OVER", "PARTITION", "ROLLUP", "CUBE", "GROUPING", "SETS",
}

_AGG_FNS = {"SUM": "sum", "COUNT": "count", "AVG": "mean", "MIN": "min",
            "MAX": "max", "STD": "std", "STDDEV": "std", "FIRST": "first",
            "LAST": "last"}
_WIN_NOARG = {"ROW_NUMBER": "row_number", "RANK": "rank",
              "DENSE_RANK": "dense_rank"}
_WIN_VALUE = {"SUM": "running_sum", "LAG": "lag", "LEAD": "lead"}


# --- AST --------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class ColRef(Node):
    name: str
    qual: Optional[str] = None
    pos: Tuple[int, int] = (1, 1)

    def __str__(self):
        return f"{self.qual}.{self.name}" if self.qual else self.name


@dataclass(frozen=True)
class Value(Node):
    """Literal or named parameter (``param`` set)."""
    value: Any = None
    param: Optional[str] = None
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class AggFunc(Node):
    fn: str                      # ops fn name (sum/mean/count/nunique/...)
    arg: ColRef = None
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class WinFunc(Node):
    fn: str                      # row_number/rank/dense_rank/running_sum/...
    value: Optional[ColRef]
    partition: Tuple[ColRef, ...]
    order: Tuple[Tuple[ColRef, bool], ...]      # (col, ascending)
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class Star(Node):
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class Cmp(Node):
    op: str                      # == != < <= > >=
    left: ColRef = None
    right: Node = None           # Value | AggFunc | MulOp
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class MulOp(Node):
    left: Node = None
    right: Node = None


@dataclass(frozen=True)
class BetweenPred(Node):
    col: ColRef = None
    lo: Value = None
    hi: Value = None


@dataclass(frozen=True)
class InPred(Node):
    col: ColRef = None
    values: Tuple[Value, ...] = ()


@dataclass(frozen=True)
class AndPred(Node):
    parts: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class OrPred(Node):
    parts: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class TableRef(Node):
    name: Optional[str] = None          # base table ...
    subquery: Optional["Query"] = None  # ... or derived table
    alias: Optional[str] = None
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class JoinClause(Node):
    how: str                            # inner/left/semi/anti
    table: TableRef = None
    on: Tuple[Tuple[ColRef, ColRef], ...] = ()
    pos: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class GroupSpec(Node):
    kind: str                           # plain/rollup/cube/sets
    cols: Tuple[ColRef, ...] = ()
    sets: Optional[Tuple[Tuple[ColRef, ...], ...]] = None


@dataclass(frozen=True)
class Select(Node):
    items: Tuple[SelectItem, ...]
    table: TableRef
    joins: Tuple[JoinClause, ...] = ()
    distinct: bool = False
    where: Optional[Node] = None
    group: Optional[GroupSpec] = None
    having: Optional[Node] = None
    order: Tuple[Tuple[str, bool, Tuple[int, int]], ...] = ()
    limit: Optional[int] = None


@dataclass(frozen=True)
class Query(Node):
    """One SELECT, or a UNION ALL chain of them."""
    selects: Tuple[Select, ...]


# --- parser -----------------------------------------------------------------


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0

    # . cursor helpers ......................................................

    @property
    def tok(self) -> Token:
        return self.toks[self.i]

    def _err(self, message: str, tok: Optional[Token] = None):
        tok = tok or self.tok
        raise SqlError(message, self.text, tok.line, tok.col)

    def at_kw(self, *words: str) -> bool:
        t = self.tok
        return t.kind == IDENT and t.upper in words

    def take_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.i += 1
            return True
        return False

    def expect_kw(self, word: str) -> Token:
        if not self.at_kw(word):
            self._err(f"expected {word}")
        t = self.tok
        self.i += 1
        return t

    def at_op(self, *syms: str) -> bool:
        t = self.tok
        return t.kind == OP and t.value in syms

    def take_op(self, *syms: str) -> bool:
        if self.at_op(*syms):
            self.i += 1
            return True
        return False

    def expect_op(self, sym: str) -> Token:
        if not self.at_op(sym):
            self._err(f"expected {sym!r}")
        t = self.tok
        self.i += 1
        return t

    def ident(self, what: str = "identifier") -> Token:
        t = self.tok
        if t.kind != IDENT or t.upper in _RESERVED:
            self._err(f"expected {what}")
        self.i += 1
        return t

    # . grammar ..............................................................

    def query(self) -> Query:
        selects = [self.select()]
        while self.take_kw("UNION"):
            self.expect_kw("ALL")      # only UNION ALL (no dedup UNION)
            selects.append(self.select())
        return Query(tuple(selects))

    def select(self) -> Select:
        self.expect_kw("SELECT")
        distinct = self.take_kw("DISTINCT")
        items = [self.select_item()]
        while self.take_op(","):
            items.append(self.select_item())
        self.expect_kw("FROM")
        table = self.table_ref()
        joins = []
        while self.at_kw("JOIN", "INNER", "LEFT"):
            joins.append(self.join_clause())
        where = self.pred() if self.take_kw("WHERE") else None
        group = None
        if self.take_kw("GROUP"):
            self.expect_kw("BY")
            group = self.group_spec()
        having = self.pred() if self.take_kw("HAVING") else None
        order: List[Tuple[str, bool, Tuple[int, int]]] = []
        if self.take_kw("ORDER"):
            self.expect_kw("BY")
            order.append(self.order_key())
            while self.take_op(","):
                order.append(self.order_key())
        limit = None
        if self.take_kw("LIMIT"):
            t = self.tok
            if t.kind != NUMBER or not isinstance(t.value, int):
                self._err("expected integer LIMIT")
            limit = t.value
            self.i += 1
        return Select(tuple(items), table, tuple(joins), distinct, where,
                      group, having, tuple(order), limit)

    def select_item(self) -> SelectItem:
        t = self.tok
        if self.take_op("*"):
            return SelectItem(Star((t.line, t.col)), None, (t.line, t.col))
        expr = self.select_expr()
        alias = None
        if self.take_kw("AS"):
            alias = self.ident("alias").value
        elif self.tok.kind == IDENT and self.tok.upper not in _RESERVED:
            alias = self.ident("alias").value
        return SelectItem(expr, alias, (t.line, t.col))

    def select_expr(self) -> Node:
        t = self.tok
        if t.kind != IDENT:
            self._err("expected column or function")
        up = t.upper
        is_call = (self.toks[self.i + 1].kind == OP
                   and self.toks[self.i + 1].value == "(")
        if is_call and (up in _AGG_FNS or up in _WIN_NOARG
                        or up in _WIN_VALUE):
            return self.func_call()
        if up in _RESERVED:
            self._err("expected column or function")
        return self.colref()

    def func_call(self) -> Node:
        """``FN(...)`` — an aggregate, or (followed by OVER) a window."""
        t = self.tok
        up = t.upper
        self.i += 1
        self.expect_op("(")
        pos = (t.line, t.col)
        arg = None
        distinct_arg = False
        if not self.at_op(")"):
            distinct_arg = self.take_kw("DISTINCT")
            arg = self.colref()
        self.expect_op(")")
        if self.at_kw("OVER"):
            fn = _WIN_NOARG.get(up) or _WIN_VALUE.get(up)
            if fn is None:
                self._err(f"{t.value} is not a window function", t)
            if fn in _WIN_NOARG.values() and arg is not None:
                self._err(f"{t.value}() takes no argument", t)
            if fn in _WIN_VALUE.values() and arg is None:
                self._err(f"{t.value}(...) needs a value column", t)
            self.i += 1
            return self.over_clause(fn, arg, pos)
        if up not in _AGG_FNS:
            self._err(f"{t.value} is not an aggregate function", t)
        if arg is None:
            self._err(f"{t.value}(*) unsupported; name a column", t)
        fn = _AGG_FNS[up]
        if distinct_arg:
            if up != "COUNT":
                self._err("DISTINCT argument only for COUNT", t)
            fn = "nunique"
        return AggFunc(fn, arg, pos)

    def over_clause(self, fn: str, value: Optional[ColRef],
                    pos) -> WinFunc:
        self.expect_op("(")
        partition: List[ColRef] = []
        order: List[Tuple[ColRef, bool]] = []
        if self.take_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self.colref())
            while self.take_op(","):
                partition.append(self.colref())
        if self.take_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                c = self.colref()
                asc = True
                if self.take_kw("DESC"):
                    asc = False
                else:
                    self.take_kw("ASC")
                order.append((c, asc))
                if not self.take_op(","):
                    break
        self.expect_op(")")
        return WinFunc(fn, value, tuple(partition), tuple(order), pos)

    def colref(self) -> ColRef:
        t = self.ident("column")
        if self.take_op("."):
            t2 = self.ident("column")
            return ColRef(t2.value, t.value, (t2.line, t2.col))
        return ColRef(t.value, None, (t.line, t.col))

    def table_ref(self) -> TableRef:
        t = self.tok
        if self.take_op("("):
            sub = self.query()
            self.expect_op(")")
            alias = self._opt_alias()
            return TableRef(None, sub, alias, (t.line, t.col))
        name = self.ident("table name")
        return TableRef(name.value, None, self._opt_alias(),
                        (name.line, name.col))

    def _opt_alias(self) -> Optional[str]:
        if self.take_kw("AS"):
            return self.ident("alias").value
        if self.tok.kind == IDENT and self.tok.upper not in _RESERVED:
            return self.ident("alias").value
        return None

    def join_clause(self) -> JoinClause:
        t = self.tok
        how = "inner"
        if self.take_kw("INNER"):
            pass
        elif self.take_kw("LEFT"):
            if self.take_kw("SEMI"):
                how = "semi"
            elif self.take_kw("ANTI"):
                how = "anti"
            else:
                self.take_kw("OUTER")
                how = "left"
        self.expect_kw("JOIN")
        table = self.table_ref()
        self.expect_kw("ON")
        on = [self._on_pair()]
        while self.take_kw("AND"):
            on.append(self._on_pair())
        return JoinClause(how, table, tuple(on), (t.line, t.col))

    def _on_pair(self) -> Tuple[ColRef, ColRef]:
        a = self.colref()
        self.expect_op("=")
        return a, self.colref()

    def group_spec(self) -> GroupSpec:
        if self.take_kw("ROLLUP"):
            return GroupSpec("rollup", self._paren_cols())
        if self.take_kw("CUBE"):
            return GroupSpec("cube", self._paren_cols())
        if self.take_kw("GROUPING"):
            self.expect_kw("SETS")
            self.expect_op("(")
            sets = [self._paren_cols(allow_empty=True)]
            while self.take_op(","):
                sets.append(self._paren_cols(allow_empty=True))
            self.expect_op(")")
            # keys = first appearance order across the sets
            cols: List[ColRef] = []
            seen = set()
            for s in sets:
                for c in s:
                    if str(c) not in seen:
                        seen.add(str(c))
                        cols.append(c)
            return GroupSpec("sets", tuple(cols), tuple(sets))
        cols = [self.colref()]
        while self.take_op(","):
            cols.append(self.colref())
        return GroupSpec("plain", tuple(cols))

    def _paren_cols(self, allow_empty: bool = False) -> Tuple[ColRef, ...]:
        self.expect_op("(")
        cols: List[ColRef] = []
        if not self.at_op(")"):
            cols.append(self.colref())
            while self.take_op(","):
                cols.append(self.colref())
        if not cols and not allow_empty:
            self._err("expected column list")
        self.expect_op(")")
        return tuple(cols)

    def order_key(self) -> Tuple[str, bool, Tuple[int, int]]:
        # a qualifier is accepted but dropped: ORDER BY binds against the
        # select list's output names, which never carry one
        c = self.colref()
        asc = True
        if self.take_kw("DESC"):
            asc = False
        else:
            self.take_kw("ASC")
        return c.name, asc, c.pos

    # . predicates ...........................................................

    def pred(self) -> Node:
        parts = [self.and_pred()]
        while self.take_kw("OR"):
            parts.append(self.and_pred())
        return parts[0] if len(parts) == 1 else OrPred(tuple(parts))

    def and_pred(self) -> Node:
        parts = [self.pred_term()]
        while self.take_kw("AND"):
            parts.append(self.pred_term())
        return parts[0] if len(parts) == 1 else AndPred(tuple(parts))

    def pred_term(self) -> Node:
        if self.take_op("("):
            p = self.pred()
            self.expect_op(")")
            return p
        col = self.colref()
        if self.take_kw("BETWEEN"):
            lo = self.value()
            self.expect_kw("AND")
            return BetweenPred(col, lo, self.value())
        if self.take_kw("IN"):
            self.expect_op("(")
            vals = [self.value()]
            while self.take_op(","):
                vals.append(self.value())
            self.expect_op(")")
            return InPred(col, tuple(vals))
        t = self.tok
        if not self.at_op("=", "!=", "<>", "<", "<=", ">", ">="):
            self._err("expected comparison operator")
        self.i += 1
        op = {"=": "==", "<>": "!="}.get(t.value, t.value)
        return Cmp(op, col, self.scalar(), (t.line, t.col))

    def scalar(self) -> Node:
        left = self.scalar_term()
        while self.take_op("*"):
            left = MulOp(left, self.scalar_term())
        return left

    def scalar_term(self) -> Node:
        t = self.tok
        if t.kind in (NUMBER, STRING, PARAM):
            return self.value()
        if (t.kind == IDENT and t.upper in _AGG_FNS
                and self.toks[self.i + 1].kind == OP
                and self.toks[self.i + 1].value == "("):
            fn = self.func_call()
            if not isinstance(fn, AggFunc):
                self._err("window function not allowed here", t)
            return fn
        self._err("expected literal, :param, or aggregate")

    def value(self) -> Value:
        t = self.tok
        if t.kind == NUMBER or t.kind == STRING:
            self.i += 1
            return Value(t.value, None, (t.line, t.col))
        if t.kind == PARAM:
            self.i += 1
            return Value(None, t.value, (t.line, t.col))
        self._err("expected literal or :param")


def parse(text: str) -> Query:
    """Parse ``text`` into a :class:`Query` AST; :class:`SqlError` (with
    source caret) on any syntax error, including trailing garbage."""
    p = _Parser(text)
    q = p.query()
    p.take_op(";")
    if p.tok.kind != EOF:
        p._err("unexpected trailing input")
    return q


# --- rendering (AST → SQL text) ---------------------------------------------


def _render_value(v: Value) -> str:
    if v.param is not None:
        return f":{v.param}"
    if isinstance(v.value, str):
        return "'" + v.value + "'"
    return repr(v.value)


def _render_scalar(e: Node) -> str:
    if isinstance(e, Value):
        return _render_value(e)
    if isinstance(e, AggFunc):
        if e.fn == "nunique":
            return f"COUNT(DISTINCT {e.arg})"
        up = {v: k for k, v in _AGG_FNS.items()}
        return f"{up[e.fn]}({e.arg})"
    if isinstance(e, MulOp):
        return f"{_render_scalar(e.left)} * {_render_scalar(e.right)}"
    raise SqlError(f"unrenderable scalar {type(e).__name__}")


def _render_pred(p: Node) -> str:
    if isinstance(p, Cmp):
        op = {"==": "=", "!=": "<>"}.get(p.op, p.op)
        return f"{p.left} {op} {_render_scalar(p.right)}"
    if isinstance(p, BetweenPred):
        return (f"{p.col} BETWEEN {_render_value(p.lo)} "
                f"AND {_render_value(p.hi)}")
    if isinstance(p, InPred):
        return (f"{p.col} IN ("
                + ", ".join(_render_value(v) for v in p.values) + ")")
    if isinstance(p, AndPred):
        return " AND ".join(
            f"({_render_pred(x)})" if isinstance(x, OrPred)
            else _render_pred(x) for x in p.parts)
    if isinstance(p, OrPred):
        return "(" + " OR ".join(
            f"({_render_pred(x)})" if isinstance(x, (AndPred, OrPred))
            else _render_pred(x) for x in p.parts) + ")"
    raise SqlError(f"unrenderable predicate {type(p).__name__}")


def _render_item(it: SelectItem) -> str:
    e = it.expr
    if isinstance(e, Star):
        return "*"
    if isinstance(e, ColRef):
        body = str(e)
    elif isinstance(e, AggFunc):
        body = _render_scalar(e)
    elif isinstance(e, WinFunc):
        noarg = {v: k for k, v in _WIN_NOARG.items()}
        if e.fn in noarg:
            head = f"{noarg[e.fn]}()"
        else:
            byval = {v: k for k, v in _WIN_VALUE.items()}
            head = f"{byval[e.fn]}({e.value})"
        inner = []
        if e.partition:
            inner.append("PARTITION BY "
                         + ", ".join(str(c) for c in e.partition))
        if e.order:
            inner.append("ORDER BY " + ", ".join(
                f"{c}" + ("" if asc else " DESC") for c, asc in e.order))
        body = f"{head} OVER ({' '.join(inner)})"
    else:
        raise SqlError(f"unrenderable select item {type(e).__name__}")
    return body + (f" AS {it.alias}" if it.alias else "")


def _render_table(tr: TableRef) -> str:
    body = tr.name if tr.subquery is None else f"({to_sql(tr.subquery)})"
    return body + (f" AS {tr.alias}" if tr.alias else "")


def _render_select(s: Select) -> str:
    parts = ["SELECT " + ("DISTINCT " if s.distinct else "")
             + ", ".join(_render_item(it) for it in s.items),
             "FROM " + _render_table(s.table)]
    for j in s.joins:
        kw = {"inner": "JOIN", "left": "LEFT JOIN",
              "semi": "LEFT SEMI JOIN", "anti": "LEFT ANTI JOIN"}[j.how]
        on = " AND ".join(f"{a} = {b}" for a, b in j.on)
        parts.append(f"{kw} {_render_table(j.table)} ON {on}")
    if s.where is not None:
        parts.append("WHERE " + _render_pred(s.where))
    if s.group is not None:
        g = s.group
        if g.kind == "plain":
            body = ", ".join(str(c) for c in g.cols)
        elif g.kind == "sets":
            body = ("GROUPING SETS ("
                    + ", ".join("(" + ", ".join(str(c) for c in st) + ")"
                                for st in g.sets) + ")")
        else:
            body = (g.kind.upper() + "("
                    + ", ".join(str(c) for c in g.cols) + ")")
        parts.append("GROUP BY " + body)
    if s.having is not None:
        parts.append("HAVING " + _render_pred(s.having))
    if s.order:
        parts.append("ORDER BY " + ", ".join(
            name + ("" if asc else " DESC") for name, asc, _pos in s.order))
    if s.limit is not None:
        parts.append(f"LIMIT {s.limit}")
    return "\n".join(parts)


def to_sql(q: Query) -> str:
    """Render an AST back to SQL text (parse → to_sql → parse is stable:
    the re-parsed AST binds to a fingerprint-identical plan tree)."""
    return "\nUNION ALL\n".join(_render_select(s) for s in q.selects)
