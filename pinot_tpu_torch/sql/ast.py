"""SQL expression AST.

Mirrors the reference's thrift expression model
(`pinot-common/src/thrift/query.thrift` -> `PinotQuery`/`Expression`): every node is a
Literal, an Identifier, or a Function call — operators are normalized to canonical function
names (`plus`, `eq`, `and`, ...), exactly like the reference's
`RequestUtils.getFunctionExpression` canonicalization. This keeps the compiler uniform: one
recursive walk lowers any expression to device ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union

Expr = Union["Literal", "Identifier", "Function"]


@dataclass(frozen=True)
class Literal:
    value: Any  # python int/float/str/bool/None

    def __repr__(self) -> str:
        return f"lit({self.value!r})"


@dataclass(frozen=True)
class Identifier:
    name: str

    def __repr__(self) -> str:
        return f"col({self.name})"


@dataclass(frozen=True)
class Function:
    name: str  # canonical lowercase: plus, times, eq, and, sum, count, ...
    args: Tuple[Expr, ...]
    distinct: bool = False  # COUNT(DISTINCT x)

    def __repr__(self) -> str:
        d = "distinct " if self.distinct else ""
        return f"{self.name}({d}{', '.join(map(repr, self.args))})"


@dataclass(eq=False)
class Subquery:
    """A column subquery operand: `x IN (SELECT col FROM t ...)`. Never
    compiled directly — the multistage planner lowers the enclosing
    `in_subquery`/`not_in_subquery` function into a SEMI/ANTI join before
    compilation, so MEMBERSHIP deliberately excludes those names."""

    stmt: "QueryStatement"

    def __repr__(self) -> str:
        return f"subquery({self.stmt.table})"


STAR = Identifier("*")

# canonical operator names (reference: FilterKind + arithmetic function names)
COMPARISONS = {"eq", "neq", "gt", "gte", "lt", "lte"}
LOGICAL = {"and", "or", "not"}
MEMBERSHIP = {"in", "not_in", "between", "like", "not_like", "regexp_like",
              "is_null", "is_not_null", "text_match", "json_match"}
FILTER_FUNCTIONS = COMPARISONS | LOGICAL | MEMBERSHIP

# aggregation functions (subset of the reference's AggregationFunctionType,
# pinot-segment-spi/.../AggregationFunctionType.java:31-80)
AGGREGATION_FUNCTIONS = {
    "count", "sum", "min", "max", "avg", "minmaxrange",
    "distinctcount", "distinctcounthll", "distinctcountbitmap",
    "distinctcountthetasketch", "distinctcountrawthetasketch",
    "percentile", "percentileest", "percentiletdigest", "percentilerawtdigest",
    "sumprecision", "mode",
    # multi-value variants (reference: CountMVAggregationFunction family)
    "countmv", "summv", "minmv", "maxmv", "avgmv", "distinctcountmv",
    "distinctsummv", "distinctavgmv",
    # moments / stats (reference: VarianceAggregationFunction + fourth moment)
    "varpop", "var_pop", "varsamp", "var_samp",
    "stddevpop", "stddev_pop", "stddevsamp", "stddev_samp",
    "skewness", "kurtosis", "covarpop", "covar_pop", "covarsamp", "covar_samp",
    "corr", "firstwithtime", "lastwithtime", "histogram",
    "distinctsum", "distinctavg", "booland", "bool_and", "boolor", "bool_or",
    # id-set building for cross-query IN_ID_SET filters (reference:
    # IdSetAggregationFunction)
    "idset", "idsetmv",
    "distinctcounthllmv", "segmentpartitioneddistinctcount",
    "distinctcountsmarthll", "distinctcountrawhll", "distinctcountrawhllmv",
    "fasthll", "distinctcountbitmapmv", "minmaxrangemv", "stunion",
}


def is_aggregation(e: Expr) -> bool:
    return isinstance(e, Function) and (
        e.name in AGGREGATION_FUNCTIONS or e.name.startswith("percentile"))


def contains_aggregation(e: Expr) -> bool:
    if is_aggregation(e):
        return True
    if isinstance(e, Function):
        return any(contains_aggregation(a) for a in e.args)
    return False


def walk(e: Expr):
    """Yield every node in the expression tree, pre-order."""
    yield e
    if isinstance(e, Function):
        for a in e.args:
            yield from walk(a)


def identifiers_in(e: Expr) -> List[str]:
    out = []
    for n in walk(e):
        if isinstance(n, Identifier) and n.name != "*":
            out.append(n.name)
    return out


@dataclass
class OrderByItem:
    expr: Expr
    desc: bool = False
    nulls_last: Optional[bool] = None


@dataclass
class JoinClause:
    """One JOIN item in the FROM clause (multistage engine only; reference:
    Calcite SqlJoin consumed by the v2 planner, SURVEY.md §2.9)."""

    table: str
    alias: Optional[str]
    join_type: str            # "inner" | "left" | "right" | "full"
    condition: Optional[Expr]  # ON expression


@dataclass
class QueryStatement:
    """Parsed SELECT statement (reference: PinotQuery thrift struct)."""

    select: List[Tuple[Expr, Optional[str]]] = field(default_factory=list)  # (expr, alias)
    distinct: bool = False
    table: str = ""
    table_alias: Optional[str] = None
    joins: List[JoinClause] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderByItem] = field(default_factory=list)
    limit: int = 10  # reference default broker limit
    offset: int = 0
    options: dict = field(default_factory=dict)  # SQL `SET key=value;` / OPTION(...)
    raw: str = ""    # original SQL text (shipped to remote servers by the transport)
    explain: bool = False  # EXPLAIN PLAN FOR prefix (reference: SqlKind.EXPLAIN)
    analyze: bool = False  # EXPLAIN ANALYZE prefix: run the query, annotate the plan


# -- SQL unparser ------------------------------------------------------------
# Inverse of the parser: expression tree -> SQL text. Used by the HTTP transport
# to ship synthesized leaf scans (multistage engine) to remote servers, and by
# EXPLAIN output. Canonical function names map back to infix operators.

_INFIX = {"eq": "=", "neq": "<>", "gt": ">", "gte": ">=", "lt": "<", "lte": "<=",
          "plus": "+", "minus": "-", "times": "*", "divide": "/", "mod": "%"}


def _sql_literal(v: Any) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return repr(v)


def _sql_ident(name: str) -> str:
    """Quote identifiers that are not plain names or that collide with keywords."""
    import re
    from .lexer import KEYWORDS
    if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_$\.]*", name) and \
            name.upper() not in KEYWORDS:
        return name
    return '"' + name.replace('"', '""') + '"'


def to_sql(e: Expr) -> str:
    """Expression -> SQL text that re-parses to the same tree."""
    if isinstance(e, Literal):
        return _sql_literal(e.value)
    if isinstance(e, Identifier):
        return _sql_ident(e.name)
    op = e.name
    if op in _INFIX and len(e.args) == 2:
        return f"({to_sql(e.args[0])} {_INFIX[op]} {to_sql(e.args[1])})"
    if op == "and":
        return "(" + " AND ".join(to_sql(a) for a in e.args) + ")"
    if op == "or":
        return "(" + " OR ".join(to_sql(a) for a in e.args) + ")"
    if op == "not":
        return f"(NOT {to_sql(e.args[0])})"
    if op in ("in", "not_in"):
        kw = "IN" if op == "in" else "NOT IN"
        vals = ", ".join(to_sql(a) for a in e.args[1:])
        return f"({to_sql(e.args[0])} {kw} ({vals}))"
    if op in ("in_subquery", "not_in_subquery"):
        kw = "IN" if op == "in_subquery" else "NOT IN"
        return (f"({to_sql(e.args[0])} {kw} "
                f"({statement_to_sql(e.args[1].stmt)}))")
    if op == "between":
        return (f"({to_sql(e.args[0])} BETWEEN {to_sql(e.args[1])}"
                f" AND {to_sql(e.args[2])})")
    if op in ("like", "not_like"):
        kw = "LIKE" if op == "like" else "NOT LIKE"
        return f"({to_sql(e.args[0])} {kw} {to_sql(e.args[1])})"
    if op == "is_null":
        return f"({to_sql(e.args[0])} IS NULL)"
    if op == "is_not_null":
        return f"({to_sql(e.args[0])} IS NOT NULL)"
    if op == "cast" and len(e.args) == 2 and isinstance(e.args[1], Literal):
        return f"CAST({to_sql(e.args[0])} AS {e.args[1].value})"
    if op == "case" and len(e.args) % 2 == 1:
        parts = ["CASE"]
        for i in range(0, len(e.args) - 1, 2):
            parts.append(f"WHEN {to_sql(e.args[i])} THEN {to_sql(e.args[i + 1])}")
        default = e.args[-1]
        if not (isinstance(default, Literal) and default.value is None):
            parts.append(f"ELSE {to_sql(default)}")
        parts.append("END")
        return " ".join(parts)
    d = "DISTINCT " if e.distinct else ""
    return f"{op}({d}{', '.join(to_sql(a) for a in e.args)})"


def statement_to_sql(stmt: "QueryStatement") -> str:
    """QueryStatement -> SQL text that re-parses to the same statement (used
    to unparse subquery operands; covers the single-table SELECT surface)."""
    items = ", ".join(
        to_sql(e) + (f" AS {_sql_ident(a)}" if a else "")
        for e, a in stmt.select)
    out = "SELECT " + ("DISTINCT " if stmt.distinct else "") + items
    out += f" FROM {_sql_ident(stmt.table)}"
    if stmt.table_alias:
        out += f" AS {_sql_ident(stmt.table_alias)}"
    if stmt.where is not None:
        out += f" WHERE {to_sql(stmt.where)}"
    if stmt.group_by:
        out += " GROUP BY " + ", ".join(to_sql(e) for e in stmt.group_by)
    if stmt.having is not None:
        out += f" HAVING {to_sql(stmt.having)}"
    if stmt.order_by:
        out += " ORDER BY " + ", ".join(
            to_sql(o.expr) + (" DESC" if o.desc else "")
            + ("" if o.nulls_last is None else " NULLS LAST" if o.nulls_last
               else " NULLS FIRST")
            for o in stmt.order_by)
    out += f" LIMIT {stmt.limit}"
    if stmt.offset:
        out += f" OFFSET {stmt.offset}"
    return out
