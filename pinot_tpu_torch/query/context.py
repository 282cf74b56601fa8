"""QueryContext: the compiled, resolved representation a server executes.

A copy of `pinot_tpu/query/context.py`. Analog of `pinot-core/.../query/request/context/QueryContext.java:72` plus the broker-side
query rewriters (`pinot-common/.../sql/parsers/rewriter/`): alias and ordinal resolution for
GROUP BY / ORDER BY / HAVING, aggregation extraction, and column validation happen here, so
the execution engine below sees only resolved expression trees.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..schema import Schema
from ..sql.ast import (Expr, Function, Identifier, Literal, OrderByItem,
                       contains_aggregation, identifiers_in, is_aggregation, walk)
from ..sql.parser import parse_query
from .optimizer import optimize_filter


class QueryValidationError(ValueError):
    pass


@dataclass
class GapfillSpec:
    """GAPFILL(timeExpr, start, end, bucket) and the per-column FILL modes
    (reference: the `core/query/reduce/GapfillProcessor.java` family, broker
    post-processing)."""

    index: int               # select-item position of the time bucket column
    start: int
    end: int                 # exclusive
    bucket: int
    # select-item position -> (mode, default); the modes are
    # FILL_PREVIOUS_VALUE and FILL_DEFAULT_VALUE
    fills: Dict[int, Tuple[str, object]] = field(default_factory=dict)


@dataclass
class QueryContext:
    table: str
    select_items: List[Tuple[Expr, str]]            # (resolved expr, output column name)
    filter: Optional[Expr]
    group_by: List[Expr]
    aggregations: List[Function]                    # unique aggregation calls, in order
    having: Optional[Expr]
    order_by: List[OrderByItem]
    limit: int
    offset: int
    distinct: bool
    options: Dict[str, object] = field(default_factory=dict)
    sql: str = ""   # original SQL text; the HTTP transport re-compiles server-side
    gapfill: Optional[GapfillSpec] = None
    explain: bool = False
    analyze: bool = False  # EXPLAIN ANALYZE: execute, then annotate the plan

    @property
    def is_aggregation_query(self) -> bool:
        return bool(self.aggregations) or bool(self.group_by)

    @property
    def output_names(self) -> List[str]:
        return [name for _, name in self.select_items]


def compile_query(sql_or_stmt, schema: Optional[Schema] = None) -> QueryContext:
    """SQL text / parsed statement -> QueryContext.

    Mirrors BaseBrokerRequestHandler compile steps
    (`pinot-broker/.../BaseBrokerRequestHandler.java:207` onwards): parse, rewrite
    aliases/ordinals, extract aggregations, validate against the schema when given.
    """
    stmt = parse_query(sql_or_stmt) if isinstance(sql_or_stmt, str) else sql_or_stmt
    if stmt.joins:
        raise QueryValidationError(
            "JOIN queries run on the multistage engine (multistage/)"
        )

    # -- expand SELECT *, strip GAPFILL/FILL wrappers ----------------------
    select: List[Tuple[Expr, str]] = []
    gapfill: Optional[GapfillSpec] = None
    fills: Dict[int, Tuple[str, object]] = {}
    for expr, alias in stmt.select:
        if isinstance(expr, Identifier) and expr.name == "*":
            if schema is None:
                raise QueryValidationError("SELECT * requires a schema to expand")
            select.extend((Identifier(c), c) for c in schema.column_names)
            continue
        if isinstance(expr, Function) and expr.name == "gapfill":
            if gapfill is not None:
                raise QueryValidationError("only one GAPFILL column is allowed")
            if len(expr.args) != 4 or not all(
                    isinstance(a, Literal) for a in expr.args[1:]):
                raise QueryValidationError(
                    "GAPFILL(timeExpr, start, end, bucket) with literal bounds")
            gapfill = GapfillSpec(index=len(select), start=int(expr.args[1].value),
                                  end=int(expr.args[2].value),
                                  bucket=int(expr.args[3].value))
            if gapfill.bucket <= 0:
                raise QueryValidationError("GAPFILL bucket must be positive")
            expr = expr.args[0]
        elif isinstance(expr, Function) and expr.name == "fill":
            if len(expr.args) < 2 or not isinstance(expr.args[1], Literal):
                raise QueryValidationError("FILL(expr, 'MODE'[, default])")
            mode = str(expr.args[1].value).upper()
            if mode not in ("FILL_PREVIOUS_VALUE", "FILL_DEFAULT_VALUE"):
                raise QueryValidationError(f"unknown FILL mode {mode!r}")
            default = expr.args[2].value if len(expr.args) > 2 else None
            fills[len(select)] = (mode, default)
            expr = expr.args[0]
        select.append((expr, alias or _default_name(expr)))
    if gapfill is not None:
        gapfill.fills = fills
    elif fills:
        raise QueryValidationError("FILL requires a GAPFILL column in the select list")

    alias_map = {name: expr for expr, name in select}

    # -- resolve ordinals + aliases in GROUP BY / ORDER BY / HAVING --------
    group_by = [_resolve(e, select, alias_map) for e in stmt.group_by]
    order_by = [OrderByItem(_resolve(o.expr, select, alias_map), o.desc, o.nulls_last)
                for o in stmt.order_by]
    having = _resolve(stmt.having, select, alias_map) if stmt.having is not None else None

    # -- collect unique aggregations over every result-shaping expression --
    aggregations: List[Function] = []
    seen = set()
    for e in ([expr for expr, _ in select] + [o.expr for o in order_by]
              + ([having] if having is not None else [])):
        for node in walk(e):
            if is_aggregation(node):
                key = repr(node)
                if key not in seen:
                    seen.add(key)
                    aggregations.append(node)
                    _validate_aggregation(node)

    # -- validation --------------------------------------------------------
    if stmt.where is not None and contains_aggregation(stmt.where):
        raise QueryValidationError("aggregation not allowed in WHERE clause")
    if aggregations and not stmt.distinct:
        group_keys = {repr(g) for g in group_by}
        for expr, name in select:
            if not contains_aggregation(expr) and repr(expr) not in group_keys:
                raise QueryValidationError(
                    f"select item {name!r} is neither aggregated nor in GROUP BY")
    if schema is not None:
        exprs = [e for e, _ in select] + group_by + [o.expr for o in order_by]
        if stmt.where is not None:
            exprs.append(stmt.where)
        if having is not None:
            exprs.append(having)
        for e in exprs:
            for col in identifiers_in(e):
                if not schema.has_column(col):
                    raise QueryValidationError(f"unknown column {col!r}")

    return QueryContext(
        table=stmt.table,
        select_items=select,
        # AST-level filter rewrites (merge EQ->IN, range tightening, dedupe) —
        # reference: core/query/optimizer/filter/ chain in BrokerRequestOptimizer
        filter=_optimize_filter(stmt.where, schema),
        group_by=group_by,
        aggregations=aggregations,
        having=having,
        order_by=order_by,
        limit=stmt.limit,
        offset=stmt.offset,
        distinct=stmt.distinct,
        options=dict(stmt.options),
        explain=stmt.explain,
        analyze=stmt.analyze,
        gapfill=gapfill,
        sql=stmt.raw or (sql_or_stmt if isinstance(sql_or_stmt, str) else ""),
    )


def _resolve(e: Expr, select: List[Tuple[Expr, str]], alias_map: Dict[str, Expr]) -> Expr:
    """Resolve ordinals (GROUP BY 1) and select aliases (ORDER BY total).

    Ordinals only apply to a *whole* GROUP BY/ORDER BY item (top level); a literal inside
    an expression (HAVING COUNT(*) > 2) stays a literal. Aliases resolve at any depth.
    """
    if isinstance(e, Literal) and isinstance(e.value, int) and not isinstance(e.value, bool):
        idx = e.value - 1
        if 0 <= idx < len(select):
            return select[idx][0]
        raise QueryValidationError(f"ordinal {e.value} out of range")
    return _resolve_aliases(e, alias_map)


def _resolve_aliases(e: Expr, alias_map: Dict[str, Expr]) -> Expr:
    if isinstance(e, Identifier) and e.name in alias_map:
        return alias_map[e.name]
    if isinstance(e, Function):
        return Function(e.name, tuple(_resolve_aliases(a, alias_map) for a in e.args),
                        e.distinct)
    return e


def _validate_aggregation(f: Function) -> None:
    for a in f.args:
        if contains_aggregation(a):
            raise QueryValidationError(f"nested aggregation in {f!r}")
    if f.name == "count" and not f.args:
        raise QueryValidationError("COUNT requires an argument (use COUNT(*))")


def _default_name(e: Expr) -> str:
    """Output column name for an unaliased select expression (reference naming:
    `count(*)` style lowercase canonical forms)."""
    if isinstance(e, Identifier):
        return e.name
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, Function):
        inner = ",".join(_default_name(a) for a in e.args)
        d = "distinct " if e.distinct else ""
        return f"{e.name}({d}{inner})"
    return repr(e)


def _optimize_filter(e, schema=None):
    return optimize_filter(e, schema)
