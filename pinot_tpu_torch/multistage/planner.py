"""Multistage planner: join-query statement -> scan specs + join pipeline + final ctx.

A copy of `pinot_tpu/multistage/planner.py`, the analog of
`QueryEnvironment.planQuery` + `StagePlanner.makeStagePlan`
(`pinot-query-planner/.../query/QueryEnvironment.java:125`,
`planner/logical/StagePlanner.java`): resolve table aliases, qualify every column
reference, push single-table predicates into leaf scans (only where outer-join
null-extension cannot observe the difference), extract equi-join keys per ON clause,
and compile the remaining query shape against the joined virtual schema (through
this package's `query/context.py`) so the regular reduce runs the final stage.
`stmt_has_in_subquery` is the broker's dispatch check (`cluster/broker.py`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Set, Tuple

from ..query.context import QueryContext, QueryValidationError, compile_query
from ..schema import Schema
from ..sql.ast import (Expr, Function, Identifier, JoinClause, OrderByItem,
                       QueryStatement, identifiers_in)
from ..sql.parser import parse_query

#: join types the hash-join pipeline executes. SEMI/ANTI come from
#: `WHERE x IN (subquery)` lowering: output is LEFT rows only (existence /
#: non-existence of a build-side match), no null extension, no right columns.
JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")

#: join types whose build side may replicate (broadcast exchange): the build
#: side contributes no unmatched rows of its own, so a copy per partition
#: never duplicates output rows
BROADCASTABLE_JOIN_TYPES = ("inner", "left", "semi", "anti")

#: build-side byte ceiling for the broadcast exchange; the broker takes it
#: from the cluster knob `broker.join.broadcast.max.bytes` when that is set
BROADCAST_MAX_BYTES_DEFAULT = 4 << 20


def choose_join_strategy(join_type: str, est_build_bytes: Optional[int],
                         max_broadcast_bytes: Optional[int] = None) -> str:
    """Stats-driven exchange strategy for one join stage: `"broadcast"` when
    the build side's estimated bytes (segment metadata before any scan;
    exact block bytes in-proc) fit under the cap (`max_broadcast_bytes`,
    BROADCAST_MAX_BYTES_DEFAULT when None) AND the join shape permits
    replication, else `"partitioned"` (hash both sides). With no estimate at
    all the safe choice is partitioned."""
    limit = (BROADCAST_MAX_BYTES_DEFAULT if max_broadcast_bytes is None
             else int(max_broadcast_bytes))
    if (join_type in BROADCASTABLE_JOIN_TYPES and est_build_bytes is not None
            and int(est_build_bytes) <= limit):
        return "broadcast"
    return "partitioned"


@dataclass
class ScanSpec:
    """A leaf stage: scan one table through the single-stage engine."""
    alias: str
    table: str
    columns: List[str]             # bare column names to materialize
    filter: Optional[Expr] = None  # bare-name predicate pushed into the scan


@dataclass
class JoinSpec:
    """One hash-join step joining the accumulated left side with a scanned table."""
    right_alias: str
    join_type: str                 # inner | left | right | full | semi | anti
    left_keys: List[str]           # qualified column names
    right_keys: List[str]
    residual: Optional[Expr] = None  # non-equi ON conjuncts (inner joins only)


@dataclass
class MultistagePlan:
    scans: Dict[str, ScanSpec]
    base_alias: str
    joins: List[JoinSpec]
    post_filter: Optional[Expr]    # qualified WHERE conjuncts applied after joins
    ctx: QueryContext              # qualified query context for the final reduce
    joined_schema: Schema


def plan_multistage(stmt_or_sql, schema_for) -> MultistagePlan:
    """`schema_for(table_name) -> Schema` resolves each referenced table."""
    stmt = parse_query(stmt_or_sql) if isinstance(stmt_or_sql, str) else stmt_or_sql
    stmt = lower_in_subqueries(stmt, schema_for)
    if not stmt.joins:
        raise QueryValidationError("multistage planner requires a JOIN query")

    # -- alias resolution --------------------------------------------------
    alias_order: List[str] = []
    tables: Dict[str, str] = {}
    schemas: Dict[str, Schema] = {}

    def add_alias(table: str, alias: Optional[str]) -> str:
        a = alias or table
        if a in tables:
            raise QueryValidationError(f"duplicate table alias {a!r}")
        sch = schema_for(table)
        if sch is None:
            raise QueryValidationError(f"unknown table {table!r}")
        alias_order.append(a)
        tables[a] = table
        schemas[a] = sch
        return a

    base_alias = add_alias(stmt.table, stmt.table_alias)
    for j in stmt.joins:
        if j.join_type == "cross":
            raise QueryValidationError("CROSS JOIN is not supported (hash joins only)")
        if j.join_type not in JOIN_TYPES:
            raise QueryValidationError(f"unsupported join type {j.join_type!r}")
        add_alias(j.table, j.alias)
    # SEMI/ANTI sides exist only to test key membership: their columns never
    # reach the joined output, so they stay out of the joined schema and only
    # their ON keys (+ their own pushed-down filter) may reference them
    semi_anti = {j.alias or j.table for j in stmt.joins
                 if j.join_type in ("semi", "anti")}

    # bare column -> owning aliases (for unqualified resolution)
    owners: Dict[str, List[str]] = {}
    for a in alias_order:
        for c in schemas[a].column_names:
            owners.setdefault(c, []).append(a)

    select_aliases = {alias for _, alias in stmt.select if alias}

    def qualify(e: Expr, allow_alias: bool = False) -> Expr:
        """Rewrite identifiers to `alias.col`. Real columns win over select-item
        aliases; bare select aliases are only legal where SQL allows them
        (GROUP BY / ORDER BY / HAVING — `allow_alias`), and are then left for
        compile_query's alias resolution."""
        if isinstance(e, Identifier):
            if e.name == "*":
                return e
            if "." in e.name:
                alias, _, col = e.name.partition(".")
                if alias in tables:
                    if not schemas[alias].has_column(col):
                        raise QueryValidationError(
                            f"unknown column {col!r} in table alias {alias!r}")
                    return Identifier(f"{alias}.{col}")
                # fall through: a dotted bare column name (unlikely)
            own = owners.get(e.name, [])
            if len(own) == 1:
                return Identifier(f"{own[0]}.{e.name}")
            if len(own) > 1:
                raise QueryValidationError(
                    f"ambiguous column {e.name!r} (in {sorted(own)})")
            if allow_alias and e.name in select_aliases:
                return e
            raise QueryValidationError(f"unknown column {e.name!r}")
        if isinstance(e, Function):
            return Function(e.name, tuple(qualify(a, allow_alias) for a in e.args),
                            e.distinct)
        return e

    # -- joined virtual schema + final query context -----------------------
    joined_fields = [replace(schemas[a].field_spec(c), name=f"{a}.{c}")
                     for a in alias_order if a not in semi_anti
                     for c in schemas[a].column_names]
    joined_schema = Schema("$joined", joined_fields)

    # WHERE conjuncts touching ONLY a semi/anti alias belong to the
    # membership subquery: they push into that leaf scan and never reach the
    # final compile (whose schema has no semi/anti columns). A conjunct
    # mixing a semi/anti alias with anything else has no post-join home.
    sub_where: Dict[str, List[Expr]] = {a: [] for a in semi_anti}
    main_where: List[Expr] = []
    if stmt.where is not None:
        for conj in _split_and(qualify(stmt.where)):
            refs = {n.partition(".")[0] for n in identifiers_in(conj)}
            inside = refs & semi_anti
            if not inside:
                main_where.append(conj)
            elif len(refs) == 1:
                sub_where[next(iter(inside))].append(conj)
            else:
                raise QueryValidationError(
                    f"predicate {conj!r} mixes a SEMI/ANTI subquery alias "
                    f"with other tables")
    q_stmt = QueryStatement(
        select=[(_qualify_select(e, qualify), alias) for e, alias in stmt.select],
        distinct=stmt.distinct,
        table=stmt.table,
        where=_and_all(main_where),
        group_by=[qualify(e, allow_alias=True) for e in stmt.group_by],
        having=qualify(stmt.having, allow_alias=True)
        if stmt.having is not None else None,
        order_by=[OrderByItem(qualify(o.expr, allow_alias=True), o.desc, o.nulls_last)
                  for o in stmt.order_by],
        limit=stmt.limit,
        offset=stmt.offset,
        options=dict(stmt.options),
    )
    ctx = compile_query(q_stmt, joined_schema)

    # -- which aliases can be null-extended by an outer join? --------------
    # Pushing a WHERE conjunct below the join is only safe when the alias cannot
    # produce null-extended rows (standard outer-join pushdown rule).
    null_extendable: Set[str] = set()
    left_side: Set[str] = {base_alias}
    for j in stmt.joins:
        a = j.alias or j.table
        if j.join_type == "left":
            null_extendable.add(a)
        elif j.join_type == "right":
            null_extendable.update(left_side)
        elif j.join_type == "full":
            null_extendable.update(left_side)
            null_extendable.add(a)
        left_side.add(a)

    # -- WHERE split: pushdown vs post-join --------------------------------
    pushdown: Dict[str, List[Expr]] = {a: [] for a in alias_order}
    # semi/anti membership filters ALWAYS push down — they define the
    # build-side key set, which must be filtered before the existence test
    for a, conjs in sub_where.items():
        pushdown[a].extend(_strip_alias(c, a) for c in conjs)
    post: List[Expr] = []
    if q_stmt.where is not None:
        for conj in _split_and(q_stmt.where):
            refs = {n.partition(".")[0] for n in identifiers_in(conj)}
            if len(refs) == 1:
                (a,) = refs
                if a not in null_extendable:
                    pushdown[a].append(_strip_alias(conj, a))
                    continue
            post.append(conj)
    post_filter = _and_all(post)

    # -- join key extraction per ON clause ---------------------------------
    joins: List[JoinSpec] = []
    joined: Set[str] = {base_alias}
    for j in stmt.joins:
        a = j.alias or j.table
        cond = qualify(j.condition) if j.condition is not None else None
        left_keys: List[str] = []
        right_keys: List[str] = []
        residual: List[Expr] = []
        for conj in (_split_and(cond) if cond is not None else []):
            pair = _equi_pair(conj, joined, a)
            if pair is not None:
                left_keys.append(pair[0])
                right_keys.append(pair[1])
            else:
                refs = {n.partition(".")[0] for n in identifiers_in(conj)}
                if not refs <= joined | {a}:
                    raise QueryValidationError(
                        f"ON condition references tables not yet joined: {conj!r}")
                residual.append(conj)
        if not left_keys:
            raise QueryValidationError(
                f"JOIN with {a!r} needs at least one equality key (hash join)")
        if residual and j.join_type != "inner":
            raise QueryValidationError(
                "non-equi ON conditions are only supported for INNER JOIN")
        joins.append(JoinSpec(a, j.join_type, left_keys, right_keys,
                              _and_all(residual)))
        joined.add(a)

    # -- per-alias column requirements -------------------------------------
    needed: Dict[str, Set[str]] = {a: set() for a in alias_order}
    exprs: List[Expr] = [e for e, _ in ctx.select_items]
    exprs += ctx.group_by + [o.expr for o in ctx.order_by]
    if ctx.having is not None:
        exprs.append(ctx.having)
    if post_filter is not None:
        exprs.append(post_filter)
    for js in joins:
        exprs += [Identifier(k) for k in js.left_keys + js.right_keys]
        if js.residual is not None:
            exprs.append(js.residual)
    for e in exprs:
        for name in identifiers_in(e):
            alias, _, col = name.partition(".")
            if alias in needed:
                needed[alias].add(col)

    scans = {
        a: ScanSpec(a, tables[a], sorted(needed[a]) or [schemas[a].column_names[0]],
                    _and_all(pushdown[a]))
        for a in alias_order
    }
    return MultistagePlan(scans, base_alias, joins, post_filter, ctx, joined_schema)


# ---------------------------------------------------------------------------

def _qualify_select(e: Expr, qualify) -> Expr:
    if isinstance(e, Identifier) and e.name == "*":
        return e  # SELECT *: expanded by compile_query against the joined schema
    return qualify(e)


def _split_and(e: Expr) -> List[Expr]:
    if isinstance(e, Function) and e.name == "and":
        out: List[Expr] = []
        for a in e.args:
            out.extend(_split_and(a))
        return out
    return [e]


def _and_all(conjs: List[Expr]) -> Optional[Expr]:
    if not conjs:
        return None
    if len(conjs) == 1:
        return conjs[0]
    return Function("and", tuple(conjs))


def _strip_alias(e: Expr, alias: str) -> Expr:
    """Rewrite `alias.col` identifiers back to bare `col` for the leaf scan."""
    if isinstance(e, Identifier):
        a, _, col = e.name.partition(".")
        return Identifier(col) if a == alias and col else e
    if isinstance(e, Function):
        return Function(e.name, tuple(_strip_alias(x, alias) for x in e.args),
                        e.distinct)
    return e


# ---------------------------------------------------------------------------
# IN (subquery) -> SEMI/ANTI join lowering
# ---------------------------------------------------------------------------

IN_SUBQUERY_FUNCS = ("in_subquery", "not_in_subquery")


def _contains_in_subquery(e: Expr) -> bool:
    if isinstance(e, Function):
        return e.name in IN_SUBQUERY_FUNCS or \
            any(_contains_in_subquery(a) for a in e.args)
    return False


def stmt_has_in_subquery(stmt) -> bool:
    """Whether the statement needs the multistage path without a JOIN clause."""
    return stmt.where is not None and _contains_in_subquery(stmt.where)


def _sub_realias(e: Expr, sub_names: Set[str], alias: str) -> Expr:
    """Rewrite the subquery's own references (bare, or qualified by the
    subquery table/alias) onto the generated join alias."""
    if isinstance(e, Identifier):
        a, _, col = e.name.partition(".")
        if col and a in sub_names:
            return Identifier(f"{alias}.{col}")
        if "." not in e.name and e.name != "*":
            return Identifier(f"{alias}.{e.name}")
        return e
    if isinstance(e, Function):
        return Function(e.name, tuple(_sub_realias(x, sub_names, alias)
                                      for x in e.args), e.distinct)
    return e


def lower_in_subqueries(stmt: QueryStatement, schema_for) -> QueryStatement:
    """Rewrite `x IN (SELECT y FROM t [WHERE ...])` WHERE conjuncts into SEMI
    joins (`NOT IN` -> ANTI) on a fresh `__in<i>` alias, with the subquery's
    own WHERE pushed down to its leaf scan.

    NOT IN lowers with NOT-EXISTS null semantics: a left row whose key is
    NULL, or whose key has no match, is KEPT (strict SQL NOT IN would return
    no rows once the subquery yields any NULL — documented in README).
    Subqueries are single-table, single-plain-column, no GROUP BY/HAVING;
    a subquery anywhere but a top-level AND conjunct is rejected."""
    if stmt.where is None or not _contains_in_subquery(stmt.where):
        return stmt

    # resolve bare outer columns in the IN's left expression against OUTER
    # tables only — the subquery table usually shares the key column's name,
    # which would be ambiguous once the generated alias joins the scope
    outer: List[Tuple[str, Schema]] = []
    for table, alias in ([(stmt.table, stmt.table_alias)]
                         + [(j.table, j.alias) for j in stmt.joins]):
        sch = schema_for(table) if schema_for is not None else None
        if sch is not None:
            outer.append((alias or table, sch))

    def qualify_outer(e: Expr) -> Expr:
        if isinstance(e, Identifier) and "." not in e.name and e.name != "*":
            own = [a for a, sch in outer if sch.has_column(e.name)]
            if len(own) == 1:
                return Identifier(f"{own[0]}.{e.name}")
            return e
        if isinstance(e, Function):
            return Function(e.name, tuple(qualify_outer(a) for a in e.args),
                            e.distinct)
        return e

    keep: List[Expr] = []
    joins = list(stmt.joins)
    idx = 0
    for conj in _split_and(stmt.where):
        if isinstance(conj, Function) and conj.name in IN_SUBQUERY_FUNCS:
            col, sub = conj.args
            sq = sub.stmt
            if sq.joins or sq.group_by or sq.having:
                raise QueryValidationError(
                    "IN (subquery) supports a single-table subquery without "
                    "GROUP BY/HAVING")
            sel = sq.select[0][0] if len(sq.select) == 1 else None
            if not isinstance(sel, Identifier) or sel.name == "*":
                raise QueryValidationError(
                    "IN (subquery) requires exactly one plain column in the "
                    "subquery SELECT")
            alias = f"__in{idx}"
            idx += 1
            sub_names = {sq.table}
            if sq.table_alias:
                sub_names.add(sq.table_alias)
            key = _sub_realias(sel, sub_names, alias)
            cond = Function("eq", (qualify_outer(col), key))
            joins.append(JoinClause(
                sq.table, alias,
                "semi" if conj.name == "in_subquery" else "anti", cond))
            if sq.where is not None:
                keep.append(_sub_realias(sq.where, sub_names, alias))
        elif _contains_in_subquery(conj):
            raise QueryValidationError(
                "IN (subquery) is only supported as a top-level WHERE "
                "conjunct")
        else:
            keep.append(conj)
    out = copy.copy(stmt)
    out.joins = joins
    out.where = _and_all(keep)
    # the generated __in aliases now share the scope: bare outer columns
    # everywhere else in the statement (SELECT, GROUP BY, ORDER BY, HAVING,
    # remaining WHERE) must bind to their outer table first, or a key column
    # the subquery table also carries turns spuriously ambiguous
    out.select = [(qualify_outer(e), a) for e, a in stmt.select]
    out.group_by = [qualify_outer(e) for e in stmt.group_by]
    out.order_by = [OrderByItem(qualify_outer(o.expr), o.desc, o.nulls_last)
                    for o in stmt.order_by]
    if stmt.having is not None:
        out.having = qualify_outer(stmt.having)
    if out.where is not None:
        out.where = qualify_outer(out.where)
    return out


def _equi_pair(conj: Expr, joined: Set[str], right_alias: str
               ) -> Optional[Tuple[str, str]]:
    """`l.k = r.k` with one side fully in the joined set and the other on the
    incoming table -> (left_key, right_key); anything else is residual."""
    if not (isinstance(conj, Function) and conj.name == "eq" and len(conj.args) == 2):
        return None
    x, y = conj.args
    if not (isinstance(x, Identifier) and isinstance(y, Identifier)):
        return None
    xa = x.name.partition(".")[0]
    ya = y.name.partition(".")[0]
    if xa in joined and ya == right_alias:
        return (x.name, y.name)
    if ya in joined and xa == right_alias:
        return (y.name, x.name)
    return None
