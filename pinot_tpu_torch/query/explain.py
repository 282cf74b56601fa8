"""EXPLAIN PLAN FOR <query>: an operator tree describing the execution plan.

A copy of `pinot_tpu/query/explain.py` (analog of the reference's explain
support, `ExplainPlanQueriesTest`, `core/query/reduce/ExplainPlanDataTableReducer`):
the response is a ResultTable with columns [Operator, Operator_Id, Parent_Id],
one row per operator node, ids in pre-order so that the tree reconstructs
from the parent links.

The plan surface is the per-segment `SegmentPlan` (planner.py): segments that
share a plan shape collapse into one subtree with a `segments:N` count. The
labels are the JAX package's, letter for letter, for every plan kind the
planner gives (device, host with its fallback reason, selection, metadata,
empty, and the star-tree rewrite); a plan that the executor sends through the
masked multi-sum scan has the label of every other device plan.

EXPLAIN ANALYZE (`analyze_result`) executes the query and adds [Rows, Ms]
to each row from the executed query's per-operator rollups
(`stats.ExecutionStats.operators`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..sql.ast import to_sql
from .context import QueryContext
from .planner import SegmentPlan, build_device_geometry, plan_segment
from .predicate import CmpLeaf, DocSetLeaf, LutLeaf, NullLeaf
from .result import ResultTable
from .startree_exec import try_star_tree


class _Node:
    def __init__(self, label: str, children: Optional[List["_Node"]] = None):
        self.label = label
        self.children = children or []

    def signature(self) -> Tuple:
        return (self.label, tuple(c.signature() for c in self.children))


def _filter_node(plan: SegmentPlan) -> _Node:
    prog = plan.filter_prog
    if prog is None or prog.is_match_all:
        return _Node("FILTER_MATCH_ALL")

    def leaf_node(i: int) -> _Node:
        leaf = prog.leaves[i]
        if isinstance(leaf, LutLeaf):
            kind = "ID_INTERVALS" if leaf.intervals is not None else "LUT"
            return _Node(f"FILTER_DICT_{kind}(column={leaf.col})")
        if isinstance(leaf, NullLeaf):
            op = "IS_NOT_NULL" if leaf.negated else "IS_NULL"
            return _Node(f"FILTER_{op}(column={leaf.col})")
        if isinstance(leaf, DocSetLeaf):
            return _Node(f"FILTER_DOCSET(column={leaf.col}; {leaf.desc})")
        assert isinstance(leaf, CmpLeaf)
        return _Node(f"FILTER_EXPR({to_sql(leaf.expr)} {leaf.op} {list(leaf.operands)})")

    def walk(node) -> _Node:
        kind = node[0]
        if kind == "const":
            return _Node(f"FILTER_CONST({'ALL' if node[1] else 'NONE'})")
        if kind == "leaf":
            return leaf_node(node[1])
        if kind == "not":
            return _Node("FILTER_NOT", [walk(node[1])])
        return _Node(f"FILTER_{kind.upper()}", [walk(c) for c in node[1]])

    return walk(prog.tree)


def _segment_plan_node(ctx: QueryContext, plan: SegmentPlan) -> _Node:
    if plan.kind == "empty":
        return _Node("PRUNED(filter folds to constant false)")
    if plan.kind == "metadata":
        aggs = ", ".join(a.call.name for a in plan.aggs)
        return _Node(f"METADATA_ONLY_AGGREGATE(aggregations:{aggs})")

    children = [_filter_node(plan)]
    if plan.kind == "selection":
        cols = ", ".join(name for _, name in ctx.select_items)
        label = ("SELECT_ORDERBY" if ctx.order_by else "SELECT") + f"(columns:{cols})"
        return _Node(label, children)

    if plan.group_exprs:
        keys = ", ".join(to_sql(g) for g in plan.group_exprs)
        aggs = ", ".join(a.call.name for a in plan.aggs) or "-"
        if plan.kind == "device":
            label = (f"DEVICE_FUSED_GROUP_BY(keys:{keys}; aggregations:{aggs}; "
                     f"denseKeys:{plan.num_keys_real or '?'})")
        else:
            label = f"HOST_GROUP_BY(keys:{keys}; aggregations:{aggs})"
    else:
        aggs = ", ".join(a.call.name for a in plan.aggs)
        label = (f"DEVICE_FUSED_AGGREGATE(aggregations:{aggs})"
                 if plan.kind == "device" else
                 f"HOST_AGGREGATE(aggregations:{aggs})")
    if plan.kind == "host" and plan.fallback_reason:
        label = label[:-1] + f"; fallback:{plan.fallback_reason})"
    return _Node(label, children)


def _planned_node(ctx: QueryContext, segment, valid_docs=None) -> _Node:
    plan = plan_segment(ctx, segment, valid_docs=valid_docs)
    if plan.kind == "device":
        build_device_geometry(plan)
    return _segment_plan_node(ctx, plan)


def explain_plan_nodes(ctx: QueryContext, segments: Sequence[Any],
                       table: Optional[str] = None, star_plans=None,
                       upsert=None) -> List[_Node]:
    """One node per distinct per-segment plan shape, each tagged segments:N.
    As in the executor, a star-tree that fits rewrites the query before it
    is planned (over the tree's record view); `star_plans` and `upsert` are
    what `ServerQueryExecutor.execute` takes, so that a segment under a
    valid-doc mask is planned under it and no star-tree rewrites it."""
    shapes: Dict[Tuple, Tuple[_Node, int]] = {}
    order: List[Tuple] = []
    for i, seg in enumerate(segments):
        mask = None if upsert is None else upsert.valid_mask(seg.name, seg.num_docs)
        stp = None
        if mask is None and not getattr(seg, "is_mutable", False):
            stp = star_plans[i] if star_plans is not None else try_star_tree(ctx, seg)
        if stp is not None:
            node = _Node(f"STAR_TREE_REWRITE(records:{stp.tree.view.num_docs})",
                         [_planned_node(stp.ctx2, stp.tree.view)])
        else:
            node = _planned_node(ctx, seg, valid_docs=mask)
        sig = node.signature()
        if sig in shapes:
            shapes[sig] = (shapes[sig][0], shapes[sig][1] + 1)
        else:
            shapes[sig] = (node, 1)
            order.append(sig)
    tbl = f"table:{table}; " if table else ""
    return [_Node(f"SEGMENT_PLAN({tbl}segments:{shapes[sig][1]})", [shapes[sig][0]])
            for sig in order]


def explain_result(ctx: QueryContext, segments: Sequence[Any],
                   broker_prefix: Optional[List[str]] = None,
                   table: Optional[str] = None, star_plans=None,
                   upsert=None) -> ResultTable:
    """The EXPLAIN response. `broker_prefix` lets a broker put its own
    operators (reduce, combine) above the per-segment subtrees; `star_plans`
    and `upsert` as `explain_plan_nodes` takes them."""
    root_labels = broker_prefix if broker_prefix is not None else _default_prefix(ctx)
    # nest the prefix chain, then hang the segment-plan subtrees off its last node
    root = cur = _Node(root_labels[0])
    for label in root_labels[1:]:
        nxt = _Node(label)
        cur.children.append(nxt)
        cur = nxt
    cur.children.extend(explain_plan_nodes(ctx, segments, table, star_plans, upsert))

    rows: List[List[Any]] = []

    def emit(node: _Node, parent_id: int) -> None:
        my_id = len(rows)
        rows.append([node.label, my_id, parent_id])
        for c in node.children:
            emit(c, my_id)

    emit(root, -1)
    return ResultTable(["Operator", "Operator_Id", "Parent_Id"], rows, {"explain": True})


ANALYZE_COLUMNS = ["Operator", "Operator_Id", "Parent_Id", "Rows", "Ms"]


def annotate_plan_rows(plan_rows: Sequence[Sequence[Any]], stats,
                       result_rows: int, total_ms: float) -> List[List[Any]]:
    """Extend 3-column EXPLAIN rows with [Rows, Ms] from the executed query's
    per-operator rollups. Labels prefix-match longest first: "DEVICE_FUSED"
    annotates DEVICE_FUSED_GROUP_BY(...), "SELECT" annotates
    SELECT_ORDERBY(...), "SEGMENT_PLAN" its wrapper, and so on. The root row
    always carries the result's row count and the total wall time."""
    ops = stats.operators()
    keys = sorted(ops, key=len, reverse=True)

    def annotate(label: str) -> Tuple[Any, Any]:
        for k in keys:
            if label.startswith(k):
                op = ops[k]
                return int(op.get("rows", 0)), round(float(op.get("ms", 0)), 3)
        return None, None

    rows = []
    for label, my_id, parent_id in plan_rows:
        r, ms = annotate(label)
        if my_id == 0:
            r = result_rows if r is None else r
            ms = round(total_ms, 3)
        rows.append([label, my_id, parent_id, r, ms])
    return rows


def analyze_result(ctx: QueryContext, segments: Sequence[Any], stats,
                   inner: ResultTable, total_ms: float,
                   broker_prefix: Optional[List[str]] = None,
                   table: Optional[str] = None, star_plans=None,
                   upsert=None) -> ResultTable:
    """The EXPLAIN ANALYZE response: EXPLAIN's operator tree with [Rows, Ms]
    from the executed query's rollups. `inner` is the executed query's
    ResultTable; its stats ride along."""
    base = explain_result(ctx, segments, broker_prefix=broker_prefix, table=table,
                          star_plans=star_plans, upsert=upsert)
    rows = annotate_plan_rows(base.rows, stats, len(inner.rows), total_ms)
    res = ResultTable(list(ANALYZE_COLUMNS), rows, dict(inner.stats))
    res.stats.update(stats.to_public_dict())
    res.stats["explain"] = True
    res.stats["analyze"] = True
    return res


def _default_prefix(ctx: QueryContext) -> List[str]:
    parts = []
    if ctx.order_by:
        keys = ", ".join(to_sql(o.expr) + (" DESC" if o.desc else "")
                         for o in ctx.order_by)
        parts.append(f"sort:[{keys}]")
    parts.append(f"limit:{ctx.limit}")
    if ctx.having is not None:
        parts.append(f"having:{to_sql(ctx.having)}")
    prefix = [f"BROKER_REDUCE({', '.join(parts)})"]
    if ctx.is_aggregation_query or ctx.distinct:
        prefix.append("COMBINE_GROUP_BY" if (ctx.group_by or ctx.distinct)
                      else "COMBINE_AGGREGATE")
    else:
        prefix.append("COMBINE_SELECT")
    return prefix
