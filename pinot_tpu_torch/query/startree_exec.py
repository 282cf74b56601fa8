"""Star-tree query execution: fit check, query rewrite, state reassembly.

A copy of `pinot_tpu/query/startree_exec.py` (the reference's
`StarTreeUtils.isFitForStarTree` and star-tree aggregation and group-by
executors). A fitting query is rewritten onto a segment's pre-aggregated
record table (`segment/startree.py` `StarTreeView`): each aggregation becomes
SUM/MIN/MAX "slots" over the stored partial columns (COUNT(*) ->
SUM($count), AVG(c) -> SUM($sum__c) / SUM($count), ...), the host-side tree
traversal gives a record mask that rides the executor's `valid_docs`, and the
regular executor runs the slot query over the view. `reassemble` turns slot
states back into the original aggregations' states, so the merge across
segments does not know which segments answered from a star-tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from ..segment.startree import COUNT_COL, StarTree, metric_col
from ..sql.ast import Function, Identifier, identifiers_in
from .context import QueryContext, QueryValidationError
from .predicate import LutLeaf, compile_filter


@dataclass
class StarTreePlan:
    tree: StarTree
    ctx2: QueryContext                       # slot query against the view
    record_mask: np.ndarray                  # traversal-selected records
    slots_per_agg: List[List[int]]           # original agg -> slot indices
    assemble: List[Callable[[List[Any]], Any]]


def _is_count_star(f: Function) -> bool:
    return f.name == "count" and (not f.args or
                                  (isinstance(f.args[0], Identifier)
                                   and f.args[0].name == "*"))


def try_star_tree(ctx: QueryContext, segment) -> Optional[StarTreePlan]:
    """Return a star-tree plan when one of the segment's trees fits the query."""
    if ctx.distinct or not ctx.aggregations:
        return None
    if ctx.filter is None and not ctx.group_by:
        return None  # metadata-only path on the base segment is already optimal
    trees = getattr(segment, "star_trees", None) or []
    for st in trees:
        plan = _fit(ctx, st)
        if plan is not None:
            return plan
    return None


def _fit(ctx: QueryContext, st: StarTree) -> Optional[StarTreePlan]:
    dim_set = set(st.dims)

    group_dims: Set[str] = set()
    for e in ctx.group_by:
        if not isinstance(e, Identifier) or e.name not in dim_set:
            return None
        group_dims.add(e.name)

    filter_dims: Set[str] = set()
    if ctx.filter is not None:
        filter_dims = set(identifiers_in(ctx.filter))
        if not filter_dims <= dim_set:
            return None

    # -- aggregation decomposition ----------------------------------------
    pairs = st.storable_pairs()
    slot_calls: List[Function] = []
    slot_index: Dict[str, int] = {}

    def slot(func: str, col: str) -> int:
        call = Function(func, (Identifier(col),))
        key = repr(call)
        if key not in slot_index:
            slot_index[key] = len(slot_calls)
            slot_calls.append(call)
        return slot_index[key]

    slots_per_agg: List[List[int]] = []
    assemble: List[Callable[[List[Any]], Any]] = []
    for f in ctx.aggregations:
        if _is_count_star(f):
            slots_per_agg.append([slot("sum", COUNT_COL)])
            assemble.append(lambda s: 0 if s[0] is None else int(round(s[0])))
            continue
        if len(f.args) != 1 or not isinstance(f.args[0], Identifier) or f.distinct:
            return None
        col = f.args[0].name
        if f.name == "sum" and ("sum", col) in pairs:
            slots_per_agg.append([slot("sum", metric_col("sum", col))])
            assemble.append(lambda s: s[0])
        elif f.name == "min" and ("min", col) in pairs:
            slots_per_agg.append([slot("min", metric_col("min", col))])
            assemble.append(lambda s: s[0])
        elif f.name == "max" and ("max", col) in pairs:
            slots_per_agg.append([slot("max", metric_col("max", col))])
            assemble.append(lambda s: s[0])
        elif f.name == "avg" and ("sum", col) in pairs:
            slots_per_agg.append([slot("sum", metric_col("sum", col)),
                                  slot("sum", COUNT_COL)])
            assemble.append(lambda s: (float(s[0] or 0.0),
                                       0 if s[1] is None else int(round(s[1]))))
        elif f.name == "minmaxrange" and ("min", col) in pairs and ("max", col) in pairs:
            slots_per_agg.append([slot("min", metric_col("min", col)),
                                  slot("max", metric_col("max", col))])
            assemble.append(lambda s: None if s[0] is None else (s[0], s[1]))
        else:
            return None

    # -- filter must compile to pure dict-id LUT leaves over tree dims -----
    view = st.view
    prune_luts: Dict[str, np.ndarray] = {}
    if ctx.filter is not None:
        try:
            prog = compile_filter(ctx.filter, view)
        except (QueryValidationError, NotImplementedError):
            return None
        if not all(isinstance(l, LutLeaf) for l in prog.leaves):
            return None
        # conjunctive-only trees allow per-dimension child pruning during traversal
        tree = prog.tree
        conj = [tree] if tree[0] == "leaf" else \
            list(tree[1]) if tree[0] == "and" else []
        if conj and all(c[0] == "leaf" for c in conj):
            for c in conj:
                leaf = prog.leaves[c[1]]
                if leaf.col in prune_luts:
                    prune_luts[leaf.col] = prune_luts[leaf.col] & leaf.lut
                else:
                    prune_luts[leaf.col] = leaf.lut

    record_mask = st.traverse(group_dims | filter_dims, prune_luts)

    ctx2 = QueryContext(
        table=ctx.table,
        select_items=[(c, f"slot{i}") for i, c in enumerate(slot_calls)]
        + [(e, repr(e)) for e in ctx.group_by],
        filter=ctx.filter,
        group_by=list(ctx.group_by),
        aggregations=slot_calls,
        having=None,
        order_by=[],
        limit=ctx.limit,
        offset=0,
        distinct=False,
        options=dict(ctx.options),
    )
    return StarTreePlan(st, ctx2, record_mask, slots_per_agg, assemble)


def reassemble(plan: StarTreePlan, sub) -> None:
    """Rewrite the slot-query SegmentResult's states into original-agg states, in
    place. `sub.kind` is 'groups' or 'scalar'."""
    if sub.kind == "groups":
        for key, states in sub.groups.items():
            sub.groups[key] = [asm([states[i] for i in slots])
                               for slots, asm in zip(plan.slots_per_agg, plan.assemble)]
    elif sub.kind == "scalar" and sub.scalar is not None:
        sub.scalar = [asm([sub.scalar[i] for i in slots])
                      for slots, asm in zip(plan.slots_per_agg, plan.assemble)]
