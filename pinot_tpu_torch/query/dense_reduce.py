"""Vectorized decode of dense group-by kernel outputs straight to a ResultTable.

A copy of `pinot_tpu/query/dense_reduce.py` for this package's aggregations.
The classic decode walks the occupied dense keys in a Python loop, building one
state list per group (`executor._decode_group_partials`), and the reduce walks
them again to finalize (`reduce.reduce_to_result`). This module decodes the
outputs of a whole segment set in numpy instead:

    counts > 0 -> occupied keys -> (vectorized ORDER BY) -> offset/limit slice
    -> dictionary.take per group column + AggFunc.dense_values per agg -> rows

It applies only to FULL results (the set executor's outputs for every
segment): server partials that merge with other servers keep the state-dict
form. It declines (returns None) for aggregations without `dense_values`
(sketch and value-set states, among them every `distinct` output), HAVING,
GAPFILL, DISTINCT rewrites, post-aggregation arithmetic in the select list, or an
ORDER BY that is not a plain group column or aggregation reference. Where
`dense_values` gives NaN for a null (`dense_nan_is_null`: VAR_SAMP of a
single row), the row holds None, as the scalar `finalize` gives.

ORDER BY on a group column sorts by dict ids: dictionaries are sorted, so id
order is value order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .aggregates import AggFunc
from .context import QueryContext
from .result import ResultTable


def _dense_capable(agg) -> bool:
    return type(agg).dense_values is not AggFunc.dense_values


def try_dense_decode(ctx: QueryContext, plan, outs) -> Optional[ResultTable]:
    """ResultTable from a set's dense kernel outputs, or None -> classic path."""
    if not plan.group_cols or ctx.having is not None or ctx.gapfill is not None \
            or ctx.distinct:
        return None
    if len(ctx.group_by) != len(plan.group_cols):
        return None
    if not all(_dense_capable(a) for a in plan.aggs):
        return None

    group_reprs = {repr(g): j for j, g in enumerate(ctx.group_by)}
    agg_reprs = {repr(call): i for i, call in enumerate(ctx.aggregations)}

    def ref(expr):
        r = repr(expr)
        if r in group_reprs:
            return ("group", group_reprs[r])
        if r in agg_reprs:
            return ("agg", agg_reprs[r])
        return None

    # select items must be plain group/agg references (no post-arithmetic)
    sel = [ref(expr) for expr, _ in ctx.select_items]
    order = [(ref(o.expr), o) for o in ctx.order_by]
    if None in sel or any(r is None for r, _ in order):
        return None

    counts_all = np.asarray(outs["count"][:plan.num_keys_real])
    occupied = np.nonzero(counts_all > 0)[0]
    num_docs = int(counts_all.sum())
    counts = counts_all[occupied]

    def ids_for(j: int) -> np.ndarray:
        return (occupied // plan.strides[j]) % max(plan.cards[j], 1)

    agg_vals: dict = {}

    def agg_for(i: int) -> np.ndarray:
        if i not in agg_vals:
            def get(name):
                if name == "count":
                    return counts
                return np.asarray(outs[f"{i}.{name}"][:plan.num_keys_real])[occupied]
            agg_vals[i] = plan.aggs[i].dense_values(get, counts)
        return agg_vals[i]

    # -- ORDER BY over all occupied groups, then offset/limit ---------------
    if order:
        keys = []
        for (kind, idx), o in reversed(order):  # lexsort: last key primary
            arr = ids_for(idx) if kind == "group" else agg_for(idx)
            arr = np.asarray(arr, dtype=np.float64 if arr.dtype.kind == "f" else np.int64)
            # a NaN ranks as reduce._sort_key ranks a null: largest unless
            # NULLS FIRST/LAST says otherwise
            is_null = arr != arr
            if is_null.any():
                arr = np.where(is_null, 0.0, arr)
            keys.append(-arr if o.desc else arr)
            if is_null.any():
                nulls_last = o.nulls_last if o.nulls_last is not None else not o.desc
                keys.append(is_null if nulls_last else ~is_null)
        take = np.lexsort(keys)
    else:
        take = np.arange(len(occupied))
    take = take[ctx.offset:ctx.offset + ctx.limit]

    # -- materialize only the emitted slice ---------------------------------
    # rows build through one object ndarray + C-level tolist(), not a Python loop
    table = np.empty((len(take), len(sel)), dtype=object)
    nan_null_cols = []
    for ci, (kind, idx) in enumerate(sel):
        if kind == "group":
            ids_j = ids_for(idx)[take].astype(np.int64)
            col = plan.group_cols[idx]
            table[:, ci] = plan.segment.column(col).dictionary.take(ids_j).tolist()
        else:
            table[:, ci] = np.asarray(agg_for(idx))[take].tolist()
            if plan.aggs[idx].dense_nan_is_null:
                nan_null_cols.append(ci)
    rows = table.tolist()
    for ci in nan_null_cols:
        for r in rows:
            if isinstance(r[ci], float) and r[ci] != r[ci]:
                r[ci] = None
    return ResultTable([name for _, name in ctx.select_items], rows,
                       {"numDocsScanned": num_docs, "numGroups": len(occupied),
                        "denseReduce": True})
