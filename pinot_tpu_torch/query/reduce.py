"""Combine + reduce: merge per-segment partials, finalize, project, HAVING/ORDER/LIMIT.

A subset of `pinot_tpu/query/reduce.py` (analog of the reference's combine
operators and broker reduce): the value-keyed merge of group, scalar and
selection partials and the final reduce. Group keys are decoded to values
before leaving a segment, so partials merge whatever each segment's
dictionaries are. A selection partial carries its rows with their exact sort
keys, and the reduce re-sorts the merged rows (`_sort_key`, a stable sort, so
rows with equal keys keep their merge order) before OFFSET and LIMIT.

A high-cardinality server partial over aligned dictionaries stays in array
form (`DensePartial`: the kernel's dense count and output arrays, keyed by a
token of the group columns, cardinalities, dictionary hashes and key count):
partials with one token merge elementwise, and the reduce finalizes them
vectorized over the occupied keys (`AggFunc.dense_values`). A merge that
also holds dict partials (a consuming segment's beside a pipeline's) or
several tokens sums each token's partials elementwise first and turns each
sum into the dict form once (`SegmentResult.materialize_dense`). GAPFILL
re-buckets the reduced rows (`_apply_gapfill`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..engine.expr import eval_host
from ..sql.ast import Expr, Function, Identifier
from .aggregates import AggFunc
from .context import QueryContext
from .result import ResultTable


@dataclass
class DensePartial:
    """A group-by partial in array form over an aligned dense key space.

    At high cardinality the dict-of-states partial is the bottleneck:
    building (and merging) 500,000 Python state lists costs seconds while the
    kernel runs in milliseconds. When every aggregation is dense-finalizable
    and the servers share aligned dictionaries (equal `token`), partials stay
    as the kernel's dense output arrays end to end: merge is elementwise
    (+ / min / max) and the reduce finalizes vectorized (reference contrast:
    GroupByDataTableReducer's IndexedTable hash merge)."""

    token: Tuple                  # (group cols, cards, dict hashes, num_keys)
    cards: Tuple[int, ...]
    strides: Tuple[int, ...]
    num_keys_real: int
    counts: np.ndarray            # int64[num_keys_real] (exact, mergeable by +)
    outs: Dict[str, np.ndarray]   # "<agg idx>.<out>" arrays, trimmed to real keys
    group_values: List[Any]       # per group col: the full dictionary value table
    # lets a consumer materialize state dicts without replanning
    aggs: Optional[List[AggFunc]] = None

    def merge_from(self, other: "DensePartial") -> None:
        self.counts = self.counts + other.counts
        for k, v in other.outs.items():
            if k.endswith(".min"):
                self.outs[k] = np.minimum(self.outs[k], v)
            elif k.endswith(".max"):
                self.outs[k] = np.maximum(self.outs[k], v)
            else:
                self.outs[k] = self.outs[k] + v


@dataclass
class SegmentResult:
    """Partial result of one segment (reference: IntermediateResultsBlock)."""

    kind: str  # "groups" | "scalar" | "selection"
    groups: Dict[Tuple, List[Any]] = field(default_factory=dict)  # key values -> agg states
    scalar: Optional[List[Any]] = None                            # agg states (no group-by)
    num_docs_scanned: int = 0
    rows: List[Tuple] = field(default_factory=list)       # selection: select-list cells
    sort_keys: List[Tuple] = field(default_factory=list)  # selection: ORDER BY values
    # selection: an ORDER BY answered by the exact path (every match gathered
    # on the host) instead of the device top-k
    topk_exact: bool = False
    # a high-cardinality array-form partial; when set, `groups` is empty
    # until `materialize_dense` converts it (consumers of the dict form call it)
    dense: Optional[DensePartial] = None
    # a server's partial: the segments it covered (None for a segment's own
    # partial), which lets the broker retry a segment a replica skipped, and
    # the flat stats record (`ExecutionStats.to_wire`) the broker merges
    served: Optional[List[str]] = None
    stats: Optional[Dict[str, float]] = None

    def materialize_dense(self, aggs: Optional[List[AggFunc]] = None) -> None:
        """Turn the array-form partial into the state dict (for a merge with
        dict partials or another token)."""
        dp = self.dense
        if dp is None:
            return
        use_aggs = aggs if aggs is not None else dp.aggs
        if use_aggs is None:
            raise ValueError("a dense partial needs its aggregations to materialize")
        occupied = np.nonzero(dp.counts > 0)[0]
        value_cols = [np.asarray(dp.group_values[j])[(occupied // dp.strides[j])
                                                     % max(dp.cards[j], 1)]
                      for j in range(len(dp.strides))]
        keys = list(zip(*[c.tolist() for c in value_cols])) if len(occupied) else []
        for row, k in enumerate(occupied):
            states = []
            for i, agg in enumerate(use_aggs):
                o = {"count": int(dp.counts[k])}
                for out_name in agg.device_outputs:
                    if out_name != "count":
                        o[out_name] = dp.outs[f"{i}.{out_name}"][k]
                states.append(agg.state_from_device(o))
            self.groups[keys[row]] = states
        self.dense = None


def merge_segment_results(results: List[SegmentResult], aggs: List[AggFunc]) -> SegmentResult:
    """Server-level combine of per-segment partials."""
    if not results:
        return SegmentResult("scalar", scalar=None)
    kind = results[0].kind
    out = SegmentResult(kind)
    out.num_docs_scanned = sum(r.num_docs_scanned for r in results)
    if kind == "groups":
        # array-form partials of one token (aligned dictionaries agree on
        # dense keys) combine elementwise, with no state dict built
        by_token: Dict[Tuple, List[SegmentResult]] = {}
        for r in results:
            if r.dense is not None:
                by_token.setdefault(r.dense.token, []).append(r)
        if len(by_token) == 1 and all(r.dense is not None for r in results):
            out.dense = _merge_dense([r.dense for r in results])
            return out
        # mixed with state-dict partials (a consuming segment's beside a
        # pipeline's), or several tokens: each token's partials sum
        # elementwise and the sum becomes a state dict once (a token's one
        # partial converts in place, as any partial a dict merge reads)
        dicts = [rs[0] if len(rs) == 1 else
                 SegmentResult("groups", dense=_merge_dense([r.dense for r in rs]))
                 for rs in by_token.values()]
        converted = {id(r) for r in dicts}
        for r in dicts:
            r.materialize_dense(aggs)
        merged: Dict[Tuple, List[Any]] = {}
        for r in dicts + [r for r in results if r.dense is None and id(r) not in converted]:
            for key, states in r.groups.items():
                cur = merged.get(key)
                if cur is None:
                    merged[key] = list(states)
                else:
                    for i, agg in enumerate(aggs):
                        cur[i] = agg.merge(cur[i], states[i])
        out.groups = merged
    elif kind == "scalar":
        merged_states: Optional[List[Any]] = None
        for r in results:
            if r.scalar is None:
                continue
            if merged_states is None:
                merged_states = list(r.scalar)
            else:
                for i, agg in enumerate(aggs):
                    merged_states[i] = agg.merge(merged_states[i], r.scalar[i])
        out.scalar = merged_states
    else:
        for r in results:
            out.rows.extend(r.rows)
            out.sort_keys.extend(r.sort_keys)
            out.topk_exact = out.topk_exact or r.topk_exact
    return out


def _merge_dense(denses: List[DensePartial]) -> DensePartial:
    """The elementwise sum of array-form partials of one token, in a new
    partial (the inputs stay as they were)."""
    base = denses[0]
    acc = DensePartial(base.token, base.cards, base.strides, base.num_keys_real,
                       base.counts.astype(np.int64, copy=True),
                       {k: v.copy() for k, v in base.outs.items()},
                       base.group_values, aggs=base.aggs)
    for d in denses[1:]:
        acc.merge_from(d)
    return acc


def _object_array(vals: List[Any]) -> np.ndarray:
    out = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        out[i] = v
    return out


def reduce_to_result(ctx: QueryContext, merged: SegmentResult, aggs: List[AggFunc],
                     group_exprs: List[Expr]) -> ResultTable:
    """Broker-side reduce: finalize states, post-aggregate, HAVING, ORDER BY, LIMIT."""
    if merged.kind == "selection":
        return _reduce_selection(ctx, merged)
    env: Dict[str, np.ndarray] = {}
    if merged.kind == "groups" and merged.dense is not None:
        # an array-form partial: finalize vectorized over the occupied keys
        # (each aggregation's dense_values, a dictionary take per group
        # column) instead of the per-group state loop below
        dp = merged.dense
        occupied = np.nonzero(dp.counts > 0)[0]
        n = len(occupied)
        counts_occ = dp.counts[occupied]
        for j, g in enumerate(group_exprs):
            ids_j = (occupied // dp.strides[j]) % max(dp.cards[j], 1)
            env[repr(g)] = _object_array(np.asarray(dp.group_values[j])[ids_j].tolist())
        for i, call in enumerate(ctx.aggregations):
            def get(name, i=i):
                return counts_occ if name == "count" else dp.outs[f"{i}.{name}"][occupied]

            vals = np.asarray(aggs[i].dense_values(get, counts_occ))
            cells = _object_array(vals.tolist())
            if aggs[i].dense_nan_is_null and vals.dtype.kind == "f":
                # where the dense form gives NaN, `finalize` gives None
                for bad in np.nonzero(vals != vals)[0]:
                    cells[bad] = None
            env[repr(call)] = cells
    elif merged.kind == "groups":
        keys = list(merged.groups.keys())
        n = len(keys)
        for j, g in enumerate(group_exprs):
            env[repr(g)] = np.array([k[j] for k in keys], dtype=object)
        for i, call in enumerate(ctx.aggregations):
            vals = [aggs[i].finalize(merged.groups[k][i]) for k in keys]
            env[repr(call)] = _object_array(vals)
    else:
        n = 1
        states = merged.scalar
        for i, call in enumerate(ctx.aggregations):
            v = (aggs[i].finalize(states[i]) if states is not None
                 else aggs[i].empty_result())
            env[repr(call)] = _object_array([v])

    keep = np.ones(n, dtype=bool)
    if ctx.having is not None:
        keep &= np.asarray(_eval_result(ctx.having, env, n), dtype=bool)

    out_cols: List[np.ndarray] = []
    for expr, _name in ctx.select_items:
        out_cols.append(np.asarray(_eval_result(expr, env, n), dtype=object))

    idx = np.nonzero(keep)[0].tolist()
    if ctx.order_by:
        sort_cols = [np.asarray(_eval_result(o.expr, env, n), dtype=object)
                     for o in ctx.order_by]
        idx.sort(key=lambda i: _sort_key(
            [c[i] for c in sort_cols], ctx.order_by))

    if ctx.gapfill is not None:
        rows = _apply_gapfill(ctx, group_exprs, [[col[i] for col in out_cols] for i in idx])
        if ctx.order_by:
            # gap rows come series first, buckets ascending: re-apply the
            # query's ORDER BY (over select-item columns) before OFFSET/LIMIT
            sel_repr = {repr(e): j for j, (e, _) in enumerate(ctx.select_items)}
            cols = [sel_repr.get(repr(o.expr)) for o in ctx.order_by]
            if all(c is not None for c in cols):
                rows.sort(key=lambda r: _sort_key([r[c] for c in cols], ctx.order_by))
        rows = rows[ctx.offset:ctx.offset + ctx.limit]
        return ResultTable([name for _, name in ctx.select_items], _pyify(rows),
                           {"numDocsScanned": merged.num_docs_scanned, "gapfilled": True})

    idx = idx[ctx.offset:ctx.offset + ctx.limit]
    rows = [[col[i] for col in out_cols] for i in idx]
    return ResultTable([name for _, name in ctx.select_items], _pyify(rows),
                       {"numDocsScanned": merged.num_docs_scanned,
                        "numGroupsTotal": n if merged.kind == "groups" else None})


def _apply_gapfill(ctx: QueryContext, group_exprs: List[Expr],
                   rows: List[List[Any]]) -> List[List[Any]]:
    """Fill the missing time buckets of each series (reference:
    GapfillProcessor). The output is ordered series by series in first-seen
    order, then by time bucket ascending; a series' key is its non-time
    group-by select items. A gap row takes FILL_PREVIOUS_VALUE's last value
    the series had (None before its first), FILL_DEFAULT_VALUE's default, or
    None."""
    gf = ctx.gapfill
    ti = gf.index
    group_reprs = {repr(g) for g in group_exprs}
    key_idx = [j for j, (e, _) in enumerate(ctx.select_items)
               if j != ti and repr(e) in group_reprs]

    series: Dict[Tuple, Dict[Any, List[Any]]] = {}
    for row in rows:
        series.setdefault(tuple(row[j] for j in key_idx), {})[row[ti]] = row

    out: List[List[Any]] = []
    for key, by_time in series.items():
        prev: Dict[int, Any] = {}
        for b in range(gf.start, gf.end, gf.bucket):
            row = by_time.get(b)
            if row is None:
                row = [None] * len(ctx.select_items)
                row[ti] = b
                for j, v in zip(key_idx, key):
                    row[j] = v
                for j in range(len(row)):
                    if j == ti or j in key_idx:
                        continue
                    mode, default = gf.fills.get(j, (None, None))
                    if mode == "FILL_PREVIOUS_VALUE":
                        row[j] = prev.get(j)
                    elif mode == "FILL_DEFAULT_VALUE":
                        row[j] = default
            else:
                for j in range(len(row)):
                    prev[j] = row[j]
            out.append(row)
    return out


def _reduce_selection(ctx: QueryContext, merged: SegmentResult) -> ResultTable:
    order = list(range(len(merged.rows)))
    if ctx.order_by:
        order.sort(key=lambda i: _sort_key(list(merged.sort_keys[i]), ctx.order_by))
    order = order[ctx.offset:ctx.offset + ctx.limit]
    rows = [list(merged.rows[i]) for i in order]
    return ResultTable([name for _, name in ctx.select_items], _pyify(rows),
                       {"numDocsScanned": merged.num_docs_scanned,
                        "topkExact": merged.topk_exact})


class _Reverse:
    """Inverts comparison order for DESC keys of arbitrary comparable type."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def _sort_key(values: List[Any], order_by) -> Tuple:
    key = []
    for v, o in zip(values, order_by):
        # null ordering: null is largest unless NULLS FIRST/LAST is given
        nulls_last = o.nulls_last if o.nulls_last is not None else not o.desc
        is_null = v is None
        null_rank = (1 if is_null else 0) if nulls_last else (0 if is_null else 1)
        v = 0 if is_null else v
        key.append((null_rank, _Reverse(v) if o.desc else v))
    return tuple(key)


def _eval_result(e: Expr, env: Dict[str, np.ndarray], n: int):
    """Evaluate a result-shaping expression: aggregation/group subtrees come from `env`
    (keyed by canonical repr), remaining arithmetic evaluates on the host."""
    sub, bindings = _substitute(e, env)
    out = eval_host(sub, bindings)
    if np.isscalar(out) or not hasattr(out, "__len__"):
        return np.full(n, out, dtype=object)
    return out


def _substitute(e: Expr, env: Dict[str, np.ndarray], bindings=None):
    if bindings is None:
        bindings = {}
    r = repr(e)
    if r in env:
        name = f"\x00{len(bindings)}"
        for k, v in bindings.items():   # reuse the binding of identical subtrees
            if v is env[r]:
                name = k
                break
        bindings[name] = env[r]
        return Identifier(name), bindings
    if isinstance(e, Function):
        new_args = []
        for a in e.args:
            na, bindings = _substitute(a, env, bindings)
            new_args.append(na)
        return Function(e.name, tuple(new_args), e.distinct), bindings
    if isinstance(e, Identifier):
        raise KeyError(f"unresolved column {e.name!r} in post-aggregation expression")
    return e, bindings


def _pyify(rows: List[List[Any]]) -> List[List[Any]]:
    return [[v.item() if isinstance(v, np.generic) else v for v in row] for row in rows]
