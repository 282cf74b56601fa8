"""Per-server query executor: plan + run each segment, combine, reduce.

Counterpart of `pinot_tpu/query/executor.py` (analog of the reference's
`ServerQueryExecutorV1Impl.processQuery`). Each segment is planned
(`planner.py`) and executed:

* scalar device plans whose filter is an AND of single dict-id bands and
  whose outputs are COUNT and plain SUMs (AVG included) run through the CUDA
  masked multi-sum scan (`engine/scan.py`), routed by `scan_route`; a SUM
  argument may be any device expression (`expr.eval_device`), evaluated into
  the scan's operand row;
* every other device plan runs the plain-PyTorch body (`engine/kernels.py`),
  whose `distinct` output (per-dict-id counts or presence of the filtered
  rows, scalar or per group) the decode turns into DISTINCTCOUNT, HLL, theta
  and t-digest states through the argument's dictionary;
* host plans run `_host_aggregate`: the filter mask (`host_filter_mask`) and
  the arguments and group keys (`expr.eval_host`, with the whole function
  library) in numpy, grouped by `_factorize_keys`. The planner marks a plan
  host exactly where the JAX planner does, so nothing the device can run
  comes here;
* selections take the filter mask on the device and gather the selected
  rows on the host; a selection whose filter the device cannot evaluate (the
  plan's `fallback_reason`) takes `host_filter_mask`. An `ORDER BY <column>
  LIMIT k` whose key the device can sort (`topk_order_key_device_ok`) and
  whose mask the device evaluates picks its candidates with the fused filter
  + top-k (`kernels.compute_topk`, k + TOPK_SLACK of them); any other ORDER
  BY, a top-k that NaN or -inf keys displaced, and one whose DOUBLE keys tie
  in f32 at the candidates' cut (`f32_tie_at_the_cut`), takes the exact path:
  every match gathered and sorted on the host, counted in the result's
  `stats["topkExact"]`. A selection without ORDER BY keeps the first OFFSET +
  LIMIT matches of each segment.

A consuming segment without device staging is mutable: it is planned on the
host, its dictionary leaves rebuilt against one `dict_snapshot` of its
readers, and a realtime inverted index (the row-append segment's) read
through a view bound to that snapshot. A consuming segment's view that
stages on the device (`segment.mutable_device.ConsumingView`,
`is_mutable=False`) runs as an immutable segment does, its block already
holding the staged chunks.

A segment with a star-tree that fits the query (`startree_exec.try_star_tree`)
answers from the tree's record table: the slot query runs over the tree's
view with the traversal's record mask as `valid_docs` (a plain array, which
keeps it off the scan route), and `reassemble` turns the slot states back
into the query's.

Upsert (`execute(..., upsert=)`): each segment, committed or consuming,
answers under its valid-doc mask from the table's upsert metadata, one live
row per primary key; no star-tree answers under a mask, and an upsert table
is never stacked into a set. The mask (an `upsert.ValidDocs`, which names
the segment's version) reaches `valid_docs`: a scan plan carries it as one
more int32 band row (`SegmentBlock.valid_band`, staged once per version),
the plain body ANDs it into `valid` (and the bitmap filter packs it into
its valid words), a host plan ANDs it into its mask.

Device plans whose filter the scan does not take evaluate their selective
dictionary leaves over the bitmap index (`planner.select_bitmap_leaves`,
the kernel of `engine/bitmap.py`); null leaves read the column's null
bitmap, doc-set leaves (IN_ID_SET over a raw column) a host mask. A selective dictionary leaf of the host filter mask
reads the inverted index's postings instead of the forward index.

Multi-value columns: a dictionary leaf over one reads the column's padded
[rows, W] id matrix and matches a row if any of its values matches
(`KernelSpec.mv_cols`); such a leaf never takes the scan route
(`_band_leaf_indices`), whose bands read one id per row. The host filter
mask reduces the LUT over the CSR per row; a host GROUP BY explodes a row
into one group row per value of its (one) multi-value key; selections
return a multi-value cell as a list.

EXPLAIN PLAN FOR answers with the plan tree (`explain.explain_result`) and
launches nothing; EXPLAIN ANALYZE executes the query under a fresh stats
record (`_execute_analyze`) and annotates the tree with the rows and
milliseconds each segment plan, COMBINE and BROKER_REDUCE recorded.

Shapes this package does not execute raise NotImplementedError with their
reason. Nothing falls back to another path: the host runs only what the
planner marks host, and what a server's tiering gate keeps off the card: its
host-tier executor (`use_device=False`, the JAX package's) runs a device plan
as a host plan, a selection's filter on the host and no top-k, and stages
nothing.

The entry points run on CUDA unless the caller passes `device="cpu"`; with
no CUDA card they raise RuntimeError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..engine import kernels, scan
from ..engine.bitmap import BitmapLeaf
from ..engine.datablock import SegmentBlock, block_for, for_delta_dtype, lut_size
from ..engine.expr import eval_device, eval_host
from ..engine.kernels import KernelInputs, KernelSpec, run_kernel
from ..segment.reader import ColumnReader, ImmutableSegment, MVValues, mv_values
from ..sql.ast import Identifier, identifiers_in
from ..upsert import ValidDocs
from . import stats as qstats
from .aggregates import make_agg
from .context import QueryContext, QueryValidationError, compile_query
from .dense_reduce import _dense_capable
from .explain import analyze_result, explain_result
from .planner import (SegmentPlan, build_device_geometry, plan_segment,
                      select_bitmap_leaves, topk_key_exact_in_f32, topk_order_key_device_ok)
from .predicate import CmpLeaf, DocSetLeaf, LutLeaf, NullLeaf
from .reduce import DensePartial, SegmentResult, merge_segment_results, reduce_to_result
from .result import ResultTable
from .startree_exec import StarTreePlan, reassemble, try_star_tree

#: per-segment plan kind -> the EXPLAIN label family it annotates in EXPLAIN
#: ANALYZE (prefix-matched against the plan nodes' labels)
PLAN_OP_LABELS = {"empty": "PRUNED", "metadata": "METADATA_ONLY_AGGREGATE",
                  "selection": "SELECT", "device": "DEVICE_FUSED", "host": "HOST"}

#: below this dense key count the state-dict partial is cheap enough that the
#: array form (`reduce.DensePartial`, which carries whole dictionaries) only
#: adds weight
DENSE_PARTIAL_MIN_GROUPS = 4096

MAX_DEVICE_TOPK = 65536   # the largest OFFSET + LIMIT the device top-k takes
# candidates beyond k, so that f32 ties at the k-th key cannot evict a true
# top-k row (the final order is exact: candidates re-sort on the host in f64)
TOPK_SLACK = 256


def resolve_device(device=None) -> torch.device:
    """The execution device: CUDA unless the caller names another. Asking for
    CUDA on a machine without a usable card raises instead of running elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pinot_tpu_torch runs on a CUDA card "
                           "unless the caller passes device='cpu'")
    return dev


class ServerQueryExecutor:
    """Executes a QueryContext over a set of local segments on one device;
    with `use_device=False`, on the host alone (a server's host tier)."""

    def __init__(self, device=None, use_device: bool = True):
        self.device = resolve_device(device)
        self.use_device = use_device

    def execute(self, segments: Sequence[ImmutableSegment],
                query: Union[str, QueryContext], schema=None,
                star_plans: Optional[Sequence[StarTreePlan]] = None,
                upsert=None) -> ResultTable:
        """`star_plans`: each segment's StarTreePlan, already traversed (the
        set executor's), or None to fit each segment here. `upsert`: the
        table's `upsert.TableUpsertMetadataManager`; each segment (committed,
        or a consumer's `query_segment()`) then answers under
        `upsert.valid_mask(name, num_docs)`, None meaning every row is
        visible, as the JAX package's server does."""
        if upsert is not None and star_plans is not None:
            raise ValueError("an upsert table's segments answer under their valid-doc "
                             "masks: no star-tree plan applies")
        t0 = time.perf_counter()
        ctx = compile_query(query, schema or (segments[0].schema if segments else None)) \
            if isinstance(query, str) else query
        if ctx.analyze:
            return self._execute_analyze(segments, ctx, star_plans, upsert)
        if ctx.explain:
            return explain_result(ctx, segments, star_plans=star_plans, upsert=upsert)
        aggs = [make_agg(f) for f in ctx.aggregations]
        group_exprs = ([e for e, _ in ctx.select_items] if ctx.distinct
                       else list(ctx.group_by))
        t_compile = time.perf_counter()
        results = [self.execute_segment(
            ctx, seg, valid_docs=None if upsert is None else upsert.valid_mask(seg.name,
                                                                                seg.num_docs),
            star=None if star_plans is None else star_plans[i])
            for i, seg in enumerate(segments)]
        t_scan = time.perf_counter()
        merged = merge_segment_results(results, aggs)
        if not results:
            merged.kind = "groups" if group_exprs else "scalar" if aggs else "selection"
        result = reduce_to_result(ctx, merged, aggs, group_exprs)
        result.stats["phaseTimesMs"] = {
            "compile": round((t_compile - t0) * 1000, 3),
            "scan": round((t_scan - t_compile) * 1000, 3),
            "reduce": round((time.perf_counter() - t_scan) * 1000, 3),
        }
        # per-operator rollups for EXPLAIN ANALYZE (no-op without a record)
        qstats.record_operator("COMBINE", rows=merged.num_docs_scanned,
                               ms=(t_scan - t_compile) * 1000)
        qstats.record_operator("BROKER_REDUCE", rows=len(result.rows),
                               ms=(time.perf_counter() - t_scan) * 1000)
        return result

    def _execute_analyze(self, segments: Sequence[ImmutableSegment], ctx: QueryContext,
                         star_plans=None, upsert=None) -> ResultTable:
        """EXPLAIN ANALYZE: run the query under a fresh stats record, then
        render the plan tree with each node's rows and milliseconds (the
        JAX package's postgres-style EXPLAIN ANALYZE)."""
        run_ctx = dataclasses.replace(ctx, explain=False, analyze=False)
        t0 = time.perf_counter()
        with qstats.collect_stats() as st:
            inner = self.execute(segments, run_ctx, star_plans=star_plans, upsert=upsert)
        return analyze_result(ctx, segments, st, inner, (time.perf_counter() - t0) * 1000,
                              star_plans=star_plans, upsert=upsert)

    # -- per-segment execution --------------------------------------------
    def execute_segment(self, ctx: QueryContext, segment: ImmutableSegment,
                        valid_docs: Optional[np.ndarray] = None,
                        star: Optional[StarTreePlan] = None) -> SegmentResult:
        """One segment's partial; `valid_docs` restricts it to the rows it sets.
        A star-tree that fits the query answers instead of the rows (not under
        a valid-doc mask: pre-aggregated records cannot honour one); `star` is
        that fit when the caller has already traversed the tree."""
        if valid_docs is None and not getattr(segment, "is_mutable", False):
            stp = star if star is not None else try_star_tree(ctx, segment)
            if stp is not None:
                sub = self.execute_segment(stp.ctx2, stp.tree.view, valid_docs=stp.record_mask)
                reassemble(stp, sub)
                return sub
        plan = plan_segment(ctx, segment, valid_docs=valid_docs)
        if not self.use_device and plan.kind in ("device", "selection"):
            if plan.kind == "device":
                plan.kind = "host"
            plan.fallback_reason = plan.fallback_reason or "device disabled"
        t0 = time.perf_counter()
        if plan.kind == "empty":
            r = self._empty_result(plan)
        elif plan.kind == "metadata":
            r = self._metadata_result(plan)
        elif plan.kind == "device":
            r = self._device_aggregate(plan)
        elif plan.kind == "selection":
            r = self._selection(plan)
        else:
            r = self._host_aggregate(plan)
        st = qstats.current_stats()
        if st is not None:
            ms = (time.perf_counter() - t0) * 1000
            if plan.kind == "empty":
                st.add(qstats.NUM_SEGMENTS_PRUNED)
                st.add(qstats.SCAN_ROWS_AVOIDED, segment.num_docs)
            else:
                st.add(qstats.NUM_SEGMENTS_QUERIED)
                if (r.num_docs_scanned > 0 or r.groups or r.rows or r.dense is not None
                        or plan.kind == "metadata"):
                    st.add(qstats.NUM_SEGMENTS_MATCHED)
            st.add_operator("SEGMENT_PLAN", rows=r.num_docs_scanned, ms=ms)
            st.add_operator(PLAN_OP_LABELS[plan.kind], rows=r.num_docs_scanned, ms=ms)
        return r

    def _empty_result(self, plan: SegmentPlan) -> SegmentResult:
        if plan.group_exprs:
            return SegmentResult("groups")
        if not plan.ctx.is_aggregation_query:
            return SegmentResult("selection")
        empty = np.empty(0, dtype=np.float64)
        return SegmentResult("scalar",
                             scalar=[a.host_state(empty) for a in plan.aggs] or None)

    def _metadata_result(self, plan: SegmentPlan) -> SegmentResult:
        """Answer from metadata without scanning (NonScanBasedAggregationOperator)."""
        seg = plan.segment
        states: List[Any] = []
        for agg in plan.aggs:
            if agg.name == "count":
                states.append(seg.num_docs)
            else:
                reader = seg.column(agg.arg.name)
                mn, mx = float(reader.min_value), float(reader.max_value)
                states.append({"min": mn, "max": mx}.get(agg.name, (mn, mx)))
        return SegmentResult("scalar", scalar=states, num_docs_scanned=0)

    # -- device aggregation -------------------------------------------------
    def _device_aggregate(self, plan: SegmentPlan) -> SegmentResult:
        build_device_geometry(plan)
        block = block_for(plan.segment, self.device)
        route = scan_route(plan)
        if route is not None:
            return self._scan_aggregate(plan, route, block)
        plan.bitmap_leaves = select_bitmap_leaves(plan, plan.segment)
        spec = kernel_spec(plan)
        outs = run_kernel(spec, self._kernel_inputs(plan, spec, block))
        outs = kernels.fetch_outputs(outs)
        if plan.group_cols:
            return self._decode_group_partials(plan, outs)
        return self._decode_scalar_partials(plan, outs)

    def _scan_aggregate(self, plan: SegmentPlan, route: str,
                        block: SegmentBlock) -> SegmentResult:
        """A scalar plan through the masked multi-sum scan. The scan covers the
        segment's real rows only (`n = num_docs`), so padding never enters it."""
        operands = _sum_operands(plan)
        args = self.scan_inputs(plan, route, block)
        answer = (scan.masked_sums_fused_answer if route == "masked_sums_fused"
                  else scan.masked_sums_answer)(*args)
        host_sums, host_count = scan.answer_to_host(answer, len(operands))   # one copy
        outs = {"count": host_count}
        for (ai, _), s in zip(operands, host_sums):
            outs[f"{ai}.sum"] = s
        return self._decode_scalar_partials(plan, outs)

    def scan_inputs(self, plan: SegmentPlan, route: str, block: SegmentBlock) -> tuple:
        """The scan's (id columns, bands, operands) of a plan `scan_route`
        sends to `route`: each band leaf's ids and interval, an upsert mask as
        its int32 band row with (1, 1) last, and the sum operands (f32 rows,
        or (base, deltas) FOR pairs for the fused scan), cut to the segment's
        rows."""
        n = plan.segment.num_docs
        leaves = [plan.filter_prog.leaves[i] for i in _band_leaf_indices(plan)]
        id_cols = [block.ids(leaf.col)[:n] for leaf in leaves]
        bands = [leaf.intervals[0] for leaf in leaves]
        if plan.valid_docs is not None:
            id_cols.append(block.valid_band(plan.valid_docs))
            bands.append((1, 1))
        operands = _sum_operands(plan)
        if route == "masked_sums_fused":
            for_rows = []
            for _, arg in operands:
                base, deltas = block.for_form(arg.name)
                for_rows.append((base, deltas[:n]))
            return id_cols, bands, for_rows
        env = {c: v[:n] for c, v in self._value_env(plan, block).items()}
        rows = [kernels.as_rows(eval_device(arg, env), n, self.device).to(torch.float32)
                for _, arg in operands]
        return id_cols, bands, rows

    def _value_env(self, plan: SegmentPlan, block: SegmentBlock):
        """Decoded value columns the plan reads, from their resident forms: a
        FOR column as deltas plus base (int32), any other column through
        `SegmentBlock.values` (a dict column as one gather of its decode table)."""
        env = {}
        for_cols = _for_cols(plan)
        for c in _plan_vals_cols(plan):
            if c in for_cols:
                base, deltas = block.for_form(c)
                env[c] = deltas.to(torch.int32) + base
            else:
                env[c] = block.values(c)
        return env

    def _kernel_inputs(self, plan: SegmentPlan, spec: KernelSpec,
                       block: SegmentBlock) -> KernelInputs:
        ids_cols = set(plan.group_cols) | distinct_cols(plan)
        luts, iscal, fscal, docsets, bitmaps = [], [], [], [], []
        nulls = {}
        # in leaf order: must mirror KernelSpec.__post_init__ routing
        for i, leaf in enumerate(plan.filter_prog.leaves):
            if i in spec.bitmap_index:
                bitmaps.append(bitmap_leaf(block.bitmap_words(leaf.col), leaf))
            elif isinstance(leaf, LutLeaf):
                ids_cols.add(leaf.col)
                if leaf.intervals is not None:
                    for lo, hi in leaf.intervals:
                        iscal.extend((lo, hi))
                else:
                    luts.append(torch.from_numpy(leaf.lut).to(self.device))
            elif isinstance(leaf, CmpLeaf):
                (iscal if leaf.is_int else fscal).extend(leaf.operands)
            elif isinstance(leaf, NullLeaf):
                nulls[leaf.col] = block.null_mask(leaf.col)
            elif isinstance(leaf, DocSetLeaf):
                docsets.append(self._padded_rows(leaf.mask, block))
        valid, valid_words = block.valid, block.valid_words
        if plan.valid_docs is not None:
            valid = valid & self._padded_rows(plan.valid_docs, block)
            valid_words = None    # packed from `valid` when a bitmap leaf needs it
        return KernelInputs(
            ids={c: block.ids(c) for c in ids_cols},
            vals=self._value_env(plan, block),
            luts=tuple(luts),
            iscal=[int(v) for v in iscal],
            fscal=[float(v) for v in fscal],
            valid=valid,
            strides=list(plan.strides),
            nulls=nulls,
            docsets=tuple(docsets),
            bitmaps=tuple(bitmaps),
            valid_words=valid_words,
        )

    def _padded_rows(self, mask: np.ndarray, block: SegmentBlock) -> torch.Tensor:
        """A host row mask as a bool tensor of the block's padded rows."""
        padded = np.zeros(block.padded, dtype=bool)
        padded[:min(len(mask), block.num_docs)] = mask[:block.num_docs]
        return torch.from_numpy(padded).to(self.device)

    def _decode_group_partials(self, plan: SegmentPlan, outs,
                               trim_global: bool = False) -> SegmentResult:
        """Group partials from dense outputs. With `trim_global` (outputs of
        every segment, as the set executor's full result has them) an ORDER BY
        on an aggregation decodes only the groups LIMIT can return."""
        seg = plan.segment
        counts = outs["count"][:plan.num_keys_real]
        occupied = np.nonzero(counts > 0)[0]
        if trim_global:
            occupied = _trim_occupied(plan, outs, occupied)
        # dense keys -> per-column dict ids -> values (vectorized per column)
        value_cols = []
        for j, col in enumerate(plan.group_cols):
            ids_j = (occupied // plan.strides[j]) % max(plan.cards[j], 1)
            value_cols.append(seg.column(col).dictionary.take(ids_j.astype(np.int64)))
        keys = list(zip(*[c.tolist() for c in value_cols])) if len(occupied) else []

        result = SegmentResult("groups")
        result.num_docs_scanned = int(counts.sum())
        readers = {i: seg.column(agg.arg.name) for i, agg in enumerate(plan.aggs)
                   if "distinct" in agg.device_outputs}
        for row, k in enumerate(occupied):
            states = []
            for i, agg in enumerate(plan.aggs):
                if i in readers:
                    states.append(_distinct_state(agg, readers[i], outs[f"{i}.distinct"][k]))
                    continue
                o = {"count": int(counts[k])}
                for out_name in agg.device_outputs:
                    if out_name != "count":
                        o[out_name] = outs[f"{i}.{out_name}"][k]
                states.append(agg.state_from_device(o))
            result.groups[tuple(keys[row])] = states
        return result

    def _decode_dense_partial(self, plan: SegmentPlan, outs) -> Optional[SegmentResult]:
        """A server partial in array form (`reduce.DensePartial`), with no
        per-group state loop; None where the state dict is the answer: fewer
        than DENSE_PARTIAL_MIN_GROUPS keys, an aggregation without
        `dense_values` or with a `distinct` output, or a group column
        without a `dictHash` (nothing proves that servers' keys align)."""
        if plan.num_keys_real < DENSE_PARTIAL_MIN_GROUPS:
            return None
        if not all(_dense_capable(a) for a in plan.aggs) \
                or any("distinct" in a.device_outputs for a in plan.aggs):
            return None
        seg = plan.segment
        dict_hashes = []
        for col in plan.group_cols:
            h = seg.column(col).meta.get("dictHash")
            if h is None:
                return None
            dict_hashes.append(h)
        real = plan.num_keys_real
        counts = np.asarray(outs["count"][:real]).astype(np.int64)
        dp_outs = {f"{i}.{o}": np.asarray(outs[f"{i}.{o}"][:real])
                   for i, agg in enumerate(plan.aggs) for o in agg.device_outputs
                   if o != "count"}
        group_values = [seg.column(col).dictionary.take(np.arange(plan.cards[j], dtype=np.int64))
                        for j, col in enumerate(plan.group_cols)]
        token = (tuple(plan.group_cols), tuple(plan.cards), tuple(dict_hashes), real)
        dp = DensePartial(token, tuple(plan.cards), tuple(plan.strides), real, counts,
                          dp_outs, group_values, aggs=plan.aggs)
        return SegmentResult("groups", dense=dp, num_docs_scanned=int(counts.sum()))

    # -- host aggregation ---------------------------------------------------
    def _host_aggregate(self, plan: SegmentPlan) -> SegmentResult:
        """A host plan in numpy: the filter mask, then the arguments and group
        keys evaluated over the decoded columns, grouped by dense codes of
        the factorized keys (the host mirror of the device's dense keys)."""
        seg = plan.segment
        mask = host_filter_mask(plan, seg)
        if plan.valid_docs is not None:
            mask = mask & plan.valid_docs[:len(mask)]
        idx = np.nonzero(mask)[0]
        env = _host_env(plan, seg, len(mask))

        def arg_values(agg) -> np.ndarray:
            if agg.arg is None or (isinstance(agg.arg, Identifier) and agg.arg.name == "*"):
                return np.zeros(len(idx))
            return _rows_of(eval_host(agg.arg, env), len(mask))[idx]

        if not plan.group_exprs:
            states = [a.host_state(arg_values(a)) for a in plan.aggs]
            return SegmentResult("scalar", scalar=states, num_docs_scanned=len(idx))

        key_arrays = [_rows_of(eval_host(g, env), len(mask))[idx] for g in plan.group_exprs]
        arg_arrays = [arg_values(a) for a in plan.aggs]
        key_arrays, arg_arrays = _explode_mv_key(key_arrays, arg_arrays)
        value_dicts = []
        n_rows = len(key_arrays[0][0] if isinstance(key_arrays[0], tuple) else key_arrays[0])
        combined = np.zeros(n_rows, dtype=np.int64)
        stride = 1
        for arr in key_arrays:
            codes, values = arr if isinstance(arr, tuple) else _factorize_keys(arr)
            combined += codes * stride
            value_dicts.append(values)
            stride *= max(len(values), 1)
        uniq_keys, inverse = np.unique(combined, return_inverse=True)
        order = np.argsort(inverse, kind="stable")
        bounds = np.zeros(len(uniq_keys) + 1, dtype=np.int64)
        np.cumsum(np.bincount(inverse, minlength=len(uniq_keys)), out=bounds[1:])

        result = SegmentResult("groups", num_docs_scanned=len(idx))
        for g, dense in enumerate(uniq_keys):
            gidx = order[bounds[g]:bounds[g + 1]]
            key = []
            rem = int(dense)
            for values in value_dicts:
                card = max(len(values), 1)
                key.append(_cell(values[rem % card]))
                rem //= card
            result.groups[tuple(key)] = [a.host_state(arg_arrays[i][gidx])
                                         for i, a in enumerate(plan.aggs)]
        return result

    # -- selection ---------------------------------------------------------
    def _selection(self, plan: SegmentPlan) -> SegmentResult:
        ctx, seg = plan.ctx, plan.segment
        topk = self._topk_candidates(plan)
        if topk is not None:
            idx, scanned = topk
        else:
            idx = np.nonzero(self._selection_mask(plan))[0]
            if not ctx.order_by:
                idx = idx[:ctx.offset + ctx.limit]   # early termination
            scanned = len(idx)
        rows, sort_keys = selection_rows(ctx, [(seg, idx)])
        return SegmentResult("selection", rows=rows, sort_keys=sort_keys,
                             num_docs_scanned=scanned,
                             topk_exact=topk is None and bool(ctx.order_by))

    def _topk_candidates(self, plan: SegmentPlan) -> Optional[Tuple[np.ndarray, int]]:
        """(candidate row ids, match count) from the device top-k, or None for
        the exact path: a key the device cannot sort, an unbounded LIMIT, or
        candidates that NaN or -inf keys displaced. The candidates hold the
        top k by f32 key plus TOPK_SLACK more, lower rows first among ties."""
        ctx, seg = plan.ctx, plan.segment
        k = ctx.offset + ctx.limit
        if len(ctx.order_by) != 1 or not 0 < k <= MAX_DEVICE_TOPK or plan.fallback_reason:
            return None
        order = ctx.order_by[0]
        if not topk_order_key_device_ok(seg, order.expr):
            return None
        block = block_for(seg, self.device)
        plan.bitmap_leaves = select_bitmap_leaves(plan, seg)
        spec = mask_spec(plan)
        inputs = self._kernel_inputs(plan, spec, block)
        if order.expr.name not in inputs.vals:
            inputs.vals[order.expr.name] = block.values(order.expr.name)
        idx, count, ok, nan_matches = kernels.compute_topk(
            spec, inputs, order.expr, order.desc, k + TOPK_SLACK)
        keep = min(len(idx), count)
        idx, ok = idx[:keep], ok[:keep]
        idx = idx[ok & (idx < seg.num_docs)]
        if nan_matches or len(idx) < min(k, count):
            return None
        if count > k + TOPK_SLACK and not topk_key_exact_in_f32(seg, order.expr):
            kth, last = _take(seg.column(order.expr.name), idx[[k - 1, -1]])
            if f32_tie_at_the_cut(kth, last):
                return None
        return idx, count

    def _selection_mask(self, plan: SegmentPlan) -> np.ndarray:
        """bool[num_docs]: the filter evaluated on the device, or on the host
        where the plan says the device cannot (`fallback_reason`)."""
        seg = plan.segment
        if plan.filter_prog.is_match_all and plan.valid_docs is None:
            return np.ones(seg.num_docs, dtype=bool)
        if plan.fallback_reason:
            mask = host_filter_mask(plan, seg)
            return mask if plan.valid_docs is None else mask & plan.valid_docs[:len(mask)]
        block = block_for(seg, self.device)
        plan.bitmap_leaves = select_bitmap_leaves(plan, seg)
        spec = mask_spec(plan)
        mask = kernels.filter_mask(spec, self._kernel_inputs(plan, spec, block))
        return mask[:seg.num_docs].cpu().numpy()

    def _decode_scalar_partials(self, plan: SegmentPlan, outs) -> SegmentResult:
        count = int(outs["count"])
        states: List[Any] = []
        for i, agg in enumerate(plan.aggs):
            if "distinct" in agg.device_outputs:
                states.append(_distinct_state(agg, plan.segment.column(agg.arg.name),
                                              outs[f"{i}.distinct"]))
                continue
            o = {"count": count}
            for out_name in agg.device_outputs:
                if out_name != "count":
                    o[out_name] = outs[f"{i}.{out_name}"]
            states.append(agg.state_from_device(o))
        return SegmentResult("scalar", scalar=states, num_docs_scanned=count)


def _distinct_state(agg, reader: ColumnReader, counts: np.ndarray):
    """An aggregation's state from its `distinct` output over one group (or
    the scalar): the per-id counts where it wants them, else the ids present."""
    counts = np.asarray(counts[:reader.cardinality])
    if agg.wants_id_counts:
        return agg.state_from_id_counts(reader.dictionary, counts)
    return agg.state_from_present_ids(reader.dictionary, np.nonzero(counts > 0)[0])


def distinct_cols(plan: SegmentPlan) -> set:
    """Columns whose dict ids a `distinct` output counts."""
    return {a.arg.name for a in plan.aggs if "distinct" in a.device_outputs}


def kernel_spec(plan: SegmentPlan) -> KernelSpec:
    """The plain body's spec of a device aggregation plan: its filter, group
    geometry and outputs, and for each `distinct` output the padded LUT size
    of its argument's dictionary (a merged view's global one on the set path)."""
    sizes = {i: lut_size(plan.segment.column(a.arg.name).cardinality)
             for i, a in enumerate(plan.aggs) if "distinct" in a.device_outputs}
    return KernelSpec(plan.filter_prog, plan.group_cols, plan.num_keys_pad,
                      tuple((a, a.device_outputs) for a in plan.aggs), sizes,
                      bitmap_leaves=plan.bitmap_leaves, mv_cols=mv_lut_cols(plan))


def mask_spec(plan: SegmentPlan) -> KernelSpec:
    """The spec of a plan's filter mask alone (a selection's, a top-k's)."""
    return KernelSpec(plan.filter_prog, (), 1, (), bitmap_leaves=plan.bitmap_leaves,
                      mv_cols=mv_lut_cols(plan))


def mv_lut_cols(plan: SegmentPlan) -> Tuple[str, ...]:
    """The dictionary-leaf columns that are multi-value on the plan's segment
    (`KernelSpec.mv_cols`)."""
    return tuple(sorted({leaf.col for leaf in plan.filter_prog.leaves
                         if isinstance(leaf, LutLeaf)
                         and plan.segment.column(leaf.col).is_multi_value}))


def bitmap_leaf(words: torch.Tensor, leaf: LutLeaf) -> BitmapLeaf:
    """A bitmap leaf's kernel input: its column's word matrix and the dict
    ids its LUT selects."""
    card = int(words.shape[-2])
    return BitmapLeaf(words, tuple(int(r) for r in np.flatnonzero(leaf.lut[:card])))


# -- selection rows ---------------------------------------------------------------

def f32_tie_at_the_cut(kth, last) -> bool:
    """True when the k-th candidate and the last one share an f32 score, so
    that rows outside the candidates may tie them in f32 and still be larger
    in f64: the candidates then decide nothing, and the exact path answers.
    A row outside with a strictly smaller f32 score is strictly smaller,
    since rounding to f32 keeps order."""
    return np.float32(kth) == np.float32(last)


def _take(reader: ColumnReader, rows: np.ndarray) -> np.ndarray:
    """The column's values at `rows`, decoded on the host; a multi-value
    column's as an object array of per-row value arrays. A consuming
    segment's reader decodes through one `dict_snapshot`: its ids and its
    dictionary must come from the same growth step."""
    if reader.is_multi_value:
        return np.asarray(mv_values(reader).take(np.asarray(rows, dtype=np.int64)))
    snapshot = getattr(reader, "dict_snapshot", None)
    if snapshot is not None:
        _, d, ids = snapshot()
        if d is not None:
            return d.take(np.asarray(ids)[rows].astype(np.int64))
    ids = np.asarray(reader.fwd)[rows]
    return reader.dictionary.take(ids.astype(np.int64)) if reader.has_dictionary else ids


def _cell(v):
    """A result cell as a Python value; a multi-value cell as a list."""
    if isinstance(v, np.generic):
        return v.item()
    return v.tolist() if isinstance(v, np.ndarray) else v


def _cells(col, n: int) -> list:
    """A column's n cells as `_cell` gives them: a numeric or string array in
    one `tolist` (the same Python values), anything else cell by cell."""
    if isinstance(col, np.ndarray) and col.ndim == 1 and col.dtype.kind in "biufUS":
        return col.tolist()
    return [_cell(col[i]) for i in range(n)]


def _tuples(cols, n: int) -> List[Tuple]:
    return list(zip(*[_cells(c, n) for c in cols])) if cols else [() for _ in range(n)]


def selection_rows(ctx: QueryContext, parts) -> Tuple[List[Tuple], List[Tuple]]:
    """(rows, sort keys) of the rows `parts` names, a list of (segment, row
    ids) taken in order: the select list and the ORDER BY values, evaluated on
    the host over the gathered columns."""
    needed = set()
    for e, _ in ctx.select_items:
        needed.update(identifiers_in(e))
    for o in ctx.order_by:
        needed.update(identifiers_in(o.expr))
    n = sum(len(rows) for _, rows in parts)
    env = {c: np.concatenate([_take(seg.column(c), rows) for seg, rows in parts])
           if parts else np.empty(0) for c in needed}

    out_cols = [_rows_of(eval_host(e, env), n) for e, _ in ctx.select_items]
    rows = _tuples(out_cols, n)
    sort_cols = [_rows_of(eval_host(o.expr, env), n) for o in ctx.order_by]
    sort_keys = _tuples(sort_cols, n) if sort_cols else []
    return rows, sort_keys


# -- host filter and environment ----------------------------------------------------

# a selective dictionary leaf of the host mask reads its inverted index's
# postings when they hold at most num_docs / INVERTED_MASK_DIVISOR docs (the
# JAX package's rule): O(matches) instead of the O(docs) forward gather
INVERTED_MASK_DIVISOR = 8


def host_filter_mask(plan: SegmentPlan, seg: ImmutableSegment) -> np.ndarray:
    """bool[num_docs]: the compiled filter program evaluated with numpy, with
    the device filter's LUT and compare semantics, so that the two agree by
    construction (the single-value branches of the JAX package's
    `host_filter_mask`). A dictionary leaf of an immutable segment with an
    inverted index sets its docs from the postings when they are few
    (`INVERTED_MASK_DIVISOR`); a null leaf reads the null bitmap, a doc-set
    leaf its host mask."""
    prog = plan.filter_prog
    n = seg.num_docs
    if prog is None or prog.is_match_all:
        return np.ones(n, dtype=bool)
    env = _host_env(plan, seg, n)

    def leaf_mask(i: int) -> np.ndarray:
        leaf = prog.leaves[i]
        if isinstance(leaf, LutLeaf):
            reader = seg.column(leaf.col)
            snapshot = getattr(reader, "dict_snapshot", None)
            snap = snapshot() if snapshot is not None else None
            if snap is not None and snap[1] is None:
                snap = None     # the sentinel of a column without a dictionary
            lut = leaf.lut
            if snap is not None:
                # a consuming reader: the LUT (rebuilt from the leaf's
                # predicate), the realtime inverted index and the ids, all
                # bound to ONE snapshot (ids remap as the sorted dictionary
                # grows)
                lut = leaf.rebuild_lut(snap[1], len(snap[1]))
                view = getattr(reader, "inverted_view", None)
                inv = view(snap) if view is not None else None
            else:
                inv = getattr(reader, "inverted_index", None)
            if inv is not None:
                match_ids = np.flatnonzero(lut[:min(inv.cardinality, len(lut))])
                if inv.match_count_for_ids(match_ids) * INVERTED_MASK_DIVISOR <= n:
                    mask = np.zeros(n, dtype=bool)
                    docs = inv.doc_ids_for_ids(match_ids)
                    mask[docs[docs < n]] = True
                    return mask
            if snap is not None:
                m = _mv_any(lut, *snap[2:]) if reader.is_multi_value \
                    else lut[np.asarray(snap[2]).astype(np.int64)]
                return np.pad(m, (0, max(0, n - len(m))))[:n]
            if reader.is_multi_value:
                return _mv_any(lut, reader.fwd, reader.mv_offsets)[:n]
            return lut[np.asarray(reader.fwd).astype(np.int64)]
        if isinstance(leaf, NullLeaf):
            nb = seg.column(leaf.col).null_bitmap
            m = np.zeros(n, dtype=bool) if nb is None else np.asarray(nb)[:n]
            return ~m if leaf.negated else m
        if isinstance(leaf, DocSetLeaf):
            return leaf.mask[:n]
        v = np.asarray(eval_host(leaf.expr, env))
        ops = leaf.operands
        if leaf.op == "eq":
            return v == ops[0]
        if leaf.op == "gte":
            return v >= ops[0]
        if leaf.op == "lte":
            return v <= ops[0]
        if leaf.op == "gt":
            return v > ops[0]
        if leaf.op == "lt":
            return v < ops[0]
        if leaf.op == "between":
            return (v >= ops[0]) & (v <= ops[1])
        m = v == ops[0]
        for o in ops[1:]:
            m = m | (v == o)
        return m

    def walk(node) -> np.ndarray:
        kind = node[0]
        if kind == "const":
            return np.full(n, node[1], dtype=bool)
        if kind == "leaf":
            return np.broadcast_to(leaf_mask(node[1]), (n,))
        if kind == "not":
            return ~walk(node[1])
        masks = [walk(c) for c in node[1]]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if kind == "and" else (out | m)
        return out

    return walk(prog.tree)


def _mv_any(lut: np.ndarray, flat, offsets) -> np.ndarray:
    """bool per row: does any of the row's values (CSR `flat` ids split at
    `offsets`) hit the LUT? Every row holds at least one value (an empty
    row stores the default null), so `reduceat` is well defined."""
    offsets = np.asarray(offsets)
    if len(offsets) < 2:
        return np.zeros(0, dtype=bool)
    hits = lut[np.asarray(flat).astype(np.int64)].astype(np.int32)
    return np.add.reduceat(hits, offsets[:-1]) > 0


def _host_env(plan: SegmentPlan, seg: ImmutableSegment, n: int) -> Dict[str, np.ndarray]:
    """Decoded columns (the first `n` rows) for host expression evaluation:
    those the group keys, the aggregate arguments and the compare leaves read."""
    needed = set()
    for g in plan.group_exprs:
        needed.update(identifiers_in(g))
    for a in plan.aggs:
        if a.arg is not None:
            needed.update(identifiers_in(a.arg))
    for leaf in plan.filter_prog.leaves:
        if isinstance(leaf, CmpLeaf):
            needed.update(identifiers_in(leaf.expr))
    env = {}
    for c in needed:
        reader = seg.column(c)
        if reader.is_multi_value:
            rows = mv_values(reader)     # its rows as CSR, decoded where read
            env[c] = rows if len(rows) == n else rows[:n]
        else:
            env[c] = reader.values()[:n]
    return env


def _explode_mv_key(key_arrays: List[np.ndarray], arg_arrays: List[np.ndarray]):
    """A multi-value group key explodes each row into one row per value (the
    reference's MV group key generators), the other keys and the arguments
    repeated with it. Found on the evaluated keys, so that a transform that
    yields multi-value rows (VALUEIN) explodes as a bare column does; a row
    with no value joins no group. A column's rows (`MVValues`) explode
    to their dict ids with the dictionary's values: (codes, values), already
    factorized."""
    mv = [j for j, arr in enumerate(key_arrays) if isinstance(arr, MVValues) or (
        arr.dtype == object and len(arr) and isinstance(arr[0], np.ndarray))]
    if not mv:
        return key_arrays, arg_arrays
    if len(mv) > 1:
        raise QueryValidationError("GROUP BY supports at most one multi-value expression")
    rows = key_arrays[mv[0]]
    if isinstance(rows, MVValues):
        # a column's rows: its dict ids are already dense codes of its
        # sorted values
        counts = rows.counts
        flat = (rows.ids[rows.offsets[0]:rows.offsets[-1]].astype(np.int64),
                list(rows.dictionary.values))
    else:
        counts = np.fromiter((len(r) for r in rows), dtype=np.int64, count=len(rows))
        flat = np.concatenate(list(rows))
    rep = np.repeat(np.arange(len(rows)), counts)
    return ([flat if k == mv[0] else arr[rep] for k, arr in enumerate(key_arrays)],
            [a[rep] for a in arg_arrays])


def _rows_of(v, n: int) -> np.ndarray:
    """An evaluated expression as n rows (a constant broadcast); a
    multi-value column's rows stay `MVValues`."""
    if isinstance(v, MVValues):
        return v
    return np.full(n, v, dtype=object) if np.ndim(v) == 0 else np.asarray(v)


def _factorize_keys(arr: np.ndarray):
    """Null-aware dense codes for host group-by keys: (codes, values), the
    values sorted as np.unique sorts them.

    SQL groups all nulls (None in object arrays, NaN in float arrays) into ONE
    group whose key surfaces as None; np.unique alone cannot sort None against
    str. Nulls get the trailing code len(values)-1 -> None. An object array
    is factorized through a dict, then only its distinct values are sorted:
    np.unique would sort every row with Python comparisons."""
    n = len(arr)
    if arr.dtype == object:
        isnull = np.fromiter((v is None for v in arr), dtype=bool, count=n)
        index: Dict[Any, int] = {}
        first = np.fromiter((index.setdefault(v, len(index)) for v in arr[~isnull]),
                            dtype=np.int64, count=n - int(isnull.sum()))
        distinct = list(index)
        order = sorted(range(len(distinct)), key=distinct.__getitem__)
        rank = np.empty(len(distinct), dtype=np.int64)
        rank[order] = np.arange(len(distinct))
        uniq = [distinct[i] for i in order]
        inv = np.zeros(n, dtype=np.int64)
        inv[~isnull] = rank[first]
    elif arr.dtype.kind == "f":
        isnull = np.isnan(arr)
        uniq, inv = np.unique(np.where(isnull, 0.0, arr), return_inverse=True)
    else:
        isnull = np.zeros(n, dtype=bool)
        uniq, inv = np.unique(arr, return_inverse=True)
    codes = inv.astype(np.int64).reshape(n)
    values = list(uniq)
    if isnull.any():
        codes[isnull] = len(values)
        values.append(None)
    return codes, values


# -- exact group trim -------------------------------------------------------------

def group_trim_spec(ctx: QueryContext, plan: SegmentPlan):
    """(agg index, desc, k) when a GROUP BY's ORDER BY can trim to its top k
    groups from device outputs alone; None otherwise.

    Exact only against outputs of every segment: per-segment partial sums can
    rank groups otherwise than their totals. Requires one ORDER BY key that is
    one of the query's aggregations, no HAVING (it could bring back trimmed
    groups), no DISTINCT rewrite and no GAPFILL (it makes rows for trimmed
    groups)."""
    if ctx.having is not None or ctx.distinct or len(ctx.order_by) != 1 \
            or ctx.gapfill is not None:
        return None
    k = ctx.offset + ctx.limit
    if not 0 < k <= MAX_DEVICE_TOPK:
        return None
    o = ctx.order_by[0]
    for i, call in enumerate(ctx.aggregations):
        if repr(o.expr) == repr(call):
            outs = plan.aggs[i].device_outputs
            if outs in (("count",), ("sum",), ("min",), ("max",), ("sum", "count")):
                return i, o.desc, k
    return None


def _trim_occupied(plan: SegmentPlan, outs, occupied: np.ndarray) -> np.ndarray:
    """The occupied dense keys the reduce can return: the k best by the ORDER
    BY aggregation, ties at the k-th going to the lower keys, in key order.
    The reduce's stable sort then orders them as it orders the untrimmed
    groups. A NaN score keeps every group (the sort's order of NaN is not a
    ranking)."""
    trim = group_trim_spec(plan.ctx, plan)
    if trim is None or len(occupied) <= trim[2]:
        return occupied
    i, desc, k = trim
    names = plan.aggs[i].device_outputs
    counts = outs["count"][:plan.num_keys_real][occupied].astype(np.float64)
    if names == ("count",):
        score = counts
    elif names == ("sum", "count"):   # AVG
        score = outs[f"{i}.sum"][:plan.num_keys_real][occupied].astype(np.float64) \
            / np.maximum(counts, 1)
    else:
        score = np.asarray(outs[f"{i}.{names[0]}"][:plan.num_keys_real][occupied],
                           dtype=np.float64)
    if np.isnan(score).any():
        return occupied
    s = -score if desc else score
    kth = np.partition(s, k - 1)[k - 1]
    better = np.nonzero(s < kth)[0]
    ties = np.nonzero(s == kth)[0][:k - len(better)]
    return occupied[np.sort(np.concatenate([better, ties]))]


# -- routing ----------------------------------------------------------------------

def _plan_vals_cols(plan: SegmentPlan) -> set:
    """Columns the plan reads as values (not as dict ids): filter compare
    expressions plus aggregate arguments other than a `distinct` output's."""
    cols = set()
    for leaf in plan.filter_prog.leaves:
        if isinstance(leaf, CmpLeaf):
            cols.update(identifiers_in(leaf.expr))
    for agg in plan.aggs:
        if "distinct" in agg.device_outputs:
            continue   # read as dict ids (`distinct_cols`)
        if agg.arg is not None and not (isinstance(agg.arg, Identifier)
                                        and agg.arg.name == "*"):
            cols.update(identifiers_in(agg.arg))
    return cols


def _for_cols(plan: SegmentPlan) -> set:
    """Value columns read from their frame-of-reference form (raw integer
    columns with one), the counterpart of the "for" entries of the JAX
    executor's `_fused_cols`. Dict columns always decode through their ids, and
    other raw columns are read as they are."""
    return {c for c in _plan_vals_cols(plan)
            if for_delta_dtype(plan.segment.column(c)) is not None}


def _band_leaf_indices(plan: SegmentPlan) -> Optional[List[int]]:
    """Leaf indices when the filter is an AND (or a single leaf, or nothing) of
    single-value LutLeafs of exactly one id interval each; None for any other
    filter."""
    prog = plan.filter_prog
    tree = prog.tree
    if tree == ("const", True):
        idx = []
    elif tree[0] == "leaf":
        idx = [tree[1]]
    elif tree[0] == "and" and all(c[0] == "leaf" for c in tree[1]):
        idx = [c[1] for c in tree[1]]
    else:
        return None
    for i in idx:
        leaf = prog.leaves[i]
        if not isinstance(leaf, LutLeaf) or leaf.intervals is None \
                or len(leaf.intervals) != 1 \
                or plan.segment.column(leaf.col).is_multi_value:
            # a multi-value column's ids are a [rows, W] matrix: the scan's
            # bands read one id per row
            return None
    return idx


def _sum_operands(plan: SegmentPlan) -> Optional[List[Tuple[int, Any]]]:
    """(agg index, argument) of every sum output when each output of the plan is
    a count or a plain (power-1) sum; None otherwise."""
    operands = []
    for i, agg in enumerate(plan.aggs):
        for o in agg.device_outputs:
            if o == "sum":
                operands.append((i, agg.arg))
            elif o != "count":
                return None
    return operands


def scan_route(plan: SegmentPlan) -> Optional[str]:
    """Which CUDA scan a segment plan runs through, or None for the plain body.

    "masked_sums_fused" when every sum operand is a bare column in FOR form
    (one delta width for all); "masked_sums" for any other scalar plan whose
    filter is an AND of single-interval dict-id bands and whose outputs are
    counts and plain sums. An upsert valid-doc mask (`upsert.ValidDocs`)
    rides the scan as one more band, while one is free; any other
    `valid_docs` (a star-tree's record mask, a plain array) keeps the plan
    on the plain body."""
    if plan.kind != "device" or plan.group_exprs:
        return None
    masked = plan.valid_docs is not None
    if masked and not (isinstance(plan.valid_docs, ValidDocs)
                       and plan.valid_docs.key is not None):
        return None
    leaves = _band_leaf_indices(plan)
    operands = _sum_operands(plan)
    if leaves is None or operands is None or not (leaves or operands or masked):
        return None
    if len(leaves) + masked > scan.MAX_MASK_COLS or len(operands) > scan.MAX_SUMS:
        return None
    for_cols = _for_cols(plan)
    if operands and all(isinstance(arg, Identifier) and arg.name in for_cols
                        for _, arg in operands):
        widths = {for_delta_dtype(plan.segment.column(arg.name)) for _, arg in operands}
        if len(widths) == 1:
            return "masked_sums_fused"
    return "masked_sums"


def execute_query(segments: Sequence[ImmutableSegment], sql: str, schema=None,
                  device=None, upsert=None) -> ResultTable:
    """One-call convenience: SQL over loaded segments, on `device` (CUDA by
    default); `upsert` as `ServerQueryExecutor.execute` takes it."""
    return ServerQueryExecutor(device).execute(segments, sql, schema, upsert=upsert)
