"""Aggregation functions: device partial outputs + host merge/finalize.

Counterpart of `pinot_tpu/query/aggregates.py` (analog of the reference's
`AggregationFunction` family), with every single-value aggregation of the JAX
package. Each function names the kernel outputs it needs on the device
(`device_outputs`: count, sum, sum2..sum4, min, max, distinct), builds a
partial state from them or from the filtered values on the host, merges
states across segments and finalizes. The planner asks `device_ok()` which
route a query takes, with the JAX planner's conditions, so that a query takes
the same route in both packages.

The `distinct` output is a per-dict-id count (or 0/1 presence) vector of the
filtered rows: DISTINCTCOUNT, HLL and theta build their states from the
surviving dictionary values (O(cardinality) host work after the row-sized
work on the device), and the t-digest from the per-id counts. HLL's (bucket,
rank) table, theta's hashes and the t-digest's float64 values are cached on
the dictionary object, keyed by its length, so that a consuming segment's
growing dictionary never reuses a table of fewer values.

The multi-value (`*MV`) aggregations run on the host, as in the JAX package:
their argument is an object array of per-row value arrays, flattened to the
values (`_mv_flat`) before the single-value function's state is built.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..segment.reader import MVValues
from ..sql.ast import Expr, Function, Identifier
from .context import QueryValidationError


@dataclass
class AggContext:
    """Static facts the planner knows when choosing the device/host path."""
    group_by: bool
    arg_is_dict_column: bool  # argument is a plain dictionary-encoded column
    arg_is_numeric: bool


class AggFunc:
    name: str = ""
    device_outputs: Tuple[str, ...] = ()  # subset of {count,sum,sum2..4,min,max,distinct}
    # a `distinct` consumer that reads per-id row counts (`state_from_id_counts`)
    # instead of 0/1 presence (`state_from_present_ids`)
    wants_id_counts = False

    def __init__(self, call: Function):
        self.call = call
        self.arg: Optional[Expr] = call.args[0] if call.args else None

    # -- capability --------------------------------------------------------
    def device_ok(self, ctx: AggContext) -> bool:
        return True

    # -- host path ---------------------------------------------------------
    def host_state(self, values: np.ndarray) -> Any:
        """Build a partial state from the filtered argument values of one segment."""
        raise NotImplementedError

    def state_from_device(self, outs: Dict[str, float]) -> Any:
        """Build the same state from the kernel's outputs for one group."""
        raise NotImplementedError

    def state_from_value_set(self, values: set) -> Any:
        """State from the device `distinct` output's surviving value set.
        Sketch aggregations override to convert to their bounded state here:
        a single-segment partial reaches the reduce without any merge call,
        and an exact value set would defeat the sketch's bounded size."""
        return values

    def state_from_present_ids(self, dictionary, present_ids: np.ndarray) -> Any:
        """State straight from the device presence vector's surviving DICT IDS.
        Default decodes the values and defers to `state_from_value_set`;
        aggregations whose state depends only on per-value derived data (HLL's
        bucket/rank) override to skip the per-query value materialization."""
        values = dictionary.take(present_ids)
        return self.state_from_value_set(set(values.tolist()))

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def finalize(self, state: Any) -> Any:
        raise NotImplementedError

    # -- vectorized decode (the dense group fast path) ---------------------
    #: dense_values emits NaN where the scalar finalize would return None
    #: (e.g. VAR_SAMP of a single row); the dense reducer converts
    dense_nan_is_null = False

    def dense_values(self, get, counts: np.ndarray) -> Optional[np.ndarray]:
        """Finalized values over ALL occupied groups at once, or None when
        this aggregation has no dense path (sketches/value-set states).

        `get(name)` returns this agg's kernel output column sliced to the
        occupied dense keys; `counts` is the per-group matched row count
        (> 0 for every occupied key, so the None-state cases of the scalar
        `finalize` cannot occur except where `dense_nan_is_null` says so).
        A high-cardinality GROUP BY decodes through this instead of a
        per-group Python state loop (`query/dense_reduce.py`)."""
        return None

    def empty_result(self) -> Any:
        """Result over zero rows (no group-by), mirroring reference defaults."""
        return None

    def validate_args(self, segment) -> None:
        """Plan-time argument validation against one segment's column types;
        raise QueryValidationError for shapes whose host path would crash deep
        in numpy (reference: AggregationFunctionFactory type checks)."""


class CountAgg(AggFunc):
    name = "count"
    device_outputs = ("count",)

    def host_state(self, values):
        return int(len(values))

    def state_from_device(self, outs):
        return int(outs["count"])

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return int(state)

    def dense_values(self, get, counts):
        return counts.astype(np.int64)

    def empty_result(self):
        return 0


class SumAgg(AggFunc):
    name = "sum"
    device_outputs = ("sum",)

    def host_state(self, values):
        return float(np.sum(values)) if len(values) else None

    def state_from_device(self, outs):
        return float(outs["sum"]) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def finalize(self, state):
        return None if state is None else float(state)

    def dense_values(self, get, counts):
        return get("sum").astype(np.float64)


class MinAgg(AggFunc):
    name = "min"
    device_outputs = ("min",)

    def host_state(self, values):
        return float(np.min(values)) if len(values) else None

    def state_from_device(self, outs):
        return float(outs["min"]) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return min(a, b)

    def finalize(self, state):
        return None if state is None else float(state)

    def dense_values(self, get, counts):
        return get(self.device_outputs[0]).astype(np.float64)


class MaxAgg(MinAgg):
    name = "max"
    device_outputs = ("max",)

    def host_state(self, values):
        return float(np.max(values)) if len(values) else None

    def state_from_device(self, outs):
        return float(outs["max"]) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return max(a, b)


class AvgAgg(AggFunc):
    name = "avg"
    device_outputs = ("sum", "count")

    def host_state(self, values):
        return (float(np.sum(values)), len(values))

    def state_from_device(self, outs):
        return (float(outs["sum"]), int(outs["count"]))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def finalize(self, state):
        s, c = state
        return None if c == 0 else s / c

    def dense_values(self, get, counts):
        return get("sum").astype(np.float64) / counts


class MinMaxRangeAgg(AggFunc):
    name = "minmaxrange"
    device_outputs = ("min", "max")

    def host_state(self, values):
        if not len(values):
            return None
        return (float(np.min(values)), float(np.max(values)))

    def state_from_device(self, outs):
        if outs["count"] == 0:
            return None
        return (float(outs["min"]), float(outs["max"]))

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return (min(a[0], b[0]), max(a[1], b[1]))

    def finalize(self, state):
        return None if state is None else state[1] - state[0]

    def dense_values(self, get, counts):
        return (get("max").astype(np.float64)
                - get("min").astype(np.float64))


class DistinctCountAgg(AggFunc):
    """Exact distinct count. Device path: per-dict-id presence vector (no group-by);
    states merge as value sets across segments since dictionaries differ per segment."""
    name = "distinctcount"
    device_outputs = ("distinct",)

    def device_ok(self, ctx: AggContext) -> bool:
        # grouped path: the kernel emits a per-group presence matrix (the
        # planner bounds its size via MAX_GROUPED_DISTINCT_CELLS)
        return ctx.arg_is_dict_column

    def host_state(self, values):
        return set(np.unique(values).tolist())

    def merge(self, a, b):
        return a | b

    def finalize(self, state):
        return len(state)

    def empty_result(self):
        return 0


def dictionary_cache(dictionary, key, build):
    """`build()`, cached on the dictionary object under `key` and its length:
    a dictionary lives as long as its segment, and a consuming segment's
    snapshot of more values is another entry, never a stale one."""
    cache = dictionary.__dict__.setdefault("_agg_cache", {})
    full_key = (key, len(dictionary))
    out = cache.get(full_key)
    if out is None:
        out = cache[full_key] = build()
    return out


HLL_DEFAULT_P = 12  # 4096 registers, ~1.6% relative error


def hll_hash(value) -> int:
    """64-bit stable hash for HLL bucketing."""
    import hashlib
    if isinstance(value, bytes):
        data = value
    elif isinstance(value, (float, np.floating)) and float(value).is_integer():
        data = str(int(value)).encode()
    else:
        data = str(value).encode()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def hll_bucket_rank(value, p: int) -> Tuple[int, int]:
    h = hll_hash(value)
    bucket = h >> (64 - p)
    # remaining bits shifted to the top of the word; low p bits are zero-filled, so
    # leading zeros of the 64-bit word count within the (64-p)-bit window
    w = (h << p) & ((1 << 64) - 1)
    rank = (64 - p) + 1 if w == 0 else min(64 - w.bit_length() + 1, (64 - p) + 1)
    return bucket, rank


def hll_estimate(registers: np.ndarray) -> float:
    """Standard HyperLogLog estimator with small-range correction."""
    m = len(registers)
    alpha = 0.7213 / (1 + 1.079 / m) if m >= 128 else {16: 0.673, 32: 0.697,
                                                       64: 0.709}.get(m, 0.7213)
    est = alpha * m * m / np.sum(np.exp2(-registers.astype(np.float64)))
    zeros = int(np.sum(registers == 0))
    if est <= 2.5 * m and zeros > 0:
        est = m * np.log(m / zeros)
    return float(est)


class DistinctCountHLLAgg(AggFunc):
    """Approximate distinct count via HyperLogLog (reference:
    DistinctCountHLLAggregationFunction, default log2m in
    `CommonConstants.Helix.DEFAULT_HYPERLOGLOG_LOG2M`).

    Device path (a dict-column argument, scalar or grouped): the kernel's
    per-dict-id presence vector (the `distinct` output DISTINCTCOUNT and the
    theta sketch use) comes back, and the registers are built on the host
    from the surviving dictionary values: O(cardinality), not O(rows).
    States merge by elementwise register max; a value-set state becomes
    registers at its first merge or finalize, like theta's.
    """

    name = "distinctcounthll"
    device_outputs = ("distinct",)

    def __init__(self, call: Function):
        super().__init__(call)
        self.p = HLL_DEFAULT_P
        if len(call.args) >= 2:
            from ..sql.ast import Literal
            if isinstance(call.args[1], Literal):
                self.p = int(call.args[1].value)

    def device_ok(self, ctx: AggContext) -> bool:
        # grouped HLL rides the per-group presence matrix
        return ctx.arg_is_dict_column

    def host_state(self, values) -> np.ndarray:
        regs = np.zeros(1 << self.p, dtype=np.int8)
        values = np.asarray(values)
        # distinct values as Python objects (what `hll_hash` hashes), sorted
        # numerically where the values are numbers
        distinct = np.unique(values).astype(object) if values.dtype != object \
            else np.unique(values)
        for v in distinct:
            b, r = hll_bucket_rank(v, self.p)
            regs[b] = max(regs[b], r)
        return regs

    def state_from_present_ids(self, dictionary, present_ids: np.ndarray):
        """Registers straight from a presence vector, via a (bucket, rank)
        table cached on the dictionary (`dictionary_cache`): hashing every
        dictionary value is paid once per dictionary instead of once per
        query, and the per-query cost is one vectorized maximum.at over the
        surviving ids."""
        def build():
            vals = np.asarray(dictionary.take(np.arange(len(dictionary))), dtype=object)
            buckets = np.empty(len(vals), dtype=np.int32)
            ranks = np.empty(len(vals), dtype=np.int8)
            for i, v in enumerate(vals):
                buckets[i], ranks[i] = hll_bucket_rank(v, self.p)
            return buckets, ranks
        br = dictionary_cache(dictionary, ("hll", self.p), build)
        regs = np.zeros(1 << self.p, dtype=np.int8)
        np.maximum.at(regs, br[0][present_ids], br[1][present_ids])
        return regs

    def _normalize(self, state) -> np.ndarray:
        if isinstance(state, set):  # device path returns the exact value set
            return self.host_state(np.asarray(list(state), dtype=object))
        return state

    def state_from_value_set(self, values: set) -> np.ndarray:
        return self._normalize(values)

    def merge(self, a, b):
        return np.maximum(self._normalize(a), self._normalize(b))

    def finalize(self, state) -> int:
        return int(round(hll_estimate(self._normalize(state))))

    def empty_result(self):
        return 0


class PercentileAgg(AggFunc):
    """Exact percentile — keeps filtered values per state (host-path only).
    `percentile(col, p)` or legacy `percentileNN(col)`."""
    name = "percentile"

    def __init__(self, call: Function):
        super().__init__(call)
        self.pct = _parse_percentile(call, "percentile")

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def host_state(self, values):
        return np.asarray(values, dtype=np.float64)

    def merge(self, a, b):
        return np.concatenate([a, b])

    def finalize(self, state):
        return None if len(state) == 0 else float(np.percentile(state, self.pct))


def _parse_percentile(call: Function, base: str) -> float:
    """`<base>NN(col)` suffix form or `<base>(col, NN)` argument form."""
    if call.name.startswith(base) and call.name[len(base):].isdigit():
        return float(call.name[len(base):])
    if len(call.args) >= 2:
        from ..sql.ast import Literal
        assert isinstance(call.args[1], Literal)
        return float(call.args[1].value)
    raise QueryValidationError(f"{call.name} needs a percentile argument")


class DistinctCountThetaAgg(AggFunc):
    """DISTINCTCOUNTTHETASKETCH — KMV theta sketch state (`sketches.ThetaSketch`).

    Reference: DistinctCountThetaSketchAggregationFunction (DataSketches theta). On the
    device path over a dict column the exact present-id set comes back from the kernel
    (same output as DISTINCTCOUNT); the sketch is built from the surviving dictionary
    values host-side — cardinality-sized work, not row-sized.
    """
    name = "distinctcountthetasketch"
    device_outputs = ("distinct",)

    def __init__(self, call: Function):
        super().__init__(call)
        from ..sql.ast import Literal
        self.k = 4096
        if len(call.args) >= 2 and isinstance(call.args[1], Literal):
            # reference accepts 'nominalEntries=NNNN' parameter strings
            s = str(call.args[1].value)
            if "=" in s:
                self.k = int(s.split("=", 1)[1])
            elif s.isdigit():
                self.k = int(s)
        # filtered set-op form (reference signature:
        # DISTINCTCOUNTTHETASKETCH(col, 'params', 'pred1', ..., 'SET_OP($1,$2)')):
        # one sketch per predicate over the rows surviving the MAIN filter,
        # combined by the post-op expression at finalize
        self.filter_exprs: List[Expr] = []
        self.post_op: Optional[str] = None
        if len(call.args) == 3:
            raise QueryValidationError(
                f"{self.name}: the filtered form needs at least one predicate "
                "AND a set-op expression — (col, 'params', 'pred1', ..., "
                "'SET_OP($1, ...)'); a lone third argument would be silently "
                "ignored")
        if len(call.args) >= 4:
            from ..sql.parser import Parser
            preds = call.args[2:-1]
            post = call.args[-1]
            if not all(isinstance(p, Literal) for p in (*preds, post)):
                raise QueryValidationError(
                    f"{self.name}: predicate/set-op arguments must be string literals")
            for p in preds:
                stmt = Parser(f"SELECT 1 FROM t WHERE {p.value}").parse()
                self.filter_exprs.append(stmt.where)
            self.post_op = str(post.value)
            # evaluate the key column AND each predicate as one packed argument
            # (the executor's agg surface is single-expression; same trick as
            # COVAR's __pack, object-typed so string keys survive)
            self.arg = Function("__packobj",
                                (call.args[0], *self.filter_exprs))

    def device_ok(self, ctx: AggContext) -> bool:
        return ctx.arg_is_dict_column and not self.filter_exprs

    @staticmethod
    def _canonical(values) -> np.ndarray:
        """One hash domain per logical type across segments AND device/host paths (the
        device path yields python ints where the host path sees the column dtype).
        Integers stay integral — float64 would collapse distinct int64s above 2^53."""
        arr = np.asarray(list(values) if isinstance(values, set) else values)
        if arr.dtype == object and arr.size:
            # the filtered path's __packobj matrix is object-typed; restore the
            # numeric hash domain or identical ids would hash differently from
            # the unfiltered/device path (raw-sketch clients intersect across
            # queries)
            if all(isinstance(v, (int, np.integer)) for v in arr.reshape(-1)):
                arr = arr.astype(np.int64)
            elif all(isinstance(v, (float, np.floating)) for v in arr.reshape(-1)):
                arr = arr.astype(np.float64)
        if arr.dtype.kind in "iub":
            return arr.astype(np.int64)
        if arr.dtype.kind == "f":
            return arr.astype(np.float64)
        return arr

    def _normalize(self, state):
        from .sketches import ThetaSketch
        if isinstance(state, set):  # device path returns the exact value set
            return ThetaSketch.from_values(self._canonical(state), self.k)
        return state

    def state_from_value_set(self, values: set):
        return self._normalize(values)

    def state_from_present_ids(self, dictionary, present_ids: np.ndarray):
        """KMV sketch straight from the device presence vector, via the
        dictionary values' 64-bit hashes cached on the dictionary
        (`dictionary_cache`, as HLL's table): hashing every dictionary value is
        paid once per dictionary, and the per-query cost is one vectorized
        k-min over the surviving ids."""
        from .sketches import ThetaSketch, hash64
        hashes = dictionary_cache(dictionary, ("theta",), lambda: hash64(self._canonical(
            np.asarray(dictionary.take(np.arange(len(dictionary))), dtype=object))))
        sk = ThetaSketch(self.k)
        sk._absorb(np.unique(hashes[present_ids]))
        return sk

    def host_state(self, values):
        from .sketches import ThetaSketch
        if self.filter_exprs:
            arr = np.asarray(values)  # [n, 1+m] object matrix from __packobj
            keys = arr[:, 0] if arr.ndim == 2 else np.empty(0, dtype=object)
            out = []
            for j in range(len(self.filter_exprs)):
                mask = arr[:, 1 + j].astype(bool) if arr.ndim == 2 \
                    else np.empty(0, dtype=bool)
                out.append(ThetaSketch.from_values(
                    self._canonical(keys[mask]), self.k))
            return tuple(out)
        return ThetaSketch.from_values(self._canonical(values), self.k)

    def merge(self, a, b):
        if self.filter_exprs:
            return tuple(x.union(y) for x, y in zip(a, b))
        return self._normalize(a).union(self._normalize(b))

    def _combined(self, state):
        from .sketches import ThetaSketch
        if not self.filter_exprs:
            return self._normalize(state)
        if state is None:
            return ThetaSketch(self.k)
        return _eval_theta_setop(self.post_op, list(state))

    def finalize(self, state):
        return int(round(self._combined(state).estimate()))

    def empty_result(self):
        return 0


def _eval_theta_setop(expr: str, sketches: List) -> "object":
    """Parse + evaluate the reference's theta post-aggregation expression:
    `$N` (1-based sketch refs), SET_UNION(...), SET_INTERSECT(...),
    SET_DIFF(a, b) (reference: DistinctCountThetaSketchAggregationFunction's
    postAggregationExpression)."""
    import re as _re
    src = expr or "$1"
    toks = []
    i = 0
    while i < len(src):  # position-tracking lexer: unknown chars ERROR, never vanish
        if src[i].isspace():
            i += 1
            continue
        m = _re.match(r"\$\d+|[A-Za-z_]+|[(),]", src[i:])
        if m is None:
            raise QueryValidationError(
                f"theta set-op: unexpected character {src[i]!r} in {expr!r}")
        toks.append(m.group(0))
        i += len(m.group(0))
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def take():
        t = peek()
        pos[0] += 1
        return t

    def parse_node():
        t = take()
        if t is None:
            raise QueryValidationError(f"theta set-op: unexpected end in {expr!r}")
        if t.startswith("$"):
            i = int(t[1:]) - 1
            if not 0 <= i < len(sketches):
                raise QueryValidationError(
                    f"theta set-op references ${i + 1} but only "
                    f"{len(sketches)} filter sketches exist")
            return sketches[i]
        op = t.upper()
        if op not in ("SET_UNION", "SET_INTERSECT", "SET_DIFF"):
            raise QueryValidationError(f"unknown theta set-op {t!r}")
        if take() != "(":
            raise QueryValidationError(f"theta set-op: expected ( after {t}")
        args = [parse_node()]
        while peek() == ",":
            take()
            args.append(parse_node())
        if take() != ")":
            raise QueryValidationError(f"theta set-op: expected ) in {expr!r}")
        if op == "SET_DIFF":
            if len(args) != 2:
                raise QueryValidationError("SET_DIFF takes exactly two arguments")
            return args[0].a_not_b(args[1])
        out = args[0]
        for a in args[1:]:
            out = out.union(a) if op == "SET_UNION" else out.intersect(a)
        return out

    node = parse_node()
    if peek() is not None:
        raise QueryValidationError(f"theta set-op: trailing tokens in {expr!r}")
    return node


class DistinctCountRawThetaAgg(DistinctCountThetaAgg):
    """DISTINCTCOUNTRAWTHETASKETCH — returns the serialized sketch (hex) instead of the
    estimate, for client-side set operations (reference: ...RawThetaSketchAggregationFunction)."""
    name = "distinctcountrawthetasketch"

    def finalize(self, state):
        return self._combined(state).to_bytes().hex()

    def empty_result(self):
        from .sketches import ThetaSketch
        return ThetaSketch(self.k).to_bytes().hex()


class PercentileTDigestAgg(AggFunc):
    """PERCENTILETDIGEST / PERCENTILETDIGESTNN — merging t-digest state.

    Reference: PercentileTDigestAggregationFunction (com.tdunning TDigest). Bounded-size
    mergeable state — unlike PercentileAgg's exact value buffer, this flows through
    multi-host reduce without shipping raw rows.
    """
    name = "percentiletdigest"
    pct_base = "percentiletdigest"  # the base of the digit-suffix form
    COMPRESSION = 100.0
    # device path: the per-dict-id COUNT vector (not mere presence): a
    # dictionary's sorted values and masked multiplicities build the digest
    # at O(cardinality) host cost after the row-sized work ran on the device
    device_outputs = ("distinct",)
    wants_id_counts = True

    def __init__(self, call: Function):
        super().__init__(call)
        self.pct = _parse_percentile(call, self.pct_base)

    def device_ok(self, ctx: AggContext) -> bool:
        return ctx.arg_is_dict_column and ctx.arg_is_numeric

    def host_state(self, values):
        from .sketches import TDigest
        return TDigest.from_values(values, self.COMPRESSION)

    def state_from_id_counts(self, dictionary, counts: np.ndarray):
        """Counts per dict id -> weighted digest over the sorted dictionary
        values. The float64 values are cached on the dictionary
        (`dictionary_cache`): a grouped decode calls this once per group, and
        taking the dictionary per group would cost O(groups x cardinality)."""
        from .sketches import TDigest
        vals = dictionary_cache(dictionary, ("tdigest",), lambda: np.asarray(
            dictionary.take(np.arange(len(dictionary))), dtype=np.float64))
        return TDigest.from_weighted(vals[:len(counts)], counts,
                                     self.COMPRESSION)

    def merge(self, a, b):
        return a.merge(b)

    def finalize(self, state):
        q = state.quantile(self.pct / 100.0)
        return None if q is None else float(q)


class PercentileEstAgg(PercentileTDigestAgg):
    """PERCENTILEEST — approximate long-valued percentile (reference uses QuantileDigest;
    here the same t-digest state with integer extraction)."""
    name = "percentileest"
    pct_base = "percentileest"

    def finalize(self, state):
        q = state.quantile(self.pct / 100.0)
        return None if q is None else int(round(q))


class ModeAgg(AggFunc):
    name = "mode"

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def host_state(self, values):
        return Counter(values.tolist())

    def merge(self, a, b):
        a.update(b)
        return a

    def finalize(self, state):
        if not state:
            return None
        # ties broken by smallest value, matching reference MODE default
        best = max(state.items(), key=lambda kv: (
            kv[1], -kv[0] if isinstance(kv[0], (int, float)) else 0))
        return float(best[0]) if isinstance(best[0], (int, float)) else best[0]


# -- moment-based aggregations (reference: VarianceAggregationFunction,
# SkewnessAggregationFunction / FourthMomentAggregationFunction) -------------
# States are tuples of raw power sums (n, Σx, Σx², ...): exactly mergeable
# across segments and computable on the device as masked sums of powers
# (`engine.grouped.grouped_agg`'s sum2..sum4), the counterpart of the reference's
# PinotFourthMoment combine. Central moments are derived only at finalize.

class MomentAgg(AggFunc):
    """Base for power-sum states (n, Σx, Σx², ...): element-wise mergeable, and
    decodable generically from the kernel's per-power outputs."""

    def state_from_device(self, outs):
        return (int(outs["count"]),) + tuple(
            float(outs.get(o, 0.0)) for o in self.device_outputs if o != "count")

    def merge(self, a, b):
        return tuple(x + y for x, y in zip(a, b))

    def validate_args(self, segment) -> None:
        _require_numeric_arg(self, segment)


class VarianceAgg(MomentAgg):
    """VAR_POP / VAR_SAMP / STDDEV_POP / STDDEV_SAMP.

    State is the CENTERED (n, Σx, m2=Σ(x-mean)²) tuple with the pairwise
    Chan/Welford merge (reference: VarianceTuple.apply) — raw Σx² would cancel
    catastrophically for large-magnitude columns (epoch seconds) even in f64.
    The device path still ships raw f32 power sums, but only for columns the
    planner proved small enough (`_power_sum_f32_safe`)."""
    name = "varpop"
    device_outputs = ("sum", "sum2", "count")
    sample = False
    sqrt = False

    def host_state(self, values):
        v = np.asarray(values, dtype=np.float64)
        if len(v) == 0:
            return (0, 0.0, 0.0)
        mean = v.mean()
        return (len(v), float(v.sum()), float(((v - mean) ** 2).sum()))

    def state_from_device(self, outs):
        n = int(outs["count"])
        s1 = float(outs.get("sum", 0.0))
        s2 = float(outs.get("sum2", 0.0))
        m2 = max(0.0, s2 - s1 * s1 / n) if n else 0.0
        return (n, s1, m2)

    def merge(self, a, b):
        na, sa, m2a = a
        nb, sb, m2b = b
        if na == 0:
            return b
        if nb == 0:
            return a
        n = na + nb
        delta = sb / nb - sa / na
        return (n, sa + sb, m2a + m2b + delta * delta * na * nb / n)

    def finalize(self, state):
        n, _s1, m2 = state
        d = n - 1 if self.sample else n
        if n == 0 or d <= 0:
            return None
        var = max(0.0, m2 / d)
        return float(np.sqrt(var)) if self.sqrt else var

    dense_nan_is_null = True  # VAR_SAMP/STDDEV_SAMP of a 1-row group is null

    def dense_values(self, get, counts):
        n = counts.astype(np.float64)
        s1 = get("sum").astype(np.float64)
        s2 = get("sum2").astype(np.float64)
        m2 = np.maximum(0.0, s2 - s1 * s1 / n)
        d = n - 1 if self.sample else n
        var = np.where(d > 0, m2 / np.maximum(d, 1), np.nan)
        return np.sqrt(var) if self.sqrt else var


class VarSampAgg(VarianceAgg):
    name = "varsamp"
    sample = True


class StdDevPopAgg(VarianceAgg):
    name = "stddevpop"
    sqrt = True


class StdDevSampAgg(VarianceAgg):
    name = "stddevsamp"
    sample = True
    sqrt = True


class SkewnessAgg(MomentAgg):
    """SKEWNESS — population skewness from the first three raw moments."""
    name = "skewness"
    device_outputs = ("sum", "sum2", "sum3", "count")

    def host_state(self, values):
        v = np.asarray(values, dtype=np.float64)
        return (len(v), float(v.sum()), float((v ** 2).sum()), float((v ** 3).sum()))

    def finalize(self, state):
        n, s1, s2, s3 = state
        if n == 0:
            return None
        mean = s1 / n
        m2 = s2 / n - mean * mean
        if m2 <= 0:
            return 0.0
        m3 = s3 / n - 3 * mean * s2 / n + 2 * mean ** 3
        return float(m3 / m2 ** 1.5)

    def dense_values(self, get, counts):
        n = counts.astype(np.float64)
        s1, s2, s3 = (get(o).astype(np.float64)
                      for o in ("sum", "sum2", "sum3"))
        mean = s1 / n
        m2 = s2 / n - mean * mean
        m3 = s3 / n - 3 * mean * s2 / n + 2 * mean ** 3
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(m2 > 0, m3 / np.maximum(m2, 1e-300) ** 1.5, 0.0)
        return out


class KurtosisAgg(MomentAgg):
    """KURTOSIS — excess kurtosis from the first four raw moments."""
    name = "kurtosis"
    device_outputs = ("sum", "sum2", "sum3", "sum4", "count")

    def host_state(self, values):
        v = np.asarray(values, dtype=np.float64)
        return (len(v), float(v.sum()), float((v ** 2).sum()),
                float((v ** 3).sum()), float((v ** 4).sum()))

    def finalize(self, state):
        n, s1, s2, s3, s4 = state
        if n == 0:
            return None
        mean = s1 / n
        m2 = s2 / n - mean * mean
        if m2 <= 0:
            return 0.0
        m4 = (s4 / n - 4 * mean * s3 / n + 6 * mean ** 2 * s2 / n - 3 * mean ** 4)
        return float(m4 / (m2 * m2) - 3.0)

    def dense_values(self, get, counts):
        n = counts.astype(np.float64)
        s1, s2, s3, s4 = (get(o).astype(np.float64)
                          for o in ("sum", "sum2", "sum3", "sum4"))
        mean = s1 / n
        m2 = s2 / n - mean * mean
        m4 = (s4 / n - 4 * mean * s3 / n
              + 6 * mean ** 2 * s2 / n - 3 * mean ** 4)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(m2 > 0, m4 / np.maximum(m2 * m2, 1e-300) - 3.0, 0.0)
        return out


# -- two-argument aggregations ------------------------------------------------
# The executor evaluates ONE argument expression per aggregation, so multi-arg
# functions pack their columns into an [n, k] matrix via the internal __pack
# transform (engine/expr.py); host_state then unpacks columns. Host-path only
# (__pack is not a device function), like the reference's covariance family.

def _pack_args(args) -> Function:
    return Function("__pack", tuple(args))


def _require_numeric_arg(agg: AggFunc, segment, arg: Optional[Expr] = None) -> None:
    """Every column referenced by the argument must be numeric."""
    from ..sql.ast import identifiers_in
    arg = arg if arg is not None else agg.arg
    if arg is None:
        return
    for name in identifiers_in(arg):
        if name == "*":
            continue
        try:
            reader = segment.column(name)
        except KeyError:
            continue
        if not reader.data_type.is_numeric:
            raise QueryValidationError(
                f"{agg.call.name.upper()} requires numeric arguments; "
                f"column {name!r} is {reader.data_type.value}")


class CovarPopAgg(MomentAgg):
    """COVAR_POP / COVAR_SAMP (reference: CovarianceAggregationFunction)."""
    name = "covarpop"
    device_outputs = ()
    sample = False

    def __init__(self, call: Function):
        super().__init__(call)
        if len(call.args) < 2:
            raise QueryValidationError(f"{self.name} needs two arguments")
        self._arg_cols = call.args[:2]
        self.arg = _pack_args(self._arg_cols)

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def validate_args(self, segment) -> None:
        for a in self._arg_cols:
            _require_numeric_arg(self, segment, a)

    def host_state(self, values):
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return (0, 0.0, 0.0, 0.0)
        x, y = v[:, 0], v[:, 1]
        # centered co-moment, merged pairwise like VarianceAgg (stable at any
        # magnitude; raw Σxy cancels catastrophically for epoch-sized columns)
        cxy = float(((x - x.mean()) * (y - y.mean())).sum())
        return (len(x), float(x.sum()), float(y.sum()), cxy)

    def merge(self, a, b):
        na, sxa, sya, ca = a
        nb, sxb, syb, cb = b
        if na == 0:
            return b
        if nb == 0:
            return a
        n = na + nb
        dx = sxb / nb - sxa / na
        dy = syb / nb - sya / na
        return (n, sxa + sxb, sya + syb, ca + cb + dx * dy * na * nb / n)

    def finalize(self, state):
        n, _sx, _sy, cxy = state
        d = n - 1 if self.sample else n
        if n == 0 or d <= 0:
            return None
        return float(cxy / d)


class CovarSampAgg(CovarPopAgg):
    name = "covarsamp"
    sample = True


class CorrAgg(CovarPopAgg):
    """CORR — Pearson correlation; centered co-moments like CovarPopAgg."""
    name = "corr"

    def host_state(self, values):
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return (0, 0.0, 0.0, 0.0, 0.0, 0.0)
        x, y = v[:, 0], v[:, 1]
        dx, dy = x - x.mean(), y - y.mean()
        return (len(x), float(x.sum()), float(y.sum()), float((dx * dx).sum()),
                float((dy * dy).sum()), float((dx * dy).sum()))

    def merge(self, a, b):
        na, sxa, sya, cxxa, cyya, cxya = a
        nb, sxb, syb, cxxb, cyyb, cxyb = b
        if na == 0:
            return b
        if nb == 0:
            return a
        n = na + nb
        dx = sxb / nb - sxa / na
        dy = syb / nb - sya / na
        w = na * nb / n
        return (n, sxa + sxb, sya + syb,
                cxxa + cxxb + dx * dx * w,
                cyya + cyyb + dy * dy * w,
                cxya + cxyb + dx * dy * w)

    def finalize(self, state):
        n, _sx, _sy, cxx, cyy, cxy = state
        if n == 0 or cxx <= 0 or cyy <= 0:
            return None
        return float(cxy / np.sqrt(cxx * cyy))


class LastWithTimeAgg(AggFunc):
    """LASTWITHTIME(col, timeCol, 'dataType') — value at the max time
    (reference: LastWithTimeAggregationFunction). State: (time, value)."""
    name = "lastwithtime"
    pick_last = True

    def __init__(self, call: Function):
        super().__init__(call)
        if len(call.args) < 2:
            raise QueryValidationError(f"{self.name} needs (value, time) arguments")
        self._arg_cols = call.args[:2]
        self.arg = _pack_args(self._arg_cols)

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def validate_args(self, segment) -> None:
        # string value columns need a typed state the __pack matrix can't carry;
        # fail at plan time instead of deep in np.asarray(dtype=float64)
        for a in self._arg_cols:
            _require_numeric_arg(self, segment, a)

    def host_state(self, values):
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return None
        x, t = v[:, 0], v[:, 1]
        i = int(np.argmax(t) if self.pick_last else np.argmin(t))
        return (float(t[i]), float(x[i]))

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if self.pick_last:
            return a if a[0] >= b[0] else b
        return a if a[0] <= b[0] else b

    def finalize(self, state):
        return None if state is None else state[1]


class FirstWithTimeAgg(LastWithTimeAgg):
    name = "firstwithtime"
    pick_last = False


class HistogramAgg(AggFunc):
    """HISTOGRAM(col, lower, upper, numBins) — equal-width bin counts
    (reference: HistogramAggregationFunction). State: int64[numBins]; values
    outside [lower, upper) are clamped into the edge bins like the reference."""
    name = "histogram"

    def __init__(self, call: Function):
        super().__init__(call)
        from ..sql.ast import Literal
        if len(call.args) != 4 or not all(isinstance(a, Literal)
                                          for a in call.args[1:]):
            raise QueryValidationError(
                "HISTOGRAM needs (column, lower, upper, numBins) literals")
        self.lower = float(call.args[1].value)
        self.upper = float(call.args[2].value)
        self.bins = int(call.args[3].value)
        if self.bins <= 0 or self.upper <= self.lower:
            raise QueryValidationError("HISTOGRAM needs upper > lower, bins > 0")
        self.arg = call.args[0]

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def host_state(self, values):
        v = np.asarray(values, dtype=np.float64)
        idx = np.floor((v - self.lower) / (self.upper - self.lower) * self.bins)
        idx = np.clip(idx, 0, self.bins - 1).astype(np.int64)
        return np.bincount(idx, minlength=self.bins).astype(np.int64)

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return [int(c) for c in state]

    def empty_result(self):
        return [0] * self.bins


class DistinctSumAgg(DistinctCountAgg):
    """DISTINCTSUM — sum over the distinct value set (reference:
    DistinctSumAggregationFunction); device path reuses the presence vector."""
    name = "distinctsum"

    def validate_args(self, segment) -> None:
        _require_numeric_arg(self, segment)

    def finalize(self, state):
        return float(sum(state)) if state else None

    def empty_result(self):
        return None


class DistinctAvgAgg(DistinctCountAgg):
    name = "distinctavg"

    def finalize(self, state):
        return float(sum(state) / len(state)) if state else None

    def empty_result(self):
        return None




class BoolAndAgg(AggFunc):
    """BOOL_AND — true iff every (boolean 0/1) value is true; rides the device
    min output (reference: BooleanAndAggregationFunction, which likewise
    requires a BOOLEAN argument — enforced in validate_args so the device
    min>=1 decode and the host truthiness path can never disagree)."""
    name = "booland"
    device_outputs = ("min",)

    def validate_args(self, segment) -> None:
        from ..sql.ast import Identifier as _Id
        if isinstance(self.arg, _Id) and self.arg.name != "*":
            try:
                dt = segment.column(self.arg.name).data_type
            except KeyError:
                return
            from ..schema import DataType as _DT
            if dt is not _DT.BOOLEAN:
                raise QueryValidationError(
                    f"{self.call.name.upper()} requires a BOOLEAN column; "
                    f"{self.arg.name!r} is {dt.value}")

    def host_state(self, values):
        return bool(np.all(np.asarray(values) != 0)) if len(values) else None

    def state_from_device(self, outs):
        return bool(outs["min"] >= 1) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a and b

    def finalize(self, state):
        return state


class BoolOrAgg(BoolAndAgg):
    name = "boolor"
    device_outputs = ("max",)

    def host_state(self, values):
        return bool(np.any(np.asarray(values) != 0)) if len(values) else None

    def state_from_device(self, outs):
        return bool(outs["max"] >= 1) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a or b


class SumPrecisionAgg(AggFunc):
    """SUMPRECISION — exact decimal sum, returned as a string (reference:
    SumPrecisionAggregationFunction over BigDecimal)."""
    name = "sumprecision"

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def validate_args(self, segment) -> None:
        _require_numeric_arg(self, segment)

    def host_state(self, values):
        from decimal import Decimal
        if not len(values):
            return None  # empty -> null, like SUM (and like empty_result)
        total = Decimal(0)
        for v in np.asarray(values).tolist():
            total += Decimal(str(v))
        return total

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def finalize(self, state):
        return str(state.normalize()) if state is not None else None


class PercentileRawTDigestAgg(PercentileTDigestAgg):
    """PERCENTILERAWTDIGEST — serialized t-digest (hex) for client-side merging.

    Host path ONLY: the device counts path builds one centroid per distinct
    value, so the serialized bytes would differ between execution paths for
    identical data — clients that store/diff raw digests need stability."""
    name = "percentilerawtdigest"
    pct_base = "percentilerawtdigest"
    device_outputs = ()
    wants_id_counts = False

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def finalize(self, state):
        return state.to_bytes().hex()









class DistinctCountRawHLLAgg(DistinctCountHLLAgg):
    """DISTINCTCOUNTRAWHLL — serialized registers (hex) for client-side merging
    (reference: DistinctCountRawHLLAggregationFunction). Register-max merge of
    two hex payloads of equal p reproduces the server-side union."""
    name = "distinctcountrawhll"

    def finalize(self, state):
        return self._normalize(state).astype(np.int8).tobytes().hex()

    def empty_result(self):
        return np.zeros(1 << self.p, dtype=np.int8).tobytes().hex()



class PercentileRawEstAgg(PercentileEstAgg):
    """PERCENTILERAWEST — serialized digest (hex); the reference serializes a
    QuantileDigest, here the same t-digest state as PERCENTILERAWTDIGEST.
    Host path only, like the other RAW variant: serialized bytes must not
    depend on the execution path."""
    name = "percentilerawest"
    pct_base = "percentilerawest"
    device_outputs = ()
    wants_id_counts = False

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def finalize(self, state):
        return state.to_bytes().hex()


class PercentileSmartTDigestAgg(PercentileTDigestAgg):
    """PERCENTILESMARTTDIGEST — exact value buffer until `threshold` values,
    then degrade to a t-digest (reference: PercentileSmartTDigestAggregationFunction,
    threshold via a 'threshold=N' third argument)."""
    name = "percentilesmarttdigest"
    pct_base = "percentilesmarttdigest"
    DEFAULT_THRESHOLD = 100_000
    # NOT the inherited device counts path: smart's state is ("exact"|
    # "digest", v) tuples and its exact-below-threshold contract needs raw
    # values, which the per-id count vector cannot restore
    device_outputs = ()
    wants_id_counts = False

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def __init__(self, call: Function):
        super().__init__(call)
        self.threshold = self.DEFAULT_THRESHOLD
        from ..sql.ast import Literal
        # args[1:]: in the digit-suffix form (PERCENTILESMARTTDIGEST90(x, ...))
        # the threshold literal is args[1]; a pct literal never contains
        # "threshold=" so the guard excludes it either way
        for a in call.args[1:]:
            if isinstance(a, Literal) and "threshold=" in str(a.value):
                self.threshold = int(str(a.value).split("=", 1)[1])

    def _digest(self, values: np.ndarray):
        from .sketches import TDigest
        return TDigest.from_values(values, self.COMPRESSION)

    def host_state(self, values):
        arr = np.asarray(values, dtype=np.float64)
        if len(arr) > self.threshold:
            return ("digest", self._digest(arr))
        return ("exact", arr)

    def merge(self, a, b):
        ka, va = a
        kb, vb = b
        if ka == "exact" and kb == "exact":
            u = np.concatenate([va, vb])
            if len(u) > self.threshold:
                return ("digest", self._digest(u))
            return ("exact", u)
        da = va if ka == "digest" else self._digest(va)
        db = vb if kb == "digest" else self._digest(vb)
        return ("digest", da.merge(db))

    def finalize(self, state):
        kind, v = state
        if kind == "exact":
            return None if len(v) == 0 else float(np.percentile(v, self.pct))
        q = v.quantile(self.pct / 100.0)
        return None if q is None else float(q)










class SegmentPartitionedDistinctCountAgg(AggFunc):
    """Exact distinct count under the promise that the column is partitioned by
    segment (each value appears in only one segment): per-segment exact unique
    count, merged by SUM — O(1) merge state instead of shipping value sets
    (reference: SegmentPartitionedDistinctCountAggregationFunction; returns
    overcounts if the promise is violated, same as the reference)."""
    name = "segmentpartitioneddistinctcount"

    def device_ok(self, ctx):
        return False

    def host_state(self, values):
        arr = np.asarray(values)
        if arr.dtype == object:
            return len({v for v in arr if v is not None})
        return len(np.unique(arr))

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return int(state)

    # NOTE: no dense_values here — `counts` is the matched-ROW count, not a
    # distinct count; inheriting CountAgg's shape would silently miscount if
    # this agg ever grows a device plan (today device_ok is False).

    def empty_result(self):
        return 0


class DistinctCountSmartHLLAgg(AggFunc):
    """Exact distinct set until `threshold` distinct values, then degrade to
    HLL (reference: DistinctCountSmartHLLAggregationFunction). Second literal
    argument overrides the threshold."""
    name = "distinctcountsmarthll"
    DEFAULT_THRESHOLD = 100_000

    def __init__(self, call: Function):
        super().__init__(call)
        self.threshold = self.DEFAULT_THRESHOLD
        if len(call.args) >= 2:
            from ..sql.ast import Literal
            if isinstance(call.args[1], Literal):
                self.threshold = int(call.args[1].value)
        self._hll = DistinctCountHLLAgg(Function("distinctcounthll",
                                                 call.args[:1]))

    def device_ok(self, ctx):
        return False

    def _to_hll(self, values_set):
        return self._hll.host_state(np.asarray(list(values_set), dtype=object))

    def host_state(self, values):
        s = {v for v in np.asarray(values, dtype=object).reshape(-1)
             if v is not None}
        if len(s) > self.threshold:
            return ("hll", self._to_hll(s))
        return ("set", s)

    def merge(self, a, b):
        ka, va = a
        kb, vb = b
        if ka == "set" and kb == "set":
            u = va | vb
            if len(u) > self.threshold:
                return ("hll", self._to_hll(u))
            return ("set", u)
        ha = va if ka == "hll" else self._to_hll(va)
        hb = vb if kb == "hll" else self._to_hll(vb)
        return ("hll", np.maximum(ha, hb))

    def finalize(self, state):
        kind, v = state
        return len(v) if kind == "set" else self._hll.finalize(v)

    def empty_result(self):
        return 0


class StUnionAgg(AggFunc):
    """STUNION — union of point geometries into one MULTIPOINT WKT (reference:
    StUnionAggregationFunction unions theta-sketch-free geometries; our geo
    model is lng/lat points — see engine/geo_fns.py — so the union is the
    distinct point set, serialized as WKT)."""
    name = "stunion"

    def device_ok(self, ctx):
        return False

    def host_state(self, values):
        from ..engine.geo_fns import _as_complex
        pts = _as_complex(values)
        return {(float(p.real), float(p.imag))
                for p in np.atleast_1d(np.asarray(pts, dtype=complex))}

    def merge(self, a, b):
        return a | b

    def finalize(self, state):
        if not state:
            return "MULTIPOINT EMPTY"
        # 12 significant digits: ~1e-7 deg (cm-scale) lng/lat stays distinct,
        # %g's 6-digit default would collapse nearby real-world points
        body = ", ".join(f"{x:.12g} {y:.12g}" for x, y in sorted(state))
        return f"MULTIPOINT ({body})"

    def empty_result(self):
        return "MULTIPOINT EMPTY"


class IdSetAgg(AggFunc):
    """IDSET(col): build a serialized value-set usable as an `IN_ID_SET` filter
    literal in a later query (reference: IdSetAggregationFunction; the broker's
    IN_SUBQUERY rewrite consumes this). State is an `IdSet`; finalize emits the
    base64 string."""

    name = "idset"

    def device_ok(self, ctx):
        return False

    def host_state(self, values):
        from .idset import IdSet
        return IdSet.from_values(values)

    def merge(self, a, b):
        return a.union(b)

    def finalize(self, state):
        return state.serialize()

    def empty_result(self):
        from .idset import IdSet
        return IdSet.empty().serialize()


# -- multi-value aggregations (the reference's CountMVAggregationFunction, ...)
# The argument on the host is the column's rows (`MVValues`, or an object
# array of per-row value arrays from a transform); each *MV function flattens
# the rows to their values first.
# Host only: the device body has no ragged-row reduction.

def _mv_flat(values) -> np.ndarray:
    if isinstance(values, MVValues):
        return values.values()
    rows = [np.asarray(v) for v in values]
    if not rows:
        return np.empty(0, dtype=np.float64)
    return np.concatenate(rows)


def _strip_mv(call: Function) -> Function:
    return Function(call.name[:-2], call.args, call.distinct)


class _MVHost:
    """Mixin of the *MV functions: host only, over the flattened values."""

    def device_ok(self, ctx: AggContext) -> bool:
        return False

    def host_state(self, values):
        return super().host_state(_mv_flat(values))


class CountMVAgg(_MVHost, CountAgg):
    name = "countmv"

    def host_state(self, values):
        if isinstance(values, MVValues):
            return int(values.counts.sum())
        return int(sum(len(v) for v in values))


class SumMVAgg(_MVHost, SumAgg):
    name = "summv"


class MinMVAgg(_MVHost, MinAgg):
    name = "minmv"


class MaxMVAgg(_MVHost, MaxAgg):
    name = "maxmv"


class AvgMVAgg(_MVHost, AvgAgg):
    name = "avgmv"


class MinMaxRangeMVAgg(_MVHost, MinMaxRangeAgg):
    name = "minmaxrangemv"


class DistinctCountMVAgg(_MVHost, DistinctCountAgg):
    name = "distinctcountmv"


class DistinctSumMVAgg(_MVHost, DistinctSumAgg):
    name = "distinctsummv"

    def host_state(self, values):
        return DistinctCountAgg.host_state(self, _mv_flat(values))


class DistinctAvgMVAgg(_MVHost, DistinctAvgAgg):
    name = "distinctavgmv"

    def host_state(self, values):
        return DistinctCountAgg.host_state(self, _mv_flat(values))


class DistinctCountHLLMVAgg(_MVHost, DistinctCountHLLAgg):
    name = "distinctcounthllmv"


class DistinctCountRawHLLMVAgg(_MVHost, DistinctCountRawHLLAgg):
    name = "distinctcountrawhllmv"


class IdSetMVAgg(_MVHost, IdSetAgg):
    name = "idsetmv"


class PercentileMVAgg(_MVHost, PercentileAgg):
    """PERCENTILEMV / PERCENTILE<NN>MV: the exact percentile of the flattened
    values (the reference's PercentileMVAggregationFunction)."""
    name = "percentilemv"

    def __init__(self, call: Function):
        super().__init__(_strip_mv(call))


class PercentileEstMVAgg(_MVHost, PercentileEstAgg):
    name = "percentileestmv"

    def __init__(self, call: Function):
        super().__init__(_strip_mv(call))


class PercentileTDigestMVAgg(_MVHost, PercentileTDigestAgg):
    name = "percentiletdigestmv"

    def __init__(self, call: Function):
        super().__init__(_strip_mv(call))


class PercentileRawEstMVAgg(_MVHost, PercentileRawEstAgg):
    name = "percentilerawestmv"

    def __init__(self, call: Function):
        super().__init__(_strip_mv(call))


class PercentileRawTDigestMVAgg(_MVHost, PercentileRawTDigestAgg):
    name = "percentilerawtdigestmv"

    def __init__(self, call: Function):
        super().__init__(_strip_mv(call))


_REGISTRY = {
    "count": CountAgg,
    "sum": SumAgg,
    "min": MinAgg,
    "max": MaxAgg,
    "avg": AvgAgg,
    "minmaxrange": MinMaxRangeAgg,
    "distinctcount": DistinctCountAgg,
    "distinctcountbitmap": DistinctCountAgg,  # exact; same state here
    "distinctcounthll": DistinctCountHLLAgg,
    "fasthll": DistinctCountHLLAgg,  # legacy alias (reference: FASTHLL)
    "distinctcountrawhll": DistinctCountRawHLLAgg,
    "distinctcountsmarthll": DistinctCountSmartHLLAgg,
    "segmentpartitioneddistinctcount": SegmentPartitionedDistinctCountAgg,
    "mode": ModeAgg,
    "percentile": PercentileAgg,
    "percentileest": PercentileEstAgg,
    "percentiletdigest": PercentileTDigestAgg,
    "percentilerawtdigest": PercentileRawTDigestAgg,
    "percentilerawest": PercentileRawEstAgg,
    "percentilesmarttdigest": PercentileSmartTDigestAgg,
    "distinctcountthetasketch": DistinctCountThetaAgg,
    "distinctcountrawthetasketch": DistinctCountRawThetaAgg,
    # moments (both reference camelCase-derived and SQL-standard spellings)
    "varpop": VarianceAgg, "var_pop": VarianceAgg,
    "varsamp": VarSampAgg, "var_samp": VarSampAgg,
    "stddevpop": StdDevPopAgg, "stddev_pop": StdDevPopAgg,
    "stddevsamp": StdDevSampAgg, "stddev_samp": StdDevSampAgg,
    "skewness": SkewnessAgg,
    "kurtosis": KurtosisAgg,
    "covarpop": CovarPopAgg, "covar_pop": CovarPopAgg,
    "covarsamp": CovarSampAgg, "covar_samp": CovarSampAgg,
    "corr": CorrAgg,
    "firstwithtime": FirstWithTimeAgg,
    "lastwithtime": LastWithTimeAgg,
    "histogram": HistogramAgg,
    "distinctsum": DistinctSumAgg,
    "distinctavg": DistinctAvgAgg,
    "booland": BoolAndAgg, "bool_and": BoolAndAgg,
    "boolor": BoolOrAgg, "bool_or": BoolOrAgg,
    "sumprecision": SumPrecisionAgg,
    "stunion": StUnionAgg,
    "idset": IdSetAgg,
    "countmv": CountMVAgg,
    "summv": SumMVAgg,
    "minmv": MinMVAgg,
    "maxmv": MaxMVAgg,
    "avgmv": AvgMVAgg,
    "minmaxrangemv": MinMaxRangeMVAgg,
    "distinctcountmv": DistinctCountMVAgg,
    "distinctcountbitmapmv": DistinctCountMVAgg,  # exact, the same state
    "distinctsummv": DistinctSumMVAgg,
    "distinctavgmv": DistinctAvgMVAgg,
    "distinctcounthllmv": DistinctCountHLLMVAgg,
    "distinctcountrawhllmv": DistinctCountRawHLLMVAgg,
    "idsetmv": IdSetMVAgg,
}

# the multi-value aggregations (the JAX package's `*MV` classes)
MV_AGGREGATIONS = frozenset({
    "countmv", "summv", "minmv", "maxmv", "avgmv", "minmaxrangemv",
    "distinctcountmv", "distinctcountbitmapmv", "distinctsummv", "distinctavgmv",
    "distinctcounthllmv", "distinctcountrawhllmv", "idsetmv"})
_PERCENTILE_PREFIXES = ("percentilesmarttdigest", "percentilerawtdigest", "percentilerawest",
                        "percentiletdigest", "percentileest", "percentile")
# PERCENTILE*MV, longest prefix first (no smart t-digest MV, as in the reference)
_PERCENTILE_MV = (("percentilerawtdigest", PercentileRawTDigestMVAgg),
                  ("percentilerawest", PercentileRawEstMVAgg),
                  ("percentiletdigest", PercentileTDigestMVAgg),
                  ("percentileest", PercentileEstMVAgg),
                  ("percentile", PercentileMVAgg))


def make_agg(call: Function) -> AggFunc:
    name = call.name
    if name == "count" and call.distinct:
        # COUNT(DISTINCT x) -> DISTINCTCOUNT(x), the reference's rewrite
        return DistinctCountAgg(Function("distinctcount", call.args))
    if name.endswith("mv") and name.startswith("percentile"):
        stem = name[:-2]
        for prefix, cls in _PERCENTILE_MV:
            if stem == prefix or (stem.startswith(prefix) and stem[len(prefix):].isdigit()):
                return cls(call)
    for prefix in _PERCENTILE_PREFIXES:
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return _REGISTRY[prefix](call)
    cls = _REGISTRY.get(name)
    if cls is None:
        raise QueryValidationError(f"unsupported aggregation function {name!r}")
    return cls(call)
