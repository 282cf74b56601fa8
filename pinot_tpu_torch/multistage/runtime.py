"""Multistage runtime: hash exchange, per-partition hash joins, aggregate, reduce.

The in-process path of `pinot_tpu/multistage/runtime.py` (analog of the
reference's `pinot-query-runtime` operator chain: `HashJoinOperator`,
`AggregateOperator`, `MailboxSendOperator`/`MailboxReceiveOperator` over
`GrpcMailboxService`, `QueryDispatcher.submitAndReduce`). Data moves between
stages as columnar blocks (`Dict[col -> np.ndarray]`) through an in-process
mailbox service. Leaf scans run the single-stage engine's filter on the device
(`ServerQueryExecutor._selection_mask`) and gather the matching rows' columns
on the host; each join partition runs the device hash join
(`engine/join_kernels.py`) on a thread of the stage pool, with the partial
GROUP BY of an aggregation query; the final reduce is the single-stage one.
A `stage_runner` may run the partitions elsewhere: the broker's funnel path
ships each partition to a server's `POST /stage` (the join spec and the
partial GROUP BY travel as JSON, `spec_to_json` / `agg_spec_to_json`), and
the mailbox shuffle (`shuffle.py`) routes with the same stable hashes in
every process.

Join null semantics: outer-join null-extended numeric columns become float NaN
and object columns None; aggregations skip them (SQL null-skipping),
comparisons fail them, and the final reduce's sort treats them as SQL nulls.

The entry points run on CUDA unless the caller passes `device="cpu"`; with no
CUDA card they raise RuntimeError.
"""

from __future__ import annotations

import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cluster.tiering import join_device_budget_bytes, predicted_join_bytes
from ..engine import join_kernels as jk
from ..engine.expr import eval_host
from ..query import stats as qstats
from ..query.aggregates import AggFunc, make_agg
from ..query.context import QueryContext
from ..query.executor import ServerQueryExecutor, resolve_device
from ..query.executor import _take as _take_rows
from ..query.planner import plan_segment
from ..query.reduce import SegmentResult, merge_segment_results, reduce_to_result
from ..query.result import ResultTable
from ..sql.ast import Expr, Function, Identifier, Literal, identifiers_in, to_sql
from ..sql.parser import parse_query
from .planner import JoinSpec, MultistagePlan, _and_all, choose_join_strategy, plan_multistage

Block = Dict[str, np.ndarray]
# scan_fn(table, columns, bare-name filter) -> Dict[bare col -> np.ndarray]
# (table, columns, filter, derived build-key filter) -> block; carries the
# `device` it runs on as an attribute (`make_segment_scan`)
ScanFn = Callable[[str, List[str], Optional[Expr], Optional[Expr]], Block]

DEFAULT_PARTITIONS = 8

# partition-stage timings, summed over a query's partition threads (read into
# the result's `phaseTimesMs`, not exported as stats keys)
STAGE_JOIN_MS = "stageJoinMs"
STAGE_AGGREGATE_MS = "stageAggregateMs"


class MailboxService:
    """In-process mailbox fabric keyed (stage, partition): the degenerate single-host
    instance of the reference's `GrpcMailboxService` (mailbox.proto bidi streams)."""

    def __init__(self) -> None:
        self._boxes: Dict[Tuple[str, int], List[JoinInput]] = {}

    def send(self, stage: str, partition: int, block: JoinInput) -> None:
        self._boxes.setdefault((stage, partition), []).append(block)

    def receive(self, stage: str, partition: int) -> List[JoinInput]:
        return self._boxes.pop((stage, partition), [])


# ---------------------------------------------------------------------------
# block primitives
# ---------------------------------------------------------------------------

def _block_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def _concat_blocks(blocks: List[Block]) -> Block:
    if not blocks:
        return {}
    cols = blocks[0].keys()
    out: Block = {}
    for c in cols:
        arrs = [b[c] for b in blocks]
        if any(a.dtype == object for a in arrs):
            arrs = [a.astype(object) for a in arrs]
        out[c] = np.concatenate(arrs) if arrs else np.empty(0)
    return out


def _take(block: Block, idx: np.ndarray) -> Block:
    return {c: v[idx] for c, v in block.items()}


# Stable hashes: Python's builtin hash() is randomized per process
# (PYTHONHASHSEED), so the exchange hashes deterministically. They must stay
# byte-identical to the JAX package's, which a shuffle between the two would
# need and the tests hold.

_NULL_HASH = np.uint64(0x9E3779B97F4A7C15)
_HASH_MULT = np.uint64(1000003)


def _stable_obj_hash(v) -> int:
    if v is None:
        return int(_NULL_HASH)
    if isinstance(v, str):
        return zlib.crc32(v.encode("utf-8"))
    if isinstance(v, (bytes, bytearray)):
        return zlib.crc32(bytes(v))
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    if isinstance(v, (int, np.integer, float, np.floating)):
        f = float(v)
        if f != f:  # NaN
            return int(_NULL_HASH)
        if f == 0.0:
            f = 0.0  # collapse -0.0
        return int(np.float64(f).view(np.uint64))
    # MV cells (lists) and anything exotic: hash the repr deterministically
    return zlib.crc32(repr(v).encode("utf-8"))


def _make_crc32_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, np.uint32(0xEDB88320) ^ (t >> 1), t >> 1)
    return t


_CRC32_TABLE = _make_crc32_table()


def _crc32_blockwise(byte_cols: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """zlib.crc32 of each row's `lengths[i]`-byte prefix of `byte_cols[i, :]`,
    vectorized column-at-a-time: the loop runs over the byte WIDTH of the
    widest string, every step updates all rows at once through the standard
    reflected-polynomial table."""
    crc = np.full(len(lengths), 0xFFFFFFFF, dtype=np.uint32)
    for j in range(byte_cols.shape[1]):
        live = j < lengths
        stepped = (_CRC32_TABLE[(crc ^ byte_cols[:, j]) & np.uint32(0xFF)]
                   ^ (crc >> np.uint32(8)))
        crc = np.where(live, stepped, crc)
    return crc ^ np.uint32(0xFFFFFFFF)


def _hash_obj_rows(arr: np.ndarray) -> np.ndarray:
    """Per-row hashing tail: mixed-type cells, bytes, MV lists, non-ASCII."""
    return np.fromiter((_stable_obj_hash(x) for x in arr), dtype=np.uint64,
                       count=len(arr))


def _hash_str_array(arr: np.ndarray) -> Optional[np.ndarray]:
    """Vectorized stable hash of an object column of str/None cells: one
    unicode conversion for the whole column, then blockwise table-driven CRC32
    over the codepoint bytes. MUST stay byte-identical to `_stable_obj_hash`'s
    per-row `zlib.crc32`. Returns None when any cell is not str/None (bytes,
    MV lists, mixed types -> the per-row tail)."""
    n = len(arr)
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    is_str = np.frompyfunc(
        lambda v: 0 if v is None else (1 if isinstance(v, str) else 2),
        1, 1)(arr).astype(np.int8)
    if (is_str == 2).any():
        return None
    null = is_str == 0
    out = np.full(n, np.uint64(_NULL_HASH), dtype=np.uint64)
    live = ~null
    if not live.any():
        return out
    u = np.where(null, "", arr).astype(str)
    width = u.dtype.itemsize // 4
    if width == 0:
        out[live] = 0  # every live string empty: crc32(b"") == 0
        return out
    cp = np.ascontiguousarray(u).view(np.uint32).reshape(n, width)
    # exact char lengths via len(): codepoint-derived lengths would miscount
    # strings with embedded/trailing NUL characters
    lens = np.zeros(n, dtype=np.int64)
    lens[live] = np.frompyfunc(len, 1, 1)(arr[live]).astype(np.int64)
    # ASCII fast path: codepoints < 128 encode to themselves in UTF-8, so the
    # codepoint matrix IS the byte matrix
    ascii_rows = live & (cp < 128).all(axis=1)
    if ascii_rows.any():
        out[ascii_rows] = _crc32_blockwise(
            cp[ascii_rows].astype(np.uint8), lens[ascii_rows]
        ).astype(np.uint64)
    slow = live & ~ascii_rows
    if slow.any():  # non-ASCII needs real UTF-8 byte layout: per-row tail
        out[slow] = _hash_obj_rows(arr[slow])
    return out


def _column_hash_codes(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == object:
        col = _hash_str_array(arr)
        return col if col is not None else _hash_obj_rows(arr)
    f = np.nan_to_num(arr.astype(np.float64), nan=0.0)
    f = np.where(f == 0.0, 0.0, f)  # collapse -0.0/+0.0
    return f.view(np.uint64)


def stable_hash_codes(block: Block, keys: Sequence[str]) -> np.ndarray:
    """Per-row uint64 hash over key columns, identical in every process.

    Numeric dtypes canonicalize through float64 bits so equal keys hash
    equally across dtypes (int 3 joining double 3.0 must co-partition; an
    outer join upstream may have promoted one side to float). String columns
    take the blockwise-CRC32 vector path (`_hash_str_array`), everything
    object-exotic the per-row tail; both produce identical codes."""
    n = _block_rows(block)
    h = np.zeros(n, dtype=np.uint64)
    for k in keys:
        h = h * _HASH_MULT ^ _column_hash_codes(block[k])
    return h


def stable_hash_key(key) -> int:
    """Deterministic hash of a group-key tuple (the columns' mixing, never
    Python's per-process `hash()`); equal to the JAX package's."""
    h = np.uint64(0)
    for v in key:
        h = h * _HASH_MULT ^ np.uint64(_stable_obj_hash(v) & 0xFFFFFFFFFFFFFFFF)
    return int(h)


def partition_block_stable(block: Block, keys: Sequence[str], p: int) -> List[Block]:
    """A block's rows split into p partitions by `stable_hash_codes % p`, as
    the JAX package routes them (an empty block is every partition)."""
    if _block_rows(block) == 0:
        return [block for _ in range(p)]
    pid = (stable_hash_codes(block, keys) % np.uint64(p)).astype(np.int64)
    return [_take(block, np.nonzero(pid == i)[0]) for i in range(p)]


def _factorize_pair(left: np.ndarray, right: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense int codes consistent across both arrays; null (None/NaN) -> -1."""
    nl = len(left)
    both = np.concatenate([left.astype(object) if left.dtype == object else left,
                           right.astype(object) if right.dtype == object else right])
    if both.dtype == object:
        codes = np.empty(len(both), dtype=np.int64)
        seen: Dict[Any, int] = {}
        for i, v in enumerate(both):
            if v is None:
                codes[i] = -1
            else:
                c = seen.get(v)
                if c is None:
                    c = len(seen)
                    seen[v] = c
                codes[i] = c
    else:
        if both.dtype.kind == "f":
            nan = np.isnan(both)
            filled = np.where(nan, 0.0, both)
            _, codes = np.unique(filled, return_inverse=True)
            codes = codes.astype(np.int64)
            codes[nan] = -1
        else:
            _, codes = np.unique(both, return_inverse=True)
            codes = codes.astype(np.int64)
    return codes[:nl], codes[nl:]


def _combine_codes_pair(lparts: List[np.ndarray], rparts: List[np.ndarray]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-column keys -> one dense code per side, with strides shared across both
    sides so equal keys combine equally; any null column nulls the row key."""
    lout = lparts[0].copy()
    rout = rparts[0].copy()
    for lc, rc in zip(lparts[1:], rparts[1:]):
        card = int(max(lc.max(initial=-1), rc.max(initial=-1))) + 2
        lnull = (lout < 0) | (lc < 0)
        rnull = (rout < 0) | (rc < 0)
        lout = lout * card + lc
        rout = rout * card + rc
        lout[lnull] = -1
        rout[rnull] = -1
    return lout, rout


# ---------------------------------------------------------------------------
# hash join
# ---------------------------------------------------------------------------

def join_indices(lcodes: np.ndarray, rcodes: np.ndarray, how: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Row index pairs for an equi-join on dense key codes; -1 marks a
    null-extended side. Null keys (-1 codes) never match (SQL semantics).

    `how` in ("semi", "anti") returns left-side rows only (ri all -1):
    SEMI keeps left rows with >= 1 match, ANTI the complement: NOT EXISTS
    semantics, so a null-key left row is kept by ANTI (it matches nothing)."""
    order = np.argsort(rcodes, kind="stable")
    rs = rcodes[order]
    valid_l = lcodes >= 0
    lo = np.searchsorted(rs, lcodes, "left")
    hi = np.searchsorted(rs, lcodes, "right")
    cnt = np.where(valid_l, hi - lo, 0)
    if how in ("semi", "anti"):
        li = np.nonzero(cnt > 0 if how == "semi" else cnt == 0)[0]
        return li.astype(np.int64), np.full(len(li), -1, dtype=np.int64)
    total = int(cnt.sum())
    li = np.repeat(np.arange(len(lcodes)), cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ri = order[np.repeat(lo, cnt) + offs] if total else np.empty(0, dtype=np.int64)

    if how in ("left", "full"):
        unmatched_l = np.nonzero(cnt == 0)[0]
        li = np.concatenate([li, unmatched_l])
        ri = np.concatenate([ri, np.full(len(unmatched_l), -1, dtype=np.int64)])
    if how in ("right", "full"):
        matched_r = np.zeros(len(rcodes), dtype=bool)
        if total:
            matched_r[ri[ri >= 0]] = True
        matched_r[rcodes < 0] = False
        unmatched_r = np.nonzero(~matched_r)[0]
        li = np.concatenate([li, np.full(len(unmatched_r), -1, dtype=np.int64)])
        ri = np.concatenate([ri, unmatched_r])
    return li.astype(np.int64), ri.astype(np.int64)


def _take_nullable(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Gather with -1 producing SQL null (NaN for numerics, None for objects)."""
    if not (idx < 0).any():
        return arr[idx]
    safe = np.clip(idx, 0, max(len(arr) - 1, 0))
    if arr.dtype == object:
        out = arr[safe] if len(arr) else np.full(len(idx), None, dtype=object)
        out = out.astype(object)
        out[idx < 0] = None
        return out
    out = (arr[safe] if len(arr) else np.zeros(len(idx))).astype(np.float64)
    out[idx < 0] = np.nan
    return out


def hash_join_host(left: Block, right: Block, spec: JoinSpec) -> Block:
    """The host numpy join oracle: factorize actual key values through a
    Python dict, expand index pairs. The routing target of joins too small
    for the device, of key columns the device codes cannot carry, and of a
    join the admission gate prices off the device."""
    pairs = [_factorize_pair(left[lk], right[rk])
             for lk, rk in zip(spec.left_keys, spec.right_keys)]
    lcodes, rcodes = _combine_codes_pair([p[0] for p in pairs],
                                         [p[1] for p in pairs])
    li, ri = join_indices(lcodes, rcodes, spec.join_type)
    out: Block = {}
    if spec.join_type in ("semi", "anti"):
        # left rows pass through unchanged (no null-extension, no right cols)
        out = {c: v[li] for c, v in left.items()}
    else:
        for c, v in left.items():
            out[c] = _take_nullable(v, li)
        for c, v in right.items():
            out[c] = _take_nullable(v, ri)
    if spec.residual is not None and _block_rows(out):
        mask = np.asarray(_null_safe_mask(spec.residual, out), dtype=bool)
        out = _take(out, np.nonzero(mask)[0])
    return out


# -- device route -------------------------------------------------------------
# `configure_device_join` sets the routing: the broker applies the cluster
# knob `server.join.device.enabled` a query. The rows floor keeps tiny joins
# off the device: a few program launches cost more than a microsecond-scale
# host join.

_DEVICE_JOIN = {"enabled": True, "min_rows": 2048}


def configure_device_join(enabled: Optional[bool] = None,
                          min_rows: Optional[int] = None) -> None:
    if enabled is not None:
        _DEVICE_JOIN["enabled"] = bool(enabled)
    if min_rows is not None:
        _DEVICE_JOIN["min_rows"] = max(0, int(min_rows))


def _any_null_mask(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Row mask: any key column null (None / NaN); null keys never match."""
    n = len(cols[0]) if cols else 0
    out = np.zeros(n, dtype=bool)
    for arr in cols:
        if arr.dtype == object:
            out |= np.frompyfunc(lambda v: v is None, 1, 1)(arr).astype(bool)
        elif arr.dtype.kind == "f":
            out |= np.isnan(arr)
    return out


def _values_equal(la: np.ndarray, ra: np.ndarray, li: np.ndarray,
                  ri: np.ndarray) -> np.ndarray:
    """Elementwise key equality of candidate pairs across dtype promotion
    (int 3 must equal double 3.0, exactly as the host factorize treats it);
    integer-vs-integer compares exactly (no float64 precision cliff)."""
    if len(li) == 0:
        return np.zeros(0, dtype=bool)
    a, b = la[li], ra[ri]
    if a.dtype == object or b.dtype == object:
        return np.asarray(a.astype(object) == b.astype(object), dtype=bool)
    if a.dtype.kind in "iub" and b.dtype.kind in "iub":
        return a.astype(np.int64) == b.astype(np.int64)
    return a.astype(np.float64) == b.astype(np.float64)


def _device_join_ok(left: Block, right: Block, spec: JoinSpec) -> bool:
    """Eligibility: enabled, both sides big enough to amortize the launches,
    and every key column vectorizable (object columns must be all-str: MV
    list cells and mixed types go to the host oracle)."""
    if not _DEVICE_JOIN["enabled"]:
        return False
    n, m = _block_rows(left), _block_rows(right)
    if n == 0 or m == 0 or (n + m) < _DEVICE_JOIN["min_rows"]:
        return False
    for keys, blk in ((spec.left_keys, left), (spec.right_keys, right)):
        for key in keys:
            arr = blk[key]
            if arr.dtype == object and _hash_str_array(arr) is None:
                return False
    return True


def _scatter_slots(lkey: Sequence[np.ndarray], rkey: Sequence[np.ndarray],
                   lnull: np.ndarray, rnull: np.ndarray):
    """Scatter-regime inputs for a single integer-like key whose build-side
    value span fits the direct-address cap: (build_slots, probe_slots, size)
    as (key - min) offsets, or None when the shape doesn't qualify. Null rows
    carry out-of-range slots the programs drop. `size` is the span itself
    (the JAX package rounds it up to a power of two to bound retraces)."""
    if len(rkey) != 1:
        return None
    la, ra = lkey[0], rkey[0]
    if la.dtype == object or ra.dtype == object:
        return None
    if la.dtype.kind not in "iubf" or ra.dtype.kind not in "iubf":
        return None
    rlive = ~rnull
    if not rlive.any():
        return None
    rv = ra.astype(np.float64)
    rvl = rv[rlive]
    if not np.isfinite(rvl).all() or not (rvl == np.floor(rvl)).all():
        return None
    mn, mx = float(rvl.min()), float(rvl.max())
    span = mx - mn + 1
    if span <= 0 or span > jk.SCATTER_TABLE_CAP:
        return None
    size = int(span)
    build = np.full(len(ra), size, dtype=np.int64)    # null rows: dropped
    build[rlive] = (rvl - mn).astype(np.int64)
    lv = la.astype(np.float64)
    with np.errstate(invalid="ignore"):
        pl = (~lnull & np.isfinite(lv) & (lv == np.floor(lv))
              & (lv >= mn) & (lv <= mx))
    probe = np.full(len(la), -1, dtype=np.int64)      # no-match sentinel
    probe[pl] = (lv[pl] - mn).astype(np.int64)
    return build.astype(np.int32), probe.astype(np.int32), size


def _join_budget_bytes(device: torch.device) -> Optional[int]:
    """The memory ledger's budget for a join's working set on `device`."""
    return join_device_budget_bytes(device)


def _device_hash_join(left: Block, right: Block, spec: JoinSpec,
                      lcodes: Optional[np.ndarray], rcodes: Optional[np.ndarray],
                      device: torch.device) -> Optional[Block]:
    """Device probe (right side builds, left probes): scatter or sort-merge
    regime over 32-bit folded codes, then host-side vectorized verification
    of the candidates against the full 64-bit codes and the actual key
    values: fold collisions cost spurious candidates, never wrong rows.
    Returns None when the admission gate prices the intermediates off the
    device (`joinServedHostTier`); the caller runs the host oracle. An error
    in a device program propagates."""
    how = spec.join_type
    n, m = _block_rows(left), _block_rows(right)
    lkey = [left[k] for k in spec.left_keys]
    rkey = [right[k] for k in spec.right_keys]
    lnull = _any_null_mask(lkey)
    rnull = _any_null_mask(rkey)
    if lcodes is None:
        lcodes = stable_hash_codes(left, spec.left_keys)
    if rcodes is None:
        rcodes = stable_hash_codes(right, spec.right_keys)

    # admission: price the working set from build-side duplication BEFORE
    # staging anything: an exploding join degrades, it does not exhaust memory
    budget = _join_budget_bytes(device)
    if budget is not None:
        dup = m / max(1, int(np.unique(rcodes).size))
        ncols = len(left) + len(right)
        if predicted_join_bytes(m, n, ncols, dup) > budget:
            qstats.record(qstats.JOIN_SERVED_HOST_TIER)
            return None

    pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None
    skew = 0.0
    scat = _scatter_slots(lkey, rkey, lnull, rnull)
    if scat is not None:
        res = jk.scatter_probe(*scat, device=device)
        if res is not None:  # None: duplicate build keys -> sort-merge
            cand, skew = res
            li = np.nonzero(cand >= 0)[0].astype(np.int64)
            ri = cand[li]
            pairs = (li, ri)
    if pairs is None:
        lo, cnt, order, skew = jk.sort_merge_probe(
            jk.fold_codes32(rcodes), jk.fold_codes32(lcodes), device=device)
        total = int(cnt.sum())
        if budget is not None and total * 16 > budget:
            qstats.record(qstats.JOIN_SERVED_HOST_TIER)
            return None
        li = np.repeat(np.arange(n, dtype=np.int64), cnt)
        offs = (np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(cnt) - cnt, cnt))
        ri = (order[np.repeat(lo, cnt) + offs] if total
              else np.empty(0, dtype=np.int64))
        keep = lcodes[li] == rcodes[ri]     # drop 32-bit fold collisions
        pairs = (li[keep], ri[keep])

    li, ri = pairs
    # verify candidates against the actual key values; null keys never match
    keep = ~(lnull[li] | rnull[ri])
    for la, ra in zip(lkey, rkey):
        keep &= _values_equal(la, ra, li, ri)
    li, ri = li[keep], ri[keep]
    qstats.record_max(qstats.JOIN_SKEW_PCT, skew)

    out: Block = {}
    if how in ("semi", "anti"):
        matched = np.zeros(n, dtype=bool)
        matched[li] = True
        keep_l = np.nonzero(matched if how == "semi" else ~matched)[0]
        out = {c: v[keep_l] for c, v in left.items()}
    else:
        if how in ("left", "full"):
            matched = np.zeros(n, dtype=bool)
            matched[li] = True
            um = np.nonzero(~matched)[0]
            li = np.concatenate([li, um])
            ri = np.concatenate([ri, np.full(len(um), -1, dtype=np.int64)])
        if how in ("right", "full"):
            matched_r = np.zeros(m, dtype=bool)
            if len(ri):
                matched_r[ri[ri >= 0]] = True
            um_r = np.nonzero(~matched_r)[0]
            li = np.concatenate([li, np.full(len(um_r), -1, dtype=np.int64)])
            ri = np.concatenate([ri, um_r])
        for c, v in left.items():
            out[c] = _take_nullable(v, li)
        for c, v in right.items():
            out[c] = _take_nullable(v, ri)
    if spec.residual is not None and _block_rows(out):
        mask = np.asarray(_null_safe_mask(spec.residual, out), dtype=bool)
        out = _take(out, np.nonzero(mask)[0])
    return out


def hash_join(left: Block, right: Block, spec: JoinSpec,
              lcodes: Optional[np.ndarray] = None,
              rcodes: Optional[np.ndarray] = None, device=None) -> Block:
    """Equi-join one partition on `device` (CUDA unless the caller names
    another): the device route when eligible, the host oracle otherwise.
    `lcodes`/`rcodes` are the 64-bit stable exchange hashes when the exchange
    already computed them; passing them skips the re-hash."""
    dev = resolve_device(device)
    if _device_join_ok(left, right, spec):
        out = _device_hash_join(left, right, spec, lcodes, rcodes, dev)
        if out is not None:
            return out
    return hash_join_host(left, right, spec)


def _null_safe_mask(e: Expr, env: Block) -> np.ndarray:
    """Evaluate a predicate; rows whose inputs are null fail it (SQL three-valued
    logic collapsed to False, which matches WHERE/ON semantics)."""
    n = _block_rows(env)
    invalid = np.zeros(n, dtype=bool)
    safe_env: Block = {}
    for name in set(identifiers_in(e)):
        arr = env[name]
        if arr.dtype == object:
            null = np.array([v is None for v in arr], dtype=bool)
            if null.any():
                fill = next((v for v in arr if v is not None), 0)
                arr = arr.copy()
                arr[null] = fill
        else:
            null = np.isnan(arr) if arr.dtype.kind == "f" else np.zeros(n, dtype=bool)
            if null.any():
                arr = np.nan_to_num(arr, nan=0.0)
        invalid |= null
        safe_env[name] = arr
    mask = np.asarray(eval_host(e, safe_env))
    if mask.dtype != bool:
        mask = mask.astype(bool)
    return mask & ~invalid


# ---------------------------------------------------------------------------
# aggregation over a joined block (null-skipping)
# ---------------------------------------------------------------------------

def _factorize_single(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """codes + uniques for group keys; nulls group together under code==len(uniques).

    SQL GROUP BY treats null as one group; the null group key surfaces as None."""
    if arr.dtype == object:
        seen: Dict[Any, int] = {}
        codes = np.empty(len(arr), dtype=np.int64)
        for i, v in enumerate(arr):
            if v is None:
                codes[i] = -1
                continue
            c = seen.get(v)
            if c is None:
                c = len(seen)
                seen[v] = c
            codes[i] = c
        uniq = np.array(list(seen.keys()), dtype=object)
    else:
        if arr.dtype.kind == "f":
            nan = np.isnan(arr)
            uniq, codes = np.unique(np.where(nan, 0.0, arr), return_inverse=True)
            codes = codes.astype(np.int64)
            codes[nan] = -1
        else:
            uniq, codes = np.unique(arr, return_inverse=True)
            codes = codes.astype(np.int64)
    codes = np.where(codes < 0, len(uniq), codes)
    return codes, uniq


def aggregate_block(ctx: QueryContext, aggs: List[AggFunc], block: Block
                    ) -> SegmentResult:
    """Group + aggregate one partition's joined rows -> mergeable SegmentResult."""
    n = _block_rows(block)
    group_exprs = ([e for e, _ in ctx.select_items] if ctx.distinct
                   else list(ctx.group_by))

    # precompute each aggregation's argument values + null-validity once
    arg_vals: List[Optional[np.ndarray]] = []
    arg_valid: List[Optional[np.ndarray]] = []
    for a in aggs:
        if a.arg is None or (isinstance(a.arg, Identifier) and a.arg.name == "*"):
            arg_vals.append(None)
            arg_valid.append(None)
            continue
        v = np.asarray(eval_host(a.arg, block))
        if v.dtype == object:
            valid = np.array([x is not None for x in v], dtype=bool)
        elif v.dtype.kind == "f":
            valid = ~np.isnan(v)
        else:
            valid = np.ones(n, dtype=bool)
        arg_vals.append(v)
        arg_valid.append(valid)

    def group_states(idx: np.ndarray) -> List[Any]:
        states: List[Any] = []
        for i, a in enumerate(aggs):
            if arg_vals[i] is None:
                # COUNT(*) counts rows; other arg-less shapes aggregate zeros
                states.append(len(idx) if a.name == "count"
                              else a.host_state(np.zeros(len(idx))))
                continue
            sel = idx[arg_valid[i][idx]]  # SQL null-skipping per argument
            if a.name == "count":
                states.append(len(sel))
            else:
                states.append(a.host_state(arg_vals[i][sel]))
        return states

    if not group_exprs:
        return SegmentResult("scalar", scalar=group_states(np.arange(n)),
                             num_docs_scanned=n)

    codes_list = []
    uniq_list = []
    for g in group_exprs:
        arr = np.asarray(eval_host(g, block))
        codes, uniq = _factorize_single(arr)
        codes_list.append(codes)
        uniq_list.append(uniq)
    combined = np.zeros(n, dtype=np.int64)
    stride = 1
    for codes, uniq in zip(codes_list, uniq_list):
        combined += codes * stride
        stride *= len(uniq) + 1
    uniq_keys, inverse = np.unique(combined, return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    bounds = np.zeros(len(uniq_keys) + 1, dtype=np.int64)
    np.cumsum(np.bincount(inverse, minlength=len(uniq_keys)), out=bounds[1:])

    result = SegmentResult("groups", num_docs_scanned=n)
    for g, dense in enumerate(uniq_keys):
        gidx = order[bounds[g]:bounds[g + 1]]
        key = []
        rem = int(dense)
        for uniq in uniq_list:
            card = len(uniq) + 1
            c = rem % card
            v = None if c == len(uniq) else uniq[c]
            key.append(v.item() if isinstance(v, np.generic) else v)
            rem //= card
        result.groups[tuple(key)] = group_states(gidx)
    return result


def selection_block(ctx: QueryContext, block: Block) -> SegmentResult:
    n = _block_rows(block)
    out_cols = [np.asarray(_eval_or_const(e, block, n)) for e, _ in ctx.select_items]
    rows = [tuple(_py(c[i]) for c in out_cols) for i in range(n)]
    sort_keys: List[Tuple] = []
    if ctx.order_by:
        sort_cols = [np.asarray(_eval_or_const(o.expr, block, n))
                     for o in ctx.order_by]
        sort_keys = [tuple(_py(c[i]) for c in sort_cols) for i in range(n)]
    return SegmentResult("selection", rows=rows, sort_keys=sort_keys,
                         num_docs_scanned=n)


def _eval_or_const(e: Expr, env: Block, n: int):
    out = eval_host(e, env)
    if np.isscalar(out) or not hasattr(out, "__len__"):
        return np.full(n, out, dtype=object)
    return out


def _py(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and np.isnan(v):
        return None
    return v


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

# one long-lived partition pool per process: a pool per stage per query would
# churn thread create/destroy. A partition never submits into this pool, so a
# nested-wait deadlock is impossible.
_STAGE_POOL: Optional[ThreadPoolExecutor] = None
_STAGE_POOL_LOCK = threading.Lock()


def _stage_pool() -> ThreadPoolExecutor:
    global _STAGE_POOL
    with _STAGE_POOL_LOCK:  # an unsynchronized check-then-set would orphan a pool
        if _STAGE_POOL is None:
            _STAGE_POOL = ThreadPoolExecutor(max_workers=8,
                                             thread_name_prefix="stage-part")
        return _STAGE_POOL


# a stage runner executes ONE partition's join (+ optional partial GROUP BY):
# the default is the local run_join_stage; the broker's funnel path passes a
# round-robin dispatch to server workers (reference: intermediate-stage
# workers receiving partitioned blocks, AggregateOperator in partial mode)
StageRunner = Callable[[JoinSpec, Block, Block, Optional["AggStageSpec"]], Any]


@dataclass
class AggStageSpec:
    """The partition-side partial-aggregation stage description (reference:
    AggregateOperator in partial mode). Duck-types the QueryContext fields
    `aggregate_block` reads, so one function serves the local and the
    remote stage."""

    distinct: bool
    group_by: List[Expr]
    select_items: List[Tuple[Expr, Optional[str]]]
    aggregations: List[Function]


def agg_spec_from_ctx(ctx: QueryContext) -> AggStageSpec:
    return AggStageSpec(distinct=ctx.distinct, group_by=list(ctx.group_by),
                        select_items=list(ctx.select_items),
                        aggregations=list(ctx.aggregations))


def _parse_expr(txt: str) -> Expr:
    return parse_query(f"SELECT {txt} FROM __t").select[0][0]


def agg_spec_to_json(spec: Optional[AggStageSpec]) -> Optional[Dict[str, Any]]:
    """Exprs travel as SQL text: qualified identifiers (a.x) round-trip
    through to_sql and the parser, so SQL is the wire form of stage plans."""
    if spec is None:
        return None
    return {"distinct": spec.distinct,
            "groupBy": [to_sql(e) for e in spec.group_by],
            "selectItems": [to_sql(e) for e, _ in spec.select_items],
            "aggs": [to_sql(f) for f in spec.aggregations]}


def agg_spec_from_json(d: Optional[Dict[str, Any]]) -> Optional[AggStageSpec]:
    if d is None:
        return None
    return AggStageSpec(distinct=bool(d["distinct"]),
                        group_by=[_parse_expr(t) for t in d["groupBy"]],
                        select_items=[(_parse_expr(t), None) for t in d["selectItems"]],
                        aggregations=[_parse_expr(t) for t in d["aggs"]])


def spec_to_json(spec: JoinSpec) -> Dict[str, Any]:
    """JoinSpec -> wire-safe dict (the residual rides as SQL text)."""
    return {"rightAlias": spec.right_alias, "joinType": spec.join_type,
            "leftKeys": list(spec.left_keys), "rightKeys": list(spec.right_keys),
            "residual": to_sql(spec.residual) if spec.residual is not None else None}


def spec_from_json(d: Dict[str, Any]) -> JoinSpec:
    residual = None
    if d.get("residual"):
        residual = parse_query(f"SELECT * FROM t WHERE {d['residual']}").where
    return JoinSpec(right_alias=d["rightAlias"], join_type=d["joinType"],
                    left_keys=list(d["leftKeys"]), right_keys=list(d["rightKeys"]),
                    residual=residual)


def run_join_stage(spec: JoinSpec, left: Block, right: Block,
                   agg: Optional[AggStageSpec] = None,
                   lcodes: Optional[np.ndarray] = None,
                   rcodes: Optional[np.ndarray] = None, device=None):
    """One partition's full stage work: hash join, then (when this is the
    final stage of an aggregation query) the PARTIAL GROUP BY, so the heavy
    aggregation runs where the joined rows already are and only mergeable
    group partials come back (reference: the v2 engine's worker-side
    AggregateOperator before the final exchange). Records the two steps'
    host times under STAGE_JOIN_MS and STAGE_AGGREGATE_MS."""
    t0 = time.perf_counter()
    out = hash_join(left, right, spec, lcodes=lcodes, rcodes=rcodes, device=device)
    t1 = time.perf_counter()
    qstats.record(STAGE_JOIN_MS, (t1 - t0) * 1000)
    if agg is None:
        return out
    partial = aggregate_block(agg, [make_agg(f) for f in agg.aggregations], out)
    qstats.record(STAGE_AGGREGATE_MS, (time.perf_counter() - t1) * 1000)
    return partial


# ---------------------------------------------------------------------------
# join exchange: staged key codes, skew-aware partitioning, broadcast
# ---------------------------------------------------------------------------

@dataclass
class JoinInput:
    """A join-exchange partition: the rows plus their 64-bit stable key codes,
    computed ONCE at the sender and handed through the mailbox by reference,
    so the receiving join stage never re-hashes the keys. A frame that came
    over the wire carries no codes (None): the stage re-hashes it."""

    block: Block
    codes: Optional[np.ndarray] = None


def _concat_join_inputs(items: List[Any]) -> Tuple[Block, Optional[np.ndarray]]:
    """Merge a mailbox's received parts (JoinInputs or plain blocks); the key
    codes survive only when every part carried them."""
    blocks = [it.block if isinstance(it, JoinInput) else it for it in items]
    codes = [it.codes if isinstance(it, JoinInput) else None for it in items]
    blk = _concat_blocks(blocks)
    if codes and all(c is not None for c in codes):
        return blk, np.concatenate(codes)
    return blk, None


def _block_nbytes(block: Block) -> int:
    """Exchange-bytes estimate: numpy buffer bytes, object cells at a pointer
    plus small-payload estimate (strings dominate; exactness doesn't matter,
    the number feeds the broadcast-vs-partitioned chooser and stats)."""
    total = 0
    for v in block.values():
        total += int(v.nbytes) if v.dtype != object else len(v) * 24
    return total


#: probe-hash bucket share (percent) above which a bucket counts as HOT:
#: its build rows replicate to every partition and its probe rows salt
#: round-robin (JSPIM-style skew key splitting). Uniform share is
#: 100/256 ≈ 0.4%, so 5% is a ~13x concentration.
JOIN_SKEW_HOT_BUCKET_PCT = 5.0

#: join types whose BUILD side may be replicated (broadcast or hot-key
#: replication) without duplicating output: the build side contributes no
#: unmatched rows of its own
_BUILD_REPLICABLE = ("inner", "left", "semi", "anti")

_SKEW_BUCKETS = 256


def _partition_join_sides(left: Block, lcodes: np.ndarray, right: Block,
                          rcodes: np.ndarray, p: int, how: str
                          ) -> Tuple[List[JoinInput], List[JoinInput], float]:
    """Hash-partition both sides of one join stage. When the probe-hash
    histogram shows hot buckets and the join shape permits replication, hot
    probe rows are salted round-robin across partitions and the matching hot
    build rows replicated to every partition: a zipf key no longer pins the
    whole stage on one partition. Returns (probe_parts, build_parts,
    skew_pct).

    Buckets and partitions come from the codes mixed by `fold_codes32`: a
    numeric key's stable hash is its float64 bits, whose low bits are zero
    for every integer below 2^45, so the raw codes' low bits would put every
    integer key in bucket 0 and partition 0."""
    n = len(lcodes)
    lmix, rmix = jk.fold_codes32(lcodes), jk.fold_codes32(rcodes)
    bucket = (lmix & np.uint32(_SKEW_BUCKETS - 1)).astype(np.int64)
    hist = np.bincount(bucket, minlength=_SKEW_BUCKETS) if n else \
        np.zeros(_SKEW_BUCKETS, dtype=np.int64)
    skew_pct = 0.0
    if n:
        top = float(hist.max()) / n
        uniform = 1.0 / _SKEW_BUCKETS
        skew_pct = max(0.0, 100.0 * (top - uniform) / (1.0 - uniform))

    lpid = (lmix % np.uint32(p)).astype(np.int64)
    rpid = (rmix % np.uint32(p)).astype(np.int64)
    hot_buckets = np.zeros(_SKEW_BUCKETS, dtype=bool)
    if (p > 1 and n and how in _BUILD_REPLICABLE
            and skew_pct > JOIN_SKEW_HOT_BUCKET_PCT):
        hot_buckets = hist > (n * JOIN_SKEW_HOT_BUCKET_PCT / 100.0)
        hot_l = np.nonzero(hot_buckets[bucket])[0]
        # salt: hot probe rows deal round-robin instead of hashing
        lpid[hot_l] = np.arange(len(hot_l)) % p

    rbucket = (rmix & np.uint32(_SKEW_BUCKETS - 1)).astype(np.int64)
    rhot = hot_buckets[rbucket]
    lparts, rparts = [], []
    for i in range(p):
        lidx = np.nonzero(lpid == i)[0]
        lparts.append(JoinInput(_take(left, lidx), lcodes[lidx]))
        # a hot-bucket build row must be visible to every partition its
        # salted probe rows may have landed on
        ridx = np.nonzero((rpid == i) | rhot)[0]
        rparts.append(JoinInput(_take(right, ridx), rcodes[ridx]))
    return lparts, rparts, skew_pct


def _broadcast_join_sides(left: Block, lcodes: np.ndarray, right: Block,
                          rcodes: np.ndarray, p: int
                          ) -> Tuple[List[JoinInput], List[JoinInput]]:
    """Broadcast exchange: the (small) build side replicates to every
    partition, the probe side splits into contiguous strips WITHOUT hashing:
    no key movement at all on the big side, and inherently skew-immune."""
    n = len(lcodes)
    cuts = np.array_split(np.arange(n), p)
    lparts = [JoinInput(_take(left, ix), lcodes[ix]) for ix in cuts]
    rparts = [JoinInput(right, rcodes) for _ in range(p)]
    return lparts, rparts


#: max distinct build keys that derive an IN-list probe filter (dictionary
#: pruning consumes membership lists; ranges cover the rest)
_DERIVED_IN_MAX = 64


def _derive_probe_filter(right: Block, spec: JoinSpec,
                         base_alias: str) -> Optional[Expr]:
    """Build-key pre-prune: once the build side is in hand, its key min/max
    (or, under `_DERIVED_IN_MAX` distinct values, the exact membership list)
    becomes a derived bare-name filter on the probe-side leaf scan, so the
    segment planner skips probe segments with no possible match. Only sound
    when probe rows failing the key filter can't reach the output
    (inner/semi/right), and only when the first join key belongs to the base
    alias."""
    if spec.join_type not in ("inner", "semi", "right"):
        return None
    alias, _, col = spec.left_keys[0].partition(".")
    if alias != base_alias or not col:
        return None
    rarr = right[spec.right_keys[0]]
    if len(rarr) == 0:
        return None  # empty build: the join itself resolves instantly
    if rarr.dtype == object:
        vals = {v for v in rarr if isinstance(v, str)}
        if 0 < len(vals) <= _DERIVED_IN_MAX and all(
                isinstance(v, str) for v in rarr if v is not None):
            return Function("in", (Identifier(col),
                                   *(Literal(v) for v in sorted(vals))))
        return None
    live = rarr[~np.isnan(rarr)] if rarr.dtype.kind == "f" else rarr
    if len(live) == 0 or (rarr.dtype.kind == "f"
                          and not np.isfinite(live).all()):
        return None
    uniq = np.unique(live)
    if len(uniq) <= _DERIVED_IN_MAX:
        return Function("in", (Identifier(col),
                               *(Literal(v.item()) for v in uniq)))
    return Function("and", (
        Function("gte", (Identifier(col), Literal(uniq[0].item()))),
        Function("lte", (Identifier(col), Literal(uniq[-1].item())))))


def _scan_alias(plan: MultistagePlan, alias: str, scan_fn: ScanFn,
                derived: Optional[Expr] = None) -> Block:
    scan = plan.scans[alias]
    filt = scan.filter
    if derived is not None:
        filt = _and_all([f for f in (filt, derived) if f is not None])
    raw = scan_fn(scan.table, scan.columns, filt, derived)
    return {f"{alias}.{c}": np.asarray(v) for c, v in raw.items()}


def execute_multistage(sql_or_plan, scan_fn: ScanFn, schema_for=None,
                       num_partitions: int = DEFAULT_PARTITIONS,
                       stage_runner: Optional[StageRunner] = None,
                       broadcast_max_bytes: Optional[int] = None) -> ResultTable:
    """Run a join query (SQL, a parsed statement or a MultistagePlan): leaf
    scans -> hash exchange -> per-partition joins -> aggregate/selection ->
    reduce. The `num_partitions` partitions run concurrently on the stage
    pool, each joining on the scan's device (`scan_fn.device`, which
    `make_segment_scan` sets: CUDA unless the caller names another), or
    through `stage_runner(spec, left, right, agg)` when one is given (a
    partition with nothing to join on one side still runs here).

    Exchange strategy per stage is stats-driven (`choose_join_strategy`):
    a build side under `broadcast_max_bytes` (BROADCAST_MAX_BYTES_DEFAULT
    when None) replicates to every partition (probe side splits without
    hashing), larger builds hash-partition both sides with hot-key salting.
    Build sides scan FIRST so their key bounds pre-prune the probe-side leaf
    scan.

    The result's stats carry `joinStrategy`, the recorded join keys, and
    `phaseTimesMs`: host wall ms of `plan`, `scan` (leaf scans), `exchange`
    (hashing and partitioning), `stages` (the partition pool), `reduce`, and,
    summed over the partition threads, `join` (hash joins, device programs
    included) and `partialAggregate`."""
    t0 = time.perf_counter()
    dev = scan_fn.device
    plan = (sql_or_plan if isinstance(sql_or_plan, MultistagePlan)
            else plan_multistage(sql_or_plan, schema_for))
    ctx = plan.ctx
    aggs = [make_agg(f) for f in ctx.aggregations]
    group_exprs = ([e for e, _ in ctx.select_items] if ctx.distinct
                   else list(ctx.group_by))
    mailboxes = MailboxService()
    outer = qstats.current_stats()
    st = qstats.ExecutionStats()
    strategies: List[str] = []
    phases = {"plan": time.perf_counter() - t0, "scan": 0.0, "exchange": 0.0,
              "stages": 0.0}

    with qstats.collect_stats(st):
        # -- leaf scans: build sides first, so the first join's build-key
        # bounds flow into the probe-side scan as a derived filter ---------
        t0 = time.perf_counter()
        blocks: Dict[str, Block] = {}
        for spec in plan.joins:
            blocks[spec.right_alias] = _scan_alias(plan, spec.right_alias,
                                                   scan_fn)
        derived = _derive_probe_filter(blocks[plan.joins[0].right_alias],
                                       plan.joins[0], plan.base_alias) \
            if plan.joins else None
        blocks[plan.base_alias] = _scan_alias(plan, plan.base_alias, scan_fn,
                                              derived)
        phases["scan"] = time.perf_counter() - t0

        # -- join pipeline: exchange + per-partition joins -----------------
        current = blocks[plan.base_alias]
        worker_partials: Optional[List[SegmentResult]] = None
        for si, spec in enumerate(plan.joins):
            t0 = time.perf_counter()
            right = blocks[spec.right_alias]
            stage = f"join{si}"
            # the LAST join stage of an aggregation query carries the partial
            # GROUP BY with it: each partition aggregates where the joined
            # rows already live (post_filter needs the raw joined rows, so it
            # keeps the block path)
            agg_stage = (agg_spec_from_ctx(ctx)
                         if si == len(plan.joins) - 1
                         and plan.post_filter is None
                         and (ctx.is_aggregation_query or ctx.distinct)
                         else None)
            lcodes = stable_hash_codes(current, spec.left_keys)
            rcodes = stable_hash_codes(right, spec.right_keys)
            build_bytes = _block_nbytes(right)
            strategy = choose_join_strategy(spec.join_type, build_bytes,
                                            broadcast_max_bytes)
            strategies.append(strategy)
            if strategy == "broadcast":
                lparts, rparts = _broadcast_join_sides(
                    current, lcodes, right, rcodes, num_partitions)
                shuffled = (_block_nbytes(current)
                            + build_bytes * num_partitions)
            else:
                lparts, rparts, skew_pct = _partition_join_sides(
                    current, lcodes, right, rcodes, num_partitions,
                    spec.join_type)
                qstats.record_max(qstats.JOIN_SKEW_PCT, skew_pct)
                shuffled = (sum(_block_nbytes(jp.block) for jp in lparts)
                            + sum(_block_nbytes(jp.block) for jp in rparts))
            qstats.record(qstats.JOIN_SHUFFLE_BYTES, shuffled)
            for p, jp in enumerate(lparts):
                mailboxes.send(f"{stage}.L", p, jp)
            for p, jp in enumerate(rparts):
                mailboxes.send(f"{stage}.R", p, jp)
            t1 = time.perf_counter()
            phases["exchange"] += t1 - t0

            def one_partition(p: int, stage=stage, spec=spec, agg_stage=agg_stage):
                with qstats.collect_stats(st):  # pool threads: same query record
                    lp, lc = _concat_join_inputs(mailboxes.receive(f"{stage}.L", p))
                    rp, rc = _concat_join_inputs(mailboxes.receive(f"{stage}.R", p))
                    # an empty (or inner-join one-sided empty) partition is
                    # O(columns) here but a whole round trip through a remote
                    # runner
                    trivial = ((_block_rows(lp) == 0 and _block_rows(rp) == 0)
                               or (spec.join_type in ("inner", "semi")
                                   and (_block_rows(lp) == 0 or _block_rows(rp) == 0)))
                    if stage_runner is None or trivial:
                        return run_join_stage(spec, lp, rp, agg_stage,
                                              lcodes=lc, rcodes=rc, device=dev)
                    return stage_runner(spec, lp, rp, agg_stage)
            parts = list(_stage_pool().map(one_partition, range(num_partitions)))
            phases["stages"] += time.perf_counter() - t1
            if agg_stage is not None:
                worker_partials = parts
                break
            current = _concat_blocks(parts)

        t0 = time.perf_counter()
        if worker_partials is not None:
            merged = merge_segment_results(worker_partials, aggs)
            result = reduce_to_result(ctx, merged, aggs, group_exprs)
            result.stats["workerAggregation"] = True
        else:
            if plan.post_filter is not None and _block_rows(current):
                mask = _null_safe_mask(plan.post_filter, current)
                current = _take(current, np.nonzero(mask)[0])
            # -- final stage: aggregate or select, then reduce -------------
            if ctx.is_aggregation_query or ctx.distinct:
                partial = aggregate_block(ctx, aggs, current)
                merged = merge_segment_results([partial], aggs)
            else:
                merged = selection_block(ctx, current)
            result = reduce_to_result(ctx, merged, aggs, group_exprs)
        phases["reduce"] = time.perf_counter() - t0

    result.stats[qstats.MULTISTAGE] = True
    if strategies:
        result.stats[qstats.JOIN_STRATEGY] = (strategies[0] if len(strategies) == 1
                                        else ",".join(strategies))
    for key, val in st.to_public_dict().items():
        if key.startswith("join") or key == qstats.NUM_SEGMENTS_PRUNED_BY_JOIN_KEY:
            result.stats[key] = val
    phases["join"] = st.counters.get(STAGE_JOIN_MS, 0.0) / 1000
    phases["partialAggregate"] = st.counters.get(STAGE_AGGREGATE_MS, 0.0) / 1000
    result.stats["phaseTimesMs"] = {k: round(v * 1000, 3) for k, v in phases.items()}
    if outer is not None:
        outer.merge(st)
    return result


def make_segment_scan(tables: Dict[str, List], device=None) -> ScanFn:
    """Leaf-scan provider over in-memory segment lists, on `device` (CUDA
    unless the caller names another): the filter as the single-stage
    executor's selection mask (on the device, or the host filter mask where
    the plan says the device cannot evaluate it), then only the needed
    columns of the matching rows decoded on the host (reference: leaf stages
    compile to `ServerQueryRequest` on the v1 engine).

    Takes the `derived` build-key filter besides the scan's own: segments whose metadata folds the derived filter to constant
    false are skipped AND attributed to `numSegmentsPrunedByJoinKey`: the
    join-key pre-prune made the difference, not the query's own filter. The
    scan's `device` attribute names where it runs."""
    executor = ServerQueryExecutor(device)

    def _ctx(table: str, columns: List[str], filt: Optional[Expr]
             ) -> QueryContext:
        return QueryContext(
            table=table,
            select_items=[(Identifier(c), c) for c in columns],
            filter=filt, group_by=[], aggregations=[], having=None,
            order_by=[], limit=1 << 62, offset=0, distinct=False)

    def scan(table: str, columns: List[str], filt: Optional[Expr],
             derived: Optional[Expr]) -> Block:
        segs = tables.get(table)
        if segs is None:
            raise KeyError(f"unknown table {table!r}")
        out: Dict[str, List[np.ndarray]] = {c: [] for c in columns}
        for seg in segs:
            plan = plan_segment(_ctx(table, columns, filt), seg)
            if plan.kind == "empty":
                if derived is not None and plan_segment(
                        _ctx(table, columns, derived), seg).kind == "empty":
                    qstats.record(qstats.NUM_SEGMENTS_PRUNED_BY_JOIN_KEY)
                    qstats.record(qstats.SCAN_ROWS_AVOIDED, seg.num_docs)
                continue
            mask = executor._selection_mask(plan)
            idx = np.nonzero(mask[:seg.num_docs])[0]
            for c in columns:
                out[c].append(_take_rows(seg.column(c), idx))
        return {c: (np.concatenate([a.astype(object) for a in arrs])
                    if arrs and any(a.dtype == object for a in arrs)
                    else np.concatenate(arrs) if arrs else np.empty(0))
                for c, arrs in out.items()}

    scan.device = executor.device
    return scan
