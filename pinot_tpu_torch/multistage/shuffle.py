"""Server-to-server streaming mailbox shuffle: the distributed multistage data plane.

A copy of `pinot_tpu/multistage/shuffle.py` (the analog of the reference's
mailbox exchange: `MailboxSendOperator` / `MailboxReceiveOperator` over
`GrpcMailboxService`, `mailbox.proto`): leaf stages hash-partition their scan
output ON THE SERVERS and stream partition frames straight to the assigned
stage worker's mailbox. The broker plans, assigns workers and receives only
final-stage partials, so a join (or a high-cardinality GROUP BY) whose
intermediate data exceeds the broker's memory still runs.

Transport: chunked HTTP both ways (`POST /mailbox/{query}/{mailbox}` with a
chunked request body of length-prefixed wire frames, `wire.py`). Each mailbox
buffers at most WINDOW_FRAMES frames: when a worker falls behind, the
receiving handler thread blocks on the full queue, TCP flow control pushes
back to the sender's socket and the sender's partitioner stalls, about
WINDOW_FRAMES x FRAME_ROWS rows in flight a mailbox.

Routing is the JAX package's, byte for byte: join rows by `stable_hash_codes`
(`runtime.py`), group keys by `stable_hash_key`, never Python's per-process
`hash()`, so every process sends a key to the same partition.

Device-routed legs: a server registers its own URL (`register_local_endpoint`)
and a leg whose target is this process skips the codec and the HTTP hop: the
receiver gets the sender's partition object (a `JoinInput` keeps its key
codes, a `DensePartial` its arrays). Join stages run on the worker's device
(`run_join_stage_task(task, device)`, the device join of `runtime.py`).

Failure: any leaf or worker error cancels the query's mailboxes everywhere
(`DELETE /mailbox/{query}`), which wakes blocked senders and consumers; the
broker raises one clean error instead of hanging. A cancelled query leaves a
tombstone, and idle mailboxes go after MAILBOX_TTL_S.
"""

from __future__ import annotations

import queue
import struct
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..cluster.admission import UNBOUNDED_LIMIT
from ..cluster.http_service import HttpError, http_call, http_stream
from ..cluster.wire import (decode_segment_result, decode_value, encode_segment_result,
                            encode_value)
from ..query import stats as qstats
from ..query.aggregates import make_agg
from ..query.reduce import (SegmentResult, _eval_result, _object_array, _sort_key,
                            merge_segment_results, reduce_to_result)
from ..sql.ast import Expr, Function, OrderByItem, _sql_ident, to_sql
from ..sql.parser import parse_query
from ..utils.metrics import get_registry
from .planner import choose_join_strategy, plan_multistage
from .runtime import (STAGE_AGGREGATE_MS, STAGE_JOIN_MS, Block, JoinInput, _block_nbytes,
                      _block_rows, _concat_join_inputs, _null_safe_mask, _take,
                      aggregate_block, hash_join, selection_block, spec_from_json,
                      spec_to_json, stable_hash_codes, stable_hash_key)

# rows per streamed block frame and frames buffered per mailbox: together they
# bound each mailbox's in-flight memory (about WINDOW_FRAMES * FRAME_ROWS rows)
FRAME_ROWS = 32768
WINDOW_FRAMES = 8
# group-key partials per streamed partial frame (the leaf agg exchange)
FRAME_GROUPS = 8192
# how long a consumer waits for the next frame before declaring the sender dead
MAILBOX_TIMEOUT_S = 120.0
# cancelled-query tombstone and idle-mailbox TTL
MAILBOX_TTL_S = 600.0


class MailboxCancelled(Exception):
    """The query owning this mailbox was cancelled (a worker died, or the
    broker gave up)."""


class P2PUnavailable(Exception):
    """The peer-to-peer shuffle cannot run (a routed server has no HTTP
    endpoint, or no leaf routes): the broker falls back to the funnel path."""


# ---------------------------------------------------------------------------
# partition routing
# ---------------------------------------------------------------------------

def partition_groups_stable(result: SegmentResult, p: int) -> List[SegmentResult]:
    """Split a group-by partial's key space into p disjoint partials, by
    `stable_hash_key(key) % p`."""
    if p == 1 and result.dense is not None:
        # the whole key space routes to one worker: the array-form partial
        # survives the exchange whole (the device-routed shuffle's case; the
        # wire carries dense partials, so remote workers keep it too)
        return [result]
    # a hash partition reorders keys arbitrarily, so an array-form partial
    # cannot survive it: the dict form, on the host
    result.materialize_dense()
    outs = [SegmentResult("groups") for _ in range(p)]
    for key, states in result.groups.items():
        outs[stable_hash_key(key) % p].groups[key] = states
    # the scan count once (partition 0), so merged counts stay exact
    if outs:
        outs[0].num_docs_scanned = result.num_docs_scanned
    return outs


def _partition_join_input(block: Block, keys: List[str], p: int, strategy: str,
                          side: str) -> Tuple[List[JoinInput], int]:
    """Split one sender's rows for a join exchange. Partitioned: by the stable
    key codes mod p, identically in every process. Broadcast: the build side
    (R) goes whole to every worker; the probe side (L) splits into strips, no
    hashing. Every part carries its rows' key codes (an in-process delivery
    hands them to the worker by reference; a remote leg ships the block only).
    Returns the parts and the exchanged-bytes estimate."""
    codes = stable_hash_codes(block, keys)
    if strategy == "broadcast":
        if side == "R":
            parts = [JoinInput(block, codes)] * p
        else:
            parts = [JoinInput(_take(block, ix), codes[ix])
                     for ix in np.array_split(np.arange(_block_rows(block)), p)]
    else:
        pid = (codes % np.uint64(p)).astype(np.int64)
        parts = [JoinInput(_take(block, ix), codes[ix])
                 for ix in (np.nonzero(pid == i)[0] for i in range(p))]
    return parts, sum(_block_nbytes(part.block) for part in parts)


def _join_input_frames(part: JoinInput) -> Iterator[dict]:
    """A join partition's remote frames: the key codes stay home (re-hashing
    on the worker is cheaper than shipping 8 bytes a row)."""
    return block_frames(part.block)


# ---------------------------------------------------------------------------
# frame codec (length-prefixed wire values)
# ---------------------------------------------------------------------------

def frame_bytes(obj: Any) -> bytes:
    payload = encode_value(obj)
    return struct.pack(">I", len(payload)) + payload


def read_exact(reader, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = reader.read(remaining)
        if not chunk:
            raise ConnectionError("mailbox stream truncated")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def read_frame(reader) -> Any:
    (n,) = struct.unpack(">I", read_exact(reader, 4))
    return decode_value(read_exact(reader, n))


def block_frames(block: Block, step: int = FRAME_ROWS) -> Iterator[dict]:
    n = _block_rows(block)
    if n == 0:
        # an empty partition still ships ONE empty frame: the receiving join
        # needs the column names and dtypes even when no row hashed its way
        yield {"kind": "block", "block": dict(block)}
        return
    for lo in range(0, n, step):
        yield {"kind": "block", "block": {c: v[lo:lo + step] for c, v in block.items()}}


def partial_frames(result: SegmentResult, step: int = FRAME_GROUPS) -> Iterator[dict]:
    """A group, scalar or selection partial as one or more mergeable partial
    frames."""
    if result.kind == "groups" and len(result.groups) > step:
        keys = list(result.groups.keys())
        for lo in range(0, len(keys), step):
            chunk = SegmentResult("groups")
            if lo == 0:
                chunk.num_docs_scanned = result.num_docs_scanned
            for k in keys[lo:lo + step]:
                chunk.groups[k] = result.groups[k]
            yield {"kind": "partial", "result": encode_segment_result(chunk)}
    elif result.kind == "selection" and len(result.rows) > FRAME_ROWS:
        for lo in range(0, len(result.rows), FRAME_ROWS):
            chunk = SegmentResult("selection")
            if lo == 0:
                chunk.num_docs_scanned = result.num_docs_scanned
            chunk.rows = result.rows[lo:lo + FRAME_ROWS]
            if result.sort_keys:
                chunk.sort_keys = result.sort_keys[lo:lo + FRAME_ROWS]
            yield {"kind": "partial", "result": encode_segment_result(chunk)}
    else:
        yield {"kind": "partial", "result": encode_segment_result(result)}


# ---------------------------------------------------------------------------
# mailbox registry (one a process; receivers push, workers pop)
# ---------------------------------------------------------------------------

class _Mailbox:
    def __init__(self, window: int = WINDOW_FRAMES):
        self.q: "queue.Queue" = queue.Queue(maxsize=window)
        self.cancelled = threading.Event()
        self.created = time.time()
        self.last_active = self.created

    def put(self, item, timeout_s: float = MAILBOX_TIMEOUT_S) -> None:
        deadline = time.time() + timeout_s
        while True:
            if self.cancelled.is_set():
                raise MailboxCancelled("mailbox cancelled")
            try:
                self.q.put(item, timeout=0.2)
                self.last_active = time.time()
                return
            except queue.Full:
                if time.time() > deadline:
                    raise TimeoutError("mailbox backpressure timeout: consumer stalled")

    def get(self, timeout_s: float = MAILBOX_TIMEOUT_S):
        deadline = time.time() + timeout_s
        while True:
            if self.cancelled.is_set():
                raise MailboxCancelled("mailbox cancelled")
            try:
                item = self.q.get(timeout=0.2)
                self.last_active = time.time()
                return item
            except queue.Empty:
                if time.time() > deadline:
                    raise TimeoutError("mailbox receive timeout: sender stalled")


class MailboxRegistry:
    """The process's mailbox fabric keyed (query, mailbox id): a mailbox is
    made on first touch, a cancelled query leaves a tombstone, and a mailbox
    idle past MAILBOX_TTL_S is swept."""

    def __init__(self):
        self._boxes: Dict[Tuple[str, str], _Mailbox] = {}
        self._cancelled: Dict[str, float] = {}   # query -> cancel time
        self._lock = threading.Lock()

    def open(self, qid: str, mid: str) -> _Mailbox:
        with self._lock:
            self._gc_locked()
            if qid in self._cancelled:
                raise MailboxCancelled(f"query {qid} cancelled")
            box = self._boxes.get((qid, mid))
            if box is None:
                box = self._boxes[(qid, mid)] = _Mailbox()
            return box

    def cancel_query(self, qid: str) -> None:
        with self._lock:
            self._cancelled[qid] = time.time()
            for (q, _m), box in self._boxes.items():
                if q == qid:
                    box.cancelled.set()

    def close_query(self, qid: str) -> None:
        """A query's normal end: its mailboxes go, without a tombstone."""
        with self._lock:
            for key in [k for k in self._boxes if k[0] == qid]:
                self._boxes.pop(key)

    def discard(self, qid: str, mid: str) -> None:
        with self._lock:
            self._boxes.pop((qid, mid), None)

    def _gc_locked(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for q, t in list(self._cancelled.items()):
            if now - t > MAILBOX_TTL_S:
                del self._cancelled[q]
        for key, box in list(self._boxes.items()):
            # IDLE time, not age: a long query whose frames still flow is
            # never reaped mid-flight
            if now - box.last_active > MAILBOX_TTL_S:
                box.cancelled.set()
                del self._boxes[key]


REGISTRY = MailboxRegistry()


# ---------------------------------------------------------------------------
# device-routed legs: a target that is this process's own mailbox endpoint
# takes the partition object straight into the local registry
# ---------------------------------------------------------------------------

_LOCAL_ENDPOINTS: Dict[str, int] = {}   # url -> refcount
_LOCAL_LOCK = threading.Lock()


def register_local_endpoint(url: str) -> None:
    u = url.rstrip("/")
    with _LOCAL_LOCK:
        _LOCAL_ENDPOINTS[u] = _LOCAL_ENDPOINTS.get(u, 0) + 1


def unregister_local_endpoint(url: str) -> None:
    u = url.rstrip("/")
    with _LOCAL_LOCK:
        n = _LOCAL_ENDPOINTS.get(u, 0) - 1
        if n > 0:
            _LOCAL_ENDPOINTS[u] = n
        else:
            _LOCAL_ENDPOINTS.pop(u, None)


def is_local_endpoint(url: str) -> bool:
    with _LOCAL_LOCK:
        return url.rstrip("/") in _LOCAL_ENDPOINTS


def _deliver_local(qid: str, mid: str, part: Any, kind: str, sender_id: str) -> None:
    """In-process delivery: what a remote sender streams as frames becomes
    two queue puts (the payload and the sender's EOS), so one mailbox drains
    local and remote senders alike."""
    box = REGISTRY.open(qid, mid)
    box.put((kind, part))
    box.put(("eos", sender_id))
    get_registry().counter("pinot_server_mailbox_local_sends").inc()


def consume_mailbox(qid: str, mid: str, expected_senders: int,
                    timeout_s: float = MAILBOX_TIMEOUT_S
                    ) -> Tuple[List[Any], List[SegmentResult]]:
    """Pop frames until every expected sender's EOS arrived: (blocks or
    JoinInputs, partials)."""
    box = REGISTRY.open(qid, mid)
    eos: set = set()
    blocks: List[Any] = []
    partials: List[SegmentResult] = []
    try:
        while len(eos) < expected_senders:
            kind, payload = box.get(timeout_s)
            if kind == "eos":
                eos.add(payload)
            elif kind == "block":
                blocks.append(payload)
            else:
                partials.append(payload)
    except BaseException:
        # the consumer gives up: cancel the box IN PLACE (senders holding it
        # wake now) and leave it registered, so that a later DELETE still
        # reaches it; discarding it would strand blocked senders
        box.cancelled.set()
        raise
    REGISTRY.discard(qid, mid)
    return blocks, partials


# ---------------------------------------------------------------------------
# sender (a chunked POST of frames to a peer's mailbox)
# ---------------------------------------------------------------------------

def send_to_mailbox(url: str, qid: str, mid: str, frames: Iterable[dict], sender_id: str,
                    timeout_s: float = MAILBOX_TIMEOUT_S, token: Optional[str] = None) -> None:
    def gen():
        for fr in frames:
            yield frame_bytes(fr)
        yield frame_bytes({"kind": "eos", "sender": sender_id})

    with http_stream("POST", f"{url}/mailbox/{qid}/{mid}", gen(), timeout=timeout_s,
                     token=token) as resp:
        resp.read()


def _send_partitions(targets: List[str], qid: str, stage: str, side: str, parts: List[Any],
                     sender_id: str, framer: Callable[[Any], Iterable[dict]], kind: str,
                     local_ok: bool = True, timeout_s: float = MAILBOX_TIMEOUT_S) -> None:
    """Every partition to its worker, a few at once. EVERY partition sends
    (an empty one its EOS only): a worker counts EOS from every expected
    sender. A target that is this process's own endpoint takes the part
    directly when `local_ok` (device routing); any other streams
    `framer(part)`'s frames. Locality is per target, so a mixed worker set
    short-circuits exactly its local legs."""
    p = len(targets)

    def one(i: int) -> None:
        mid = f"{stage}.{side}.{i}"
        if local_ok and is_local_endpoint(targets[i]):
            _deliver_local(qid, mid, parts[i], kind, sender_id)
        else:
            send_to_mailbox(targets[i], qid, mid, framer(parts[i]), sender_id, timeout_s)

    if p == 1:
        one(0)
        return
    with ThreadPoolExecutor(max_workers=min(4, p), thread_name_prefix="mailbox-send") as pool:
        futs = [pool.submit(one, i) for i in range(p)]
        errs = [f.exception() for f in futs]
    for e in errs:
        if e is not None:
            raise e


# ---------------------------------------------------------------------------
# stage context (the final stage's plan, with SQL as the wire form)
# ---------------------------------------------------------------------------

@dataclass
class StageCtx:
    """Duck-types the QueryContext fields the stage operators read
    (aggregate_block, selection_block, trim_group_result)."""

    select_items: List[Tuple[Expr, Optional[str]]]
    group_by: List[Expr]
    aggregations: List[Function]
    distinct: bool = False
    having: Optional[Expr] = None
    order_by: List[OrderByItem] = field(default_factory=list)
    limit: int = UNBOUNDED_LIMIT
    offset: int = 0

    @property
    def is_aggregation_query(self) -> bool:
        return bool(self.aggregations) or bool(self.group_by)


def stage_ctx_to_json(ctx) -> Dict[str, Any]:
    return {
        "selectItems": [to_sql(e) for e, _ in ctx.select_items],
        "groupBy": [to_sql(e) for e in ctx.group_by],
        "aggs": [to_sql(f) for f in ctx.aggregations],
        "distinct": bool(ctx.distinct),
        "having": to_sql(ctx.having) if ctx.having is not None else None,
        "orderBy": [{"e": to_sql(o.expr), "d": o.desc, "nl": o.nulls_last}
                    for o in ctx.order_by],
        "limit": int(ctx.limit if ctx.limit is not None else UNBOUNDED_LIMIT),
        "offset": int(ctx.offset or 0),
    }


def _parse_expr(txt: str) -> Expr:
    return parse_query(f"SELECT {txt} FROM __t").select[0][0]


def stage_ctx_from_json(d: Dict[str, Any]) -> StageCtx:
    return StageCtx(
        select_items=[(_parse_expr(t), None) for t in d["selectItems"]],
        group_by=[_parse_expr(t) for t in d["groupBy"]],
        aggregations=[_parse_expr(t) for t in d["aggs"]],
        distinct=bool(d["distinct"]),
        having=_parse_expr(d["having"]) if d.get("having") else None,
        order_by=[OrderByItem(_parse_expr(o["e"]), o["d"], o.get("nl"))
                  for o in d.get("orderBy", [])],
        limit=int(d.get("limit", UNBOUNDED_LIMIT)),
        offset=int(d.get("offset", 0)))


def trim_group_result(ctx, merged: SegmentResult, aggs) -> SegmentResult:
    """The worker's trim of a disjoint key range: HAVING (group-local, so
    safe here) and the top (limit + offset) groups by the final ordering; the
    global top-k is within the union of the workers' because their key
    ranges are disjoint (reference: the v2 engine's intermediate GroupBy
    trim). States stay unfinalized, so the partial still merges."""
    if merged.kind != "groups":
        return merged
    limit = ctx.limit if ctx.limit is not None else UNBOUNDED_LIMIT
    k = min(limit + (ctx.offset or 0), UNBOUNDED_LIMIT)
    if merged.dense is not None:
        occupied = int((merged.dense.counts > 0).sum())
        if ctx.having is None and (k >= UNBOUNDED_LIMIT or occupied <= k):
            return merged   # nothing to trim: the array form stays
        merged.materialize_dense(aggs)
    needs_having = ctx.having is not None
    needs_trim = k < UNBOUNDED_LIMIT and len(merged.groups) > k
    if not needs_having and not needs_trim:
        return merged
    group_exprs = [e for e, _ in ctx.select_items] if ctx.distinct else list(ctx.group_by)
    keys = list(merged.groups.keys())
    n = len(keys)
    env: Dict[str, np.ndarray] = {}
    for j, g in enumerate(group_exprs):
        env[repr(g)] = np.array([key[j] for key in keys], dtype=object)
    for i, call in enumerate(ctx.aggregations):
        env[repr(call)] = _object_array([aggs[i].finalize(merged.groups[key][i])
                                         for key in keys])
    idx = np.arange(n)
    if needs_having:
        keep = np.asarray(_eval_result(ctx.having, env, n), dtype=bool)
        idx = idx[keep]
    if k < UNBOUNDED_LIMIT and len(idx) > k:
        if ctx.order_by:
            cols = [np.asarray(_eval_result(o.expr, env, n), dtype=object)
                    for o in ctx.order_by]
            idx = sorted(idx, key=lambda i: _sort_key([c[i] for c in cols], ctx.order_by))[:k]
        else:
            idx = idx[:k]
    out = SegmentResult("groups", num_docs_scanned=merged.num_docs_scanned)
    for i in idx:
        out.groups[keys[i]] = merged.groups[keys[i]]
    return out


def _trim_selection(ctx, result: SegmentResult) -> SegmentResult:
    """A worker's selection trimmed to limit + offset rows (sorted when
    ordered)."""
    limit = ctx.limit if ctx.limit is not None else UNBOUNDED_LIMIT
    k = limit + (ctx.offset or 0)
    if k >= UNBOUNDED_LIMIT or len(result.rows) <= k:
        return result
    out = SegmentResult("selection", num_docs_scanned=result.num_docs_scanned)
    if result.sort_keys:
        order = sorted(range(len(result.rows)),
                       key=lambda i: _sort_key(list(result.sort_keys[i]), ctx.order_by))[:k]
        out.rows = [result.rows[i] for i in order]
        out.sort_keys = [result.sort_keys[i] for i in order]
        return out
    out.rows = result.rows[:k]
    return out


# ---------------------------------------------------------------------------
# the servers' task runners (the ServerService routes call them)
# ---------------------------------------------------------------------------

def _check_leaf_coverage(task: Dict[str, Any], res: SegmentResult) -> None:
    """A replica mid segment-transition can skip a routed segment; the
    scatter path retries it elsewhere, but a leaf has already streamed its
    frames: the only sound answer is to fail the query loudly."""
    if res.served is None:
        return
    missing = set(task["segments"]) - set(res.served)
    if missing:
        raise RuntimeError(f"leaf scan did not cover routed segments {sorted(missing)} "
                           f"(segment transition in flight): retry the query")


def run_leaf_join_task(server, task: Dict[str, Any]) -> Dict[str, Any]:
    """Scan this server's segments (its `execute_partial`, on its device),
    hash-partition on the join keys and stream the partitions to the stage
    workers (reference: a leaf stage's MailboxSendOperator over the v1 leaf
    executor). Returns rows, shuffled bytes and the task's ms."""
    t0 = time.perf_counter()
    alias = task["alias"]
    columns = list(task["columns"])
    res = server.execute_partial(task["table"], task["sql"], task["segments"],
                                 time_filter=task.get("timeFilter"))
    _check_leaf_coverage(task, res)
    t_scan = time.perf_counter()
    schema = server.catalog.schema_for_table(task["table"])
    n = len(res.rows)
    block: Block = {}
    for j, c in enumerate(columns):
        vals = [r[j] for r in res.rows]
        dt = schema.field_spec(c).data_type
        block[f"{alias}.{c}"] = (np.asarray(vals, dtype=dt.numpy_dtype) if dt.is_numeric
                                 else np.asarray(vals, dtype=object))
    t_cols = time.perf_counter()
    parts, shuffled = _partition_join_input(block, list(task["keys"]),
                                            int(task["numPartitions"]),
                                            task.get("strategy", "partitioned"), task["side"])
    _send_partitions(list(task["targets"]), task["queryId"], task["stage"], task["side"],
                     parts, task["senderId"], _join_input_frames, "block",
                     local_ok=bool(task.get("deviceRoute", True)))
    t1 = time.perf_counter()
    return {"rows": n, "shuffleBytes": int(shuffled), "ms": (t1 - t0) * 1000,
            "scanMs": (t_scan - t0) * 1000, "columnsMs": (t_cols - t_scan) * 1000,
            "sendMs": (t1 - t_cols) * 1000}


def run_leaf_agg_task(server, task: Dict[str, Any]) -> Dict[str, Any]:
    """A distributed GROUP BY's leaf: the server's own partial aggregation,
    its groups hash-partitioned by key and streamed to the merge workers
    (reference: the agg exchange PinotAggregateExchangeNodeInsertRule
    inserts). Returns the groups, the task's ms and the partition's ms."""
    t0 = time.perf_counter()
    res = server.execute_partial(task["table"], task["sql"], task["segments"],
                                 time_filter=task.get("timeFilter"))
    _check_leaf_coverage(task, res)
    if res.kind != "groups":
        raise ValueError(f"leaf agg task expects a group-by, got {res.kind}")
    groups = len(res.groups) if res.dense is None else int((res.dense.counts > 0).sum())
    t_scan = time.perf_counter()
    parts = partition_groups_stable(res, int(task["numPartitions"]))
    t_part = time.perf_counter()
    _send_partitions(list(task["targets"]), task["queryId"], task["stage"], "A", parts,
                     task["senderId"], partial_frames, "partial",
                     local_ok=bool(task.get("deviceRoute", True)))
    t1 = time.perf_counter()
    return {"groups": groups, "ms": (t1 - t0) * 1000, "scanMs": (t_scan - t0) * 1000,
            "partitionMs": (t_part - t_scan) * 1000, "sendMs": (t1 - t_part) * 1000}


def _join_stage_body(task: Dict[str, Any], device) -> List[dict]:
    """One join-stage partition's work, under the caller's stats record.
    Returns the data frames to stream back."""
    qid, stage, p = task["queryId"], task["stage"], int(task["partition"])
    spec = spec_from_json(task["spec"])
    lparts, _ = consume_mailbox(qid, f"{stage}.L.{p}", int(task["numLeftSenders"]))
    rparts, _ = consume_mailbox(qid, f"{stage}.R.{p}", int(task["numRightSenders"]))
    # local senders' JoinInputs keep their key codes; remote frames re-hash
    left, lcodes = _concat_join_inputs(lparts)
    right, rcodes = _concat_join_inputs(rparts)
    t0 = time.perf_counter()
    out = hash_join(left, right, spec, lcodes=lcodes, rcodes=rcodes, device=device)
    t1 = time.perf_counter()
    qstats.record(STAGE_JOIN_MS, (t1 - t0) * 1000)

    down = task["downstream"]
    if down["kind"] == "mailbox":
        parts, shuffled = _partition_join_input(out, list(down["keys"]), len(down["targets"]),
                                                down.get("strategy", "partitioned"),
                                                down.get("side", "L"))
        qstats.record(qstats.JOIN_SHUFFLE_BYTES, shuffled)
        _send_partitions(list(down["targets"]), qid, down["stage"], down.get("side", "L"),
                         parts, down["senderId"], _join_input_frames, "block",
                         local_ok=bool(down.get("deviceRoute", True)))
        return [{"kind": "ack", "rows": _block_rows(out)}]

    # the final stage: the post-filter (row-local, so safe before the
    # aggregation), then the aggregation, or the selection and its trim
    ctx = stage_ctx_from_json(task["finalCtx"])
    if task.get("postFilter") and _block_rows(out):
        mask = _null_safe_mask(_parse_expr(task["postFilter"]), out)
        out = _take(out, np.nonzero(np.asarray(mask, dtype=bool))[0])
    if ctx.is_aggregation_query or ctx.distinct:
        aggs = [make_agg(f) for f in ctx.aggregations]
        # partitions follow the JOIN keys, not the group keys: group ranges
        # are not disjoint here, so HAVING or a top-k trim would be unsound;
        # the full (mergeable) partial goes back
        partial = aggregate_block(ctx, aggs, out)
        qstats.record(STAGE_AGGREGATE_MS, (time.perf_counter() - t1) * 1000)
    else:
        partial = _trim_selection(ctx, selection_block(ctx, out))
    return list(partial_frames(partial))


def run_join_stage_task(task: Dict[str, Any], device=None) -> Iterator[bytes]:
    """One join-stage partition on a worker, joining on `device` (the
    server's): consume both sides' mailboxes, hash-join, then forward the
    output to the next stage's mailboxes or run the final stage and stream
    its partial frames back. The frames end with the worker's stats
    (joinBuildMs, joinProbeMs, joinSkewPct, stageJoinMs, ...), which ride
    back to the broker. The body runs EAGERLY under the stats record: a
    generator suspended inside `collect_stats` would leak the thread-local
    record onto the HTTP handler thread between yields."""
    st = qstats.ExecutionStats()
    with qstats.collect_stats(st):
        frames = _join_stage_body(task, device)
    for fr in frames:
        yield frame_bytes(fr)
    yield frame_bytes({"kind": "stats", "stats": st.to_wire()})
    yield frame_bytes({"kind": "end"})


def run_agg_stage_task(task: Dict[str, Any]) -> Iterator[bytes]:
    """One merge partition of a distributed GROUP BY: consume the
    partitioned partials, merge this key range, HAVING and the top-k trim
    (the ranges ARE disjoint here), stream the merged partial back, then the
    merge's ms as a stats frame."""
    t0 = time.perf_counter()
    ctx = stage_ctx_from_json(task["finalCtx"])
    aggs = [make_agg(f) for f in ctx.aggregations]
    _, partials = consume_mailbox(task["queryId"], f"{task['stage']}.A.{task['partition']}",
                                  int(task["numSenders"]))
    t1 = time.perf_counter()
    merged = merge_segment_results(partials, aggs) if partials else SegmentResult("groups")
    merged = trim_group_result(ctx, merged, aggs)
    frames = list(partial_frames(merged))
    merge_ms = (time.perf_counter() - t1) * 1000
    for fr in frames:
        yield frame_bytes(fr)
    yield frame_bytes({"kind": "stats", "stats": {
        "stageWaitMs": (t1 - t0) * 1000, "stageMergeMs": merge_ms}})
    yield frame_bytes({"kind": "end"})


# ---------------------------------------------------------------------------
# the broker's coordinator
# ---------------------------------------------------------------------------

def _post_stage_task(url: str, path: str, task: Dict[str, Any], timeout_s: float,
                     stats_sink: Optional[List[Dict[str, float]]] = None
                     ) -> List[SegmentResult]:
    """Dispatch a worker task and read its streamed response frames; its
    stats frames go to `stats_sink` when one is given."""
    partials: List[SegmentResult] = []
    with http_stream("POST", f"{url}/{path}", encode_value(task), timeout=timeout_s) as resp:
        while True:
            d = read_frame(resp)
            if d["kind"] == "end":
                resp.read()   # the terminal chunk: the connection can be pooled
                break
            if d["kind"] == "error":
                # the worker's own failure (a mailbox timeout, a cancelled
                # peer, a bad plan): a QUERY error from a live server
                raise RuntimeError(f"stage worker failed: {d['message']}")
            if d["kind"] == "partial":
                partials.append(decode_segment_result(d["result"]))
            elif d["kind"] == "stats" and stats_sink is not None:
                stats_sink.append(d["stats"])
            # "ack" frames carry no data
    return partials


def cancel_query_mailboxes(urls: Iterable[str], qid: str) -> None:
    """DELETE the query's mailboxes on every server, best effort: the TTL
    sweep is the backstop."""
    for url in set(urls):
        try:
            http_call("DELETE", f"{url}/mailbox/{qid}", timeout=5.0)
        except (ConnectionError, HttpError, OSError):
            pass


@dataclass
class LeafRoute:
    """One leaf dispatch: (server, url, table, segments, time filter)."""
    server_id: str
    url: str
    table: str
    segments: List[str]
    time_filter: Optional[str]


def _device_routing_enabled(broker) -> bool:
    """clusterConfig `broker.shuffle.device.routing` (default on): legs whose
    target mailbox is in the sender's own process skip the codec and the
    HTTP hop."""
    prop = broker.catalog.get_property("clusterConfig/broker.shuffle.device.routing")
    if prop is None:
        return True
    return str(prop).strip().lower() not in ("false", "0", "no", "off")


def _explicit_partitions(options) -> bool:
    opt = {str(k).lower() for k in (options or {})}
    return bool(opt & {"numpartitions", "stageparallelism"})


def _broadcast_max_bytes(broker) -> Optional[int]:
    """clusterConfig `broker.join.broadcast.max.bytes`: a build side
    estimated under it replicates to every worker instead of hash-partitioning
    (None: the planner's default)."""
    prop = broker.catalog.get_property("clusterConfig/broker.join.broadcast.max.bytes")
    try:
        return int(prop) if prop is not None else None
    except (TypeError, ValueError):
        return None


def _est_route_bytes(broker, routes, ncols: int) -> int:
    """A routed scan's size from metadata: the routed segments' doc counts x
    the projected columns x 8 bytes (pushed filters make it an upper bound,
    which errs only toward the always-correct partitioned strategy)."""
    docs = 0
    for r in routes:
        metas = broker.catalog.segments.get(r.table, {})
        docs += sum(int(getattr(metas[s], "num_docs", 0)) for s in r.segments if s in metas)
    return docs * max(1, int(ncols)) * 8


def _leaf_sql(scan) -> str:
    sql = (f"SELECT {', '.join(_sql_ident(c) for c in scan.columns)} "
           f"FROM {_sql_ident(scan.table)}")
    if scan.filter is not None:
        sql += f" WHERE {to_sql(scan.filter)}"
    return sql + f" LIMIT {UNBOUNDED_LIMIT}"


def _run_stage_tasks(broker, qid: str, worker_tasks, leaf_tasks, all_urls,
                     worker_stats: Optional[List[Dict[str, float]]]):
    """Dispatch every worker and leaf task on a pool of this query's own and
    gather them in completion order: (worker partials, leaf responses).
    Workers block until their mailboxes drain, so sharing the broker's
    bounded scatter pool (or the mux pool) could deadlock them behind the
    leaves that feed them. The first failure cancels the query's mailboxes
    everywhere BEFORE the pool's shutdown waits on the blocked peers."""
    partials: List[SegmentResult] = []
    leaf_results: List[Dict[str, Any]] = []
    pool = ThreadPoolExecutor(max_workers=len(worker_tasks) + len(leaf_tasks),
                              thread_name_prefix="p2p-stage")
    try:
        futs = {}
        for url, path, task in worker_tasks:
            futs[pool.submit(_post_stage_task, url, path, task, broker.stage_timeout_s,
                             worker_stats)] = "worker"
        for url, path, task in leaf_tasks:
            futs[pool.submit(broker._post_leaf_task, url, path, task)] = "leaf"
        # bounded: one wedged worker raises TimeoutError into the cancel below
        for f in as_completed(futs, timeout=broker.stage_timeout_s):
            r = f.result()
            if futs[f] == "worker":
                partials.extend(r)
            else:
                leaf_results.append(r)
    except Exception:
        cancel_query_mailboxes(all_urls, qid)
        raise
    finally:
        pool.shutdown(wait=True)
    return partials, leaf_results


def _sum_key(dicts, key: str) -> float:
    return round(sum(float(d.get(key, 0.0) or 0.0) for d in dicts), 3)


def coordinate_join(broker, stmt, num_partitions: int):
    """The peer-to-peer run of a join query. The broker plans, routes the
    leaf scans, assigns P workers a stage, dispatches everything and receives
    ONLY the final stage's partials (reference: QueryDispatcher.submitAndReduce)."""
    t0 = time.perf_counter()
    plan = plan_multistage(stmt, lambda t: (
        broker.catalog.schema_for_table(broker._physical_tables(t)[0])
        if broker._physical_tables(t) else None))
    ctx = plan.ctx
    qid = f"q{uuid.uuid4().hex[:16]}"
    P = num_partitions

    # workers first (a cheap check): an in-process cluster without HTTP
    # endpoints falls back here, before any quota is taken
    workers = broker._stage_workers(P)
    device_route = _device_routing_enabled(broker)

    leaf_routes: Dict[str, List[LeafRoute]] = {}
    for alias, scan in plan.scans.items():
        leaf_routes[alias] = broker._leaf_routes(scan.table, scan.columns, scan.filter)
        if not leaf_routes[alias]:
            # an empty or fully pruned side has no senders, and its workers
            # would see schema-less empty mailboxes: the funnel path answers
            # the empty relation
            raise P2PUnavailable(f"no leaf routes for {scan.table!r}")
    # quota only once EVERY alias routed: a fallback must not have charged it
    broker._acquire_scan_quota([s.table for s in plan.scans.values()])

    # a build side whose metadata estimate fits under the broadcast cap
    # replicates to every worker; larger ones hash-partition both sides
    bmax = _broadcast_max_bytes(broker)
    strategies = [choose_join_strategy(
        spec.join_type,
        _est_route_bytes(broker, leaf_routes[spec.right_alias],
                         len(plan.scans[spec.right_alias].columns)), bmax)
        for spec in plan.joins]
    targets = [w[1] for w in workers]
    leaf_tasks: List[Tuple[str, str, Dict[str, Any]]] = []

    def add_leaf_tasks(alias: str, stage: str, side: str, keys: List[str],
                       strategy: str) -> int:
        scan = plan.scans[alias]
        sql = _leaf_sql(scan)
        for i, r in enumerate(leaf_routes[alias]):
            leaf_tasks.append((r.url, "leafStage", {
                "queryId": qid, "table": r.table, "sql": sql, "segments": r.segments,
                "timeFilter": r.time_filter, "alias": alias, "columns": scan.columns,
                "keys": keys, "numPartitions": P, "stage": stage, "side": side,
                "strategy": strategy, "targets": targets, "deviceRoute": device_route,
                "senderId": f"leaf.{alias}.{i}"}))
        return len(leaf_routes[alias])

    worker_tasks: List[Tuple[str, str, Dict[str, Any]]] = []
    n_left = add_leaf_tasks(plan.base_alias, "join0", "L", plan.joins[0].left_keys,
                            strategies[0])
    for si, spec in enumerate(plan.joins):
        stage = f"join{si}"
        n_right = add_leaf_tasks(spec.right_alias, stage, "R", spec.right_keys,
                                 strategies[si])
        last = si == len(plan.joins) - 1
        for p in range(P):
            task: Dict[str, Any] = {"queryId": qid, "stage": stage, "partition": p,
                                    "spec": spec_to_json(spec),
                                    "numLeftSenders": n_left, "numRightSenders": n_right}
            if last:
                task["downstream"] = {"kind": "response"}
                task["finalCtx"] = stage_ctx_to_json(ctx)
                task["postFilter"] = (to_sql(plan.post_filter)
                                      if plan.post_filter is not None else None)
            else:
                nxt = plan.joins[si + 1]
                task["downstream"] = {"kind": "mailbox", "keys": nxt.left_keys,
                                      "stage": f"join{si + 1}", "side": "L",
                                      "strategy": strategies[si + 1], "targets": targets,
                                      "deviceRoute": device_route,
                                      "senderId": f"{stage}.w{p}"}
            worker_tasks.append((workers[p][1], "joinStage", task))
        n_left = P   # the next stage's left side is this stage's P workers

    all_urls = ({r.url for routes in leaf_routes.values() for r in routes}
                | {w[1] for w in workers})
    t_plan = time.perf_counter()
    worker_stats: List[Dict[str, float]] = []
    partials, leaf_results = _run_stage_tasks(broker, qid, worker_tasks, leaf_tasks,
                                              all_urls, worker_stats)
    t_stages = time.perf_counter()

    aggs = [make_agg(f) for f in ctx.aggregations]
    group_exprs = [e for e, _ in ctx.select_items] if ctx.distinct else list(ctx.group_by)
    merged = merge_segment_results(partials, aggs)
    if not partials:
        merged.kind = "groups" if group_exprs else "scalar" if aggs else "selection"
    result = reduce_to_result(ctx, merged, aggs, group_exprs)
    t_reduce = time.perf_counter()
    result.stats[qstats.MULTISTAGE] = True
    result.stats[qstats.MAILBOX_SHUFFLE] = True
    result.stats[qstats.NUM_STAGE_WORKERS] = len({u for u, _, _ in worker_tasks})
    # the workers' join accounting merged with the leaves' exchange bytes,
    # exported under the funnel path's keys
    st = qstats.ExecutionStats()
    for d in worker_stats:
        st.merge(d)
    leaf_shuffle = sum(int(r.get("shuffleBytes", 0) or 0) for r in leaf_results)
    if leaf_shuffle:
        st.add(qstats.JOIN_SHUFFLE_BYTES, leaf_shuffle)
    for key, val in st.to_public_dict().items():
        if key.startswith("join") or key == qstats.NUM_SEGMENTS_PRUNED_BY_JOIN_KEY:
            result.stats[key] = val
    result.stats[qstats.JOIN_STRATEGY] = (strategies[0] if len(strategies) == 1
                                    else ",".join(strategies))
    result.stats["phaseTimesMs"] = {
        "plan": round((t_plan - t0) * 1000, 3), "stages": round((t_stages - t_plan) * 1000, 3),
        "reduce": round((t_reduce - t_stages) * 1000, 3),
        # summed over the leaf tasks and the workers
        "leaf": _sum_key(leaf_results, "ms"), "leafScan": _sum_key(leaf_results, "scanMs"),
        "leafColumns": _sum_key(leaf_results, "columnsMs"),
        "leafSend": _sum_key(leaf_results, "sendMs"),
        "join": round(st.counters.get(STAGE_JOIN_MS, 0.0), 3),
        "partialAggregate": round(st.counters.get(STAGE_AGGREGATE_MS, 0.0), 3)}
    outer = qstats.current_stats()
    if outer is not None:
        outer.merge(st)
    return result


def coordinate_groupby(broker, ctx, physical: List[str], num_partitions: int):
    """The peer-to-peer distributed single-table GROUP BY: the leaf servers
    send hash-partitioned group partials straight to P merge workers; the
    broker receives P disjoint, trimmed key ranges and concatenates them
    (reference: PinotAggregateExchangeNodeInsertRule's partitioned agg
    exchange)."""
    t0 = time.perf_counter()
    qid = f"q{uuid.uuid4().hex[:16]}"
    P = num_partitions
    workers = broker._stage_workers(P)
    routes: List[LeafRoute] = broker._leaf_routes_groupby(ctx, physical)
    if not routes:
        raise P2PUnavailable("no routable leaf servers")

    device_route = _device_routing_enabled(broker)
    device_routed = False
    if device_route and P > 1 and not _explicit_partitions(ctx.options):
        urls = {w[1] for w in workers} | {r.url for r in routes}
        if all(is_local_endpoint(u) for u in urls):
            # the whole exchange is in this process: ONE merge partition, so
            # array-form partials reach the worker by reference and merge
            # elementwise. An explicit OPTION(numPartitions / stageParallelism)
            # pins P and skips the collapse.
            P = 1
            workers = workers[:1]
            device_routed = True

    targets = [w[1] for w in workers]
    leaf_tasks = [(r.url, "leafAgg", {
        "queryId": qid, "table": r.table, "sql": ctx.sql, "segments": r.segments,
        "timeFilter": r.time_filter, "numPartitions": P, "stage": "agg0",
        "targets": targets, "deviceRoute": device_route, "senderId": f"leaf.{i}"})
        for i, r in enumerate(routes)]
    worker_tasks = [(workers[p][1], "aggStage", {
        "queryId": qid, "stage": "agg0", "partition": p, "numSenders": len(routes),
        "finalCtx": stage_ctx_to_json(ctx)}) for p in range(P)]
    all_urls = {r.url for r in routes} | {w[1] for w in workers}
    t_plan = time.perf_counter()
    worker_stats: List[Dict[str, float]] = []
    partials, leaf_results = _run_stage_tasks(broker, qid, worker_tasks, leaf_tasks,
                                              all_urls, worker_stats)
    t_stages = time.perf_counter()

    aggs = [make_agg(f) for f in ctx.aggregations]
    group_exprs = [e for e, _ in ctx.select_items] if ctx.distinct else list(ctx.group_by)
    # the key ranges are disjoint: the merge is a union, never a re-aggregation
    merged = merge_segment_results(partials, aggs)
    if not partials:
        merged.kind = "groups"
    result = reduce_to_result(ctx, merged, aggs, group_exprs)
    t_reduce = time.perf_counter()
    result.stats[qstats.DISTRIBUTED_GROUP_BY] = True
    if device_routed:
        result.stats[qstats.DEVICE_ROUTED_SHUFFLE] = True
    result.stats[qstats.NUM_STAGE_WORKERS] = len({u for u, _, _ in worker_tasks})
    result.stats["phaseTimesMs"] = {
        "plan": round((t_plan - t0) * 1000, 3), "stages": round((t_stages - t_plan) * 1000, 3),
        "reduce": round((t_reduce - t_stages) * 1000, 3),
        "leaf": _sum_key(leaf_results, "ms"), "leafScan": _sum_key(leaf_results, "scanMs"),
        "leafPartition": _sum_key(leaf_results, "partitionMs"),
        "leafSend": _sum_key(leaf_results, "sendMs"),
        "mergeWait": _sum_key(worker_stats, "stageWaitMs"),
        "merge": _sum_key(worker_stats, "stageMergeMs")}
    result.stats["leafGroups"] = [int(r.get("groups", 0)) for r in leaf_results]
    return result
