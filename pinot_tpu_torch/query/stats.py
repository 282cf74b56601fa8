"""Per-query execution statistics.

A subset of `pinot_tpu/query/stats.py`: the typed record (`ExecutionStats`),
the thread-local "current record" slot (`collect_stats`, `current_stats`) and
the accounting hooks `record`, `record_min`, `record_max` and
`record_operator`, with the segment counts the per-segment executor, the
servers and the broker record, the consuming segments' count and freshness,
the broker's pruning, hedge and retry keys, the server tiers' host-tier,
promotion and cold-load keys, the mux transport's two waits,
the join keys, `scanRowsAvoided`, the batch ingestion's keys, and the names
of the multistage route's result keys. A server partial carries its record as a flat
dict (`to_wire`, `SegmentResult.stats`), which the broker merges. Accounting
sites record into whatever record is active on their thread, and do nothing
when none is; a worker thread serving one query re-installs that query's
record with `collect_stats(st)`.

Per-operator rows and milliseconds (what EXPLAIN ANALYZE reads) flatten into
the same dict under `op:<label>:rows` and `op:<label>:ms`, so one merge rule
covers everything; `operators()` reassembles them and `to_public_dict()`
leaves them out.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

# segments a partial planned (per segment or as a set), those the server's
# planner folded to nothing (a constant-false filter) and those that matched
# at least one row; the broker's metadata pruners add to numSegmentsPruned and
# to their kind's breakdown
NUM_SEGMENTS_QUERIED = "numSegmentsQueried"
NUM_SEGMENTS_PRUNED = "numSegmentsPruned"
NUM_SEGMENTS_MATCHED = "numSegmentsMatched"
NUM_SEGMENTS_PRUNED_BY_PARTITION = "numSegmentsPrunedByPartition"
NUM_SEGMENTS_PRUNED_BY_TIME = "numSegmentsPrunedByTime"
NUM_SEGMENTS_PRUNED_BY_RANGE = "numSegmentsPrunedByRange"
NUM_SEGMENTS_PRUNED_BY_BLOOM = "numSegmentsPrunedByBloom"
NUM_DOCS_SCANNED = "numDocsScanned"
# the broker's duplicate dispatches to another replica (hedging), the
# milliseconds a retry round waited out replicas' Retry-After hints, and the
# segments a retry round sent to another replica (a key of this package: the
# JAX package's broker counts no retries)
HEDGED_REQUESTS = "hedgedRequests"
ADMISSION_DEFER_MS = "admissionDeferMs"
NUM_SEGMENTS_RETRIED = "numSegmentsRetried"
# docs never scanned because their segment was pruned (by the broker's
# metadata pruners, a server's constant-false fold or the join's build-key
# derived filter)
SCAN_ROWS_AVOIDED = "scanRowsAvoided"
# device hash join: wall time in the build-side sort / scatter programs and
# the probe programs (summed across join partitions), bytes exchanged between
# join stages, probe segments skipped by the build-key derived filter, and
# joins the admission gate priced off the device (served by the host join)
JOIN_BUILD_MS = "joinBuildMs"
JOIN_PROBE_MS = "joinProbeMs"
JOIN_SHUFFLE_BYTES = "joinShuffleBytes"
NUM_SEGMENTS_PRUNED_BY_JOIN_KEY = "numSegmentsPrunedByJoinKey"
JOIN_SERVED_HOST_TIER = "joinServedHostTier"
# worst probe-key skew any join partition saw (hot-bucket excess percentage
# of the probe-hash histogram); max-merged
JOIN_SKEW_PCT = "joinSkewPct"

# batch ingestion (`ingest/batch.py`): milliseconds inside the record
# readers and the rows they gave (both passes of a streaming job), the
# streaming job's stats pass, its write pass (the segment builds, its pushes
# not counted) and the controller's `upload_segment` calls
BATCH_READ_MS = "batchReadMs"
BATCH_ROWS_READ = "batchRowsRead"
BATCH_STATS_PASS_MS = "batchStatsPassMs"
BATCH_WRITE_PASS_MS = "batchWritePassMs"
BATCH_PUSH_MS = "batchPushMs"

# consuming (realtime) segments a partial served, and the freshness of the
# stalest of them: the epoch ms of the newest row it holds (its largest
# event time, else when it last consumed)
NUM_CONSUMING_SEGMENTS_QUERIED = "numConsumingSegmentsQueried"
MIN_CONSUMING_FRESHNESS_TIME_MS = "minConsumingFreshnessTimeMs"

# the server's tiers (`cluster/tiering.py`): segments the admission gate kept
# off the device (answered by the host plan), segments newly promoted to the
# device this query, and COLD segments loaded from the deep store on a query
# with the milliseconds those loads took
SEGMENTS_SERVED_HOST_TIER = "segmentsServedHostTier"
TIER_PROMOTIONS = "tierPromotions"
SEGMENTS_COLD_LOADED = "segmentsColdLoaded"
COLD_LOAD_MS = "coldLoadMs"

# the mux transport (`cluster/mux.py`): milliseconds a request frame waited in
# the broker's write queue, and milliseconds a server's demux loop held it at
# the stream's flow-control window (`server.mux.max.inflight`)
MUX_FRAME_QUEUE_MS = "muxFrameQueueMs"
MUX_FLOW_CONTROL_MS = "muxFlowControlMs"

# the multistage route's result keys (a ResultTable's stats, not counters):
# the query took the multistage engine, the peer-to-peer mailbox shuffle or
# the distributed GROUP BY (`multistage/shuffle.py`); that GROUP BY's
# exchange stayed in one process (one merge partition); the distinct servers
# that ran its stages; the join stages' exchange strategies ("broadcast" or
# "partitioned", comma-joined). The workers' join keys above ride back to
# the broker in their stats frames.
MULTISTAGE = "multistage"
MAILBOX_SHUFFLE = "mailboxShuffle"
DISTRIBUTED_GROUP_BY = "distributedGroupBy"
DEVICE_ROUTED_SHUFFLE = "deviceRoutedShuffle"
NUM_STAGE_WORKERS = "numStageWorkers"
JOIN_STRATEGY = "joinStrategy"

# keys that merge by MAXIMUM: a skew percentage summed over partitions means
# nothing; the worst partition bounds the stage
MAX_KEYS = (JOIN_SKEW_PCT,)
# keys that merge by MINIMUM: an answer is only as fresh as the stalest
# consuming segment it read, whichever server served it
MIN_KEYS = (MIN_CONSUMING_FRESHNESS_TIME_MS,)

# counters the broker's response always carries (0 when the path never ran):
# a response over the mux transport and one over POST /query carry one key set
BROKER_COUNTER_KEYS = (NUM_SEGMENTS_QUERIED, NUM_SEGMENTS_PRUNED, NUM_SEGMENTS_MATCHED,
                       HEDGED_REQUESTS, NUM_SEGMENTS_RETRIED, MUX_FRAME_QUEUE_MS,
                       MUX_FLOW_CONTROL_MS, SEGMENTS_SERVED_HOST_TIER, TIER_PROMOTIONS,
                       SEGMENTS_COLD_LOADED, COLD_LOAD_MS)

#: routing pruner kind (cluster.routing.PRUNER_KINDS) -> its breakdown counter
PRUNED_BY_KIND = {
    "partition": NUM_SEGMENTS_PRUNED_BY_PARTITION,
    "time": NUM_SEGMENTS_PRUNED_BY_TIME,
    "range": NUM_SEGMENTS_PRUNED_BY_RANGE,
    "bloom": NUM_SEGMENTS_PRUNED_BY_BLOOM,
}

_OP_PREFIX = "op:"


def op_key(label: str, fld: str) -> str:
    """The flat counter key of one operator's `rows` or `ms`."""
    return f"{_OP_PREFIX}{label}:{fld}"


class ExecutionStats:
    """One query's execution accounting: a flat dict of summable counters."""

    __slots__ = ("counters", "_lock")

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, key: str, n: float = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def set_min(self, key: str, v: float) -> None:
        """Keep the minimum seen for a min-merged key (no-op when `v` loses)."""
        with self._lock:
            cur = self.counters.get(key)
            self.counters[key] = v if cur is None else min(cur, v)

    def set_max(self, key: str, v: float) -> None:
        """Keep the maximum seen for a max-merged key (no-op when `v` loses)."""
        with self._lock:
            cur = self.counters.get(key)
            self.counters[key] = v if cur is None else max(cur, v)

    def add_operator(self, label: str, rows: float = 0, ms: float = 0.0) -> None:
        with self._lock:
            rk, mk = op_key(label, "rows"), op_key(label, "ms")
            self.counters[rk] = self.counters.get(rk, 0) + rows
            self.counters[mk] = self.counters.get(mk, 0) + ms

    def operators(self) -> Dict[str, Dict[str, float]]:
        """The per-operator breakdown: label -> {rows, ms}."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for k, v in self.counters.items():
                if k.startswith(_OP_PREFIX):
                    label, _, fld = k[len(_OP_PREFIX):].rpartition(":")
                    out.setdefault(label, {"rows": 0, "ms": 0.0})[fld] = v
        return out

    def merge(self, other) -> None:
        """Fold another record (an ExecutionStats or its `to_wire` dict) into
        this one: every numeric key sums, except MIN_KEYS and MAX_KEYS,
        which keep the minimum or maximum of the sides that carry the key."""
        if other is None:
            return
        if isinstance(other, ExecutionStats):
            with other._lock:
                src = dict(other.counters)
        else:
            src = {k: v for k, v in other.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        with self._lock:
            for k, v in src.items():
                if k in MIN_KEYS:
                    cur = self.counters.get(k)
                    self.counters[k] = v if cur is None else min(cur, v)
                elif k in MAX_KEYS:
                    cur = self.counters.get(k)
                    self.counters[k] = v if cur is None else max(cur, v)
                else:
                    self.counters[k] = self.counters.get(k, 0) + v

    def to_wire(self) -> Dict[str, float]:
        """The flat dict a server partial carries (`op:*` entries kept)."""
        with self._lock:
            return dict(self.counters)

    def to_public_dict(self) -> Dict[str, object]:
        """Export of the counters recorded (unlike the JAX package's, no key
        is zero-filled, so an absent key means the path never ran): ints for
        counts and for MIN_KEYS' epoch-ms timestamps, floats rounded to 3
        decimals for the other `*Ms` and `*Pct`; the op:* breakdowns stay off
        it (EXPLAIN ANALYZE reads them)."""
        with self._lock:
            return {k: round(float(v), 3) if k.endswith(("Ms", "Pct")) and k not in MIN_KEYS
                    else int(v)
                    for k, v in self.counters.items() if not k.startswith(_OP_PREFIX)}


# -- thread-local current record ---------------------------------------------------

_local = threading.local()


def current_stats() -> Optional[ExecutionStats]:
    return getattr(_local, "stats", None)


def record(key: str, n: float = 1) -> None:
    """Add to the active record, if any."""
    st = getattr(_local, "stats", None)
    if st is not None:
        st.add(key, n)


def record_min(key: str, v: float) -> None:
    """Keep the smallest value seen by the active record, if any."""
    st = getattr(_local, "stats", None)
    if st is not None:
        st.set_min(key, v)


def record_max(key: str, v: float) -> None:
    """Keep the largest value seen by the active record, if any."""
    st = getattr(_local, "stats", None)
    if st is not None:
        st.set_max(key, v)


def record_operator(label: str, rows: float = 0, ms: float = 0.0) -> None:
    """Add one operator's rows and milliseconds to the active record, if any."""
    st = getattr(_local, "stats", None)
    if st is not None:
        st.add_operator(label, rows=rows, ms=ms)


@contextmanager
def collect_stats(st: Optional[ExecutionStats] = None) -> Iterator[ExecutionStats]:
    """Install a record (a fresh one by default) as this thread's active
    stats for the scope; a worker thread passes its query's record."""
    st = st if st is not None else ExecutionStats()
    prev = getattr(_local, "stats", None)
    _local.stats = st
    try:
        yield st
    finally:
        _local.stats = prev

