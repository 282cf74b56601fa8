"""Server-side realtime consumption: one consumer per stream partition, and
the server's realtime table manager.

Counterpart of `pinot_tpu/ingest/realtime.py` (the analog of the reference's
`LLRealtimeSegmentDataManager` and `RealtimeTableDataManager`).
`RealtimePartitionConsumer.pump()` fetches a batch from the partition,
decodes it and indexes it into the consuming segment; `query_segment()`
gives the segment queries run against; `maybe_complete()` walks the
completion protocol against the controller's LLC segment manager
(`cluster/completion.py`) once the flush thresholds are reached:

    INITIAL_CONSUMING -> CATCHING_UP -> HOLDING -> COMMITTING -> COMMITTED
                                     \\-> DISCARDED (lost the race: download instead)
                                      \\-> RETAINED (KEEP: the local build adopted)
                                       \\-> ERROR

A consumer reaches its thresholds at the granularity of what one pump
indexes (a columnar block carries the row count past the threshold): the
segment's end offset is the offset the consumer reached, as in the JAX
package. A controller's pause request (`set_paused`) stops fetching and makes
a consumer that holds rows commit at its next completion round.

The consuming segment's class, as the JAX package chooses it: the chunked
`DeviceMutableSegment`, unless the table has upsert or dedup, names text or
inverted index columns, or sets the stream property
`realtime.ingest.vectorized=false`; then the row-append `MutableSegment`
(`segment/mutable.py`), which keeps the realtime indexes and indexes row by
row.

The stream is the table's stream type through the factory registry
(`stream.get_stream_factory`: a `MemoryStream` topic, or a kafkalite
partition over its socket, which `close()` releases). The decode lanes follow
the JAX package's, chosen by what the decoder and the consumer offer
(`last_decode_path` names the lane the last pump took):
* a columnar block stream (a decoder `stream.get_block_decoder` knows:
  "columnar"): each message is a PCB1 block, decoded to a `ColumnarBatch` and
  appended with `index_arrays` ("blocks"); the blocks come from the
  consumer's `fetch_spliced` (one buffer, walked with `np.frombuffer` views),
  else `fetch_raw`, else `fetch`. A table with upsert or dedup cannot take it;
* a JSON stream over a splicing consumer (`fetch_spliced`), with no filter or
  transforms: one native walk of the spliced values to typed arrays
  (`vectorized.columnar_batch_from_json`, "columnar-array") where the segment
  appends arrays, else to coerced column lists
  (`transform.columns_from_spliced_json`, "columnar"); a row stream with a
  spliced batch decoder: one parse of the joined values ("spliced");
* a row stream with a batch decoder over a consumer that offers `fetch_raw`:
  the value bytes decoded in one call ("raw"), or over `fetch` ("batch");
  where that call fails or gives another number of rows than messages, the
  row decoder decodes each message, so that a malformed one raises alone. The
  decoded rows are coerced by the transform pipeline and appended column by
  column with `index_batch`;
* the per-row lane of an upsert or dedup table ("row"): the batch's messages
  decoded and transformed (`TransformPipeline.apply_rows`: the rows
  `apply_row` gives one at a time), then `_index_row` row by row in arrival
  order: the dedup check, the partial-upsert merge, the append and
  `add_record` into the table's upsert metadata (the comparison value is the
  `comparisonColumn`'s, else the message offset).

With the stream property `realtime.ingest.device.staging=true` a chunked
consuming segment stages its numeric chunks on `device` (CUDA unless the
caller names another) and its views run on the device path. A row-append
segment runs on the host, as the JAX planner routes it. A retired or
discarded consumer's staged chunks and view block are released
(`RealtimeTableManager._release_device`).

`RealtimeTableManager` is one server's realtime side of one table: it starts
a consumer for each CONSUMING assignment, hands a committed segment over
(`on_segment_online`: the local build where this server committed or
reached the same end offset, else the caller downloads the committed copy;
`retire_consumer` once the immutable copy serves), answers the consuming
segments of a query from one snapshot (`consuming_results`), and pumps and
completes its consumers (`pump_all`, `complete_all`, or a background loop,
`start_loop`). It keeps one upsert metadata manager for the table and one
dedup manager per partition.

The stream properties `filterExpr` and `columnTransforms` configure the
`TransformPipeline`: with either, a block lane's batches go through it as
column lists before they are indexed.

Ingestion health (the reference's IngestionDelayTracker and
consumingSegmentsInfo): each consumer's `ConsumerLagTracker` counts the rows
it indexed and filtered, its pump errors and an EWMA of its rows a second,
and keeps its freshness; `lag_status` is one consuming segment's snapshot
(current and latest stream offsets, offset lag, freshness lag) and exports
the `pinot_server_realtime_*` gauges of `_LAG_GAUGES` for the (table,
partition). The offset lag is read from the stream when asked, so a paused
consumer's lag grows while producers go on; a stream whose probe raises, or
that has no `latest_offset` (Kinesis), reports it as None. The manager's
`ingestion_status` is the table's rollup (the worst offset and freshness
lags, the rows a second, the segments in ERROR), which a server's
`/debug/consuming` serves and the controller's verdict reads; a consumer
stopped with its segment, or the manager's stop, removes its gauges.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..cluster.completion import parse_llc_name
from ..query.context import QueryContext
from ..query.reduce import SegmentResult
from ..segment.mutable import MutableSegment
from ..segment.mutable_device import DeviceMutableSegment
from ..segment.writer import SegmentBuilder, SegmentGeneratorConfig
from ..table import TableConfig
from ..upsert import (PartitionDedupMetadataManager, TableUpsertMetadataManager,
                      merge_partial)
from ..utils.metrics import get_registry
from .stream import get_batch_decoder, get_block_decoder, get_decoder, get_stream_factory
from .transform import TransformPipeline, columns_from_spliced_json, rows_to_all_columns
from .vectorized import columnar_batch_from_json

#: messages one `pump()` fetches unless the caller or the stream property
#: `realtime.ingest.batch.size` names another count
MAX_PUMP_MESSAGES = 10_000

# consumer states (the reference's LLRealtimeSegmentDataManager.State)
INITIAL_CONSUMING = "INITIAL_CONSUMING"
CATCHING_UP = "CATCHING_UP"
HOLDING = "HOLDING"
COMMITTING = "COMMITTING"
COMMITTED = "COMMITTED"
DISCARDED = "DISCARDED"
RETAINED = "RETAINED"
ERROR = "ERROR"

_CONSUMING_STATES = (INITIAL_CONSUMING, CATCHING_UP, HOLDING)

#: how a replica's consuming segment became its immutable copy
#: (`RealtimeTableManager.handoffs`): it committed it, kept its own build of
#: the committed offset, or discarded it and downloaded the committed copy
COMMIT, KEEP, DISCARD = "COMMIT", "KEEP", "DISCARD"


class ConsumerLagTracker:
    """One consuming partition's ingestion accounting (the reference's
    IngestionDelayTracker and its realtime gauges): rows indexed and
    filtered (fetched but dropped by the filter or dedup), pump errors, an
    EWMA of the rows indexed a second (one batch a sample), the wall time of
    the last fetch that returned messages and the largest event time indexed
    (epoch ms, from the table's time column)."""

    #: the EWMA's weight of the newest batch
    EWMA_ALPHA = 0.3

    def __init__(self, table: str, partition: int):
        self.table = table
        self.partition = partition
        self.rows_indexed = 0
        self.rows_filtered = 0
        self.errors = 0
        self.last_consumed_ms: Optional[int] = None
        self.last_event_time_ms: Optional[float] = None
        self.rows_per_s = 0.0
        self._last_batch_t: Optional[float] = None
        self._lock = threading.Lock()

    def on_batch(self, fetched: int, indexed: int, max_event_time_ms: Optional[float]) -> None:
        now = time.time()
        with self._lock:
            self.rows_indexed += indexed
            self.rows_filtered += max(fetched - indexed, 0)
            if fetched:
                self.last_consumed_ms = int(now * 1000)
            if max_event_time_ms is not None:
                self.last_event_time_ms = max(self.last_event_time_ms or 0.0,
                                              float(max_event_time_ms))
            if self._last_batch_t is not None:
                dt = max(now - self._last_batch_t, 1e-6)
                self.rows_per_s = (self.EWMA_ALPHA * (indexed / dt)
                                   + (1 - self.EWMA_ALPHA) * self.rows_per_s)
            self._last_batch_t = now

    def on_error(self) -> None:
        with self._lock:
            self.errors += 1


#: the gauges `lag_status` exports a (table, partition), listed once so that
#: a teardown removes exactly these
_LAG_GAUGES = (
    "pinot_server_realtime_offset_lag",
    "pinot_server_realtime_freshness_lag_ms",
    "pinot_server_realtime_rows_per_s",
    "pinot_server_realtime_last_consumed_ts_ms",
)


class RealtimePartitionConsumer:
    """One consuming segment of one stream partition on one server. One
    thread pumps at a time; any number of threads may query the segment
    meanwhile.

    `completion` is the controller's `LLCSegmentManager` (None for a
    consumer driven without a cluster: `maybe_complete` raises once the
    thresholds are reached), `server_id` the server it reports as. `upsert` is the table's
    `upsert.TableUpsertMetadataManager` (shared by every consumer of the
    table, and by the queries that read its masks), `dedup` the partition's
    `PartitionDedupMetadataManager`, `partial_rows` the table's last merged
    row per primary key (a PARTIAL upsert's state, shared like `upsert`)."""

    def __init__(self, segment_name: str, table_cfg: TableConfig, schema,
                 start_offset: int, data_dir: str, completion=None, device=None,
                 upsert=None, dedup=None, partial_rows: Optional[dict] = None,
                 server_id: str = ""):
        self.segment_name = segment_name
        self.table_cfg = table_cfg
        self.schema = schema
        self.completion = completion
        self.server_id = server_id
        self.data_dir = data_dir
        self.upsert = upsert
        self.dedup = dedup
        self.partial_rows = partial_rows if partial_rows is not None else {}
        self.state = INITIAL_CONSUMING
        stream_cfg = table_cfg.stream
        props = stream_cfg.properties or {}
        indexing = table_cfg.indexing
        vectorized_ok = (
            str(props.get("realtime.ingest.vectorized", "true")).lower() != "false"
            and upsert is None and dedup is None
            and not any(schema.has_column(c) for c in (*indexing.text_index_columns,
                                                       *indexing.inverted_index_columns)))
        if vectorized_ok:
            staging = str(props.get("realtime.ingest.device.staging", "false")).lower() == "true"
            self.mutable = DeviceMutableSegment(segment_name, schema, device_staging=staging,
                                                device=device)
        else:
            self.mutable = MutableSegment(
                segment_name, schema, text_index_columns=indexing.text_index_columns,
                inverted_index_columns=indexing.inverted_index_columns)
        try:
            self._batch_size = int(props.get("realtime.ingest.batch.size", MAX_PUMP_MESSAGES))
        except (TypeError, ValueError):
            self._batch_size = MAX_PUMP_MESSAGES
        self.pipeline = TransformPipeline(schema, props.get("filterExpr"),
                                          props.get("columnTransforms"))
        self.partition = parse_llc_name(segment_name)["partition"]
        self._factory = get_stream_factory(stream_cfg.stream_type, stream_cfg.topic,
                                           stream_cfg.properties)
        # made again at the next pump where the topic does not exist yet (a
        # producer may create it after the table) or the broker is down
        self.consumer = None
        self._connect()
        # a block stream (columnar) decodes whole blocks; any other decodes rows
        self.block_decoder = get_block_decoder(stream_cfg.decoder)
        self.decoder = self.batch_decoder = None
        if self.block_decoder is not None:
            if upsert is not None or dedup is not None:
                raise ValueError(
                    f"table {table_cfg.name}: upsert/dedup need per-row decode and offsets; "
                    "they cannot consume a columnar block stream")
        else:
            self.decoder = get_decoder(stream_cfg.decoder)
            self.batch_decoder = get_batch_decoder(stream_cfg.decoder)
        self.offset = start_offset
        self.start_consume_time = time.time()
        self.lag = ConsumerLagTracker(table_cfg.name, self.partition)
        self.catchup_target: Optional[int] = None
        # the handoff's fence: `on_segment_online` sets `halted` and takes
        # `pump_lock` before it reads the offset, so that no pump indexes rows
        # past the committed end offset into a segment being adopted
        self.halted = False
        self.pause_requested = False
        self.pump_lock = threading.Lock()
        # the thread inside `_commit` (in process, the controller's ONLINE
        # publish runs the handoff on it), and set when `_commit` returns
        self._commit_thread: Optional[int] = None
        self._commit_done = threading.Event()
        # which lane the last pump took: "blocks" | "columnar-array" |
        # "columnar" | "spliced" | "raw" | "batch" | "row" | None
        self.last_decode_path: Optional[str] = None

    def _connect(self) -> bool:
        """Make the stream consumer; False where the topic or the broker is
        not there yet (the next pump tries again)."""
        try:
            self.consumer = self._factory.create_consumer(self.table_cfg.stream.topic,
                                                          self.partition)
        except (KeyError, OSError):
            return False
        return True

    # -- consume loop --------------------------------------------------------
    def pump(self, max_messages: Optional[int] = None) -> int:
        """Fetch, decode and index one batch of at most `max_messages`
        messages (the stream property `realtime.ingest.batch.size` by
        default); returns the rows indexed (the reference's consumeLoop, one
        iteration). Nothing is fetched once the consumer left the consuming
        states, is halted or paused; a catch-up fetches no further than its
        target. The fetch and decode run outside `pump_lock` (a stalled
        broker socket must not block the handoff); the indexing and the
        offset's publish hold it, and drop the batch where the consumer was
        halted or another pump indexed the range meanwhile."""
        if self.halted or self.pause_requested or self.state not in _CONSUMING_STATES:
            return 0
        if self.consumer is None and not self._connect():
            return 0
        limit = max_messages if max_messages is not None else self._batch_size
        if self.catchup_target is not None:
            limit = min(limit, self.catchup_target - self.offset)
            if limit <= 0:
                return 0
        fetch_from = self.offset
        lane, payload, next_offset, messages = self._fetch(fetch_from, limit)
        tc = self.table_cfg.time_column
        indexed = fetched = 0
        max_event: Optional[float] = None
        with self.pump_lock:
            if self.halted or self.offset != fetch_from:
                return 0
            if lane == "blocks":
                # arrays index directly unless the table configures a filter
                # or transforms, or the segment appends rows: then each block
                # goes through the pipeline as lists
                direct = hasattr(self.mutable, "index_arrays") and \
                    self.pipeline.filter_expr is None and not self.pipeline.column_transforms
                for cb in payload:
                    fetched += cb.n
                    ev = cb.max_of(tc) if tc else None
                    if ev is not None and (max_event is None or ev > max_event):
                        max_event = ev
                    if direct:
                        indexed += self.mutable.index_arrays(cb)
                    else:
                        indexed += self._index_columns(
                            self.pipeline.apply(cb.to_lists(self.schema)))
            elif lane == "columnar-array":
                fetched = payload.n
                max_event = payload.max_of(tc) if tc else None
                indexed = self.mutable.index_arrays(payload)
            elif lane == "columnar":
                fetched = len(next(iter(payload.values()))) if payload else 0
                max_event = _max_column_value(payload.get(tc)) if tc else None
                indexed = self._index_columns(payload)
            elif lane == "row":
                if payload:
                    fetched = len(payload)
                    max_event = _max_event_time(payload, tc)
                    for row, msg in zip(self.pipeline.apply_rows(payload), messages):
                        if row is not None and self._index_row(row, msg.offset):
                            indexed += 1
            elif payload:   # decoded rows: "spliced", "raw" or "batch"
                fetched = len(payload)
                max_event = _max_event_time(payload, tc)
                indexed = self._index_columns(self.pipeline.apply(rows_to_all_columns(payload)))
            if fetched:
                self.last_decode_path = lane
            self.offset = next_offset
        self.lag.on_batch(fetched, indexed, max_event)
        return indexed

    def _fetch(self, fetch_from: int, limit: int):
        """One fetch and its decode, outside `pump_lock`: (lane, payload,
        next offset, messages). The payload is a list of `ColumnarBatch`es
        ("blocks"), one `ColumnarBatch` ("columnar-array"), coerced column
        lists ("columnar") or decoded rows (the others); `messages` are the
        fetched messages of the per-row lane, whose rows need their offsets."""
        consumer = self.consumer
        if self.block_decoder is not None:
            blocks, next_offset = self._fetch_blocks(fetch_from, limit)
            return "blocks", blocks, next_offset, None
        per_row = self.upsert is not None or self.dedup is not None
        fetch_spliced = getattr(consumer, "fetch_spliced", None)
        spliced = getattr(self.batch_decoder, "spliced", None)
        if not per_row and fetch_spliced is not None and spliced is not None:
            prefix, sep, suffix, parse = spliced
            data, n, next_offset = fetch_spliced(fetch_from, limit, sep=sep)
            if n == 0:
                return "spliced", [], next_offset, None
            if self.table_cfg.stream.decoder == "json" and self.pipeline.filter_expr is None \
                    and not self.pipeline.column_transforms:
                # one native walk straight to typed arrays where the segment
                # appends arrays, else to coerced column lists
                if hasattr(self.mutable, "index_arrays"):
                    try:
                        cbatch = columnar_batch_from_json(data, n, self.schema)
                    except (ValueError, TypeError):
                        cbatch = None
                    if cbatch is not None:
                        return "columnar-array", cbatch, next_offset, None
                try:
                    cols = columns_from_spliced_json(data, n, self.schema)
                except (ValueError, TypeError):
                    cols = None
                if cols is not None:
                    return "columnar", cols, next_offset, None
            try:
                rows = parse(prefix + data + suffix)
            except ValueError:   # a malformed member: the raw lane isolates it
                rows = None
            # a value holding top-level separators gives another count than
            # the transport's: the raw lane below decodes message by message
            if rows is not None and len(rows) == n:
                return "spliced", rows, next_offset, None
        fetch_raw = getattr(consumer, "fetch_raw", None)
        if not per_row and fetch_raw is not None:
            values, next_offset = fetch_raw(fetch_from, limit)
            return "raw", self._decode_batch(values) if values else [], next_offset, None
        batch = consumer.fetch(fetch_from, limit)
        values = [m.value for m in batch.messages]
        if per_row:
            return "row", [self.decoder(v) for v in values], batch.next_offset, batch.messages
        return "batch", self._decode_batch(values) if values else [], batch.next_offset, None

    def _fetch_blocks(self, fetch_from: int, limit: int):
        """One fetch of a block stream, decoded: (ColumnarBatches, next
        offset). A splicing consumer hands one buffer of joined blocks, walked
        with no copy per block; else the raw values, else the messages."""
        bd = self.block_decoder
        fetch_spliced = getattr(self.consumer, "fetch_spliced", None)
        if fetch_spliced is not None:
            data, n, next_offset = fetch_spliced(fetch_from, limit, sep=bd.sep)
            return (bd.decode_spliced(data, n) if n else []), next_offset
        fetch_raw = getattr(self.consumer, "fetch_raw", None)
        if fetch_raw is not None:
            values, next_offset = fetch_raw(fetch_from, limit)
            return [bd.decode_one(v) for v in values], next_offset
        batch = self.consumer.fetch(fetch_from, limit)
        return [bd.decode_one(m.value) for m in batch.messages], batch.next_offset

    def _decode_batch(self, values: List[Any]) -> List[Dict[str, Any]]:
        """A fetch's rows: one call of the batch decoder where the stream has
        one. Where that call fails or gives another number of rows than
        messages, the row decoder decodes each message, so that a malformed
        one raises alone (the JAX package's consumer does the same)."""
        if self.batch_decoder is not None:
            try:
                rows = self.batch_decoder(values)
            except ValueError:   # a malformed member: isolated below
                rows = None
            if rows is not None and len(rows) == len(values):
                return rows
        return [self.decoder(v) for v in values]

    def _index_columns(self, cols: Dict[str, list]) -> int:
        """Append a batch the transform pipeline coerced."""
        if isinstance(self.mutable, MutableSegment):
            return self.mutable.index_batch(cols, coerced=True)
        return self.mutable.index_batch(cols)

    def _index_row(self, row: Dict[str, Any], msg_offset: int) -> bool:
        """Index one row with the dedup and upsert hooks (the reference's
        MutableSegmentImpl.index hooks); False when dedup drops it. A row
        that `add_record` rejects (older than its key's live row) is still
        indexed, and stays invisible."""
        pk_cols = self.schema.primary_key_columns
        pk = tuple(row.get(c) for c in pk_cols) if pk_cols else None

        if self.dedup is not None and pk is not None:
            if not self.dedup.check_and_add(pk):
                return False

        if self.upsert is not None and pk is not None:
            up_cfg = self.table_cfg.upsert
            if up_cfg and up_cfg.mode == "PARTIAL":
                prev = self.partial_rows.get(pk)
                if prev is not None:
                    merged = dict(prev)
                    for col, val in row.items():
                        if col in pk_cols:
                            continue
                        strategy = up_cfg.partial_strategies.get(col, "OVERWRITE")
                        merged[col] = merge_partial(strategy, prev.get(col), val)
                    row = merged
                self.partial_rows[pk] = dict(row)
            cmp_val = (row.get(up_cfg.comparison_column)
                       if up_cfg and up_cfg.comparison_column else msg_offset)
            doc_id = self.mutable.num_docs
            self.mutable.index(row)
            self.upsert.partition(self.partition).add_record(
                self.segment_name, doc_id, pk, cmp_val)
            return True

        self.mutable.index(row)
        return True

    def query_segment(self):
        """The segment queries run against: a chunked segment's view frozen at
        its current row count (cached per row count), or the row-append
        segment itself."""
        qv = getattr(self.mutable, "query_view", None)
        return qv() if qv is not None else self.mutable

    def freshness_time_ms(self) -> int:
        """Epoch ms of the freshest data this consumer serves (behind the
        broker's minConsumingFreshnessTimeMs): the largest event time
        indexed, else the last fetch's wall time, else when it started."""
        lt = self.lag.last_event_time_ms or self.lag.last_consumed_ms
        return int(lt if lt is not None else self.start_consume_time * 1000)

    def lag_status(self, export: bool = True) -> Dict[str, Any]:
        """This consuming segment's lag snapshot (a consumingSegmentsInfo
        row); also sets the partition's `pinot_server_realtime_*` gauges
        unless `export` is False."""
        latest = None
        consumer = self.consumer
        if consumer is not None:
            try:
                latest = int(consumer.latest_offset())
            except Exception:   # the stream's probe failed or has none: lag unknown
                latest = None
        offset_lag = max(latest - self.offset, 0) if latest is not None else None
        fresh = self.freshness_time_ms()
        freshness_lag = max(int(time.time() * 1000) - fresh, 0)
        st = {"segment": self.segment_name, "partition": self.partition,
              "state": self.state, "paused": self.pause_requested,
              "currentOffset": self.offset, "latestStreamOffset": latest,
              "offsetLag": offset_lag, "freshnessTimeMs": fresh,
              "freshnessLagMs": freshness_lag,
              "rowsPerSecond": round(self.lag.rows_per_s, 3),
              "rowsIndexed": self.lag.rows_indexed,
              "rowsFiltered": self.lag.rows_filtered,
              "consumeErrors": self.lag.errors,
              "lastConsumedMs": self.lag.last_consumed_ms,
              "numDocs": self.mutable.num_docs}
        if export:
            reg = get_registry()
            labels = {"table": self.table_cfg.name, "partition": str(self.partition)}
            if offset_lag is not None:
                reg.gauge(_LAG_GAUGES[0], labels).set(offset_lag)
            reg.gauge(_LAG_GAUGES[1], labels).set(freshness_lag)
            reg.gauge(_LAG_GAUGES[2], labels).set(self.lag.rows_per_s)
            reg.gauge(_LAG_GAUGES[3], labels).set(self.lag.last_consumed_ms or 0)
        return st

    def close(self) -> None:
        """Halt pumping and release the stream connection (idempotent)."""
        self.halted = True
        consumer = self.consumer
        if consumer is not None:
            consumer.close()

    def end_criteria_reached(self) -> bool:
        """The flush thresholds (the reference's realtime.segment.flush.*)."""
        stream_cfg = self.table_cfg.stream
        if self.mutable.num_docs >= stream_cfg.flush_threshold_rows:
            return True
        return (time.time() - self.start_consume_time >= stream_cfg.flush_threshold_seconds
                and self.mutable.num_docs > 0)

    # -- completion protocol (the reference's PartitionConsumer postConsume) --
    def maybe_complete(self) -> str:
        """One protocol round trip once the thresholds are reached (or a
        pause request finds rows held, or a catch-up is under way); returns
        the consumer's state. HOLD parks it, CATCHUP sets the offset to
        consume to, COMMIT builds and commits, KEEP and DISCARD end it."""
        if self.state in (COMMITTED, DISCARDED, RETAINED, ERROR):
            return self.state
        force = self.pause_requested and self.mutable.num_docs > 0
        if not force and not self.end_criteria_reached() and self.catchup_target is None:
            return self.state
        if self.completion is None:
            raise RuntimeError(f"{self.segment_name} reached its flush threshold with no "
                               "completion endpoint to report to")
        resp = self.completion.segment_consumed(self.segment_name, self.server_id,
                                                self.offset)
        status = resp["status"]
        if status == "HOLD":
            self.state = HOLDING
        elif status == "CATCHUP":
            self.state = CATCHING_UP
            self.catchup_target = int(resp["offset"])
        elif status == "COMMIT":
            self._commit()
        elif status == "KEEP":
            self.state = RETAINED
        elif status == "DISCARD":
            self.state = DISCARDED
        else:
            self.state = ERROR
        return self.state

    def _commit(self) -> None:
        """commitStart, the immutable build, commitEnd (the reference's
        buildSegmentForCommit and commitSegment)."""
        self.state = COMMITTING
        # in process the controller's ONLINE publish runs this server's
        # handoff on this thread, inside commitEnd: the marker lets it adopt
        # its own commit's build instead of waiting for a state that cannot
        # change before this call returns
        self._commit_thread = threading.get_ident()
        try:
            if self.completion.segment_commit_start(self.segment_name,
                                                    self.server_id) != "COMMIT_CONTINUE":
                self.state = ERROR
                return
            seg_dir = self.build_immutable()
            resp = self.completion.segment_commit_end(self.segment_name, self.server_id,
                                                      seg_dir, self.offset)
            self.state = COMMITTED if resp == "COMMIT_SUCCESS" else ERROR
        except BaseException:
            self.state = ERROR
            raise
        finally:
            self._commit_thread = None
            self._commit_done.set()

    def build_immutable(self) -> str:
        """Write the consuming segment as an immutable segment directory (the
        reference's RealtimeSegmentConverter), with the table's indexing
        config, from the chunked store's column arrays or the row-append
        store's column lists (None at null rows); returns the directory."""
        snap_arrays = getattr(self.mutable, "snapshot_arrays", None)
        columns = snap_arrays() if snap_arrays is not None else self.mutable.snapshot_columns()
        return SegmentBuilder(self.schema, SegmentGeneratorConfig.from_indexing(
            self.table_cfg.indexing)).build(
            columns, os.path.join(self.data_dir, "realtime_build"), self.segment_name)


def _max_column_value(values: Optional[List[Any]]) -> Optional[float]:
    """The largest non-null value of a coerced column list, None without one
    or where the values are not numbers."""
    try:
        best = max((v for v in values or () if v is not None), default=None)
        return float(best) if best is not None else None
    except (TypeError, ValueError):
        return None


def _max_event_time(rows: List[Dict[str, Any]], tc: Optional[str]) -> Optional[float]:
    """The largest value of the time column `tc` in decoded rows, None
    without one or where the values are not numbers."""
    if not tc:
        return None
    try:
        vals = [r.get(tc) for r in rows]
        best = max((v for v in vals if v is not None), default=None)
        return float(best) if best is not None else None
    except (TypeError, ValueError):
        return None


class RealtimeTableManager:
    """One server's realtime side of one table (the reference's
    RealtimeTableDataManager). `server` gives `catalog`, `instance_id`,
    `data_dir` and `executor` (whose device the consumers stage on)."""

    def __init__(self, server, table: str, table_cfg: TableConfig, completion):
        self.server = server
        self.table = table
        self.table_cfg = table_cfg
        self.completion = completion
        self.consumers: Dict[str, RealtimePartitionConsumer] = {}
        self._lock = threading.RLock()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._pump_pool = None   # per-partition pump lanes, made by the first pump_all
        self.upsert = TableUpsertMetadataManager() if table_cfg.upsert else None
        self._dedup: Dict[int, PartitionDedupMetadataManager] = {}
        self.partial_rows: Dict[tuple, dict] = {}
        # segment -> COMMIT | KEEP | DISCARD: how each handoff went here
        self.handoffs: Dict[str, str] = {}
        # consumer -> the queries reading its view; a consumer dropped while
        # read keeps its device memory until the last of them is done (a
        # query that found the view's block gone would stage it again)
        self._readers: Dict[RealtimePartitionConsumer, int] = {}
        self._release_after_read: set = set()
        # a table paused before this manager existed stays paused
        self._paused = bool(server.catalog.get_property(f"pause/{table}"))

    def start_consuming(self, segment_name: str) -> None:
        """A consumer for a CONSUMING assignment, from the segment's start
        offset (ServerNode.reconcile calls it)."""
        with self._lock:
            if segment_name in self.consumers:
                return
            with self.server.catalog._lock:
                meta = self.server.catalog.segments.get(self.table, {}).get(segment_name)
            start_offset = int(meta.start_offset) if meta and meta.start_offset else 0
            partition = parse_llc_name(segment_name)["partition"]
            dedup = None
            if self.table_cfg.dedup_enabled:
                dedup = self._dedup.setdefault(partition, PartitionDedupMetadataManager())
            consumer = RealtimePartitionConsumer(
                segment_name, self.table_cfg, self.server.catalog.schema_for_table(self.table),
                start_offset, self.server.data_dir, completion=self.completion,
                device=self.server.executor.device, upsert=self.upsert, dedup=dedup,
                partial_rows=self.partial_rows, server_id=self.server.instance_id)
            consumer.pause_requested = self._paused
            self.consumers[segment_name] = consumer

    def stop_consuming(self, segment_name: str) -> Optional[RealtimePartitionConsumer]:
        """Drop a consumer whose segment left this server's ideal state."""
        with self._lock:
            consumer = self.consumers.pop(segment_name, None)
        if consumer is not None:
            consumer.close()
            # the partition's series goes with its consumer (a successor's
            # next snapshot sets it again)
            self._remove_lag_gauges([consumer])
            self._release_device(consumer)
        return consumer

    def retire_consumer(self, segment_name: str) -> None:
        """The handoff's second half: drop the consumer once the immutable
        copy is registered. Until then its buffer answers queries, so the
        segment is never unserved in between."""
        with self._lock:
            consumer = self.consumers.pop(segment_name, None)
        if consumer is not None:
            self._release_device(consumer)

    def _release_device(self, consumer: RealtimePartitionConsumer) -> None:
        """Free a dropped consumer's staged chunks and view block (a chunked
        segment's; the row-append segment holds nothing on the device), now
        or, while queries read its view, when the last of them is done."""
        with self._lock:
            if self._readers.get(consumer):
                self._release_after_read.add(consumer)
                return
        release = getattr(consumer.mutable, "release_device", None)
        if release is not None:
            release()

    # -- the CONSUMING -> ONLINE handoff -------------------------------------
    def on_segment_online(self, segment_name: str) -> Optional[str]:
        """This replica's CONSUMING -> ONLINE (the reference's
        onBecomeOnlineFromConsuming): the directory of the local build where
        this server committed the segment or consumed exactly to its end
        offset (KEEP), else None: the caller downloads the committed copy
        (DISCARD). The consumer stays registered, answering queries, until
        the caller calls `retire_consumer`."""
        with self._lock:
            consumer = self.consumers.get(segment_name)
        if consumer is None:
            return None
        # the committer arrives here inside its own commitEnd (in process the
        # publish runs on its thread): it adopts the build it just made. A
        # commit on another thread is waited for briefly; past that the
        # download is merely wasteful, never wrong
        own_commit = consumer._commit_thread == threading.get_ident()
        if not own_commit and consumer.state == COMMITTING:
            consumer._commit_done.wait(2.0)
        # fence the pumps out before reading the offset; the stream
        # connection is done either way
        consumer.halted = True
        decision, local = DISCARD, None
        try:
            with consumer.pump_lock:
                if consumer.state == COMMITTED or (own_commit and consumer.state == COMMITTING):
                    seg_dir = os.path.join(consumer.data_dir, "realtime_build", segment_name)
                    if os.path.isdir(seg_dir):
                        decision, local = COMMIT, seg_dir
                elif consumer.state in (*_CONSUMING_STATES, RETAINED):
                    with self.server.catalog._lock:
                        meta = self.server.catalog.segments.get(self.table, {}).get(segment_name)
                    if meta is not None and meta.end_offset is not None \
                            and consumer.offset == int(meta.end_offset):
                        decision, local = KEEP, consumer.build_immutable()
        finally:
            consumer.close()
        with self._lock:
            self.handoffs[segment_name] = decision
        return local

    # -- queries ---------------------------------------------------------------
    def consuming_results(self, ctx: QueryContext,
                          segment_names: Optional[Sequence[str]] = None,
                          exclude: Sequence[str] = ()
                          ) -> Tuple[List[SegmentResult], List[str]]:
        """(results, served names), both from one snapshot taken under the
        manager's lock, so that the served list names exactly what the
        results count: decided apart, a commit landing in between would let
        the broker retry a counted segment or drop an uncounted one.

        A COMMITTED consumer answers from its buffer until `retire_consumer`;
        `exclude` (the segments the caller answered immutably in this query)
        keeps such a segment from counting twice. A DISCARDED consumer is not
        served: its rows lost the commit race."""
        with self._lock:
            snapshot = [(name, c) for name, c in self.consumers.items()
                        if (segment_names is None or name in segment_names)
                        and c.state != DISCARDED and name not in exclude]
            # the views freeze under the lock too: a handoff cannot retire a
            # consumer between the snapshot and its view
            views = [(name, c.query_segment()) for name, c in snapshot]
            for _, c in snapshot:
                self._readers[c] = self._readers.get(c, 0) + 1
        try:
            out = []
            for name, seg in views:
                if seg.num_docs > 0:
                    valid = self.upsert.valid_mask(name, seg.num_docs) if self.upsert else None
                    out.append(self.server.executor.execute_segment(ctx, seg, valid))
        finally:
            done = []
            with self._lock:
                for _, c in snapshot:
                    left = self._readers.pop(c) - 1
                    if left:
                        self._readers[c] = left
                    elif c in self._release_after_read:
                        self._release_after_read.discard(c)
                        done.append(c)
            for c in done:
                self._release_device(c)
        return out, [name for name, _ in views]

    def consumer_status(self) -> Dict[str, Dict[str, Any]]:
        """Each consumer's state, offset, rows and last decode lane (a server
        process's `/debug` reports it)."""
        with self._lock:
            consumers = list(self.consumers.items())
        return {name: {"state": c.state, "offset": c.offset, "numDocs": c.mutable.num_docs,
                       "lastDecodePath": c.last_decode_path}
                for name, c in consumers}

    def ingestion_status(self) -> Dict[str, Any]:
        """The table's rollup of its consumers' lag snapshots (which export
        their gauges), with the worst numbers the controller's verdict reads."""
        with self._lock:
            consumers = list(self.consumers.items())
        segs = {name: c.lag_status() for name, c in consumers}
        offset_lags = [s["offsetLag"] for s in segs.values() if s["offsetLag"] is not None]
        return {
            "table": self.table,
            "paused": self._paused,
            "numConsumingSegments": len(segs),
            "maxOffsetLag": max(offset_lags) if offset_lags else 0,
            "maxFreshnessLagMs": max((s["freshnessLagMs"] for s in segs.values()), default=0),
            "totalRowsPerSecond": round(sum(s["rowsPerSecond"] for s in segs.values()), 3),
            "errorSegments": sorted(n for n, s in segs.items() if s["state"] == ERROR),
            "segments": segs,
        }

    def _remove_lag_gauges(self, consumers: Sequence[RealtimePartitionConsumer]) -> None:
        """Drop these consumers' partitions' lag series."""
        reg = get_registry()
        for c in consumers:
            labels = {"table": self.table_cfg.name, "partition": str(c.partition)}
            for g in _LAG_GAUGES:
                reg.remove_gauge(g, labels)

    def min_freshness_ms(self, segment_names: Sequence[str]) -> Optional[int]:
        """The oldest freshness among the named consumers (this server's
        part of minConsumingFreshnessTimeMs)."""
        with self._lock:
            consumers = [c for n, c in self.consumers.items() if n in segment_names]
        if not consumers:
            return None
        return min(c.freshness_time_ms() for c in consumers)

    # -- driving: deterministic (pump_all, complete_all) or a background loop --
    def pump_all(self, max_messages: Optional[int] = None) -> int:
        """Pump every consumer once; a table of several partitions pumps them
        at once on the manager's pool (each has its own pump lock)."""
        with self._lock:
            consumers = list(self.consumers.values())
        if not consumers:
            return 0
        if len(consumers) == 1:
            return self._pump_one(consumers[0], max_messages)
        pool = self._pump_pool
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix=f"pump-{self.table}")
            self._pump_pool = pool
        futures = [pool.submit(self._pump_one, c, max_messages) for c in consumers]
        return sum(f.result(timeout=60.0) for f in futures)

    @staticmethod
    def _pump_one(c: RealtimePartitionConsumer, max_messages: Optional[int]) -> int:
        """One consumer's pump; an error is counted on its tracker, then raised."""
        try:
            return c.pump(max_messages)
        except Exception:
            c.lag.on_error()
            raise

    def complete_all(self) -> Dict[str, str]:
        """One completion round of every consumer: segment -> its state."""
        with self._lock:
            consumers = list(self.consumers.items())
        return {name: c.maybe_complete() for name, c in consumers}

    def set_paused(self, paused: bool) -> None:
        """The controller's pause or resume: paused consumers stop fetching,
        and those holding rows commit at their next completion round."""
        with self._lock:
            self._paused = paused
            for c in self.consumers.values():
                c.pause_requested = paused

    def start_loop(self, interval_s: float = 0.1) -> None:
        """Pump and complete in a background thread until `stop`; an error
        is counted and backed off exponentially (at most 5 s)."""
        def loop():
            errors = 0
            while not self._stop.is_set():
                try:
                    self.pump_all()
                    self.complete_all()
                    errors = 0
                except Exception:   # counted, then retried after the backoff
                    errors += 1
                    get_registry().counter("pinot_server_consume_errors",
                                           {"table": self.table}).inc()
                    self._stop.wait(min(interval_s * (2 ** min(errors, 6)), 5.0))
                self._stop.wait(interval_s)
        t = threading.Thread(target=loop, daemon=True,
                             name=f"consume-{self.server.instance_id}-{self.table}")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        """Stop the loop and the pool, and drop every consumer with its
        device memory and its lag gauges."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        pool, self._pump_pool = self._pump_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        with self._lock:
            consumers = list(self.consumers.values())
            self.consumers.clear()
        for c in consumers:
            c.close()
            self._release_device(c)
        self._remove_lag_gauges(consumers)
