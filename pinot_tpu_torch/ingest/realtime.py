"""Server-side realtime consumption: one consumer per stream partition.

Counterpart of `RealtimePartitionConsumer` in `pinot_tpu/ingest/realtime.py`
(the analog of the reference's `LLRealtimeSegmentDataManager`): `pump()`
fetches a batch from the partition, decodes it and indexes it into the
consuming segment; `query_segment()` gives the segment queries run against;
`end_criteria_reached()` applies the flush thresholds and `build_immutable()`
writes the consuming segment as an immutable one.

The consuming segment's class, as the JAX package chooses it: the chunked
`DeviceMutableSegment`, unless the table has upsert or dedup, names text or
inverted index columns, or sets the stream property
`realtime.ingest.vectorized=false`; then the row-append `MutableSegment`
(`segment/mutable.py`), which keeps the realtime indexes and indexes row by
row.

Three decode lanes, as in the JAX package:
* a columnar block stream (a decoder `stream.get_block_decoder` knows:
  "columnar"): each message is a PCB1 block, decoded to a `ColumnarBatch` and
  appended with `index_arrays` (`last_decode_path` "blocks"); a table with
  upsert or dedup cannot take it;
* a row stream (JSON, Avro, or a registered Protobuf or Thrift decoder,
  `stream.get_decoder`): the batch's messages decoded (in one call of the
  stream's batch decoder where one is registered, `stream.get_batch_decoder`:
  JSON's), coerced by the transform pipeline and appended column by column
  with `index_batch` ("batch");
* the per-row lane of an upsert or dedup table ("row"): the batch's messages
  decoded and transformed (`TransformPipeline.apply_rows`: the rows
  `apply_row` gives one at a time), then `_index_row` row by row in arrival
  order: the dedup check, the partial-upsert merge, the append and
  `add_record` into the table's upsert metadata (the comparison value is the
  `comparisonColumn`'s, else the message offset).

With the stream property `realtime.ingest.device.staging=true` a chunked
consuming segment stages its numeric chunks on `device` (CUDA unless the
caller names another) and its views run on the device path. A row-append
segment runs on the host, as the JAX planner routes it.

Not ported: the completion protocol with the controller (`maybe_complete`
raises NotImplementedError once the flush thresholds are reached),
`RealtimeTableManager` (a caller that commits builds the segment, loads it
and starts the next consumer with the same upsert manager), and the socket
broker's splicing fetch. The stream properties `filterExpr` and
`columnTransforms` configure the `TransformPipeline`: with either, a block
lane's batches go through it as column lists before they are indexed.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from ..segment.mutable import MutableSegment
from ..segment.mutable_device import DeviceMutableSegment
from ..segment.writer import SegmentBuilder, SegmentGeneratorConfig
from ..table import TableConfig
from ..upsert import merge_partial
from .stream import MemoryStreamConsumer, get_batch_decoder, get_block_decoder, get_decoder
from .transform import TransformPipeline, rows_to_all_columns

#: messages one `pump()` fetches unless the caller names another count
MAX_PUMP_MESSAGES = 10_000


def parse_llc_name(name: str) -> dict:
    """`<table>__<partition>__<sequence>__<time>` -> its parts (the
    reference's LLCSegmentName)."""
    parts = name.split("__")
    return {"table": parts[0], "partition": int(parts[1]), "sequence": int(parts[2])}


class RealtimePartitionConsumer:
    """One consuming segment of one stream partition. One thread pumps; any
    number of threads may query the segment meanwhile.

    `upsert` is the table's `upsert.TableUpsertMetadataManager` (shared by
    every consumer of the table, and by the queries that read its masks),
    `dedup` the partition's `PartitionDedupMetadataManager`, `partial_rows`
    the table's last merged row per primary key (a PARTIAL upsert's state,
    shared like `upsert`)."""

    def __init__(self, segment_name: str, table_cfg: TableConfig, schema,
                 start_offset: int, data_dir: str, completion=None, device=None,
                 upsert=None, dedup=None, partial_rows: Optional[dict] = None):
        self.segment_name = segment_name
        self.table_cfg = table_cfg
        self.schema = schema
        self.completion = completion
        self.data_dir = data_dir
        self.upsert = upsert
        self.dedup = dedup
        self.partial_rows = partial_rows if partial_rows is not None else {}
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
        self.pipeline = TransformPipeline(schema, props.get("filterExpr"),
                                          props.get("columnTransforms"))
        self.partition = parse_llc_name(segment_name)["partition"]
        self.consumer = MemoryStreamConsumer(stream_cfg.topic, self.partition)
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
        # which lane the last pump took: "blocks" | "batch" | "row" | None
        self.last_decode_path: Optional[str] = None

    def pump(self, max_messages: int = MAX_PUMP_MESSAGES) -> int:
        """Fetch, decode and index one batch of at most `max_messages`
        messages; returns the rows indexed (the reference's consumeLoop, one
        iteration)."""
        batch = self.consumer.fetch(self.offset, max_messages)
        indexed = 0
        if self.block_decoder is not None:
            self.last_decode_path = "blocks"
            # arrays index directly unless the table configures a filter or
            # transforms, or the segment appends rows: then each block goes
            # through the pipeline as lists
            direct = hasattr(self.mutable, "index_arrays") and \
                self.pipeline.filter_expr is None and not self.pipeline.column_transforms
            for m in batch.messages:
                cb = self.block_decoder.decode_one(m.value)
                if direct:
                    indexed += self.mutable.index_arrays(cb)
                else:
                    indexed += self._index_columns(self.pipeline.apply(cb.to_lists(self.schema)))
        elif batch.messages and self.upsert is None and self.dedup is None:
            self.last_decode_path = "batch"
            rows = self._decode_batch([m.value for m in batch.messages])
            indexed = self._index_columns(self.pipeline.apply(rows_to_all_columns(rows)))
        elif batch.messages:
            self.last_decode_path = "row"
            decoded = [self.decoder(m.value) for m in batch.messages]
            for row, msg in zip(self.pipeline.apply_rows(decoded), batch.messages):
                if row is not None and self._index_row(row, msg.offset):
                    indexed += 1
        self.offset = batch.next_offset
        return indexed

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

    def end_criteria_reached(self) -> bool:
        """The flush thresholds (the reference's realtime.segment.flush.*)."""
        stream_cfg = self.table_cfg.stream
        if self.mutable.num_docs >= stream_cfg.flush_threshold_rows:
            return True
        return (time.time() - self.start_consume_time >= stream_cfg.flush_threshold_seconds
                and self.mutable.num_docs > 0)

    def maybe_complete(self) -> None:
        """The completion protocol's round trip once the thresholds are
        reached: nothing to do before then. It needs the controller's LLC
        segment manager (`cluster/completion.py`), which is not ported."""
        if not self.end_criteria_reached():
            return
        raise NotImplementedError(
            f"{self.segment_name} reached its flush threshold: the segment completion "
            "protocol (cluster/completion.py) is not ported to pinot_tpu_torch; "
            "build_immutable() writes the segment")

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
