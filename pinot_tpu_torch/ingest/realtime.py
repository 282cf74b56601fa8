"""Server-side realtime consumption: one consumer per stream partition.

Counterpart of `RealtimePartitionConsumer` in `pinot_tpu/ingest/realtime.py`
(the analog of the reference's `LLRealtimeSegmentDataManager`): `pump()`
fetches a batch from the partition, decodes it and indexes it into a
`DeviceMutableSegment`; `query_segment()` gives the frozen view queries run
against; `end_criteria_reached()` applies the flush thresholds and
`build_immutable()` writes the consuming segment as an immutable one.

Two decode lanes, as in the JAX package:
* a columnar block stream (decoder "columnar"): each message is a PCB1 block,
  decoded to a `ColumnarBatch` and appended with `index_arrays`
  (`last_decode_path` "blocks");
* a JSON row stream: the batch's messages decoded, coerced by the transform
  pipeline and appended column by column with `index_batch` ("batch").

With the stream property `realtime.ingest.device.staging=true` the consuming
segment stages its numeric chunks on `device` (CUDA unless the caller names
another) and its views run on the device path.

Not ported: the completion protocol with the controller (`maybe_complete`
raises NotImplementedError once the flush thresholds are reached),
`RealtimeTableManager`, upsert and dedup, the row-append `MutableSegment`
(every consumer here indexes into a `DeviceMutableSegment`; a table whose
indexing config names text or inverted index columns, which need it, raises
ValueError), and the socket
broker's splicing fetch. The stream properties `filterExpr` and
`columnTransforms` configure the `TransformPipeline`: with either, a block
lane's batches go through it as column lists before they are indexed.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ..segment.mutable_device import ConsumingView, DeviceMutableSegment
from ..segment.writer import SegmentBuilder, SegmentGeneratorConfig
from ..table import TableConfig
from .stream import MemoryStreamConsumer, get_decoder
from .transform import TransformPipeline, rows_to_all_columns
from .vectorized import ColumnarBlockDecoder

#: messages one `pump()` fetches unless the caller names another count
MAX_PUMP_MESSAGES = 10_000


def parse_llc_name(name: str) -> dict:
    """`<table>__<partition>__<sequence>__<time>` -> its parts (the
    reference's LLCSegmentName)."""
    parts = name.split("__")
    return {"table": parts[0], "partition": int(parts[1]), "sequence": int(parts[2])}


class RealtimePartitionConsumer:
    """One consuming segment of one stream partition. One thread pumps; any
    number of threads may query the segment meanwhile."""

    def __init__(self, segment_name: str, table_cfg: TableConfig, schema,
                 start_offset: int, data_dir: str, completion=None, device=None):
        self.segment_name = segment_name
        self.table_cfg = table_cfg
        self.schema = schema
        self.completion = completion
        self.data_dir = data_dir
        stream_cfg = table_cfg.stream
        props = stream_cfg.properties or {}
        staging = str(props.get("realtime.ingest.device.staging", "false")).lower() == "true"
        self.mutable = DeviceMutableSegment(
            segment_name, schema, device_staging=staging, device=device,
            text_index_columns=table_cfg.indexing.text_index_columns,
            inverted_index_columns=table_cfg.indexing.inverted_index_columns)
        self.pipeline = TransformPipeline(schema, props.get("filterExpr"),
                                          props.get("columnTransforms"))
        self.partition = parse_llc_name(segment_name)["partition"]
        self.consumer = MemoryStreamConsumer(stream_cfg.topic, self.partition)
        # a columnar stream decodes whole blocks; any other decodes rows
        self.block_decoder = None
        self.decoder = None
        if stream_cfg.decoder == "columnar":
            self.block_decoder = ColumnarBlockDecoder()
        else:
            self.decoder = get_decoder(stream_cfg.decoder)
        self.offset = start_offset
        self.start_consume_time = time.time()
        # which lane the last pump took: "blocks" | "batch" | None
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
            # transforms: then each block goes through the pipeline as lists
            direct = self.pipeline.filter_expr is None and not self.pipeline.column_transforms
            for m in batch.messages:
                cb = self.block_decoder.decode_one(m.value)
                if direct:
                    indexed += self.mutable.index_arrays(cb)
                else:
                    indexed += self.mutable.index_batch(
                        self.pipeline.apply(cb.to_lists(self.schema)))
        elif batch.messages:
            self.last_decode_path = "batch"
            rows = [self.decoder(m.value) for m in batch.messages]
            indexed = self.mutable.index_batch(
                self.pipeline.apply(rows_to_all_columns(rows)))
        self.offset = batch.next_offset
        return indexed

    def query_segment(self) -> ConsumingView:
        """The segment queries run against: the consuming segment frozen at
        its current row count (cached per row count)."""
        return self.mutable.query_view()

    def end_criteria_reached(self) -> bool:
        """The flush thresholds (the reference's realtime.segment.flush.*)."""
        stream_cfg = self.table_cfg.stream
        if self.mutable.num_docs >= stream_cfg.flush_threshold_rows:
            return True
        return (time.time() - self.start_consume_time >= stream_cfg.flush_threshold_seconds
                and self.mutable.num_docs > 0)

    def maybe_complete(self) -> None:
        """The completion protocol's round trip once the thresholds are
        reached: nothing to do before then. It needs the controller, which is
        not ported."""
        if not self.end_criteria_reached():
            return
        raise NotImplementedError(
            f"{self.segment_name} reached its flush threshold: the segment completion "
            "protocol (controller and server roles) is not ported to pinot_tpu_torch; "
            "build_immutable() writes the segment")

    def build_immutable(self) -> str:
        """Write the consuming segment as an immutable segment directory from
        its column arrays (the reference's RealtimeSegmentConverter), with the
        table's indexing config; returns the directory."""
        return SegmentBuilder(self.schema, SegmentGeneratorConfig.from_indexing(
            self.table_cfg.indexing)).build(
            self.mutable.snapshot_arrays(), os.path.join(self.data_dir, "realtime_build"),
            self.segment_name)
