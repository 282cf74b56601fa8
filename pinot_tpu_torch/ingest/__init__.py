"""Ingestion: streams, the columnar block codec, the partition consumer, and
file-based batch ingestion.

Counterpart of `pinot_tpu/ingest/`: `realtime.RealtimePartitionConsumer`
pumps a stream partition (a `stream.MemoryStream` topic, or a kafkalite one:
`kafkalite.py`, the Kafka wire protocol of `kafka_wire.py` over a socket) of
PCB1 columnar blocks (`vectorized.py`) or rows a registered decoder reads
(JSON, Avro, Protobuf, Thrift) into a `segment.mutable_device.
DeviceMutableSegment`, whose `query_view()` the executors answer over on the
device. `readers.py` reads
CSV, JSON-lines, Avro (`avro.py`), Thrift (`thriftfmt.py`), Protobuf
(`proto.py`), Parquet and ORC files into rows; `batch.py` turns files into
segments (the streaming two-pass runner and the per-file unit) and
`dataframe.py` pandas frames. The package imports no submodule: the
consuming segment imports the codec, and the consumer the consuming segment.
"""
