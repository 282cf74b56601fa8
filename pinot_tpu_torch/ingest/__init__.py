"""Realtime ingestion: streams, the columnar block codec, the partition consumer.

Counterpart of `pinot_tpu/ingest/`: `realtime.RealtimePartitionConsumer`
pumps a `stream.MemoryStream` partition (PCB1 columnar blocks,
`vectorized.py`, or JSON rows) into a
`segment.mutable_device.DeviceMutableSegment`, whose `query_view()` the
executors answer over on the device. The package imports no submodule: the
consuming segment imports the codec, and the consumer the consuming segment.
"""
