"""Stream SPI and the in-process memory stream.

A trimmed copy of `pinot_tpu/ingest/stream.py` (the analog of the reference's
pluggable stream abstraction, `pinot-spi/.../stream/`): offsets are integers,
a consumer fetches message batches from one partition, and `MemoryStream`
plays the role of the embedded Kafka the reference uses in tests; it is the
one stream type ported, so the consumer builds `MemoryStreamConsumer`
directly (the reference's stream factory registry is not ported). Decoders:
`json` (one row per message) and, for columnar block streams, the `columnar`
block decoder (`ingest/vectorized.py`: one message carries a whole block).
The JAX package's socket broker (`kafkalite`) and its avro decoder are not
ported.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List


@dataclass(frozen=True)
class StreamMessage:
    value: Any
    offset: int


@dataclass
class MessageBatch:
    messages: List[StreamMessage]
    next_offset: int                 # offset to resume from


class MemoryStream:
    """In-process partitioned topic store shared by producers and consumers."""

    _topics: Dict[str, "MemoryStream"] = {}
    _lock = threading.RLock()

    def __init__(self, topic: str, num_partitions: int):
        self.topic = topic
        self.num_partitions = num_partitions
        self.partitions: List[List[StreamMessage]] = [[] for _ in range(num_partitions)]
        self._plock = threading.RLock()

    @classmethod
    def create(cls, topic: str, num_partitions: int) -> "MemoryStream":
        with cls._lock:
            if topic not in cls._topics:
                cls._topics[topic] = MemoryStream(topic, num_partitions)
            return cls._topics[topic]

    @classmethod
    def get(cls, topic: str) -> "MemoryStream":
        with cls._lock:
            if topic not in cls._topics:
                raise KeyError(f"unknown topic {topic!r}")
            return cls._topics[topic]

    @classmethod
    def reset_all(cls) -> None:
        with cls._lock:
            cls._topics.clear()

    def produce(self, value: Any, partition: int) -> int:
        """Append one message to `partition`; returns its offset."""
        with self._plock:
            plist = self.partitions[partition]
            msg = StreamMessage(value=value, offset=len(plist))
            plist.append(msg)
            return msg.offset


class MemoryStreamConsumer:
    """Fetches from one partition of a `MemoryStream` (the reference's
    PartitionGroupConsumer)."""

    def __init__(self, topic: str, partition: int):
        self.stream = MemoryStream.get(topic)
        self.partition = partition

    def fetch(self, start_offset: int, max_messages: int) -> MessageBatch:
        with self.stream._plock:
            msgs = self.stream.partitions[self.partition][
                start_offset:start_offset + max_messages]
        return MessageBatch(list(msgs), start_offset + len(msgs))


# -- row decoders (the reference's StreamMessageDecoder SPI) ----------------
# A "columnar" stream has no row decoder: each of its messages is a whole
# PCB1 block, which the consumer decodes with `vectorized.ColumnarBlockDecoder`.

def json_decoder(value: Any) -> Dict[str, Any]:
    if isinstance(value, (bytes, str)):
        return json.loads(value)
    return dict(value)


_DECODERS: Dict[str, Callable[[Any], Dict[str, Any]]] = {
    "json": json_decoder,
}


def get_decoder(name: str) -> Callable[[Any], Dict[str, Any]]:
    if name not in _DECODERS:
        raise NotImplementedError(f"stream decoder {name!r} is not ported to pinot_tpu_torch "
                                  f"(ported: columnar, {', '.join(sorted(_DECODERS))})")
    return _DECODERS[name]
