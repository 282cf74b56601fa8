"""Stream SPI, the stream factory registry and the in-process memory stream.

A trimmed copy of `pinot_tpu/ingest/stream.py` (the analog of the reference's
pluggable stream abstraction, `pinot-spi/.../stream/`: `PartitionGroupConsumer`,
`StreamConsumerFactory`, `StreamMetadataProvider`, `MessageBatch`): offsets are
integers, a consumer fetches message batches from one partition. A stream type
names a factory (`register_stream_factory`, `get_stream_factory`): `memory`
(`MemoryStream`, the role of the embedded Kafka the reference uses in tests),
and, each registered by its module when first asked for, `kafkalite` (the
socket log broker speaking the Kafka wire protocol, `ingest/kafkalite.py`),
`pulsar` (the broker speaking Pulsar's binary protocol,
`ingest/pulsarlite.py`) and `kinesis` (the Kinesis JSON API and its stub,
`ingest/kinesislite.py`). A consumer may offer more than `fetch`:
`fetch_raw` (the value bytes) and `fetch_spliced` (the values joined in C
with a decoder's separator), which the realtime consumer's lanes take where
the decoder can read them; and `latest_offset`, the offset the next message
will take, which the consumer's lag status reads (a stream without it, as
Kinesis, reports its offset lag as unknown).

Decoders, as in the JAX package:

* row decoders (`get_decoder`, `register_decoder`): `json`, `dict` and
  `avro` (confluent-framed, its schema id resolved against
  `avro.DEFAULT_REGISTRY`). The Protobuf and Thrift decoders are made for a
  schema (`proto.make_proto_decoder`, `thriftfmt.make_thrift_decoder`,
  `avro.make_simple_avro_decoder`) and registered under a name the table's
  `StreamConfig.decoder` gives;
* batch decoders (`get_batch_decoder`, `register_batch_decoder`): a whole
  fetch at once, `json` as one parse of the spliced messages (its `spliced`
  attribute, `(prefix, sep, suffix, parse)`, lets a splicing transport hand
  it the joined values). The consumer's batch lane decodes a fetch with the
  stream's batch decoder where one is registered, and with its row decoder
  otherwise;
* the block decoder (`get_block_decoder`): one message carries a whole
  columnar block, `columnar` (`ingest/vectorized.py`), the one block format,
  with its splice separator (`sep`) and `decode_spliced`.

A decoder or stream type that nothing registered raises NotImplementedError.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass(frozen=True)
class StreamMessage:
    value: Any
    offset: int
    key: Optional[str] = None
    timestamp_ms: int = 0


@dataclass
class MessageBatch:
    messages: List[StreamMessage]
    next_offset: int                 # offset to resume from


class PartitionGroupConsumer:
    """Fetches from one partition (the reference's PartitionGroupConsumer)."""

    def fetch(self, start_offset: int, max_messages: int, timeout_ms: int = 0) -> MessageBatch:
        raise NotImplementedError

    def latest_offset(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamMetadataProvider:
    def partition_count(self, topic: str) -> int:
        raise NotImplementedError

    def earliest_offset(self, topic: str, partition: int) -> int:
        return 0


class StreamConsumerFactory:
    """One per stream type (the reference's StreamConsumerFactory)."""

    def create_consumer(self, topic: str, partition: int) -> PartitionGroupConsumer:
        raise NotImplementedError

    def metadata_provider(self) -> StreamMetadataProvider:
        raise NotImplementedError


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


class MemoryStreamConsumer(PartitionGroupConsumer):
    """Fetches from one partition of a `MemoryStream`."""

    def __init__(self, topic: str, partition: int):
        self.stream = MemoryStream.get(topic)
        self.partition = partition

    def fetch(self, start_offset: int, max_messages: int, timeout_ms: int = 0) -> MessageBatch:
        with self.stream._plock:
            msgs = self.stream.partitions[self.partition][
                start_offset:start_offset + max_messages]
        return MessageBatch(list(msgs), start_offset + len(msgs))

    def latest_offset(self) -> int:
        with self.stream._plock:
            return len(self.stream.partitions[self.partition])


class MemoryStreamFactory(StreamConsumerFactory):
    def __init__(self, topic: str, properties: Optional[Dict[str, Any]] = None):
        self.topic = topic

    def create_consumer(self, topic: str, partition: int) -> PartitionGroupConsumer:
        return MemoryStreamConsumer(topic or self.topic, partition)

    def metadata_provider(self) -> StreamMetadataProvider:
        factory = self

        class _Meta(StreamMetadataProvider):
            def partition_count(self, topic: str) -> int:
                return MemoryStream.get(topic or factory.topic).num_partitions

        return _Meta()


# -- decoders (the reference's StreamMessageDecoder SPI) --------------------

def json_decoder(value: Any) -> Dict[str, Any]:
    if isinstance(value, (bytes, str)):
        return json.loads(value)
    return dict(value)


def passthrough_decoder(value: Any) -> Dict[str, Any]:
    return value


def avro_decoder(value: Any) -> Dict[str, Any]:
    """A confluent-framed Avro message -> row dict (the schema id resolved
    against the process-local registry, `avro.DEFAULT_REGISTRY`)."""
    from .avro import confluent_avro_decoder   # the codec loads when first used
    return confluent_avro_decoder(value)


_DECODERS: Dict[str, Callable[[Any], Dict[str, Any]]] = {
    "json": json_decoder,
    "dict": passthrough_decoder,
    "avro": avro_decoder,
}


def _json_batch_decoder(values) -> List[Dict[str, Any]]:
    """Decode a whole batch of JSON payloads with one parse, by splicing them
    into a JSON array; raises on any malformed member."""
    parts = [v if isinstance(v, bytes) else str(v).encode("utf-8") for v in values]
    return json.loads(b"[" + b",".join(parts) + b"]")


#: the spliced protocol: values a transport joined with `sep` parse as one
#: JSON array, `prefix + data + suffix`
_json_batch_decoder.spliced = (b"[", b",", b"]", json.loads)


#: batch decoders: name -> (List[raw value] -> List[row dict])
_BATCH_DECODERS: Dict[str, Callable[[List[Any]], List[Dict[str, Any]]]] = {
    "json": _json_batch_decoder,
}


def register_decoder(name: str, fn: Callable[[Any], Dict[str, Any]]) -> None:
    _DECODERS[name] = fn


def register_batch_decoder(name: str,
                           fn: Callable[[List[Any]], List[Dict[str, Any]]]) -> None:
    _BATCH_DECODERS[name] = fn


def get_batch_decoder(name: str):
    return _BATCH_DECODERS.get(name)


def get_block_decoder(name: str):
    """The block decoder of a block stream (an object with `sep`, the
    transport's one-byte splice separator, `decode_spliced(data, n)` and
    `decode_one(value) -> ColumnarBatch`), None for a row stream."""
    if name != "columnar":
        return None
    from .vectorized import ColumnarBlockDecoder   # loaded when a block stream asks
    return ColumnarBlockDecoder()


def get_decoder(name: str) -> Callable[[Any], Dict[str, Any]]:
    if name not in _DECODERS:
        raise NotImplementedError(f"no stream decoder {name!r} is registered "
                                  f"(registered: {', '.join(sorted(_DECODERS))})")
    return _DECODERS[name]


#: stream types: name -> factory class, made with (topic, properties)
_FACTORIES: Dict[str, Callable[..., StreamConsumerFactory]] = {
    "memory": MemoryStreamFactory,
}

#: stream types whose module registers them when it is imported
_LAZY_FACTORIES = {"kafkalite": ".kafkalite", "pulsar": ".pulsarlite",
                   "kinesis": ".kinesislite"}


def register_stream_factory(name: str, factory: Callable[..., StreamConsumerFactory]) -> None:
    """A stream plugin (the reference's stream type -> factory class name)."""
    _FACTORIES[name] = factory


def stream_factories() -> Dict[str, Callable[..., StreamConsumerFactory]]:
    """Every registered stream type, the lazily registered ones loaded."""
    import importlib
    for mod in _LAZY_FACTORIES.values():
        importlib.import_module(mod, __package__)
    return _FACTORIES


def get_stream_factory(stream_type: str, topic: str,
                       properties: Optional[Dict[str, Any]] = None) -> StreamConsumerFactory:
    """The factory of `stream_type` for `topic`; `properties` holds the
    plugin's connection settings (kafkalite's `bootstrap`, pulsar's
    `serviceUrl`, kinesis's `endpoint` and keys)."""
    if stream_type not in _FACTORIES:
        stream_factories()
    if stream_type not in _FACTORIES:
        raise NotImplementedError(f"no stream type {stream_type!r} is registered "
                                  f"(registered: {', '.join(sorted(_FACTORIES))})")
    return _FACTORIES[stream_type](topic, properties)
