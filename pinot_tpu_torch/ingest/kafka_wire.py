"""Kafka binary wire protocol: the primitives, record batch v2 and the APIs the
log broker speaks (ApiVersions, Metadata, ListOffsets, Fetch, Produce, and
CreateTopics for admin).

A copy of `pinot_tpu/ingest/kafka_wire.py`; its bytes equal the JAX package's
in both directions. Non-flexible versions, from the Kafka protocol
specification: request frames are `int32 length | int16 api_key | int16
api_version | int32 correlation_id | nullable_string client_id | body`;
responses are `int32 length | int32 correlation_id | body`. Record batches are
the v2 (magic 2) format with CRC-32C over attributes..records and
zigzag-varint record fields, byte-compatible with what a stock Kafka client
produces and consumes (the reference's consumer:
`pinot-plugins/pinot-stream-ingestion/pinot-kafka-2.0/.../KafkaPartitionLevelConsumer.java`).

The CRC, the record walk and the value splice run in C (`native/`), which
builds on first use and raises where it cannot: there is no pure-Python lane.
A malformed batch raises ValueError. This module is encode and decode only;
`kafkalite.py` owns the sockets.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

# api keys (Kafka protocol numbers)
API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_API_VERSIONS = 18
API_CREATE_TOPICS = 19

# error codes
ERR_NONE = 0
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_CORRUPT_MESSAGE = 2
ERR_UNSUPPORTED_VERSION = 35

# supported version ranges advertised through ApiVersions
SUPPORTED = {
    API_PRODUCE: (3, 3),
    API_FETCH: (4, 4),
    API_LIST_OFFSETS: (1, 1),
    API_METADATA: (0, 1),
    API_API_VERSIONS: (0, 0),
    API_CREATE_TOPICS: (0, 0),
}

LATEST_TS = -1   # ListOffsets timestamp sentinel: latest
EARLIEST_TS = -2


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("kafka frame truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> str:
        return self._take(self.i16()).decode("utf-8")

    def nullable_string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode("utf-8")

    def bytes32(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self._take(n)

    def array(self, item_fn) -> Optional[list]:
        n = self.i32()
        if n < 0:
            return None
        return [item_fn() for _ in range(n)]

    def uvarint(self) -> int:
        shift = out = 0
        while True:
            b = self._take(1)[0]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def varint(self) -> int:
        u = self.uvarint()
        return (u >> 1) ^ -(u & 1)  # zigzag decode


def i8(v: int) -> bytes:
    return struct.pack(">b", v)


def i16(v: int) -> bytes:
    return struct.pack(">h", v)


def i32(v: int) -> bytes:
    return struct.pack(">i", v)


def i64(v: int) -> bytes:
    return struct.pack(">q", v)


def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return i16(len(raw)) + raw


def nullable_string(s: Optional[str]) -> bytes:
    return i16(-1) if s is None else string(s)


def bytes32(b: Optional[bytes]) -> bytes:
    return i32(-1) if b is None else i32(len(b)) + b


def array(items: Optional[List[bytes]]) -> bytes:
    if items is None:
        return i32(-1)
    return i32(len(items)) + b"".join(items)


def uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint(v: int) -> bytes:
    return uvarint((v << 1) ^ (v >> 63))  # zigzag encode (64-bit domain)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), the record batches' checksum (not zlib's CRC-32)."""
    from ..native import crc32c as _native
    return _native(data, crc)


# ---------------------------------------------------------------------------
# record batch v2 (magic = 2)
# ---------------------------------------------------------------------------

def encode_record_batch(base_offset: int,
                        records: List[Tuple[Optional[bytes], bytes, int]]) -> bytes:
    """records = [(key|None, value, timestamp_ms)] -> one v2 batch."""
    if not records:
        return b""
    first_ts = records[0][2]
    max_ts = max(r[2] for r in records)
    recs = bytearray()
    for idx, (key, value, ts) in enumerate(records):
        body = (i8(0)                          # record attributes
                + varint(ts - first_ts)        # timestampDelta
                + varint(idx)                  # offsetDelta
                + (varint(-1) if key is None
                   else varint(len(key)) + key)
                + varint(len(value)) + value
                + uvarint(0))                  # headers
        recs += varint(len(body)) + body
    crc_part = (i16(0)                          # batch attributes (no compression)
                + i32(len(records) - 1)         # lastOffsetDelta
                + i64(first_ts) + i64(max_ts)
                + i64(-1) + i16(-1) + i32(-1)   # producerId/epoch/baseSequence
                + i32(len(records)) + bytes(recs))
    inner = (i32(-1)                            # partitionLeaderEpoch
             + i8(2)                            # magic
             + u32(crc32c(crc_part)) + crc_part)
    return i64(base_offset) + i32(len(inner)) + inner


def splice_record_batches(data: bytes, min_offset: int, sep: bytes = b",",
                          max_records: int = 1 << 62):
    """All batches in a record set -> (values spliced with `sep`, count,
    last_offset), each batch's CRC verified. No per-record Python objects:
    each batch's value section splices in C and the caller runs one parse
    over the joined payload. `max_records` caps the total count exactly (a
    catch-up target depends on it)."""
    from ..native import splice_values as _native_splice
    parts: List[bytes] = []
    total = 0
    last_offset = -1
    r = Reader(data)
    while r.pos + 12 <= len(r.data):
        base_offset = r.i64()
        batch_len = r.i32()
        if r.pos + batch_len > len(r.data):
            break  # partial trailing batch (Kafka allows truncated tails)
        # the header read in place (batches are megabytes on the consume
        # path); `rest` is the one slice the CRC and the splice share
        start, end = r.pos, r.pos + batch_len
        r.pos = end
        body = Reader(data)
        body.pos = start
        body.i32()                      # partitionLeaderEpoch
        magic = body.i8()
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        crc = body.u32()
        rest = data[body.pos:end]
        if crc32c(rest) != crc:
            raise ValueError("record batch CRC mismatch")
        count = struct.unpack(">i", rest[36:40])[0]
        if total >= max_records:
            break
        spliced = _native_splice(rest[40:], base_offset,
                                 min(count, max_records - total),
                                 min_offset, sep)
        if spliced is None:
            raise ValueError(f"malformed record batch at offset {base_offset}")
        chunk, n, last = spliced
        if n:
            parts.append(chunk)
            total += n
            last_offset = max(last_offset, last)
    return sep.join(parts), total, last_offset


def decode_record_batches(data: bytes) -> List[Tuple[int, int, Optional[bytes], bytes]]:
    """All batches in a record set -> [(offset, timestamp_ms, key, value)]."""
    out: List[Tuple[int, int, Optional[bytes], bytes]] = []
    r = Reader(data)
    while r.pos + 12 <= len(r.data):
        base_offset = r.i64()
        batch_len = r.i32()
        if r.pos + batch_len > len(r.data):
            break  # partial trailing batch (Kafka allows truncated tails)
        body = Reader(r._take(batch_len))
        body.i32()                      # partitionLeaderEpoch
        magic = body.i8()
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        crc = body.u32()
        rest = body.data[body.pos:]
        if crc32c(rest) != crc:
            raise ValueError("record batch CRC mismatch")
        body.i16()                      # attributes
        body.i32()                      # lastOffsetDelta
        first_ts = body.i64()
        body.i64()                      # maxTimestamp
        body.i64(); body.i16(); body.i32()  # producer id/epoch/base seq
        count = body.i32()
        from ..native import decode_records as _native_decode
        records = _native_decode(body.data[body.pos:], base_offset, first_ts, count)
        if records is None:
            raise ValueError(f"malformed record batch at offset {base_offset}")
        out.extend(records)
    return out


# ---------------------------------------------------------------------------
# request/response framing
# ---------------------------------------------------------------------------

def encode_request(api_key: int, api_version: int, correlation_id: int,
                   client_id: Optional[str], body: bytes) -> bytes:
    payload = (i16(api_key) + i16(api_version) + i32(correlation_id)
               + nullable_string(client_id) + body)
    return i32(len(payload)) + payload


def decode_request_header(payload: bytes) -> Tuple[int, int, int, Optional[str], Reader]:
    r = Reader(payload)
    return r.i16(), r.i16(), r.i32(), r.nullable_string(), r


def encode_response(correlation_id: int, body: bytes) -> bytes:
    payload = i32(correlation_id) + body
    return i32(len(payload)) + payload


# -- per-API bodies (the versions in SUPPORTED) ------------------------------

def encode_api_versions_response() -> bytes:
    return i16(ERR_NONE) + array(
        [i16(k) + i16(lo) + i16(hi) for k, (lo, hi) in sorted(SUPPORTED.items())])


def encode_metadata_request(topics: Optional[List[str]]) -> bytes:
    return array(None if topics is None else [string(t) for t in topics])


def decode_metadata_request(r: Reader) -> Optional[List[str]]:
    return r.array(r.string)


def encode_metadata_response(version: int, host: str, port: int,
                             topics: Dict[str, int]) -> bytes:
    """One-broker cluster: node 0 is leader of every partition."""
    broker = i32(0) + string(host) + i32(port) + (nullable_string(None)
                                                  if version >= 1 else b"")
    topic_items = []
    for name, n_parts in sorted(topics.items()):
        parts = [i16(ERR_NONE) + i32(p) + i32(0)
                 + array([i32(0)]) + array([i32(0)])
                 for p in range(n_parts)]
        topic_items.append(i16(ERR_NONE) + string(name)
                           + (i8(0) if version >= 1 else b"")  # is_internal
                           + array(parts))
    return (array([broker])
            + (i32(0) if version >= 1 else b"")   # controller_id
            + array(topic_items))


def decode_metadata_response(version: int, r: Reader) -> Dict[str, Any]:
    def broker():
        node, host, port = r.i32(), r.string(), r.i32()
        rack = r.nullable_string() if version >= 1 else None
        return {"node": node, "host": host, "port": port, "rack": rack}
    brokers = r.array(broker)
    controller = r.i32() if version >= 1 else 0

    def topic():
        err, name = r.i16(), r.string()
        internal = bool(r.i8()) if version >= 1 else False

        def part():
            perr, idx, leader = r.i16(), r.i32(), r.i32()
            r.array(r.i32); r.array(r.i32)  # replicas, isr
            return {"error": perr, "partition": idx, "leader": leader}
        return {"error": err, "topic": name, "internal": internal,
                "partitions": r.array(part)}
    return {"brokers": brokers, "controller": controller,
            "topics": r.array(topic)}


def encode_list_offsets_request(topic: str, partition: int, timestamp: int) -> bytes:
    return i32(-1) + array([string(topic) + array([i32(partition) + i64(timestamp)])])


def decode_list_offsets_request(r: Reader) -> List[Tuple[str, int, int]]:
    r.i32()  # replica_id
    out = []

    def topic():
        name = r.string()

        def part():
            out.append((name, r.i32(), r.i64()))
        r.array(part)
    r.array(topic)
    return out


def encode_list_offsets_response(results: List[Tuple[str, int, int, int, int]]) -> bytes:
    """results = [(topic, partition, error, timestamp, offset)] (v1 shape)."""
    by_topic: Dict[str, List[bytes]] = {}
    for topic, part, err, ts, off in results:
        by_topic.setdefault(topic, []).append(i32(part) + i16(err) + i64(ts)
                                              + i64(off))
    return array([string(t) + array(ps) for t, ps in sorted(by_topic.items())])


def decode_list_offsets_response(r: Reader) -> List[Dict[str, Any]]:
    out = []

    def topic():
        name = r.string()

        def part():
            out.append({"topic": name, "partition": r.i32(), "error": r.i16(),
                        "timestamp": r.i64(), "offset": r.i64()})
        r.array(part)
    r.array(topic)
    return out


def encode_fetch_request(topic: str, partition: int, offset: int,
                         max_wait_ms: int, max_bytes: int) -> bytes:
    return (i32(-1) + i32(max_wait_ms) + i32(1) + i32(max_bytes) + i8(0)
            + array([string(topic)
                     + array([i32(partition) + i64(offset) + i32(max_bytes)])]))


def decode_fetch_request(r: Reader) -> Tuple[int, int, List[Tuple[str, int, int, int]]]:
    r.i32()                     # replica_id
    max_wait = r.i32()
    r.i32()                     # min_bytes
    max_bytes = r.i32()
    r.i8()                      # isolation_level
    parts = []

    def topic():
        name = r.string()

        def part():
            parts.append((name, r.i32(), r.i64(), r.i32()))
        r.array(part)
    r.array(topic)
    return max_wait, max_bytes, parts


def encode_fetch_response(
        results: List[Tuple[str, int, int, int, bytes]]) -> bytes:
    """results = [(topic, partition, error, high_watermark, record_set)]."""
    by_topic: Dict[str, List[bytes]] = {}
    for topic, part, err, hw, recs in results:
        by_topic.setdefault(topic, []).append(
            i32(part) + i16(err) + i64(hw) + i64(hw)   # last_stable = hw
            + array([])                                 # aborted transactions
            + bytes32(recs))
    return i32(0) + array([string(t) + array(ps)
                           for t, ps in sorted(by_topic.items())])


def decode_fetch_response(r: Reader, raw_records: bool = False
                          ) -> List[Dict[str, Any]]:
    """`raw_records=True` keeps each partition's record-set bytes under
    "recordSet" instead of decoding them to records (the splice's input)."""
    r.i32()  # throttle
    out = []

    def topic():
        name = r.string()

        def part():
            d = {"topic": name, "partition": r.i32(), "error": r.i16(),
                 "highWatermark": r.i64()}
            r.i64()             # last_stable_offset
            r.array(lambda: (r.i64(), r.i64()))  # aborted txns
            data = r.bytes32() or b""
            if raw_records:
                d["recordSet"] = data
            else:
                d["records"] = decode_record_batches(data)
            out.append(d)
        r.array(part)
    r.array(topic)
    return out


def encode_produce_request(topic: str, partition: int, record_set: bytes,
                           acks: int = -1, timeout_ms: int = 30000) -> bytes:
    return (nullable_string(None) + i16(acks) + i32(timeout_ms)
            + array([string(topic) + array([i32(partition)
                                            + bytes32(record_set)])]))


def decode_produce_request(r: Reader) -> List[Tuple[str, int, bytes]]:
    r.nullable_string()         # transactional_id
    r.i16()                     # acks
    r.i32()                     # timeout
    out = []

    def topic():
        name = r.string()

        def part():
            out.append((name, r.i32(), r.bytes32() or b""))
        r.array(part)
    r.array(topic)
    return out


def encode_produce_response(results: List[Tuple[str, int, int, int]]) -> bytes:
    """results = [(topic, partition, error, base_offset)] (v3 shape)."""
    by_topic: Dict[str, List[bytes]] = {}
    for topic, part, err, off in results:
        by_topic.setdefault(topic, []).append(i32(part) + i16(err) + i64(off)
                                              + i64(-1))  # log_append_time
    return array([string(t) + array(ps)
                  for t, ps in sorted(by_topic.items())]) + i32(0)


def decode_produce_response(r: Reader) -> List[Dict[str, Any]]:
    out = []

    def topic():
        name = r.string()

        def part():
            out.append({"topic": name, "partition": r.i32(), "error": r.i16(),
                        "offset": r.i64(), "logAppendTime": r.i64()})
        r.array(part)
    r.array(topic)
    r.i32()  # throttle
    return out


def encode_create_topics_request(topic: str, num_partitions: int) -> bytes:
    return array([string(topic) + i32(num_partitions) + i16(1)
                  + array([]) + array([])]) + i32(30000)


def decode_create_topics_request(r: Reader) -> List[Tuple[str, int]]:
    out = []

    def topic():
        name = r.string()
        n = r.i32()
        r.i16()                 # replication factor
        r.array(lambda: (r.i32(), r.array(r.i32)))  # assignments
        r.array(lambda: (r.string(), r.nullable_string()))  # configs
        out.append((name, n))
    r.array(topic)
    r.i32()  # timeout
    return out


def encode_create_topics_response(results: List[Tuple[str, int]]) -> bytes:
    return array([string(t) + i16(err) for t, err in results])


def decode_create_topics_response(r: Reader) -> List[Tuple[str, int]]:
    return r.array(lambda: (r.string(), r.i16()))


def decode_api_versions_response(r: Reader) -> Dict[int, Tuple[int, int]]:
    err = r.i16()
    if err:
        raise ValueError(f"ApiVersions error {err}")
    out = {}
    for k, lo, hi in r.array(lambda: (r.i16(), r.i16(), r.i16())):
        out[k] = (lo, hi)
    return out
