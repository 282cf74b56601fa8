"""PulsarLite: a broker speaking Pulsar's binary protocol over TCP, and the
stream plugin for it.

A copy of `pinot_tpu/ingest/pulsarlite.py`. The reference ships a Pulsar
consumer plugin (`pinot-plugins/pinot-stream-ingestion/pinot-pulsar/.../
PulsarPartitionLevelConsumer.java`) against an external Pulsar cluster; this
module holds both halves, so that the stream SPI runs across a real socket in
Pulsar's framing (the public PulsarApi.proto and its binary protocol):

* frames: `[totalSize u32][commandSize u32][BaseCommand]`, and for SEND and
  MESSAGE the payload form `... [magic 0x0e01][crc32c u32][metadataSize u32]
  [MessageMetadata][payload]`, the CRC-32C (`kafka_wire.crc32c`, the C one)
  over everything after it. `BaseCommand` and `MessageMetadata` are proto2
  messages written here and read with `proto.iter_fields`;
* commands: CONNECT / CONNECTED, PRODUCER / PRODUCER_SUCCESS, SEND /
  SEND_RECEIPT, SUBSCRIBE / SUCCESS, FLOW (permits), MESSAGE, SEEK,
  GET_LAST_MESSAGE_ID, CLOSE_*, PING / PONG;
* `PulsarLiteBroker`: one single-ledger log a topic partition
  (`partition_topic`: `persistent://public/default/<topic>-partition-<n>`),
  entry id = offset; a subscription is pushed MESSAGE frames only while it
  holds FLOW permits, Pulsar's flow control;
* `PulsarLiteClient` (one connection; every read through a buffer that keeps
  a frame cut by a poll's deadline), `PulsarLiteProducer` and
  `PulsarLiteConsumer`: a reader-style consumer that SEEKs where the fetch
  offset is not its cursor, asks FLOW permits for the batch and drains what
  is pushed (the reference plugin's Reader positioned at its start message);
  `latest_offset` through GET_LAST_MESSAGE_ID;
* `PulsarLiteFactory`, registered as stream type "pulsar"
  (`properties["serviceUrl"]`: `pulsar://host:port`).

The frames equal the JAX package's byte for byte, and each package's client
works against the other's broker. A message's value reaches the consumer as
a str (its bytes decoded with `surrogateescape`, so binary payloads such as
columnar blocks encode back unchanged).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .kafka_wire import crc32c
from .proto import iter_fields, write_uvarint
from .stream import (MessageBatch, PartitionGroupConsumer, StreamConsumerFactory,
                     StreamMessage, StreamMetadataProvider, register_stream_factory)

MAGIC = b"\x0e\x01"

# BaseCommand.Type values (PulsarApi.proto); the BaseCommand field that
# carries each command's message has the number of its type
CONNECT = 2
CONNECTED = 3
SUBSCRIBE = 4
PRODUCER = 5
SEND = 6
SEND_RECEIPT = 7
SEND_ERROR = 8
MESSAGE = 9
ACK = 10
FLOW = 11
UNSUBSCRIBE = 12
SUCCESS = 13
ERROR = 14
CLOSE_PRODUCER = 15
CLOSE_CONSUMER = 16
PRODUCER_SUCCESS = 17
PING = 18
PONG = 19
SEEK = 28
GET_LAST_MESSAGE_ID = 29
GET_LAST_MESSAGE_ID_RESPONSE = 30


# -- proto2 writers (the readers are proto.py's) ------------------------------

def _field_varint(num: int, v: int) -> bytes:
    # a negative encodes as its 64-bit two's complement (int64 varint)
    return write_uvarint(num << 3) + write_uvarint(v & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(num: int, v: bytes) -> bytes:
    return write_uvarint((num << 3) | 2) + write_uvarint(len(v)) + v


def _msg(fields: Dict[int, Any]) -> bytes:
    """{field number: int | str | bytes | dict (a message) | list} -> body."""
    out = b""
    for num, v in fields.items():
        if v is None:
            continue
        for item in (v if isinstance(v, list) else [v]):
            if isinstance(item, dict):
                out += _field_bytes(num, _msg(item))
            elif isinstance(item, bytes):
                out += _field_bytes(num, item)
            elif isinstance(item, str):
                out += _field_bytes(num, item.encode("utf-8"))
            else:
                out += _field_varint(num, int(item))
    return out


def _decode(data: bytes) -> Dict[int, List[Any]]:
    """Field number -> its values (nested messages stay bytes)."""
    out: Dict[int, List[Any]] = {}
    for num, _wt, v in iter_fields(data):
        out.setdefault(num, []).append(v)
    return out


def _one(d: Dict[int, List[Any]], num: int, default=None):
    vs = d.get(num)
    return vs[0] if vs else default


def _signed(v: int) -> int:
    """A varint as a signed int64 (a negative arrives as 2^64 - n)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _base_command(cmd_type: int, body: Optional[Dict[int, Any]] = None) -> bytes:
    fields: Dict[int, Any] = {1: cmd_type}
    if body is not None:
        fields[cmd_type] = body
    return _msg(fields)


def _message_id(ledger: int, entry: int) -> Dict[int, Any]:
    return {1: ledger, 2: entry}


def encode_frame(command: bytes, metadata: Optional[bytes] = None,
                 payload: bytes = b"") -> bytes:
    """A simple frame, or with `metadata` a payload frame."""
    if metadata is None:
        return struct.pack(">II", 4 + len(command), len(command)) + command
    meta_part = struct.pack(">I", len(metadata)) + metadata + payload
    rest = MAGIC + struct.pack(">I", crc32c(meta_part)) + meta_part
    return struct.pack(">II", 4 + len(command) + len(rest), len(command)) + command + rest


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    # into one preallocated buffer: appending chunk by chunk copies the
    # prefix each time, quadratic in a multi-megabyte payload frame
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            return None
        got += r
    return bytes(buf)


def parse_frame(body: bytes):
    """One frame's body (all after totalSize) -> (command fields, metadata
    fields or None, payload or None); a bad magic or CRC raises ValueError."""
    (cmd_size,) = struct.unpack(">I", body[:4])
    cmd = _decode(body[4:4 + cmd_size])
    rest = body[4 + cmd_size:]
    if not rest:
        return cmd, None, None
    if rest[:2] != MAGIC:
        raise ValueError("bad payload magic")
    (crc,) = struct.unpack(">I", rest[2:6])
    meta_part = rest[6:]
    if crc32c(meta_part) != crc:
        raise ValueError("pulsar frame CRC mismatch")
    (meta_size,) = struct.unpack(">I", meta_part[:4])
    return cmd, _decode(meta_part[4:4 + meta_size]), meta_part[4 + meta_size:]


def read_frame(sock: socket.socket):
    """One frame from a blocking socket (the broker's serve loop), None at
    EOF; the clients read through `PulsarLiteClient`'s buffer instead."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (total,) = struct.unpack(">I", head)
    body = _recv_exact(sock, total)
    if body is None:
        return None
    return parse_frame(body)


# -- the broker ---------------------------------------------------------------

class _TopicLog:
    """One topic partition's single ledger: entry id == offset."""

    def __init__(self):
        self.entries: List[Tuple[bytes, int]] = []   # (payload, publish ms)
        self.lock = threading.Lock()

    def append(self, payload: bytes, ts: int) -> int:
        with self.lock:
            self.entries.append((payload, ts))
            return len(self.entries) - 1


class PulsarLiteBroker:
    """CONNECT, PRODUCER, SEND, SUBSCRIBE, FLOW, SEEK and GET_LAST_MESSAGE_ID
    over TCP, a thread a connection; `stop` closes the listener and every
    open connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.topics: Dict[str, _TopicLog] = {}
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: set = set()
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True,
                                          name="pulsarlite-accept")
        self._acceptor.start()

    @property
    def service_url(self) -> str:
        return f"pulsar://{self.host}:{self.port}"

    def topic(self, name: str) -> _TopicLog:
        with self._lock:
            if name not in self.topics:
                self.topics[name] = _TopicLog()
            return self.topics[name]

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._acceptor.join(timeout=2.0)
        with self._lock:
            conns = list(self._conns)
        for c in conns:   # each connection's thread ends at its socket's close
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="pulsarlite-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        producers: Dict[int, str] = {}               # producer id -> topic
        consumers: Dict[int, Dict[str, Any]] = {}    # consumer id -> cursor, permits
        try:
            while not self._stop.is_set():
                frame = read_frame(conn)
                if frame is None:
                    return
                self._handle(conn, frame, producers, consumers)
        except (OSError, ValueError):   # a dead socket, a bad frame: drop the connection
            return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn, frame, producers, consumers) -> None:
        cmd, metadata, payload = frame
        ctype = _one(cmd, 1)
        if ctype == CONNECT:
            conn.sendall(encode_frame(_base_command(CONNECTED, {1: "pulsarlite", 2: 21})))
        elif ctype == PING:
            conn.sendall(encode_frame(_base_command(PONG, {})))
        elif ctype == PRODUCER:
            d = _decode(_one(cmd, PRODUCER))
            topic = _one(d, 1).decode()
            pid, req = _one(d, 2, 0), _one(d, 3, 0)
            producers[pid] = topic
            self.topic(topic)
            conn.sendall(encode_frame(_base_command(PRODUCER_SUCCESS,
                                                    {1: req, 2: f"p-{pid}", 3: -1})))
        elif ctype == SEND:
            d = _decode(_one(cmd, SEND))
            pid, seq = _one(d, 1, 0), _one(d, 2, 0)
            ts = _one(metadata, 3, 0) if metadata else 0
            entry = self.topic(producers[pid]).append(payload or b"", int(ts))
            conn.sendall(encode_frame(_base_command(
                SEND_RECEIPT, {1: pid, 2: seq, 3: _message_id(0, entry)})))
        elif ctype == SUBSCRIBE:
            d = _decode(_one(cmd, SUBSCRIBE))
            topic = _one(d, 1).decode()
            cid, req = _one(d, 4, 0), _one(d, 5, 0)
            start = _decode(_one(d, 9)) if d.get(9) else None
            consumers[cid] = {"topic": topic, "cursor": _one(start, 2, 0) if start else 0,
                              "permits": 0}
            self.topic(topic)
            conn.sendall(encode_frame(_base_command(SUCCESS, {1: req})))
        elif ctype == SEEK:
            d = _decode(_one(cmd, SEEK))
            cid, req = _one(d, 1, 0), _one(d, 2, 0)
            mid = _decode(_one(d, 3)) if d.get(3) else None
            if cid in consumers and mid is not None:
                consumers[cid]["cursor"] = _one(mid, 2, 0)
                consumers[cid]["permits"] = 0
            conn.sendall(encode_frame(_base_command(SUCCESS, {1: req})))
        elif ctype == FLOW:
            d = _decode(_one(cmd, FLOW))
            state = consumers.get(_one(d, 1, 0))
            if state is not None:
                state["permits"] += _one(d, 2, 0)
                self._deliver(conn, _one(d, 1, 0), state)
        elif ctype == GET_LAST_MESSAGE_ID:
            d = _decode(_one(cmd, GET_LAST_MESSAGE_ID))
            cid, req = _one(d, 1, 0), _one(d, 2, 0)
            state = consumers.get(cid)
            log = self.topic(state["topic"]) if state else None
            last = len(log.entries) - 1 if log else -1
            conn.sendall(encode_frame(_base_command(
                GET_LAST_MESSAGE_ID_RESPONSE, {1: _message_id(0, last), 2: req})))
        elif ctype in (CLOSE_PRODUCER, CLOSE_CONSUMER):
            req = _one(_decode(_one(cmd, ctype)), 2, 0)
            conn.sendall(encode_frame(_base_command(SUCCESS, {1: req})))
        # ACK: a reader's cursor is the client's; nothing to do

    def _deliver(self, conn: socket.socket, cid: int, state: Dict[str, Any]) -> None:
        """Push MESSAGE frames from the cursor while permits last."""
        log = self.topic(state["topic"])
        while state["permits"] > 0:
            with log.lock:
                if state["cursor"] >= len(log.entries):
                    return
                payload, ts = log.entries[state["cursor"]]
                entry = state["cursor"]
            conn.sendall(encode_frame(
                _base_command(MESSAGE, {1: cid, 2: _message_id(0, entry)}),
                _msg({1: "p", 2: entry, 3: ts}), payload))
            state["cursor"] = entry + 1
            state["permits"] -= 1


# -- the client and the stream plugin ------------------------------------------

def partition_topic(topic: str, partition: int) -> str:
    return f"persistent://public/default/{topic}-partition-{partition}"


class PulsarLiteClient:
    """One connection: the CONNECT handshake and the command exchange. Every
    read goes through a buffer (`read_frame_timeout`): a poll whose deadline
    falls inside a frame keeps the bytes it got for the next read instead of
    losing the frame's boundary."""

    def __init__(self, service_url: str):
        if not service_url.startswith("pulsar://"):
            raise ValueError(f"not a pulsar:// service URL: {service_url!r}")
        host, port = service_url[len("pulsar://"):].split(":")
        self.sock = socket.create_connection((host, int(port)), timeout=30)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._req = 0
        self._rbuf = bytearray()
        self.sock.sendall(encode_frame(_base_command(
            CONNECT, {1: "pinot-tpu-pulsarlite", 4: 21})))
        cmd, _, _ = self.read_frame_blocking()
        if _one(cmd, 1) != CONNECTED:
            raise ConnectionError(f"pulsar handshake failed: {cmd}")

    def read_frame_timeout(self, timeout_s: float):
        """One whole frame, or None once `timeout_s` passed first. The
        socket's timeout is restored on every exit, so that a send never runs
        under a short poll's timeout (a send cut inside a frame would break
        the stream for good)."""
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                if len(self._rbuf) >= 4:
                    (total,) = struct.unpack(">I", bytes(self._rbuf[:4]))
                    if len(self._rbuf) >= 4 + total:
                        body = bytes(self._rbuf[4:4 + total])
                        del self._rbuf[:4 + total]
                        return parse_frame(body)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self.sock.settimeout(remaining)
                try:
                    chunk = self.sock.recv(1 << 16)
                except (socket.timeout, TimeoutError):
                    continue
                if not chunk:
                    raise ConnectionError("pulsar connection closed")
                self._rbuf.extend(chunk)
        finally:
            self.sock.settimeout(30)

    def read_frame_blocking(self, timeout_s: float = 30.0):
        frame = self.read_frame_timeout(timeout_s)
        if frame is None:
            raise ConnectionError("pulsar exchange timed out")
        return frame

    def next_req(self) -> int:
        self._req += 1
        return self._req

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class PulsarLiteProducer:
    def __init__(self, service_url: str, topic: str, partition: int = 0):
        self.client = PulsarLiteClient(service_url)
        self.producer_id = 1
        self._seq = 0
        self.client.sock.sendall(encode_frame(_base_command(PRODUCER, {
            1: partition_topic(topic, partition), 2: self.producer_id,
            3: self.client.next_req()})))
        cmd, _, _ = self.client.read_frame_blocking()
        if _one(cmd, 1) != PRODUCER_SUCCESS:
            raise ConnectionError(f"producer create failed: {cmd}")

    def send(self, payload: bytes, ts: Optional[int] = None) -> int:
        """Send one message; returns its entry id (its offset)."""
        self._seq += 1
        metadata = _msg({1: "p", 2: self._seq,
                         3: ts if ts is not None else int(time.time() * 1000)})
        self.client.sock.sendall(encode_frame(
            _base_command(SEND, {1: self.producer_id, 2: self._seq}), metadata, payload))
        cmd, _, _ = self.client.read_frame_blocking()
        if _one(cmd, 1) != SEND_RECEIPT:
            raise RuntimeError(f"send failed: {cmd}")
        return _one(_decode(_one(_decode(_one(cmd, SEND_RECEIPT)), 3)), 2, -1)

    def close(self) -> None:
        self.client.close()


class PulsarLiteConsumer(PartitionGroupConsumer):
    """A reader on one partition: a non-durable subscription, a SEEK where
    the fetch offset is not the cursor, FLOW permits for the batch.

    Safe to share between a pumping thread and a lag probe: one exchange at
    a time holds the connection, and MESSAGE frames that arrive while
    `latest_offset` waits for its answer are kept for the next fetch. (The
    JAX package's consumer drops them there: permits left over from earlier
    fetches let the broker push past a fetch's batch, so a probe between two
    fetches lost those messages and the next fetch skipped their offsets.)"""

    def __init__(self, service_url: str, topic: str, partition: int):
        self.client = PulsarLiteClient(service_url)
        self.consumer_id = 1
        self._lock = threading.Lock()
        # pushed MESSAGE frames a probe read: (entry, publish ms, payload)
        self._pending: List[Tuple[int, int, bytes]] = []
        self.client.sock.sendall(encode_frame(_base_command(SUBSCRIBE, {
            1: partition_topic(topic, partition), 2: "pinot-tpu-reader", 3: 0,
            4: self.consumer_id, 5: self.client.next_req(), 8: 0, 9: _message_id(0, 0)})))
        cmd, _, _ = self.client.read_frame_blocking()
        if _one(cmd, 1) != SUCCESS:
            raise ConnectionError(f"subscribe failed: {cmd}")
        self._cursor = 0

    def _seek(self, offset: int) -> None:
        self.client.sock.sendall(encode_frame(_base_command(SEEK, {
            1: self.consumer_id, 2: self.client.next_req(), 3: _message_id(0, offset)})))
        # MESSAGE frames pushed before the seek may precede its SUCCESS: stale
        while True:
            cmd, _, _ = self.client.read_frame_blocking()
            if _one(cmd, 1) == SUCCESS:
                break
        self._pending.clear()
        self._cursor = offset

    @staticmethod
    def _message(cmd, metadata, payload) -> Tuple[int, int, bytes]:
        entry = _one(_decode(_one(_decode(_one(cmd, MESSAGE)), 2)), 2, 0)
        return entry, int(_one(metadata, 3, 0) if metadata else 0), payload or b""

    def fetch(self, start_offset: int, max_messages: int, timeout_ms: int = 0) -> MessageBatch:
        """At most `max_messages` from `start_offset`: waits up to
        `timeout_ms` (at least 50 ms) for the first, then takes what arrives
        within 20 ms of the last."""
        with self._lock:
            if self._cursor != start_offset:
                self._seek(start_offset)
            got = [m for m in self._pending if m[0] >= start_offset][:max_messages]
            self._pending = [m for m in self._pending if m[0] >= start_offset][len(got):]
            if len(got) < max_messages and not self._pending:
                self.client.sock.sendall(encode_frame(_base_command(FLOW, {
                    1: self.consumer_id, 2: max_messages - len(got)})))
                self._drain(got, start_offset, max_messages, timeout_ms)
            msgs = [StreamMessage(value=payload.decode("utf-8", "surrogateescape"),
                                  offset=entry, key=None, timestamp_ms=ts)
                    for entry, ts, payload in got]
            next_offset = msgs[-1].offset + 1 if msgs else start_offset
            self._cursor = next_offset
            return MessageBatch(msgs, next_offset)

    def _drain(self, got: list, start_offset: int, max_messages: int, timeout_ms: int) -> None:
        deadline = time.monotonic() + max(timeout_ms, 50) / 1000.0
        while len(got) < max_messages:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                frame = self.client.read_frame_timeout(0.02 if got else remaining)
            except ConnectionError:
                break   # the broker closed the connection: what was drained
            if frame is None:
                if got:
                    break
                continue
            if _one(frame[0], 1) != MESSAGE:
                continue
            m = self._message(*frame)
            if m[0] >= start_offset:   # an earlier one was pushed before the seek
                got.append(m)

    def latest_offset(self) -> int:
        """The offset the next message will take (GET_LAST_MESSAGE_ID + 1)."""
        with self._lock:
            self.client.sock.sendall(encode_frame(_base_command(
                GET_LAST_MESSAGE_ID, {1: self.consumer_id, 2: self.client.next_req()})))
            while True:
                cmd, metadata, payload = self.client.read_frame_blocking()
                ctype = _one(cmd, 1)
                if ctype == GET_LAST_MESSAGE_ID_RESPONSE:
                    d = _decode(_one(cmd, GET_LAST_MESSAGE_ID_RESPONSE))
                    return _signed(_one(_decode(_one(d, 1)), 2, -1)) + 1
                if ctype == MESSAGE:
                    self._pending.append(self._message(cmd, metadata, payload))

    def close(self) -> None:
        self.client.close()


class PulsarLiteFactory(StreamConsumerFactory):
    """Stream type "pulsar"; `properties["serviceUrl"]` (or "endpoint")."""

    def __init__(self, topic: str, properties: Optional[Dict[str, Any]] = None):
        props = properties or {}
        self.topic = topic
        self.service_url = props.get("serviceUrl") or props.get("endpoint", "")

    def create_consumer(self, topic: str, partition: int) -> PartitionGroupConsumer:
        return PulsarLiteConsumer(self.service_url, topic or self.topic, partition)

    def metadata_provider(self) -> StreamMetadataProvider:
        # the controller gives the partition count at table creation; each
        # partition is its own "<topic>-partition-<n>" topic
        return StreamMetadataProvider()


register_stream_factory("pulsar", PulsarLiteFactory)
