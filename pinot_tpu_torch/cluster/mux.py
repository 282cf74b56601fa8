"""Multiplexed broker<->server data-plane transport.

A copy of `pinot_tpu/cluster/mux.py`, without its fault-injection points
(`utils/faults.py` waits). The broker's scatter takes it first
(`RemoteServerHandle.submit_async`): a partial in flight holds a tagged
frame on a shared stream, not a broker thread. This module multiplexes MANY tagged in-flight queries over ONE
long-lived HTTP/1.1 exchange per connection (reference analog: the broker's
pooled Netty channels carry concurrent InstanceRequests per server;
`QueryRouter.java` matches responses to requests by canonical request id):

* the client opens `POST /mux` with a chunked request body and reads the
  chunked response CONCURRENTLY — request frames flow down while response
  frames flow up, out of order, matched by tag;
* the server demuxes request frames into its executor under a per-stream
  flow-control window and yields response frames as queries finish;
* frame payloads are wire.py buffers end to end: responses are written as
  gathered `encode_segment_result_parts` buffers (no intermediate joins) and
  decoded zero-copy on the client.

Frame layout (all integers little-endian)::

    frame    := tag u32 | kind u8 | length u32 | payload[length]
    REQUEST  (kind 1, client->server): encode_query_request bytes
    RESPONSE (kind 2, server->client): status u32 | body
    GOODBYE  (kind 3, client->server): empty — clean stream shutdown

RESPONSE status mirrors HTTP so the broker's failure taxonomy survives
unchanged: 200 carries an encoded SegmentResult; 429/408 are scheduler
backpressure (`_is_backpressure` keys on HttpError status); anything else is
a query error on a LIVE server. Transport death (socket reset, truncated
frame) fails every in-flight tag with ConnectionError — exactly what
`_is_transport_failure` expects of a dead server.
"""

from __future__ import annotations

import json
import queue
import random
import struct
import threading
import time
import urllib.parse
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from .http_service import HttpError, open_client_connection

_HEADER = struct.Struct("<IBI")
_STATUS = struct.Struct("<I")

KIND_REQUEST = 1
KIND_RESPONSE = 2
KIND_GOODBYE = 3

#: response parts below this ride the accumulating small-part buffer; at or
#: above it they are yielded as standalone chunks (zero-copy to the socket)
_COALESCE_MAX = 65536


class MuxStreamClosed(ConnectionError):
    """The stream died between tag allocation and frame write — the caller
    (MuxClient) retries once on a fresh stream."""


# -- client ------------------------------------------------------------------

class _MuxConnection:
    """One duplex exchange: a writer thread drains the frame queue into the
    chunked request body, a reader thread completes futures from the chunked
    response. Any transport failure fails every in-flight tag and retires the
    connection (MuxClient mints a replacement on the next submit)."""

    def __init__(self, scheme: str, host: str, port: int,
                 token: Optional[str], timeout_s: float):
        self._timeout_s = timeout_s
        conn = open_client_connection(scheme, host, port, timeout_s)
        try:
            conn.putrequest("POST", "/mux")
            conn.putheader("Content-Type", "application/octet-stream")
            conn.putheader("Transfer-Encoding", "chunked")
            if token:
                conn.putheader("Authorization", f"Bearer {token}")
            conn.endheaders()
            # the server sends its 200 + chunked headers BEFORE reading any
            # request frame (duplex route), so this does not deadlock
            resp = conn.getresponse()
            if resp.status != 200:
                body = resp.read()
                raise HttpError(resp.status, body.decode(errors="replace"))
            # response frames arrive whenever queries finish; an idle stream
            # must not die of a read timeout — liveness is request-scoped
            # (MuxClient reaps connections whose oldest tag overstays)
            conn.sock.settimeout(None)
        except BaseException:
            conn.close()
            raise
        self._conn = conn
        self._resp = resp
        self._lock = threading.Lock()
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._next_tag = 1
        self._closed = False
        # unbounded here: the server's flow-control window caps the tags in
        # flight on a stream
        self._outq: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(
            target=self._write_loop, name=f"mux-writer-{host}:{port}",
            daemon=True)
        self._reader = threading.Thread(
            target=self._read_loop, name=f"mux-reader-{host}:{port}",
            daemon=True)
        self._writer.start()
        self._reader.start()

    # -- public surface ------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def stale(self) -> bool:
        """True when the oldest in-flight tag has overstayed the request
        timeout — the server stopped answering without dropping the socket;
        the owner fails this connection and reconnects."""
        with self._lock:
            if not self._pending:
                return False
            oldest = min(e["t0"] for e in self._pending.values())
        return (time.perf_counter() - oldest) > self._timeout_s

    def submit(self, payload: bytes, *, trace=None, depth: int = 0,
               dispatch_ms: float = 0.0, span_name: Optional[str] = None
               ) -> "Future":
        fut: "Future" = Future()
        entry: Dict[str, Any] = {
            "fut": fut, "trace": trace, "depth": depth,
            "dispatch_ms": dispatch_ms, "span_name": span_name,
            "t0": time.perf_counter(),
            "enq_ms": trace.now_ms() if trace is not None else 0.0,
            "queue_ms": 0.0, "sent_ms": 0.0,
        }
        with self._lock:
            if self._closed:
                raise MuxStreamClosed("mux stream already closed")
            tag = self._next_tag
            self._next_tag += 1
            self._pending[tag] = entry
        self._outq.put((tag, payload, entry))
        return fut

    def fail(self, reason: str) -> None:
        self._fail(ConnectionError(reason))

    def close(self) -> None:
        """Clean shutdown: goodbye frame, then fail whatever was left."""
        self._outq.put(None)
        self._writer.join(timeout=2.0)
        self._fail(ConnectionError("mux connection closed"))
        self._reader.join(timeout=2.0)

    # -- writer --------------------------------------------------------------

    def _write_loop(self) -> None:
        while True:
            try:
                item = self._outq.get(timeout=1.0)
            except queue.Empty:
                with self._lock:  # _fail() flips _closed under the lock
                    closed = self._closed
                if closed:
                    return
                continue
            try:
                if item is None:  # goodbye: end of request body
                    frame = _HEADER.pack(0, KIND_GOODBYE, 0)
                    self._conn.send(b"%x\r\n" % len(frame) + frame +
                                    b"\r\n0\r\n\r\n")
                    return
                tag, payload, entry = item
                tr = entry["trace"]
                if tr is not None:
                    wait = tr.now_ms() - entry["enq_ms"]
                    entry["queue_ms"] = wait
                    tr.record("mux:frame_queue", entry["enq_ms"], wait,
                              entry["depth"] + 1)
                    entry["sent_ms"] = tr.now_ms()
                header = _HEADER.pack(tag, KIND_REQUEST, len(payload))
                n = len(header) + len(payload)
                # one send per frame: size line + header + payload + CRLF
                self._conn.send(b"".join(
                    (b"%x\r\n" % n, header, payload, b"\r\n")))
            except OSError as e:
                self._fail(ConnectionError(f"mux write failed: {e}"))
                return

    # -- reader --------------------------------------------------------------

    def _read_exact(self, n: int, at_boundary: bool) -> Optional[bytearray]:
        """Read exactly n response-body bytes; None on clean EOF at a frame
        boundary (server ended the stream)."""
        buf = bytearray(n)
        mv = memoryview(buf)
        got = 0
        while got < n:
            k = self._resp.readinto(mv[got:])
            if not k:
                if got == 0 and at_boundary:
                    return None
                raise ConnectionError("mux stream truncated mid-frame")
            got += k
        return buf

    def _read_loop(self) -> None:
        try:
            while True:
                hdr = self._read_exact(_HEADER.size, at_boundary=True)
                if hdr is None:
                    break
                tag, kind, length = _HEADER.unpack(hdr)
                payload = self._read_exact(length, at_boundary=False)
                if kind != KIND_RESPONSE:
                    continue
                with self._lock:
                    entry = self._pending.pop(tag, None)
                if entry is None:
                    continue  # reaped/unknown tag — drop
                self._complete(entry, payload)
        except Exception as e:
            self._fail(e if isinstance(e, ConnectionError)
                       else ConnectionError(f"mux read failed: {e}"))
        else:
            self._fail(ConnectionError("mux stream closed by server"))

    def _complete(self, entry: Dict[str, Any], payload: bytearray) -> None:
        from ..query.stats import MUX_FRAME_QUEUE_MS
        from .wire import decode_segment_result
        fut: "Future" = entry["fut"]
        (status,) = _STATUS.unpack_from(payload, 0)
        body = memoryview(payload)[_STATUS.size:]
        if status != 200:
            retry_after = None
            try:
                obj = json.loads(bytes(body).decode())
                msg = obj.get("error", "")
                retry_after = obj.get("retryAfterMs")
            except (ValueError, AttributeError):
                msg = bytes(body).decode(errors="replace")
            err = HttpError(status, msg)
            if retry_after is not None:
                # the broker's backpressure bookkeeping and the remote retry
                # path read this attribute off the decoded error
                try:
                    err.retry_after_ms = float(retry_after)
                except (TypeError, ValueError):
                    pass
            fut.set_exception(err)
            return
        tr = entry["trace"]
        try:
            arrive_ms = tr.now_ms() if tr is not None else 0.0
            t0 = time.perf_counter()
            result = decode_segment_result(body)
            decode_dur = (time.perf_counter() - t0) * 1000
            if entry["queue_ms"]:
                stats = result.stats if isinstance(result.stats, dict) \
                    else {}
                stats[MUX_FRAME_QUEUE_MS] = round(
                    stats.get(MUX_FRAME_QUEUE_MS, 0.0) + entry["queue_ms"], 3)
                result.stats = stats
            if tr is not None:
                depth = entry["depth"]
                tr.record("send", entry["sent_ms"],
                          arrive_ms - entry["sent_ms"], depth + 1)
                tr.record("deserialize", arrive_ms, decode_dur, depth + 1)
                spans = getattr(result, "trace_spans", None)
                if spans:
                    # splice HERE (mirrors RemoteServerHandle.__call__) and
                    # clear the attr so no later consumer double-splices
                    tr.splice(spans, offset_ms=entry["dispatch_ms"],
                              depth_offset=depth + 1)
                    result.trace_spans = None
                if entry["span_name"]:
                    tr.record(entry["span_name"], entry["dispatch_ms"],
                              tr.now_ms() - entry["dispatch_ms"], depth)
        except Exception as e:
            fut.set_exception(
                ValueError(f"mux response decode failed: {e}"))
            return
        fut.set_result(result)

    def _fail(self, exc: Exception) -> None:
        with self._lock:
            if self._closed:
                pending: List[Dict[str, Any]] = []
            else:
                self._closed = True
                pending = list(self._pending.values())
                self._pending.clear()
        for entry in pending:
            entry["fut"].set_exception(exc)
        try:
            self._conn.close()
        except OSError:
            pass


class MuxClient:
    """Per-server mux endpoint: a small fixed set of streams (round-robin)
    with reconnect-on-failure. `submit` returns a Future resolving to the
    decoded SegmentResult — it never blocks on the round trip, which is the
    whole point: in-flight queries per server are bounded by the server's
    flow-control window, not by a client thread pool."""

    #: reconnect bounds: a dead server must not be stormed by the old
    #: retry-once-immediately loop — attempts are capped and separated by
    #: jittered exponential backoff (full jitter halves synchronized retries
    #: from concurrent submitters)
    MAX_ATTEMPTS = 4
    BACKOFF_BASE_S = 0.005
    BACKOFF_MAX_S = 0.1

    def __init__(self, url: str, token: Optional[str] = None,
                 streams: int = 1, timeout_s: float = 60.0,
                 max_attempts: Optional[int] = None):
        parsed = urllib.parse.urlsplit(url)
        self._scheme = parsed.scheme or "http"
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or (443 if self._scheme == "https" else 80)
        self._token = token
        self._timeout_s = timeout_s
        self._max_attempts = max(1, int(max_attempts if max_attempts
                                        is not None else self.MAX_ATTEMPTS))
        self._slots: List[Optional[_MuxConnection]] = \
            [None] * max(1, int(streams))
        self._rr = 0
        self._lock = threading.Lock()

    def _connection(self) -> _MuxConnection:
        from ..utils.metrics import get_registry
        with self._lock:
            i = self._rr % len(self._slots)
            self._rr += 1
            conn = self._slots[i]
            if conn is not None and not conn.closed and conn.stale():
                # socket alive but the oldest tag overstayed its timeout:
                # the stream is wedged — fail it (in-flight tags error out)
                # and reconnect
                conn.fail(f"mux response from {self._host}:{self._port} "
                          f"overdue past {self._timeout_s}s")
            if conn is None or conn.closed:
                reconnect = conn is not None
                conn = _MuxConnection(self._scheme, self._host, self._port,
                                      self._token, self._timeout_s)
                self._slots[i] = conn
                if reconnect:
                    get_registry().counter(
                        "pinot_broker_mux_reconnects").inc()
            return conn

    def submit(self, payload: bytes, *, trace=None, depth: int = 0,
               dispatch_ms: float = 0.0, span_name: Optional[str] = None
               ) -> "Future":
        """Submit one tagged frame, reconnecting with jittered exponential
        backoff on a dying stream. The attempts cap bounds how long a dead
        server is hammered; exhausting it raises ConnectionError, which the
        owning RemoteServerHandle answers by retrying the request once over
        the legacy per-request transport."""
        from ..utils.metrics import get_registry
        reg = get_registry()
        reg.counter("pinot_broker_mux_dispatches").inc()
        delay_s = self.BACKOFF_BASE_S
        last_exc: Optional[Exception] = None
        for attempt in range(self._max_attempts):
            if attempt:
                # full jitter: delay * [0.5, 1.5), doubled per attempt
                reg.counter("pinot_broker_mux_reconnect_backoffs").inc()
                time.sleep(delay_s * (0.5 + random.random()))
                delay_s = min(delay_s * 2.0, self.BACKOFF_MAX_S)
            try:
                conn = self._connection()
                return conn.submit(payload, trace=trace, depth=depth,
                                   dispatch_ms=dispatch_ms,
                                   span_name=span_name)
            except (MuxStreamClosed, ConnectionError) as e:
                last_exc = e  # dying stream or failed mint: back off, retry
        raise ConnectionError(
            f"mux stream to {self._host}:{self._port} keeps closing "
            f"({self._max_attempts} attempts): {last_exc}")

    def close(self) -> None:
        with self._lock:
            conns = [c for c in self._slots if c is not None]
            self._slots = [None] * len(self._slots)
        for c in conns:
            c.close()


# -- server ------------------------------------------------------------------

def _read_exact_from(body, n: int, at_boundary: bool) -> Optional[bytes]:
    """Read exactly n bytes from an incremental request-body reader; None on
    clean end-of-body at a frame boundary."""
    pieces: List[bytes] = []
    got = 0
    while got < n:
        chunk = body.read(n - got)
        if not chunk:
            if got == 0 and at_boundary:
                return None
            raise ConnectionError("mux request stream truncated mid-frame")
        pieces.append(chunk)
        got += len(chunk)
    return pieces[0] if len(pieces) == 1 else b"".join(pieces)


def serve_mux_stream(body, execute: Callable[[bytes, float],
                                             Tuple[int, List[Any]]],
                     executor, max_inflight: int,
                     principal=None, on_frame: Optional[Callable[[], None]]
                     = None):
    """Server half of one mux stream: demux request frames into `executor`,
    yield response frames as queries finish (out of order).

    `execute(payload, flow_wait_ms) -> (status, parts)` runs ON AN EXECUTOR
    THREAD; `principal` (captured at stream open — executor threads have no
    ambient auth context) is re-published around each call. `max_inflight`
    is the per-stream flow-control window: the demux loop stops pulling
    request frames off the socket while that many responses are unwritten,
    so one stream cannot swamp the executor or buffer unbounded results —
    the wait it induces is measured and handed to `execute`.
    Returns the response-frame generator for a duplex route."""
    from ..auth import set_current_principal

    # at most max_inflight responses are unwritten: the window below stops
    # the demux loop from taking request frames past it
    outq: "queue.Queue" = queue.Queue()
    window = threading.Semaphore(max_inflight)
    lock = threading.Lock()
    state = {"reading": True, "inflight": 0, "aborted": False}

    def _finish_if_drained() -> None:
        with lock:
            done = not state["reading"] and state["inflight"] == 0
        if done:
            outq.put(None)

    def _run(tag: int, payload: bytes, flow_wait_ms: float) -> None:
        set_current_principal(principal)
        try:
            status, parts = execute(payload, flow_wait_ms)
        except Exception as e:
            status = getattr(e, "status", 500)
            if not isinstance(status, int):
                status = 500
            parts = [json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode()]
        finally:
            set_current_principal(None)
        outq.put((tag, status, parts))
        with lock:
            state["inflight"] -= 1
        _finish_if_drained()

    def _demux() -> None:
        try:
            while True:
                hdr = _read_exact_from(body, _HEADER.size, at_boundary=True)
                if hdr is None:
                    break
                tag, kind, length = _HEADER.unpack(hdr)
                payload = _read_exact_from(body, length, at_boundary=False) \
                    if length else b""
                if kind == KIND_GOODBYE:
                    break
                if kind != KIND_REQUEST:
                    continue
                if on_frame is not None:
                    on_frame()
                t0 = time.perf_counter()
                # the permit is not released here: _frames() releases it once
                # this tag's response frame is written (the window)
                while not window.acquire(timeout=1.0):
                    if state["aborted"]:
                        return
                try:
                    with lock:
                        state["inflight"] += 1
                    wait_ms = (time.perf_counter() - t0) * 1000
                    executor.submit(_run, tag, payload, wait_ms)
                except BaseException:
                    # submit() raises once the executor shuts down mid-stream;
                    # without this rollback the window permit and the inflight
                    # count both leak and the stream never drains.  A dead
                    # executor means the server is going down — end the stream
                    # cleanly rather than crash the demux thread.
                    window.release()
                    with lock:
                        state["inflight"] -= 1
                    return
        except ConnectionError:
            pass  # torn stream: the client fails its own in-flight tags
        finally:
            with lock:
                state["reading"] = False
            _finish_if_drained()

    reader = threading.Thread(target=_demux, name="mux-demux", daemon=True)
    reader.start()

    def _frames():
        try:
            while True:
                try:
                    item = outq.get(timeout=1.0)
                except queue.Empty:
                    continue  # idle stream: keep the exchange open
                if item is None:
                    return
                tag, status, parts = item
                total = _STATUS.size + sum(len(p) for p in parts)
                buf = bytearray(_HEADER.pack(tag, KIND_RESPONSE, total))
                buf += _STATUS.pack(status)
                for p in parts:
                    if len(p) >= _COALESCE_MAX:
                        if buf:
                            yield buf
                            buf = bytearray()
                        yield p  # zero-copy: array buffers go out as-is
                    else:
                        buf += p
                if buf:
                    yield buf
                window.release()
        finally:
            state["aborted"] = True

    return _frames()
