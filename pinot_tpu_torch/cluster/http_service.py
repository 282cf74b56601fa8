"""HTTP service harness and pooled client that every cluster role uses.

A copy of `pinot_tpu/cluster/http_service.py` (the transport analog of the
reference's role endpoints: the Jersey/Grizzly admin apps, the Netty query
server and the completion handlers): one threaded stdlib HTTP server a role,
routes registered as callables, bearer-token authentication and TLS on every
endpoint, chunked (streaming) and duplex (mux) routes, and the keep-alive
client pool (`http_call`, `http_stream`, `get_json`, `post_json`) with one
mint point for client sockets (`open_client_connection`). The data plane
(query dispatch, partials) rides the binary codec of `wire.py`; the control
plane (catalog, admin) is JSON. The JAX package's fault-injection points
(`utils/faults.py`) wait with that module.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

# route handler: (path_parts, query_params, body) -> (status, content_type, body_bytes)
RouteHandler = Callable[[list, Dict[str, str], bytes], Tuple[int, str, bytes]]


class _ChunkedReader:
    """Incremental reader over a chunked transfer-encoded request body
    (stdlib's BaseHTTPRequestHandler does not decode chunked requests; peers
    stream mailbox frames as chunked POSTs)."""

    def __init__(self, rfile):
        self._rfile = rfile
        self._remaining = 0   # unread bytes of the current chunk
        self._done = False

    def read(self, n: int) -> bytes:
        if self._done:
            return b""
        if self._remaining == 0:
            line = self._rfile.readline(128).strip()
            try:
                size = int(line.split(b";")[0], 16)
            except ValueError:
                raise ConnectionError(f"bad chunk size line {line!r}") from None
            if size == 0:
                # consume trailer section up to the blank line
                while self._rfile.readline(1024).strip():
                    pass
                self._done = True
                return b""
            self._remaining = size
        data = self._rfile.read(min(n, self._remaining))
        self._remaining -= len(data)
        if self._remaining == 0:
            self._rfile.read(2)  # chunk-terminating CRLF
        return data

    def drain(self) -> None:
        """Consume the rest of the body INCLUDING the terminating 0-chunk.
        Responding while unread bytes sit in the receive buffer makes the
        close send a TCP RST that races the 200 on the sender's side."""
        while self.read(65536):
            pass


class _LengthReader:
    """Incremental reader over a Content-Length request body."""

    def __init__(self, rfile, length: int):
        self._rfile = rfile
        self._remaining = length

    def read(self, n: int) -> bytes:
        if self._remaining <= 0:
            return b""
        data = self._rfile.read(min(n, self._remaining))
        self._remaining -= len(data)
        return data

    def drain(self) -> None:
        while self.read(65536):
            pass


def json_response(obj: Any, status: int = 200) -> Tuple[int, str, bytes]:
    return status, "application/json", json.dumps(obj).encode()


def binary_response(data: bytes, status: int = 200) -> Tuple[int, str, bytes]:
    return status, "application/octet-stream", data


def error_response(msg: str, status: int = 500) -> Tuple[int, str, bytes]:
    return status, "application/json", json.dumps({"error": msg}).encode()


class HttpService:
    """A role's HTTP endpoint: register routes, serve on a daemon thread.

    `access_control` (`auth.AccessControl`) gates every request:
    bearer-token authentication (401 on failure), then the route's declared
    action against the principal's permissions (403); handlers do table-level
    checks through `auth.require_table_access`. None skips authentication."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 access_control=None, ssl_context=None):
        self._routes: Dict[Tuple[str, str], RouteHandler] = {}
        self._actions: Dict[Tuple[str, str], str] = {}
        self._stream_body: set = set()  # routes taking an incremental body reader
        self._duplex: set = set()       # full-duplex routes (mux streams)
        self.access_control = access_control
        self.scheme = "https" if ssl_context is not None else "http"
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence per-request stderr noise
                pass

            def _dispatch(self, method: str) -> None:
                parsed = urllib.parse.urlparse(self.path)
                parts = [p for p in parsed.path.split("/") if p]
                params = dict(urllib.parse.parse_qsl(parsed.query))
                head = parts[0] if parts else ""
                if (method, head) in service._stream_body or \
                        (method, head) in service._duplex:
                    # streaming-body route: hand the handler an incremental
                    # reader instead of buffering the body (mailbox frames
                    # arrive as a chunked POST under backpressure — reading it
                    # all here would be exactly the unbounded buffering the
                    # mailbox design exists to prevent). The connection closes
                    # after the response: the body may be only partially
                    # consumed on error/cancel paths.
                    self.close_connection = True
                    if self.headers.get("Transfer-Encoding", ""
                                        ).lower() == "chunked":
                        body = _ChunkedReader(self.rfile)
                    else:
                        body = _LengthReader(
                            self.rfile,
                            int(self.headers.get("Content-Length") or 0))
                else:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                handler = service._routes.get((method, head))
                if handler is None:
                    status, ctype, data = error_response("not found", 404)
                else:
                    try:
                        service._authenticate(method, head, self.headers)
                        status, ctype, data = handler(parts[1:], params, body)
                    except Exception as e:  # surfaced to caller, not fatal to server
                        from ..auth import AuthError
                        code = e.status if isinstance(e, AuthError) else 500
                        status, ctype, data = error_response(
                            f"{type(e).__name__}: {e}", code)
                    finally:
                        from ..auth import set_current_principal
                        set_current_principal(None)
                if (method, head) in service._stream_body:
                    # safety net for EVERY response path (success, handler
                    # error, auth failure): consume the rest of the request
                    # body before responding — closing with unread bytes in
                    # the receive buffer RSTs the sender (drain is idempotent;
                    # the remainder is bounded by the sender's partition).
                    # Duplex routes are EXCLUDED: their response generator
                    # owns the body reader and consumes it concurrently with
                    # the response — draining here would deadlock the stream.
                    try:
                        body.drain()
                    except Exception:
                        pass
                if isinstance(data, str):
                    # a str body is a non-streaming response that forgot to
                    # encode — chunk-iterating it per character would garble
                    # the stream and TypeError in write_chunk
                    data = data.encode("utf-8")
                if not isinstance(data, (bytes, bytearray)) and hasattr(data, "__iter__"):
                    # streaming handler: iterator of byte chunks -> HTTP/1.1
                    # chunked transfer (the gRPC-streaming analog for large
                    # exports; see BrokerService queryStream)
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    def write_chunk(payload: bytes) -> None:
                        self.wfile.write(f"{len(payload):x}\r\n".encode())
                        self.wfile.write(payload)
                        self.wfile.write(b"\r\n")
                    try:
                        for chunk in data:
                            if chunk:
                                write_chunk(chunk)
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away mid-stream
                    except Exception as e:
                        # the 200/chunked headers are already on the wire — a
                        # mid-stream failure must still terminate the stream
                        # cleanly, with the error as the final event (clients
                        # check for it) instead of an abrupt IncompleteRead
                        try:
                            write_chunk(json.dumps(
                                {"error": f"{type(e).__name__}: {e}"}
                            ).encode() + b"\n")
                            self.wfile.write(b"0\r\n\r\n")
                        except (BrokenPipeError, ConnectionResetError):
                            pass
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

        class _Server(ThreadingHTTPServer):
            # stdlib default backlog is 5: a mailbox shuffle's burst of
            # parallel partition streams (leaf senders x partitions x sides)
            # overflows it under load and the kernel RSTs new connections —
            # surfacing as spurious "connection reset by peer" query failures
            request_queue_size = 128

        # response header/body writes are separate sends: Nagle + the peer's
        # delayed ACK costs ~40ms per response on keep-alive connections
        Handler.disable_nagle_algorithm = True

        self._server = _Server((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        if ssl_context is not None:
            # TLS on every role endpoint (reference: pinot.*.tls.* configs,
            # TlsIntegrationTest). do_handshake_on_connect=False is
            # LOAD-BEARING: with it, accept() returns immediately and the
            # handshake happens lazily on first read INSIDE the per-connection
            # handler thread — a client that connects and sends nothing would
            # otherwise wedge the single accept loop and hang every request
            # to this role
            self._server.socket = ssl_context.wrap_socket(
                self._server.socket, server_side=True,
                do_handshake_on_connect=False)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def route(self, method: str, head: str, handler: RouteHandler,
              action: str = "READ", stream_body: bool = False,
              duplex: bool = False) -> None:
        """Register a handler for `METHOD /head/...` (first path component match).
        `action` is the permission access control demands (READ/WRITE/ADMIN).
        `stream_body=True` hands the handler an incremental `.read(n)` reader
        instead of the buffered body (for peer mailbox streams).
        `duplex=True` additionally returns the response generator BEFORE the
        request body is consumed — the generator reads request frames and
        yields response frames concurrently on one exchange (mux streams);
        the pre-response body drain is skipped."""
        self._routes[(method, head)] = handler
        self._actions[(method, head)] = action
        if stream_body:
            self._stream_body.add((method, head))
        if duplex:
            self._duplex.add((method, head))

    def _authenticate(self, method: str, head: str, headers) -> None:
        """Bearer-token auth + route-action authorization; publishes the
        principal for handler-level table checks."""
        from ..auth import AuthError, set_current_principal
        if self.access_control is None:
            set_current_principal(None)
            return
        if method == "GET" and head == "health":
            # liveness/readiness probes are credential-less by convention
            # (reference: Pinot exempts health endpoints from auth)
            set_current_principal(None)
            return
        raw = headers.get("Authorization", "")
        token = raw[7:] if raw.startswith("Bearer ") else None
        principal = self.access_control.authenticate(token)
        if principal is None:
            raise AuthError(401, "missing or invalid bearer token")
        action = self._actions.get((method, head), "READ")
        if not principal.allows(action):
            raise AuthError(403, f"{principal.name} lacks {action}")
        set_current_principal(principal)

    def start(self) -> "HttpService":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"http-{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # shutdown() returns once serve_forever exits, so the join is quick;
        # guard for stop() without start() (config-error teardown paths)
        thread = getattr(self, "_thread", None)
        if thread is not None:
            thread.join(timeout=5.0)
        # drop idle pooled client connections: endpoints commonly die with
        # their co-located service (tests spin up hundreds) and parked
        # sockets to dead peers would sit in CLOSE_WAIT for the process life
        _POOL.clear()


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


# this process's outgoing identity (reference: per-service auth token configs
# like pinot.broker.segment.fetcher.auth.token) — applied to every http_call
_DEFAULT_TOKEN: Optional[str] = None

# this process's client-side TLS trust (reference: tls truststore configs);
# None = plain http / system trust
_CLIENT_SSL_CONTEXT = None


def set_default_token(token: Optional[str]) -> None:
    global _DEFAULT_TOKEN
    _DEFAULT_TOKEN = token


def set_default_tls(cafile: Optional[str] = None,
                    insecure: bool = False) -> None:
    """Configure this process's outgoing TLS trust: a CA bundle for the
    cluster's (self-signed) certs, or `insecure=True` to skip verification
    (test rigs only)."""
    import ssl
    global _CLIENT_SSL_CONTEXT
    if cafile is None and not insecure:
        _CLIENT_SSL_CONTEXT = None
        return
    ctx = ssl.create_default_context(cafile=cafile)
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    _CLIENT_SSL_CONTEXT = ctx


def client_ssl_context():
    return _CLIENT_SSL_CONTEXT


def open_client_connection(scheme: str, host: str, port: int,
                           timeout: float):
    """A fresh outgoing connection with this process's client TLS trust and
    TCP_NODELAY applied — the ONE place client sockets are minted. The pool
    draws from here; long-lived custom exchanges (mux streams) call it
    directly instead of importing http.client themselves."""
    import http.client

    if scheme == "https":
        ctx = _CLIENT_SSL_CONTEXT
        if ctx is None:
            import ssl
            ctx = ssl.create_default_context()
        conn = http.client.HTTPSConnection(host, port, timeout=timeout,
                                           context=ctx)
    else:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.connect()
    # TCP_NODELAY: header and body go out as separate writes; with Nagle
    # on a warm connection the second write waits for the peer's delayed
    # ACK (~40ms per request — measured 4.5ms -> 48ms p50 without this)
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


class _ConnPool:
    """Keep-alive connection pool per (scheme, host, port): every query pays
    TCP (+TLS) setup once per server instead of once per request (reference:
    the broker's pooled Netty channels per server). Connections are checked
    out exclusively; a request that fails on a REUSED connection retries once
    on a fresh one (the server may have idle-closed it between requests —
    the standard keep-alive staleness pattern), a fresh-connection failure is
    genuine and propagates."""

    MAX_IDLE_PER_HOST = 32

    def __init__(self):
        self._idle: Dict[Tuple[str, str, int], list] = {}
        self._lock = threading.Lock()

    def _key(self, scheme: str, host: str, port: int):
        return (scheme, host, port)

    def get(self, scheme: str, host: str, port: int, timeout: float):
        """(conn, reused) — reused connections may be stale."""
        with self._lock:
            stack = self._idle.get(self._key(scheme, host, port))
            if stack:
                conn = stack.pop()
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
        return open_client_connection(scheme, host, port, timeout), False

    def put(self, scheme: str, host: str, port: int, conn) -> None:
        with self._lock:
            stack = self._idle.setdefault(self._key(scheme, host, port), [])
            if len(stack) < self.MAX_IDLE_PER_HOST:
                stack.append(conn)
                return
        conn.close()

    def flush(self, scheme: str, host: str, port: int) -> None:
        """Drop every idle connection to one endpoint (a staleness failure
        means the peer restarted: its other parked connections are stale
        too, and the retry must get a genuinely FRESH socket)."""
        with self._lock:
            stack = self._idle.pop(self._key(scheme, host, port), [])
        for conn in stack:
            try:
                conn.close()
            except OSError:
                pass

    def clear(self) -> None:
        with self._lock:
            stacks = list(self._idle.values())
            self._idle.clear()
        for stack in stacks:
            for conn in stack:
                try:
                    conn.close()
                except OSError:
                    pass


_POOL = _ConnPool()


def _pooled_request(method: str, url: str, body: Optional[bytes],
                    headers: Dict[str, str], timeout: float,
                    return_headers: bool = False):
    """One pooled exchange; returns the body, or (body, lowercase response
    headers) with `return_headers=True` — for protocols whose pagination
    token rides a header (ADLS x-ms-continuation)."""
    parsed = urllib.parse.urlparse(url)
    scheme = parsed.scheme or "http"
    host = parsed.hostname or "127.0.0.1"
    port = parsed.port or (443 if scheme == "https" else 80)
    path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
    for attempt in (0, 1):
        conn, reused = _POOL.get(scheme, host, port, timeout)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except Exception as e:
            conn.close()
            # retry ONLY the keep-alive staleness signature on a reused
            # connection: the peer closed it idle, so the request was never
            # processed (RemoteDisconnected subclasses ConnectionResetError).
            # A TIMEOUT is NOT staleness — the server may be slow but
            # working, and replaying a non-idempotent POST would execute it
            # twice (double segment upload / commit). A restarted peer
            # leaves EVERY parked connection stale: flush them so the retry
            # gets a genuinely fresh socket, not stale conn #2.
            if reused and attempt == 0 and isinstance(
                    e, (ConnectionResetError, BrokenPipeError)):
                _POOL.flush(scheme, host, port)
                continue
            raise
        if resp.status >= 300:
            # no transparent redirect following (urlopen used to): inside the
            # cluster a 3xx is unexpected — surfacing it loudly beats
            # returning a redirect body as a successful payload
            conn.close()   # error bodies end the exchange; don't reuse
            raise HttpError(resp.status, data.decode(errors="replace"))
        if resp.will_close:
            conn.close()
        else:
            _POOL.put(scheme, host, port, conn)
        if return_headers:
            return data, {k.lower(): v for k, v in resp.getheaders()}
        return data
    raise ConnectionError(f"{method} {url}: unreachable")   # pragma: no cover


def http_call(method: str, url: str, body: Optional[bytes] = None,
              timeout: float = 30.0, retries: int = 0,
              content_type: str = "application/json",
              token: Optional[str] = None) -> bytes:
    """One HTTP request over the keep-alive pool, with optional
    connection-failure retries (reference: broker's retry/backoff in
    BaseExponentialBackoffRetryFailureDetector — here a bounded linear
    retry; callers decide unhealthy-marking)."""
    last: Optional[Exception] = None
    headers = {"Content-Type": content_type}
    bearer = token if token is not None else _DEFAULT_TOKEN
    if bearer:
        headers["Authorization"] = f"Bearer {bearer}"
    import http.client as _hc
    for attempt in range(retries + 1):
        try:
            return _pooled_request(method, url, body, headers, timeout)
        except HttpError:
            raise
        except (socket.timeout, ConnectionError, OSError,
                _hc.HTTPException) as e:
            # HTTPException covers mid-response protocol failures
            # (IncompleteRead/BadStatusLine) — part of the retry contract,
            # and callers' transport-failure classification expects
            # ConnectionError, not http.client internals
            last = e
            if attempt < retries:
                time.sleep(0.05 * (attempt + 1))
    raise ConnectionError(f"{method} {url} failed: {last}") from last


class PooledStream:
    """A pooled exchange whose RESPONSE is consumed incrementally (chunked
    frame streams — stage exchanges). Context-managed: a fully-read keep-alive
    response returns its connection to the pool on exit; anything else (early
    exit, error, Connection: close) closes the socket."""

    def __init__(self, conn, resp, key: Tuple[str, str, int], reusable: bool = True):
        self._conn = conn
        self._resp = resp
        self._key = key
        self._reusable = reusable

    def read(self, n: int = -1) -> bytes:
        return self._resp.read(n)

    def __enter__(self) -> "PooledStream":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None and self._reusable and self._resp.isclosed() and \
                not self._resp.will_close:
            _POOL.put(*self._key, self._conn)
        else:
            self._conn.close()
        return False


def http_stream(method: str, url: str, body=None, timeout: float = 30.0,
                content_type: str = "application/octet-stream",
                token: Optional[str] = None) -> PooledStream:
    """Open one pooled exchange and hand back the UNREAD response as a
    `PooledStream` (callers parse frame-structured bodies incrementally).
    `body` is bytes, or an iterable of byte chunks sent as a chunked request
    body (a peer's mailbox stream) on a fresh connection: a generator cannot
    be replayed on a stale one. Same keep-alive staleness retry and error
    taxonomy as `http_call`: >=300 raises HttpError, transport failures raise
    ConnectionError."""
    headers = {"Content-Type": content_type}
    bearer = token if token is not None else _DEFAULT_TOKEN
    if bearer:
        headers["Authorization"] = f"Bearer {bearer}"
    parsed = urllib.parse.urlparse(url)
    scheme = parsed.scheme or "http"
    host = parsed.hostname or "127.0.0.1"
    port = parsed.port or (443 if scheme == "https" else 80)
    path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
    import http.client as _hc
    streamed = body is not None and not isinstance(body, (bytes, bytearray, memoryview))
    for attempt in (0, 1):
        if streamed:
            conn, reused = open_client_connection(scheme, host, port, timeout), False
        else:
            conn, reused = _POOL.get(scheme, host, port, timeout)
        try:
            # an iterable body goes chunked (http.client adds the header)
            conn.request(method, path, body=body, headers=headers, encode_chunked=streamed)
            resp = conn.getresponse()
        except Exception as e:
            conn.close()
            # same staleness contract as _pooled_request: only a reused
            # connection's reset/broken-pipe before any response merits one
            # retry on a fresh socket
            if reused and attempt == 0 and isinstance(
                    e, (ConnectionResetError, BrokenPipeError)):
                _POOL.flush(scheme, host, port)
                continue
            if isinstance(e, (socket.timeout, OSError, _hc.HTTPException)) \
                    and not isinstance(e, ConnectionError):
                raise ConnectionError(f"{method} {url} failed: {e}") from e
            raise
        if resp.status >= 300:
            data = resp.read()
            conn.close()
            raise HttpError(resp.status, data.decode(errors="replace"))
        # a streamed-body route closes its connection after the response
        # (without saying so in a header): never pool it
        return PooledStream(conn, resp, (scheme, host, port), reusable=not streamed)
    raise ConnectionError(f"{method} {url}: unreachable")   # pragma: no cover


def get_json(url: str, timeout: float = 30.0, retries: int = 0,
             token: Optional[str] = None) -> Any:
    return json.loads(http_call("GET", url, timeout=timeout, retries=retries,
                                token=token).decode())


def post_json(url: str, obj: Any, timeout: float = 30.0, retries: int = 0,
              token: Optional[str] = None) -> Any:
    data = json.dumps(obj).encode()
    return json.loads(http_call("POST", url, data, timeout=timeout,
                                retries=retries, token=token).decode())
