"""Remote proxies: the HTTP clients that let server and broker processes join a cluster.

A trimmed copy of `pinot_tpu/cluster/remote.py`. The controller process owns
the catalog (`catalog.py`); a remote role mirrors it through
`RemoteCatalog`, a version-stamped snapshot with long-poll watches (the
ZooKeeper-watch analog) that fires the in-process catalog's events from
snapshot diffs, and forwards the mutations a remote role makes (instance
registration, external-view reports, properties) to the controller.
`RemoteCompletion` is a server's client of the segment completion protocol
(the reference's `ServerSegmentCompletionProtocolHandler` posting to
`LLCSegmentCompletionHandlers`): segment consumed, commit start, and commit
end with the built segment's tar as its body. `RemoteServerHandle` is the
broker's dispatch to a server: over the mux transport (`submit_async`, a
Future that holds no thread for the round trip) or one `POST /query` a
partial, and `join_stage` runs a funnel-path join partition on the server
(`POST /stage`); `ControllerDeepStore` reaches the deep store through the
controller; `ingestion_poller` and `memory_poller` are the controller's
reads of a server process's `GET /debug/consuming` (its consumers' lag
rollups) and `GET /debug/memory` (its ledger and tiering counters). What the minion needs (`RemoteController`, `RemoteTaskQueue`)
waits: ROADMAP.md queue 1, item 3.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.parse
from typing import Optional, Sequence

from ..schema import Schema
from ..table import TableConfig
from .catalog import Catalog, InstanceInfo, SegmentMeta
from .deepstore import DeepStoreFS, tar_segment
from .http_service import HttpError, get_json, http_call, http_stream, post_json
from .wire import decode_segment_result, encode_query_request


class RemoteCatalog(Catalog):
    """Catalog mirror for a remote role process.

    Reads are served from the local mirror (refreshed by a watch thread); the
    mutations a remote role performs are forwarded to the controller. Watch events
    fire exactly like the in-proc catalog's, driven by snapshot diffs.
    """

    def __init__(self, controller_url: str, poll_timeout_s: float = 10.0):
        super().__init__()
        self.controller_url = controller_url.rstrip("/")
        self._version = -1
        self._poll_timeout_s = poll_timeout_s
        self._stop = threading.Event()
        self._refresh()  # initial sync before any subscriber exists
        self._thread = threading.Thread(target=self._watch_loop,
                                        name="catalog-watch", daemon=True)
        self._thread.start()

    # -- remote-forwarded mutations ----------------------------------------
    def register_instance(self, info: InstanceInfo) -> None:
        post_json(f"{self.controller_url}/catalog/instances", info.to_json(),
                  retries=2)
        super().register_instance(info)

    def report_state(self, table: str, segment: str, server: str, state) -> None:
        post_json(f"{self.controller_url}/catalog/externalView",
                  {"table": table, "segment": segment, "server": server,
                   "state": state}, retries=2)
        super().report_state(table, segment, server, state)

    def set_instance_alive(self, instance_id: str, alive: bool) -> None:
        post_json(f"{self.controller_url}/catalog/instances",
                  {"instance_id": instance_id, "alive": alive}, retries=2)
        super().set_instance_alive(instance_id, alive)

    def put_property(self, key: str, value) -> None:
        post_json(f"{self.controller_url}/catalog/property",
                  {"key": key, "value": value}, retries=2)
        super().put_property(key, value)

    def mutate_property(self, key: str, fn):
        # A remote read-modify-write needs a controller-side CAS endpoint; silently
        # mutating only the mirror would be clobbered by the next snapshot poll
        # (e.g. two minions double-claiming a task). Fail loudly until that exists.
        raise NotImplementedError(
            "mutate_property is not supported on RemoteCatalog; run task claiming "
            "(TaskQueue) against the controller's in-proc catalog")

    # -- watch loop ----------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        # best-effort reap: an idle watcher exits immediately; one blocked in
        # the long poll is a daemon and dies at its poll boundary — teardown
        # must not wait out an in-flight controller hold
        self._thread.join(timeout=1.0)

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                resp = get_json(f"{self.controller_url}/catalog/watch"
                                f"?since={self._version}"
                                f"&timeoutSec={self._poll_timeout_s}",
                                timeout=self._poll_timeout_s + 10)
                if resp.get("version", -1) != self._version:
                    self._refresh()
            except (ConnectionError, HttpError):
                if self._stop.wait(0.5):
                    return
            except Exception as e:
                # a subscriber callback blowing up (transient consumer-create
                # failure, reconcile error) must NOT kill the watch thread —
                # that would permanently blind this node to catalog changes
                import sys
                print(f"[pinot-tpu] catalog watch error: {type(e).__name__}: {e}",
                      file=sys.stderr)
                if self._stop.wait(0.5):
                    return

    def _refresh(self) -> None:
        snap = get_json(f"{self.controller_url}/catalog/snapshot", retries=2)
        with self._lock:
            old_ideal = self.ideal_state
            old_ev = self.external_view
            # content-sensitive: a config VALUE change (quota, indexing) must fire
            # a 'table' event too, not just key add/remove
            old_tables = {k: json.dumps(v.to_json(), sort_keys=True)
                          for k, v in self.table_configs.items()}
            old_instances = {k: (v.alive, v.port) for k, v in self.instances.items()}
            old_properties = dict(self.properties)

            self.schemas = {k: Schema.from_json(v)
                            for k, v in snap["schemas"].items()}
            self.table_configs = {k: TableConfig.from_json(v)
                                  for k, v in snap["tableConfigs"].items()}
            self.segments = {t: {s: SegmentMeta.from_json(m)
                                 for s, m in segs.items()}
                             for t, segs in snap["segments"].items()}
            self.ideal_state = snap["idealState"]
            self.external_view = snap["externalView"]
            self.instances = {k: InstanceInfo.from_json(v)
                              for k, v in snap["instances"].items()}
            self.properties = snap.get("properties", {})
            self._version = snap["version"]

            ideal_changed = [t for t in set(old_ideal) | set(self.ideal_state)
                             if old_ideal.get(t) != self.ideal_state.get(t)]
            ev_changed = [t for t in set(old_ev) | set(self.external_view)
                          if old_ev.get(t) != self.external_view.get(t)]
            new_tables = {k: json.dumps(v.to_json(), sort_keys=True)
                          for k, v in self.table_configs.items()}
            table_changed = [k for k in set(old_tables) | set(new_tables)
                             if old_tables.get(k) != new_tables.get(k)]
            inst_changed = [
                k for k, v in self.instances.items()
                if old_instances.get(k) != (v.alive, v.port)
            ] + [k for k in old_instances if k not in self.instances]
            prop_changed = [k for k in set(old_properties) | set(self.properties)
                            if old_properties.get(k) != self.properties.get(k)]

        for t in table_changed:
            self._notify("table", t)
        for t in ideal_changed:
            self._notify("ideal_state", t)
        for t in ev_changed:
            self._notify("external_view", t)
        for i in inst_changed:
            self._notify("instance", i)
        for k in prop_changed:
            self._notify("property", k)


class RemoteCompletion:
    """A server's HTTP client of the segment completion protocol, with the
    LLC segment manager's three calls (`cluster/completion.py`)."""

    def __init__(self, controller_url: str):
        self.controller_url = controller_url.rstrip("/")

    def segment_consumed(self, segment: str, server: str, offset: int):
        return post_json(f"{self.controller_url}/segmentConsumed",
                         {"segment": segment, "server": server, "offset": offset}, retries=2)

    def segment_commit_start(self, segment: str, server: str) -> str:
        return post_json(f"{self.controller_url}/segmentCommitStart",
                         {"segment": segment, "server": server}, retries=2)["status"]

    def segment_commit_end(self, segment: str, server: str, segment_dir: str,
                           end_offset: int) -> str:
        """Tar the locally built segment and send it with the commit end (the
        reference's commitSegment: the end metadata and the file upload)."""
        with tempfile.TemporaryDirectory() as tmp:
            tar_path = os.path.join(tmp, f"{segment}.tar.gz")
            tar_segment(segment_dir, tar_path)
            with open(tar_path, "rb") as f:
                payload = f.read()
        q = urllib.parse.urlencode({"segment": segment, "server": server, "offset": end_offset})
        resp = http_call("POST", f"{self.controller_url}/segmentCommitEnd?{q}", payload,
                         content_type="application/octet-stream", timeout=300.0)
        return json.loads(resp.decode())["status"]


class RemoteServerHandle:
    """Broker -> server query dispatch over HTTP; matches the in-proc
    `ServerHandle` signature (reference: QueryRouter.submitQuery + DataTable
    deserialize on response).

    Two transports: `submit_async` multiplexes tagged queries over the mux
    stream (`cluster/mux.py`) and returns a Future WITHOUT holding a thread
    for the round trip — the broker's scatter prefers it; `__call__` blocks
    (riding the mux future when available, else the legacy one-exchange-per-
    query POST /query). `use_mux=False` pins the legacy transport (the
    differential tests dispatch both ways and compare)."""

    def __init__(self, server_url: str, timeout_s: float = 60.0,
                 token: Optional[str] = None, use_mux: bool = True,
                 mux_streams: int = 1):
        self.server_url = server_url.rstrip("/")
        self.timeout_s = timeout_s
        # explicit per-handle token (external connector processes have no
        # process-global default token); None falls back to the default
        self.token = token
        self.use_mux = use_mux
        self._mux_streams = max(1, int(mux_streams))
        self._mux = None               # lazily opened MuxClient
        self._mux_unsupported = False  # old peer without /mux: legacy forever
        self._mux_down_until = 0.0     # transient legacy window after backoff
        self._mux_lock = threading.Lock()

    #: how long dispatch rides the legacy transport after the mux client
    #: exhausts its reconnect backoff; afterwards mux is retried (the peer may
    #: have restarted) rather than being pinned to legacy forever.
    MUX_COOLDOWN_S = 1.0

    def _mux_client(self):
        from .mux import MuxClient
        with self._mux_lock:
            if self._mux is None:
                from .http_service import _DEFAULT_TOKEN
                token = self.token if self.token is not None \
                    else _DEFAULT_TOKEN
                self._mux = MuxClient(self.server_url, token=token,
                                      streams=self._mux_streams,
                                      timeout_s=self.timeout_s)
            return self._mux

    def close(self) -> None:
        with self._mux_lock:
            mux, self._mux = self._mux, None
        if mux is not None:
            mux.close()

    def submit_async(self, table: str, ctx, segment_names: Sequence[str],
                     time_filter: Optional[str] = None,
                     span_name: Optional[str] = None):
        """Mux dispatch: a Future resolving to the decoded SegmentResult
        (tracing spliced, frame-queue stats folded in — same observable
        surface as `__call__`). Returns None when mux is disabled or the
        peer predates /mux; the caller falls back to the legacy transport."""
        if not self.use_mux or self._mux_unsupported:
            return None
        if time.time() < self._mux_down_until:
            return None  # inside the post-backoff cooldown: ride legacy
        from ..utils.metrics import get_registry
        from ..utils.trace import current_depth, current_trace
        sql = ctx if isinstance(ctx, str) else ctx.sql
        if not sql:
            raise ValueError("remote dispatch requires the query SQL text")
        tr = current_trace()
        depth = current_depth() if tr is not None else 0
        dispatch_ms = tr.elapsed_ms() if tr is not None else 0.0
        t0 = time.perf_counter()
        body = encode_query_request(
            table, sql, segment_names, time_filter,
            trace=tr is not None,
            trace_id=tr.trace_id if tr is not None else "",
            sampled=bool(tr.sampled) if tr is not None else False)
        if tr is not None:
            tr.record("serialize", dispatch_ms,
                      (time.perf_counter() - t0) * 1000, depth + 1)
        try:
            return self._mux_client().submit(
                body, trace=tr, depth=depth, dispatch_ms=dispatch_ms,
                span_name=span_name)
        except HttpError as e:
            if e.status in (404, 405, 501):
                # peer without a /mux route: remember and use legacy for good
                self._mux_unsupported = True
                get_registry().counter("pinot_broker_mux_fallbacks").inc()
                return None
            raise
        except ConnectionError:
            # the mux client already burned its jittered-backoff budget
            # (MuxClient.submit retries internally); answer by retrying this
            # request over the legacy per-request transport, and keep riding
            # it for a short cooldown so a dead peer isn't re-probed through
            # the full backoff ladder on every scatter
            self._mux_down_until = time.time() + self.MUX_COOLDOWN_S
            get_registry().counter("pinot_broker_mux_fallbacks").inc()
            return None

    #: longest Retry-After deferral honored before the single bounded retry
    #: (server hints can be large under saturation; a dispatch thread must
    #: not sleep seconds inside a scatter)
    RETRY_AFTER_CAP_S = 0.1

    def __call__(self, table: str, ctx, segment_names: Sequence[str],
                 time_filter: Optional[str] = None):
        try:
            return self._call_once(table, ctx, segment_names, time_filter)
        except HttpError as e:
            # overload-aware retry: a 429 carrying the server's Retry-After
            # hint (drain-rate estimate from its scheduler) gets exactly ONE
            # deferred retry after honoring the hint — bounded, so backoff
            # never amplifies into the blind hammering the hint exists to stop
            if e.status != 429:
                raise
            hint_ms = getattr(e, "retry_after_ms", None)
            if hint_ms is None:
                # legacy transport: the hint rides the JSON error body, which
                # http_call folds into the exception message
                s = str(e)
                try:
                    hint_ms = json.loads(s[s.index("{"):]).get("retryAfterMs")
                except (ValueError, AttributeError):
                    hint_ms = None
            if hint_ms is None:
                raise
            time.sleep(min(float(hint_ms) / 1000.0, self.RETRY_AFTER_CAP_S))
            return self._call_once(table, ctx, segment_names, time_filter)

    def _call_once(self, table: str, ctx, segment_names: Sequence[str],
                   time_filter: Optional[str] = None):
        from concurrent.futures import TimeoutError as _FutureTimeout

        from ..utils.trace import current_depth, current_trace, span
        fut = self.submit_async(table, ctx, segment_names, time_filter)
        if fut is not None:
            try:
                return fut.result(timeout=self.timeout_s)
            except _FutureTimeout:
                # the stream's stale-reap fails the wedged connection on the
                # next submit; classify this as a transport failure now
                raise ConnectionError(
                    f"mux response from {self.server_url} timed out "
                    f"after {self.timeout_s}s") from None
        sql = ctx if isinstance(ctx, str) else ctx.sql
        if not sql:
            raise ValueError("remote dispatch requires the query SQL text")
        tr = current_trace()
        dispatch_ms = tr.elapsed_ms() if tr is not None else 0.0
        # wire-level spans decompose the broker<->server hop: serialize the
        # request, the on-the-wire round trip (send), deserialize the result —
        # the server's own queue_wait/deserialize/exec spans splice in below
        with span("serialize"):
            body = encode_query_request(
                table, sql, segment_names, time_filter,
                trace=tr is not None,
                trace_id=tr.trace_id if tr is not None else "",
                sampled=bool(tr.sampled) if tr is not None else False)
        with span("send"):
            resp = http_call("POST", f"{self.server_url}/query", body,
                             timeout=self.timeout_s,
                             content_type="application/octet-stream",
                             token=self.token)
        with span("deserialize"):
            result = decode_segment_result(resp)
        spans = getattr(result, "trace_spans", None)
        if tr is not None and spans:
            # already prefixed server-side with its instance id; rebase the server's
            # local clock onto this trace's axis at the dispatch point, and nest
            # its spans one level under the dispatching server:<id> span
            tr.splice(spans, offset_ms=dispatch_ms,
                      depth_offset=current_depth())
        return result

    def explain(self, table: str, ctx, segment_names: Sequence[str]):
        """EXPLAIN rows from the remote server (POST /explain, JSON)."""
        sql = ctx if isinstance(ctx, str) else ctx.sql
        body = encode_query_request(table, sql, segment_names)
        resp = http_call("POST", f"{self.server_url}/explain", body,
                         timeout=self.timeout_s,
                         content_type="application/octet-stream",
                         token=self.token)
        return json.loads(resp.decode())["rows"]

    def join_stage(self, spec, left, right, agg=None):
        """One multistage stage partition on the remote server (POST /stage
        with wire-encoded blocks). The response is a chunked stream of
        length-prefixed frames over the keep-alive pool (`http_stream`):
        joined-row block frames, read one at a time, or one partial
        aggregation frame, which decodes to a mergeable SegmentResult."""
        from ..multistage.runtime import _concat_blocks, agg_spec_to_json, spec_to_json
        from ..multistage.shuffle import read_frame
        from .wire import decode_block, encode_value
        body = encode_value({"spec": spec_to_json(spec), "agg": agg_spec_to_json(agg),
                             "left": dict(left), "right": dict(right)})
        blocks = []
        with http_stream("POST", f"{self.server_url}/stage", body, timeout=self.timeout_s,
                         token=self.token) as resp:
            while True:
                d = read_frame(resp)
                if d["kind"] == "end":
                    resp.read()   # the terminal chunk: the connection can be pooled
                    break
                if d["kind"] == "partial":
                    return decode_segment_result(d["result"])
                blocks.append(decode_block(d["block"]))
        return _concat_blocks(blocks)


def ingestion_poller(server_url: str):
    """The controller's poll of a server process's consumers: a call that
    GETs its `/debug/consuming` and answers its tables' rollups (one retry
    on a connection failure)."""
    def poll():
        return get_json(f"{server_url}/debug/consuming", timeout=5.0, retries=1).get("tables", {})
    return poll


def memory_poller(server_url: str):
    """The controller's poll of a server process's memory ledger: a call that
    GETs its `/debug/memory` (one retry on a connection failure)."""
    def poll():
        return get_json(f"{server_url}/debug/memory", timeout=5.0, retries=1)
    return poll


class ControllerDeepStore(DeepStoreFS):
    """Deep-store access through the controller by URL (reference: the http
    segment fetcher of `SegmentFetcherFactory`): a server without the deep
    store's credentials downloads its segments through the controller. The
    controller serves GET and POST only, so the SPI's delete, exists and
    listdir stay unimplemented here."""

    scheme = "http"

    def __init__(self, controller_url: str):
        self.controller_url = controller_url.rstrip("/")

    def upload(self, local_path: str, uri: str) -> None:
        with open(local_path, "rb") as f:
            http_call("POST", f"{self.controller_url}/deepstore/{uri}", f.read(),
                      content_type="application/octet-stream", timeout=120.0)

    def download(self, uri: str, local_path: str) -> None:
        data = http_call("GET", f"{self.controller_url}/deepstore/{uri}",
                         timeout=120.0, retries=2)
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        with open(local_path, "wb") as f:
            f.write(data)
