"""HTTP services for each cluster role: controller, server, broker.

A trimmed copy of `pinot_tpu/cluster/services.py`. Each wraps an in-process
role object (`controller.py`, `server.py`, `broker.py`) with the reference's
endpoints:

* `ControllerService`: the catalog API that stands in for ZooKeeper (a
  snapshot and a long-poll watch on a version counter bumped by every
  catalog event), schema, table and segment CRUD with the segment tar
  upload (a table with a stream config made with its consuming segments,
  `numPartitions` of them), the segment download (a `peer://` segment's from
  a serving peer), the segment completion protocol (`segmentConsumed`,
  `segmentCommitStart`, `segmentCommitEnd` with the built segment's tar),
  the consumption pause and resume, the deep-store proxy, table status,
  segment metadata, tenants, cluster configs, table state, instance tags,
  rebalance, the validation round, the memory check (`POST /memoryCheck`)
  and each table's verdicts (`GET /tables/{t}/memoryStatus`, `GET
  /tables/{t}/ingestionStatus`), metrics, debug, and the `sql` proxy to a
  live broker.
* `ServerService`: `POST /query` (one binary wire exchange a partial),
  `POST /mux` (the multiplexed transport, `mux.py`), `POST /explain`,
  the multistage data plane (`POST /stage`, a funnel-path join partition;
  `POST` and `DELETE /mailbox`, the peers' partition streams and their
  cancellation; `leafStage`, `leafAgg`, `joinStage` and `aggStage`, the
  mailbox shuffle's tasks, `multistage/shuffle.py`; its URL registered as a
  local endpoint while it runs), health and readiness, debug, segments,
  `segmentData` (the tar of a loaded segment: the peer download scheme),
  `/debug/consuming` (its consumers' lag rollups), `/debug/memory` (its
  memory ledger and tiering counters) and metrics. Its
  `/debug` also
  reports this process's kernel launches (`scan.masked_sums`,
  `scan.masked_sums_fused`, `bitmap.bitmap_filter`, `grouped.grouped_agg`;
  `POST /debug/launches/reset` sets them to 0), its device memory
  (`torch.cuda.memory_allocated` and the bytes its staged blocks hold), its
  realtime consumers and whether `jax` or `pinot_tpu` was ever imported in
  it: fields of this package, which the JAX package's server does not report.
* `BrokerService`: `POST /query`, `POST /queryStream` (JSON lines over
  chunked HTTP), health, metrics and debug; it wires a `RemoteServerHandle`
  for every live server the catalog advertises, with its stage handle and
  URL (the mailbox shuffle's worker).

Routes that wait answer 501 with the ROADMAP.md item that holds them: the
minion's `tasks`, `replaceSegments` and `ingestJobs`, and the admin UI.
`/metrics` answers the registry's snapshot as JSON: the Prometheus text export
waits.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from ..multistage.runtime import agg_spec_from_json, run_join_stage, spec_from_json
from ..multistage.shuffle import (REGISTRY, MailboxCancelled, frame_bytes, read_frame,
                                  register_local_endpoint, run_agg_stage_task,
                                  run_join_stage_task, run_leaf_agg_task, run_leaf_join_task,
                                  unregister_local_endpoint)
from ..schema import Schema
from ..table import TableConfig
from ..utils.metrics import get_registry
from .broker import Broker
from .catalog import InstanceInfo
from .controller import Controller
from .deepstore import untar_segment
from .http_service import HttpService, binary_response, error_response, json_response
from .remote import RemoteServerHandle
from .server import ServerNode
from .wire import (decode_block, decode_query_request, decode_segment_result, decode_value,
                   encode_segment_result, encode_value)

MINION_WAITS = "the minion and its task routes wait: ROADMAP.md queue 1, item 3"
UI_WAITS = "the admin UI waits: ROADMAP.md queue 1, item 3"


def _waits(reason: str):
    def handler(parts, params, body):
        return error_response(reason, 501)
    return handler


def _json_default(v):
    import numpy as np
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def _json(obj, status: int = 200):
    return status, "application/json", json.dumps(obj, default=_json_default).encode()


def _metrics_route(parts, params, body):
    """GET /metrics: the process registry's snapshot, {series: value}."""
    from ..utils.metrics import get_registry
    return _json(get_registry().snapshot())


def _events_route(params):
    """GET /debug/events?since=<seq>: the process journal past the cursor."""
    from ..utils.events import get_journal
    try:
        since = int(params.get("since", 0))
    except (TypeError, ValueError):
        since = 0
    try:
        limit = int(params["limit"]) if "limit" in params else None
    except (TypeError, ValueError):
        limit = None
    return _json(get_journal().events_since(since, limit))


def _untar_body(body: bytes, name: str, dest: str) -> str:
    """Write an uploaded segment tar to disk and unpack it; returns the segment dir."""
    tar_path = os.path.join(dest, f"{name}.tar.gz")
    with open(tar_path, "wb") as f:
        f.write(body)
    return untar_segment(tar_path, dest)


class ControllerService:
    """Controller role process: owns the authoritative catalog and the deep store."""

    def __init__(self, controller: Controller, host: str = "127.0.0.1",
                 port: int = 0, access_control=None, ssl_context=None):
        self.controller = controller
        self.catalog = controller.catalog
        self.http = HttpService(host, port, access_control=access_control,
                                ssl_context=ssl_context)
        # the catalog's version: every catalog event bumps it, and a watch
        # waits on it (the reference's ZooKeeper watch)
        self._version = 0
        self._version_cv = threading.Condition()
        self.catalog.subscribe(self._bump_version)
        s = self.http
        s.route("GET", "health", lambda p, q, b: json_response({"status": "OK"}))
        s.route("GET", "catalog", self._catalog_get)
        s.route("POST", "catalog", self._catalog_post, action="WRITE")
        s.route("POST", "schemas", self._post_schema, action="WRITE")
        s.route("GET", "schemas", self._get_schema)
        s.route("POST", "tables", self._post_table, action="WRITE")
        s.route("GET", "tables", self._get_tables)
        s.route("DELETE", "tables", self._delete_table, action="ADMIN")
        s.route("POST", "segments", self._post_segment, action="WRITE")
        s.route("GET", "segments", self._get_segment)
        s.route("DELETE", "segments", self._delete_segment, action="ADMIN")
        s.route("GET", "deepstore", self._deepstore_get)
        s.route("POST", "deepstore", self._deepstore_post, action="WRITE")
        s.route("GET", "tableStatus", self._table_status)
        s.route("GET", "segmentsMeta", self._segments_meta)
        s.route("POST", "reload", self._reload_table, action="WRITE")
        s.route("GET", "tenants", self._list_tenants)
        s.route("GET", "clusterConfigs", self._get_cluster_configs)
        s.route("POST", "clusterConfigs", self._set_cluster_config, action="ADMIN")
        s.route("POST", "tableState", self._table_state, action="ADMIN")
        s.route("POST", "instanceTags", self._update_instance_tags, action="ADMIN")
        s.route("POST", "rebalance", self._rebalance, action="ADMIN")
        s.route("POST", "validate", self._validate, action="ADMIN")
        s.route("POST", "memoryCheck", self._memory_check, action="ADMIN")
        s.route("GET", "metrics", _metrics_route)
        s.route("GET", "debug", self._debug)
        s.route("POST", "sql", self._sql_proxy)
        s.route("POST", "segmentConsumed", self._segment_consumed, action="WRITE")
        s.route("POST", "segmentCommitStart", self._segment_commit_start, action="WRITE")
        s.route("POST", "segmentCommitEnd", self._segment_commit_end, action="WRITE")
        s.route("POST", "pauseConsumption", self._pause_consumption, action="ADMIN")
        s.route("POST", "resumeConsumption", self._resume_consumption, action="ADMIN")
        for method, head in (("POST", "tasks"), ("GET", "tasks"), ("POST", "replaceSegments"),
                             ("POST", "ingestJobs")):
            s.route(method, head, _waits(MINION_WAITS))
        s.route("GET", "", _waits(UI_WAITS))
        s.route("GET", "ui", _waits(UI_WAITS))
        self.http.start()

    @property
    def url(self) -> str:
        return self.http.url

    def stop(self) -> None:
        self.http.stop()

    def _debug(self, parts, params, body):
        """GET /debug: the controller's rollup; GET /debug/events: the journal."""
        if parts and parts[0] == "events":
            return _events_route(params)
        return _json(self.controller.debug_stats())

    def _sql_proxy(self, parts, params, body):
        """POST /sql {"sql": ...}: forward to a live broker (reference: the
        controller's PinotQueryResource), trying each until one answers."""
        from .http_service import post_json
        d = json.loads(body.decode())
        with self.catalog._lock:
            brokers = [(i.instance_id, i.url) for i in self.catalog.instances.values()
                       if i.role == "broker" and i.alive and i.port]
        last = "no live broker registered"
        for _bid, url in sorted(brokers):
            try:
                return json_response(post_json(f"{url}/query", {"sql": d["sql"]},
                                               timeout=60.0))
            except Exception as e:
                last = f"{type(e).__name__}: {e}"
        return json_response({"error": f"broker unavailable: {last}"}, status=503)

    # -- catalog API (the ZooKeeper stand-in) -----------------------------
    def _bump_version(self, event: str, table: str) -> None:
        with self._version_cv:
            self._version += 1
            self._version_cv.notify_all()

    def _catalog_get(self, parts, params, body):
        if parts and parts[0] == "snapshot":
            with self.catalog._lock:
                snap = {
                    "version": self._version,
                    "schemas": {k: v.to_json() for k, v in self.catalog.schemas.items()},
                    "tableConfigs": {k: v.to_json()
                                     for k, v in self.catalog.table_configs.items()},
                    "segments": {t: {s: m.to_json() for s, m in segs.items()}
                                 for t, segs in self.catalog.segments.items()},
                    "idealState": self.catalog.ideal_state,
                    "externalView": self.catalog.external_view,
                    "instances": {k: v.to_json() for k, v in self.catalog.instances.items()},
                    "properties": self.catalog.properties,
                }
                # serialized under the lock: the dicts change in place
                data = json.dumps(snap, default=_json_default).encode()
            return 200, "application/json", data
        if parts and parts[0] == "watch":
            since = int(params.get("since", -1))
            timeout = float(params.get("timeoutSec", 10.0))
            with self._version_cv:
                self._version_cv.wait_for(lambda: self._version != since, timeout=timeout)
                return json_response({"version": self._version})
        return error_response("not found", 404)

    def _catalog_post(self, parts, params, body):
        d = json.loads(body.decode())
        if parts and parts[0] == "instances":
            if "role" in d:
                self.catalog.register_instance(InstanceInfo.from_json(d))
            else:   # a liveness update
                self.catalog.set_instance_alive(d["instance_id"], d["alive"])
            return json_response({"status": "OK"})
        if parts and parts[0] == "externalView":
            self.catalog.report_state(d["table"], d["segment"], d["server"], d["state"])
            return json_response({"status": "OK"})
        if parts and parts[0] == "property":
            self.catalog.put_property(d["key"], d.get("value"))
            return json_response({"status": "OK"})
        return error_response("not found", 404)

    # -- schemas, tables, segments ----------------------------------------
    def _post_schema(self, parts, params, body):
        self.controller.add_schema(Schema.from_json(json.loads(body.decode())))
        return json_response({"status": "OK"})

    def _get_schema(self, parts, params, body):
        with self.catalog._lock:
            schema = self.catalog.schemas.get(parts[0]) if parts else None
            resp = schema.to_json() if schema is not None else None
        if resp is None:
            return error_response(f"unknown schema {parts[0] if parts else ''}", 404)
        return json_response(resp)

    def _post_table(self, parts, params, body):
        d = json.loads(body.decode())
        cfg = TableConfig.from_json(d["config"] if "config" in d else d)
        if cfg.stream is not None:
            try:
                segs = self.controller.add_realtime_table(cfg, int(d.get("numPartitions", 1)))
            except ValueError as e:
                return error_response(str(e), 400)
            return json_response({"status": "OK", "consumingSegments": segs})
        self.controller.add_table(cfg)
        return json_response({"status": "OK"})

    def _get_tables(self, parts, params, body):
        if len(parts) == 2 and parts[1] == "ingestionStatus":
            # GET /tables/{t}/ingestionStatus: the verdict, polled live from
            # the servers (outside the catalog's lock)
            try:
                return json_response(self.controller.ingestion_status(parts[0]))
            except ValueError as e:
                return error_response(str(e), 404)
        if len(parts) == 2 and parts[1] == "memoryStatus":
            # GET /tables/{t}/memoryStatus: the memory check's verdict
            try:
                return json_response(self.controller.memory_status(parts[0]))
            except ValueError as e:
                return error_response(str(e), 404)
        with self.catalog._lock:
            if parts:   # GET /tables/{nameWithType}: the table config
                cfg = self.catalog.table_configs.get(parts[0])
                resp = None if cfg is None else {"config": cfg.to_json()}
            else:
                resp = {"tables": sorted(self.catalog.table_configs)}
        if resp is None:
            return error_response(f"unknown table {parts[0]}", 404)
        return json_response(resp)

    def _delete_table(self, parts, params, body):
        self.controller.drop_table(parts[0])
        return json_response({"status": "OK"})

    def _post_segment(self, parts, params, body):
        """POST /segments/{tableNameWithType}?name=...[&custom=json] with the
        tar as the body (reference: PinotSegmentUploadDownloadRestletResource)."""
        table = parts[0]
        from ..auth import require_table_access
        require_table_access(table, "WRITE")
        name = params["name"]
        custom = json.loads(params["custom"]) if params.get("custom") else None
        with tempfile.TemporaryDirectory() as tmp:
            seg_dir = _untar_body(body, name, tmp)
            meta = self.controller.upload_segment(table, seg_dir, custom=custom)
        return json_response({"status": "OK", "segment": meta.name})

    def _get_segment(self, parts, params, body):
        """GET /segments/{table}/{name}: the committed tar, from the deep
        store or (a `peer://` segment, a failing deep store) a serving peer."""
        table, name = parts[0], parts[1]
        from ..auth import require_table_access
        from .peers import download_segment_tar
        require_table_access(table, "READ")   # raw data: the queries' ACL
        with self.catalog._lock:
            meta = self.catalog.segments.get(table, {}).get(name)
            path = meta.download_path if meta is not None else None
        if not path:
            return error_response(f"no such segment {table}/{name}", 404)
        with tempfile.TemporaryDirectory() as tmp:
            local = os.path.join(tmp, "seg.tar.gz")
            download_segment_tar(self.controller.deepstore, self.catalog, table, name, local,
                                 path)
            with open(local, "rb") as f:
                return binary_response(f.read())

    def _delete_segment(self, parts, params, body):
        permanent = str(params.get("permanent", "")).lower() in ("true", "1")
        self.controller.delete_segment(parts[0], parts[1], permanent=permanent)
        return json_response({"status": "OK"})

    # -- admin reads and writes (reference: PinotTableRestletResource et al.) --
    def _table_status(self, parts, params, body):
        return json_response(self.controller.table_status(parts[0]))

    def _segments_meta(self, parts, params, body):
        """GET /segmentsMeta/{tableNameWithType}: each segment's metadata."""
        table = parts[0]
        with self.catalog._lock:
            segs = self.catalog.segments.get(table)
            resp = None if segs is None else \
                {"segments": {s: m.to_json() for s, m in segs.items()}}
        if resp is None:
            return error_response(f"unknown table {table}", 404)
        return json_response(resp)

    def _reload_table(self, parts, params, body):
        if parts[0] not in self.catalog.table_configs:
            return error_response(f"unknown table {parts[0]}", 404)
        self.controller.reload_table(parts[0])
        return json_response({"status": "OK", "table": parts[0]})

    def _list_tenants(self, parts, params, body):
        return json_response({"tenants": self.controller.list_tenants()})

    def _get_cluster_configs(self, parts, params, body):
        """GET /clusterConfigs: the catalog's clusterConfig/ properties."""
        with self.catalog._lock:
            out = {k.split("/", 1)[1]: v for k, v in self.catalog.properties.items()
                   if k.startswith("clusterConfig/")}
        return json_response({"clusterConfigs": out})

    def _set_cluster_config(self, parts, params, body):
        """POST /clusterConfigs {"key": ..., "value": ...} (a null value deletes)."""
        d = json.loads(body.decode())
        self.catalog.put_property(f"clusterConfig/{d['key']}", d.get("value"))
        return json_response({"status": "OK", "key": d["key"], "value": d.get("value")})

    def _table_state(self, parts, params, body):
        """POST /tableState/{table}?state=enable|disable."""
        state = str(params.get("state", "")).lower()
        if state not in ("enable", "disable"):
            return error_response("state must be enable|disable", 400)
        try:
            self.controller.set_table_state(parts[0], state == "enable")
        except ValueError as e:
            return error_response(str(e), 404)
        return json_response({"status": "OK", "table": parts[0], "state": state})

    def _update_instance_tags(self, parts, params, body):
        """POST /instanceTags/{instanceId} {"tags": [...]}."""
        d = json.loads(body.decode())
        try:
            self.controller.update_instance_tags(parts[0], list(d["tags"]))
        except ValueError as e:
            return error_response(str(e), 404)
        return json_response({"status": "OK", "instance": parts[0], "tags": d["tags"]})

    def _rebalance(self, parts, params, body):
        moves = self.controller.rebalance(parts[0])
        return json_response({"status": "OK", "idealState": moves})

    def _validate(self, parts, params, body):
        """POST /validate: one realtime validation round now (the periodic
        task's work, on demand): successors, dead replicas, peer-scheme
        segments healed."""
        return json_response(self.controller.llc.validate())

    def _memory_check(self, parts, params, body):
        """POST /memoryCheck: one memory check now (the periodic task's body);
        answers each table's verdict."""
        return json_response(self.controller.run_memory_check())

    def _pause_consumption(self, parts, params, body):
        """POST /pauseConsumption/{tableNameWithType} (the reference's
        PinotRealtimeTableResource.pauseConsumption)."""
        try:
            return json_response(self.controller.llc.pause_consumption(parts[0]))
        except ValueError as e:
            return error_response(str(e), 400)

    def _resume_consumption(self, parts, params, body):
        try:
            return json_response(self.controller.llc.resume_consumption(parts[0]))
        except ValueError as e:
            return error_response(str(e), 400)

    # -- the segment completion protocol (LLCSegmentCompletionHandlers) ------
    def _segment_consumed(self, parts, params, body):
        d = json.loads(body.decode())
        return json_response(self.controller.llc.segment_consumed(
            d["segment"], d["server"], int(d["offset"])))

    def _segment_commit_start(self, parts, params, body):
        d = json.loads(body.decode())
        return json_response({"status": self.controller.llc.segment_commit_start(
            d["segment"], d["server"])})

    def _segment_commit_end(self, parts, params, body):
        """POST /segmentCommitEnd?segment=&server=&offset= with the built
        segment's tar as the body."""
        segment, server, offset = params["segment"], params["server"], int(params["offset"])
        with tempfile.TemporaryDirectory() as tmp:
            seg_dir = _untar_body(body, segment, tmp)
            status = self.controller.llc.segment_commit_end(segment, server, seg_dir, offset)
        return json_response({"status": status})

    # -- deep-store proxy ---------------------------------------------------
    def _deepstore_get(self, parts, params, body):
        uri = "/".join(parts)
        # deep-store URIs lead with the table name: a reader of one table must
        # not fetch another's segments
        from ..auth import require_table_access
        if parts:
            require_table_access(parts[0], "READ")
        with tempfile.TemporaryDirectory() as tmp:
            local = os.path.join(tmp, "blob")
            self.controller.deepstore.download(uri, local)
            with open(local, "rb") as f:
                return binary_response(f.read())

    def _deepstore_post(self, parts, params, body):
        uri = "/".join(parts)
        with tempfile.TemporaryDirectory() as tmp:
            local = os.path.join(tmp, "blob")
            with open(local, "wb") as f:
                f.write(body)
            self.controller.deepstore.upload(local, uri)
        return json_response({"status": "OK"})


def kernel_launch_counts() -> Dict[str, int]:
    """This process's launches of each hand kernel (each wrapper counts where
    it launches, and nowhere else)."""
    from ..engine import bitmap, grouped, scan
    return {"masked_sums": scan.masked_sums.launches,
            "masked_sums_fused": scan.masked_sums_fused.launches,
            "bitmap_filter": bitmap.bitmap_filter.launches,
            "grouped_agg": grouped.grouped_agg.launches}


def reset_kernel_launch_counts() -> None:
    from ..engine import bitmap, grouped, scan
    scan.reset_launch_counts()
    bitmap.reset_launch_counts()
    grouped.reset_launch_counts()


def _tensor_bytes(obj, seen: set) -> int:
    """Bytes of the distinct device tensors in `obj` (a tensor, or dicts,
    tuples and lists of them)."""
    import torch
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.numel())
        if obj.device.type == "cpu" or key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    return 0


def server_device_memory(server: ServerNode) -> Dict[str, int]:
    """The server's device memory: the allocator's bytes on the card, the
    bytes its staged blocks hold (each served segment's blocks, and the
    stacked set blocks of its pipeline's set executor) and those of its
    consuming segments (their staged chunks and their views' blocks)."""
    import torch
    seen: set = set()
    staged = 0
    for mgr in list(server.tables.values()):
        for name in mgr.segment_names:
            seg = mgr.get(name)
            for blk in list(getattr(seg, "__dict__", {}).get("_device_blocks", {}).values()):
                staged += _tensor_bytes(vars(blk), seen)
    if server.device_pipeline is not None:
        for _, blk in list(server.device_pipeline.mesh_exec._set_blocks.values()):
            staged += _tensor_bytes(vars(blk), seen)
    consuming = 0
    for rt in list(server._realtime_managers.values()):
        for c in list(rt.consumers.values()):
            store = c.mutable
            consuming += _tensor_bytes(list(getattr(store, "_dev_chunks", {}).values()), seen)
            view = getattr(store, "_view", None)
            for blk in list(getattr(view, "_device_blocks", {}).values()):
                consuming += _tensor_bytes(vars(blk), seen)
    on_card = server.executor.device.type == "cuda"
    return {"memoryAllocated": int(torch.cuda.memory_allocated(server.executor.device))
            if on_card else 0, "stagedBytes": staged, "consumingStagedBytes": consuming}


class ServerService:
    """Server role process: the query endpoints over the binary wire format."""

    def __init__(self, server: ServerNode, host: str = "127.0.0.1", port: int = 0,
                 access_control=None, ssl_context=None):
        self.server = server
        self.http = HttpService(host, port, access_control=access_control,
                                ssl_context=ssl_context)
        # queries demuxed off mux streams run here, not on the HTTP thread
        # that owns the stream (it reads frames); `server.mux.workers` bounds
        # the decode and dispatch threads, the scheduler below them admits
        workers = int(server.catalog.get_property("clusterConfig/server.mux.workers", 16))
        self._mux_pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                            thread_name_prefix="mux-exec")
        self._mux_open = 0
        self._mux_lock = threading.Lock()
        s = self.http
        s.route("POST", "query", self._query)
        s.route("POST", "mux", self._mux, duplex=True)
        s.route("POST", "explain", self._explain)
        s.route("GET", "health", self._health)
        s.route("GET", "debug", self._debug)
        s.route("POST", "debug", self._debug_post, action="ADMIN")
        s.route("GET", "segments", self._segments)
        s.route("GET", "metrics", _metrics_route)
        s.route("POST", "stage", self._stage)
        # the peer-to-peer mailbox shuffle (reference: GrpcMailboxService and
        # the MailboxSend/Receive operators; multistage/shuffle.py)
        s.route("POST", "mailbox", self._mailbox, stream_body=True)
        s.route("DELETE", "mailbox", self._mailbox_cancel)
        s.route("POST", "leafStage", self._leaf_stage)
        s.route("POST", "leafAgg", self._leaf_agg)
        s.route("POST", "joinStage", self._join_stage)
        s.route("POST", "aggStage", self._agg_stage)
        s.route("GET", "segmentData", self._segment_data)
        self.http.start()
        # advertise the query endpoint so brokers find it (reference: the
        # Helix instance config carries host and port)
        info = server.catalog.instances.get(server.instance_id)
        tags = info.tags if info else ["DefaultTenant"]
        server.catalog.register_instance(InstanceInfo(
            server.instance_id, "server", host=self.http.host, port=self.http.port,
            tags=tags, scheme=self.http.scheme))
        # this process owns its mailbox endpoint: legs that target it skip
        # the codec and the HTTP hop (the device-routed shuffle)
        register_local_endpoint(self.http.url)
        # a server process walks its residency back under the tiering target
        server.start_pressure_loop()

    @property
    def url(self) -> str:
        return self.http.url

    def stop(self) -> None:
        unregister_local_endpoint(self.http.url)
        self.http.stop()
        self._mux_pool.shutdown(wait=False)

    def _mux(self, parts, params, body):
        """POST /mux: one duplex multiplexed query stream (`mux.py`). Request
        frames demux into the mux pool under the stream's flow-control window
        (`server.mux.max.inflight`); response frames stream back out of order
        as queries finish. The 200 and chunked headers go out before any
        frame is read."""
        from ..auth import current_principal
        from ..utils.metrics import get_registry
        from .mux import serve_mux_stream
        reg = get_registry()
        frames = reg.counter("pinot_server_mux_frames")
        streams_gauge = reg.gauge("pinot_server_mux_streams")
        with self._mux_lock:
            self._mux_open += 1
            streams_gauge.set(self._mux_open)
        max_inflight = int(self.server.catalog.get_property(
            "clusterConfig/server.mux.max.inflight", 64))
        inner = serve_mux_stream(body, self._mux_execute, executor=self._mux_pool,
                                 max_inflight=max(1, max_inflight),
                                 principal=current_principal(), on_frame=frames.inc)

        def gen():
            try:
                yield from inner
            finally:
                with self._mux_lock:
                    self._mux_open -= 1
                    streams_gauge.set(self._mux_open)
        return 200, "application/octet-stream", gen()

    def _reject_body(self, e) -> dict:
        """A 429's body: the error and a Retry-After hint (the scheduler's
        drain estimate when the exception carries none)."""
        body = {"error": str(e)}
        hint = getattr(e, "retry_after_ms", None)
        if hint is None and self.server.scheduler is not None:
            hint = self.server.scheduler.retry_after_ms()
        if hint is not None:
            body["retryAfterMs"] = round(float(hint), 3)
        return body

    @staticmethod
    def _timeout_body(e) -> dict:
        """A 408's body: the error and the deadline that expired."""
        body = {"error": str(e)}
        d = getattr(e, "deadline_epoch_ms", None)
        if d is not None:
            body["deadlineEpochMs"] = round(float(d), 3)
        return body

    def _run(self, payload):
        """Decode one query request and run its partial under the request's
        trace: (result, trace, decode ms) or a backpressure status."""
        import time as _time

        from ..auth import require_table_access
        from ..utils.trace import request_trace
        t0 = _time.perf_counter()
        req = decode_query_request(payload)
        decode_ms = (_time.perf_counter() - t0) * 1000
        require_table_access(req["table"], "READ")
        with request_trace(bool(req.get("trace")), trace_id=req.get("traceId") or None) as tr:
            if tr is not None:
                # the decode ran before this trace began: a span before its origin
                tr.record("deserialize", -decode_ms, decode_ms)
            result = self.server.execute_partial(req["table"], req["sql"], req["segments"],
                                                 time_filter=req.get("timeFilter"))
        return result, tr

    def _spans(self, tr):
        if tr is None:
            return None
        # named under this server so the broker's spliced view reads as its
        # own scatter spans (server:<id>/segment:...)
        return [dict(s, name=f"server:{self.server.instance_id}/{s['name']}")
                for s in tr.to_rows()]

    def _mux_execute(self, payload, flow_wait_ms):
        """One mux request frame -> (status, response parts): `_query`'s
        work and statuses (429 and 408 ride the frame as HTTP statuses), with
        the flow-control wait as a span and a stats key. The parts are
        gathered `encode_segment_result_parts` buffers: array payloads reach
        the socket without a join."""
        from ..query.scheduler import QueryRejectedError, QueryTimeoutError
        from ..query.stats import MUX_FLOW_CONTROL_MS
        from .wire import encode_segment_result_parts
        try:
            result, tr = self._run(payload)
        except QueryRejectedError as e:
            return 429, [json.dumps(self._reject_body(e)).encode()]
        except QueryTimeoutError as e:
            return 408, [json.dumps(self._timeout_body(e)).encode()]
        if flow_wait_ms:
            stats = result.stats if isinstance(result.stats, dict) else {}
            stats[MUX_FLOW_CONTROL_MS] = round(stats.get(MUX_FLOW_CONTROL_MS, 0.0)
                                               + flow_wait_ms, 3)
            result.stats = stats
            if tr is not None:
                tr.record("mux:flow_control", -flow_wait_ms, flow_wait_ms)
        return 200, encode_segment_result_parts(result, trace_spans=self._spans(tr))

    def _query(self, parts, params, body):
        from ..query.scheduler import QueryRejectedError, QueryTimeoutError
        try:
            result, tr = self._run(body)
        except QueryRejectedError as e:   # backpressure, not a server fault
            return 429, "application/json", json.dumps(self._reject_body(e)).encode()
        except QueryTimeoutError as e:
            return 408, "application/json", json.dumps(self._timeout_body(e)).encode()
        return binary_response(encode_segment_result(result, trace_spans=self._spans(tr)))

    def _health(self, parts, params, body):
        """GET /health: liveness, 200 while the process serves; GET
        /health/readiness: 503 until every assigned segment is served.
        Both without credentials."""
        st = self.server.startup_status()
        st["instance"] = self.server.instance_id
        if self.server.device_pipeline is not None:
            st["device"] = self.server.device_pipeline.stats()
        if parts and parts[0] == "readiness":
            return json_response(st, status=200 if st["ready"] else 503)
        return json_response(st, status=200)

    def _debug(self, parts, params, body):
        """GET /debug: the server's metrics and gauge rings, its kernels'
        launches, its device memory, its realtime consumers (state, offset,
        rows, decode lane), its pipeline's stats and its imported packages;
        GET /debug/consuming: each realtime table's consumers' lag rollup
        (`ServerNode.ingestion_snapshot`, the reference's
        consumingSegmentsInfo); GET /debug/memory: its memory ledger and
        tiering counters (`ServerNode.memory_snapshot`); GET /debug/events:
        the journal."""
        from ..utils.metrics import get_registry
        if parts and parts[0] == "events":
            return _events_route(params)
        if parts and parts[0] == "consuming":
            return _json({"instance": self.server.instance_id,
                          "tables": self.server.ingestion_snapshot()})
        if parts and parts[0] == "memory":
            return _json(self.server.memory_snapshot())
        reg = get_registry()
        pipeline = self.server.device_pipeline
        return _json({
            "instance": self.server.instance_id,
            "device": str(self.server.executor.device),
            "serverMetrics": {k: v for k, v in reg.snapshot().items()
                              if k.startswith("pinot_server")},
            "gaugeHistories": reg.gauge_histories("pinot_server"),
            "kernelLaunches": kernel_launch_counts(),
            "deviceMemory": server_device_memory(self.server),
            "consumers": {t: m.consumer_status()
                          for t, m in list(self.server._realtime_managers.items())},
            "pipeline": pipeline.stats() if pipeline is not None else None,
            "importedPackages": {m: m in sys.modules for m in ("jax", "pinot_tpu")},
        })

    def _debug_post(self, parts, params, body):
        """POST /debug/launches/reset: set this process's kernel launch
        counts to 0; answers the counts they held."""
        if parts[:2] != ["launches", "reset"]:
            return error_response("POST /debug/launches/reset", 404)
        before = kernel_launch_counts()
        reset_kernel_launch_counts()
        return _json({"instance": self.server.instance_id, "kernelLaunches": before})

    def _explain(self, parts, params, body):
        from ..auth import require_table_access
        req = decode_query_request(body)
        require_table_access(req["table"], "READ")   # plans show schema and indexes
        rows = self.server.explain_partial(req["table"], req["sql"], req["segments"])
        return _json({"rows": rows})

    def _segments(self, parts, params, body):
        return json_response({"segments": self.server.segments_served(parts[0])})

    def _segment_data(self, parts, params, body):
        """GET /segmentData/{table}/{segment}: the tar of this server's loaded
        copy (the peer download scheme: every ONLINE replica serves the
        committed bytes when the deep store cannot)."""
        from ..auth import require_table_access
        from .deepstore import tar_segment
        table, name = parts[0], parts[1]
        require_table_access(table, "READ")   # raw data: the queries' ACL
        seg_dir = self.server.local_segment_dir(table, name)
        if seg_dir is None:
            return error_response(f"{table}/{name} not served here", 404)
        with tempfile.TemporaryDirectory() as tmp:
            tar_path = os.path.join(tmp, "seg.tar.gz")
            tar_segment(seg_dir, tar_path)
            with open(tar_path, "rb") as f:
                return binary_response(f.read())

    # -- the multistage data plane ------------------------------------------
    #: rows a streamed stage-output frame carries (bounded buffering both sides)
    STAGE_FRAME_ROWS = 65536

    def _stage(self, parts, params, body):
        """POST /stage: one funnel-path stage partition on this server's
        device: the hash join, and the partial GROUP BY when the broker marks
        the final aggregation stage (reference: an intermediate-stage worker
        and AggregateOperator in partial mode). The response streams
        length-prefixed wire frames: joined rows in bounded block frames, a
        partial aggregation as one frame."""
        d = decode_value(body)
        out = run_join_stage(spec_from_json(d["spec"]), decode_block(d["left"]),
                             decode_block(d["right"]), agg_spec_from_json(d.get("agg")),
                             device=self.server.executor.device)
        get_registry().counter("pinot_server_join_stages").inc()

        def gen():
            if isinstance(out, dict):   # joined rows: bounded row frames
                n = next((len(v) for v in out.values()), 0)
                step = self.STAGE_FRAME_ROWS
                for lo in range(0, max(n, 1), step):
                    yield frame_bytes({"kind": "rows",
                                       "block": {c: v[lo:lo + step] for c, v in out.items()}})
            else:   # a partial aggregation
                yield frame_bytes({"kind": "partial", "result": encode_segment_result(out)})
            yield frame_bytes({"kind": "end"})
        return 200, "application/octet-stream", gen()

    def _mailbox(self, parts, params, body):
        """POST /mailbox/{queryId}/{mailboxId}: a peer streams partition
        frames into this server's mailbox as a chunked body. The mailbox's
        queue is bounded: when its worker falls behind the put blocks, this
        thread stops reading the socket and TCP flow control holds the sender
        (reference: the gRPC mailbox stream's flow-control window)."""
        qid, mid = parts[0], parts[1]
        frames = get_registry().counter("pinot_server_mailbox_frames")
        try:
            box = REGISTRY.open(qid, mid)
            while True:
                d = read_frame(body)
                if d["kind"] == "eos":
                    box.put(("eos", d["sender"]))
                    break
                if d["kind"] == "block":
                    box.put(("block", decode_block(d["block"])))
                else:
                    box.put(("partial", decode_segment_result(d["result"])))
                frames.inc()
        except MailboxCancelled:
            # drain before the 409 too: unread bytes would make the close a
            # TCP reset that races the status on the sender's side
            body.drain()
            return error_response("query cancelled", 409)
        body.drain()   # the chunked terminator, before the response (as above)
        return json_response({"ok": True})

    def _mailbox_cancel(self, parts, params, body):
        """DELETE /mailbox/{queryId}: cancel every mailbox of the query,
        waking its blocked senders and consumers."""
        REGISTRY.cancel_query(parts[0])
        return json_response({"ok": True})

    def _leaf_stage(self, parts, params, body):
        """POST /leafStage: scan the local segments, hash-partition on the
        join keys and stream the partitions straight to the stage workers'
        mailboxes; the broker never sees these rows."""
        from ..auth import require_table_access
        task = decode_value(body)
        require_table_access(task["table"], "READ")
        return binary_response(encode_value(run_leaf_join_task(self.server, task)))

    def _leaf_agg(self, parts, params, body):
        """POST /leafAgg: a distributed GROUP BY's leaf: the local partial
        aggregation, its groups hash-partitioned by key to the merge workers."""
        from ..auth import require_table_access
        task = decode_value(body)
        require_table_access(task["table"], "READ")
        return binary_response(encode_value(run_leaf_agg_task(self.server, task)))

    def _join_stage(self, parts, params, body):
        """POST /joinStage: one join-stage partition on this server's device:
        both sides' mailboxes, the join, then the next stage's mailboxes or
        the final partial frames back. An error ends the stream as an error
        frame, so the broker reports its cause, not a truncated stream."""
        task = decode_value(body)
        get_registry().counter("pinot_server_join_stages").inc()
        device = self.server.executor.device

        def gen():
            try:
                yield from run_join_stage_task(task, device)
            except Exception as e:
                yield frame_bytes({"kind": "error", "message": f"{type(e).__name__}: {e}"})
        return 200, "application/octet-stream", gen()

    def _agg_stage(self, parts, params, body):
        """POST /aggStage: one merge partition of a distributed GROUP BY: this
        disjoint key range merged, HAVING and the top-k trim, the merged
        partial streamed back."""
        task = decode_value(body)

        def gen():
            try:
                yield from run_agg_stage_task(task)
            except Exception as e:
                yield frame_bytes({"kind": "error", "message": f"{type(e).__name__}: {e}"})
        return 200, "application/octet-stream", gen()


class BrokerService:
    """Broker role process: SQL over HTTP; finds its servers in the catalog."""

    def __init__(self, broker: Broker, host: str = "127.0.0.1", port: int = 0,
                 access_control=None, ssl_context=None, mux: Optional[bool] = None):
        self.broker = broker
        self._registered: Dict[str, str] = {}   # instance id -> endpoint url
        self._handles: Dict[str, RemoteServerHandle] = {}
        self._wire_lock = threading.Lock()
        # `mux` pins the servers' transport (tests dispatch both ways); None
        # reads `broker.mux.enabled` for each new handle
        self._mux_override = mux
        self.http = HttpService(host, port, access_control=access_control,
                                ssl_context=ssl_context)
        self.http.route("POST", "query", self._query)
        self.http.route("POST", "queryStream", self._query_stream)
        self.http.route("GET", "health", lambda p, q, b: json_response({"status": "OK"}))
        self.http.route("GET", "metrics", _metrics_route)
        self.http.route("GET", "debug", self._debug)
        # subscribe before the first scan: a server registering in between
        # fires an event (a rescan) instead of being missed
        broker.catalog.subscribe(self._on_event)
        self._wire_server_handles()
        self.broker.failure_detector.start()
        self.http.start()
        # advertise the SQL endpoint (the controller's sql proxy and clients
        # find brokers in the catalog)
        broker.catalog.register_instance(InstanceInfo(
            broker.instance_id, "broker", host=self.http.host, port=self.http.port,
            scheme=self.http.scheme))

    @property
    def url(self) -> str:
        return self.http.url

    def stop(self) -> None:
        self.broker.failure_detector.stop()
        with self._wire_lock:
            handles = list(self._handles.values())
            self._handles.clear()
        for handle in handles:
            handle.close()   # retire the mux streams
        self.http.stop()

    def _mux_enabled(self) -> bool:
        if self._mux_override is not None:
            return self._mux_override
        v = self.broker.catalog.get_property("clusterConfig/broker.mux.enabled", True)
        return str(v).lower() not in ("false", "0", "no")

    def _mux_streams(self) -> int:
        try:
            return max(1, int(self.broker.catalog.get_property(
                "clusterConfig/broker.mux.streams", 1)))
        except (TypeError, ValueError):
            return 1

    def _debug(self, parts, params, body):
        """GET /debug: the broker's rollups; GET /debug/traces?id=: one kept
        trace; GET /debug/events: the journal."""
        if parts and parts[0] == "events":
            return _events_route(params)
        if parts and parts[0] == "traces":
            trace_id = params.get("id")
            entry = self.broker.trace_ring.get(trace_id) if trace_id else None
            if entry is None:
                return error_response(f"unknown trace {trace_id}", 404)
            return _json(entry)
        return _json(self.broker.debug_stats())

    def _on_event(self, event: str, _key: str) -> None:
        if event == "instance":
            self._wire_server_handles()

    def _wire_server_handles(self) -> None:
        """A RemoteServerHandle for every live server the catalog advertises.
        Only new or moved endpoints register again (registering marks a
        server healthy, which must not bring back one the failure detector
        holds out); a dead server's handle and probe go."""
        with self._wire_lock:
            for info in list(self.broker.catalog.instances.values()):
                if info.role != "server" or not info.port:
                    continue
                if not info.alive:
                    if self._registered.pop(info.instance_id, None):
                        self.broker.unregister_server(info.instance_id)
                        old = self._handles.pop(info.instance_id, None)
                        if old is not None:
                            old.close()
                    continue
                url = info.url
                if self._registered.get(info.instance_id) == url:
                    continue
                self._registered[info.instance_id] = url
                handle = RemoteServerHandle(url, use_mux=self._mux_enabled(),
                                            mux_streams=self._mux_streams())
                old = self._handles.pop(info.instance_id, None)
                if old is not None:
                    old.close()   # the endpoint moved: retire the old streams
                self._handles[info.instance_id] = handle

                def probe(u=url):
                    # /health needs no token; a 503 (not ready) still proves life
                    from .http_service import HttpError, http_call
                    try:
                        http_call("GET", f"{u}/health", timeout=2.0)
                        return True
                    except HttpError as e:
                        return e.status == 503
                    except Exception:
                        return False
                self.broker.register_server_handle(info.instance_id, handle,
                                                   explain_handle=handle.explain,
                                                   probe=probe,
                                                   stage_handle=handle.join_stage, url=url)

    def _authorize(self, sql: str):
        """The table ACL before any work: the parsed statement when a
        principal is set (the broker then parses once), else None."""
        from ..auth import current_principal, require_table_access
        if current_principal() is None:
            return None
        from ..sql.parser import parse_query
        try:
            stmt = parse_query(sql)
        except Exception:
            return None   # handle_query raises it and counts the exception
        for table in [stmt.table] + [j.table for j in stmt.joins]:
            require_table_access(table, "READ")
        return stmt

    def _query(self, parts, params, body):
        sql = json.loads(body.decode())["sql"]
        result = self.broker.handle_query(sql, stmt=self._authorize(sql))
        return _json(result.to_json())

    def _query_stream(self, parts, params, body):
        """POST /queryStream: JSON lines over chunked HTTP, one
        {"columns": [...]} line, then one {"rows": [...]} line a batch."""
        sql = json.loads(body.decode())["sql"]
        stmt = self._authorize(sql)

        def gen():
            from ..query.result import _jsonify
            for kind, payload in self.broker.stream_query(sql, stmt=stmt):
                if kind == "schema":
                    yield (json.dumps({"columns": payload}) + "\n").encode()
                else:
                    yield (json.dumps({"rows": [[_jsonify(v) for v in r] for r in payload]},
                                      default=_json_default) + "\n").encode()
        return 200, "application/x-ndjson", gen()
