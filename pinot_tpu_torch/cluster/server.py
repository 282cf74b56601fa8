"""Server role: segment lifecycle and the server half of a query.

A trimmed copy of `pinot_tpu/cluster/server.py` (the analog of the
reference's `HelixInstanceDataManager`, the per-table data managers with
their reference-counted acquire and release, and the query half of
`ServerQueryExecutorV1Impl`). Ideal-state changes arrive as catalog events:
the server downloads each segment assigned ONLINE to it from the deep store,
loads it and reports it in the external view; a segment taken from it is
unloaded. A CONSUMING assignment of a realtime table starts a consumer in
the table's `RealtimeTableManager` (`ingest/realtime.py`, made on the first
one, `realtime_manager`); its CONSUMING -> ONLINE flip hands the segment
over (the local build where this server committed it or consumed exactly to
its end offset, else the committed copy from the deep store) and retires the
consumer once the immutable copy is registered; a consuming segment taken
from the server stops its consumer. `completion` is the controller's LLC
segment manager the consumers report to (in a server process its HTTP
client, `remote.RemoteCompletion`); a caller pumps and completes them, or,
with `auto_consume` (a server process), each realtime table's manager runs
its background loop (`start_loop`) from its first CONSUMING assignment until
the table is dropped or the server shuts down.

A segment's copy comes from the deep store, with the `deepstore.retry.*`
backoff, else from a peer that serves it (`cluster/peers.py`): at once for a
`peer://` segment, committed while the deep store was down. `GET
/segmentData` serves a loaded segment's directory to such peers
(`local_segment_dir`).

A partial (`execute_partial`) runs over the server's copy of the segments the
broker routed to it, under the broker's deadline (`deadlineEpochMs`) and an
optional time filter. Its route is chosen before anything runs:

* with a `device_pipeline` (a `DeviceQueryPipeline` over the set executor),
  an aggregation, a DISTINCT or an ORDER BY ... LIMIT that passes
  `device_topk_screen`, whose first segment's plan is not a host plan, goes
  to the pipeline as one server-level partial for the whole set;
* every other partial, and every partial of a server without a pipeline,
  runs through the per-segment `ServerQueryExecutor`, which runs the planner's
  host plans on the host;
* the committed segments of a REALTIME table take these routes as an
  offline table's do, except that an upsert table never takes the pipeline:
  its segments run per segment under the table's valid-doc masks;
* the consuming segments the broker routed here answer after them, each on
  the per-segment executor over its view (staged on the device where the
  stream sets `realtime.ingest.device.staging`), from one snapshot of the
  table's consumers that leaves out the segments already answered
  immutably; the partial's `served` list names both, and its stats carry
  `numConsumingSegmentsQueried` and `minConsumingFreshnessTimeMs`.

Device memory is a managed tier (`tiering.py` over the memory ledger,
`utils/memledger.py`). Before a route is chosen, the partial's segments
assigned COLD here with no local copy load from the deep store under the
broker's deadline (a spent deadline raises QueryTimeoutError naming the
cold-tier load); then the tiering gate (`TieringManager.admit`) decides, from
each segment's predicted block bytes and the ledger, which segments may stage
on the device. Only the admitted ones reach the pipeline or the per-segment
executor; the others answer on the host-tier executor (`use_device=False`),
counted in `segmentsServedHostTier`. The host tier is the gate's planned
route, chosen before anything stages: no error becomes another path's answer,
and what the pipeline or an executor raises (`torch.cuda.OutOfMemoryError`
included) propagates to the broker, which may retry the segments on another
replica. A segment unloaded while a query holds it keeps its device block
until the last holder releases it. `server.hbm.capacity.bytes` pins the
ledger's capacity, `server.hbm.target.headroom.pct` the gate's headroom; a
server process runs the pressure sweep every `PRESSURE_INTERVAL_S`
(`start_pressure_loop`); `memory_snapshot` is its `GET /debug/memory` and
`ingestion_snapshot` (each realtime table's consumers' lag rollup) its `GET
/debug/consuming`; a realtime table's manager stopping (the table dropped,
the server shut down) removes its partitions' lag gauges. The
cluster knobs `server.index.bitmap.enabled` and `server.fused.enabled` are
not ported: a server whose cluster sets one raises NotImplementedError rather
than ignore it.

The server runs on CUDA unless the caller passes `device="cpu"` (or a
pipeline whose set executor runs on the CPU); without a card it raises
RuntimeError.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

from ..engine.datablock import bind_table, has_block, release_block
from ..parallel.combine import device_topk_screen
from ..query import stats as qstats
from ..query.aggregates import make_agg
from ..query.context import QueryContext, compile_query
from ..query.executor import PLAN_OP_LABELS, ServerQueryExecutor
from ..query.explain import explain_result
from ..query.planner import plan_segment
from ..query.reduce import SegmentResult, merge_segment_results
from ..query.scheduler import QueryTimeoutError
from ..segment.reader import ImmutableSegment, load_segment
from ..utils.events import emit_event
from ..utils.memledger import get_ledger
from ..utils.metrics import get_registry
from ..utils.periodic import PeriodicTask, PeriodicTaskScheduler
from ..utils.trace import current_depth, current_trace, span
from .catalog import COLD, CONSUMING, ONLINE, Catalog, InstanceInfo
from .deepstore import DeepStoreFS, untar_segment
from .peers import download_segment_tar
from .tiering import PRESSURE_INTERVAL_S, TieringManager

#: cluster knobs of the JAX package's server that this package does not honour
UNPORTED_KNOBS = {
    "server.index.bitmap.enabled": "false",
    "server.fused.enabled": "false",
}


class TableDataManager:
    """One table's loaded segments with their reference counts (the
    reference's BaseTableDataManager). A segment unloaded while a query holds
    it stays readable by that query, device block included: its block and
    ledger entries are released when the last holder releases it."""

    def __init__(self, table: str, data_dir: str):
        self.table = table
        self.data_dir = data_dir
        self._segments: Dict[str, ImmutableSegment] = {}
        self._refcounts: Dict[str, int] = {}
        # segments unloaded while a query held them: released at the last release()
        self._deferred: Dict[str, ImmutableSegment] = {}
        self._lock = threading.RLock()

    def add_segment(self, name: str, segment: ImmutableSegment) -> None:
        with self._lock:
            # a deferred copy being replaced (a reload) releases now: its
            # holders keep the old object, readable until they release it
            old = self._deferred.pop(name, None)
            self._segments[name] = segment
            self._refcounts.setdefault(name, 0)
        if old is not None and old is not segment:
            release_block(old)
        bind_table(segment, self.table)

    def remove_segment(self, name: str) -> None:
        with self._lock:
            seg = self._segments.pop(name, None)
            if seg is not None and self._refcounts.get(name, 0) > 0:
                self._deferred[name] = seg   # a running query holds it
                return
            self._refcounts.pop(name, None)
        if seg is not None:
            release_block(seg)
            get_ledger().release(table=self.table, segment=name)

    def acquire(self, names: Optional[Sequence[str]] = None) -> List[ImmutableSegment]:
        with self._lock:
            targets = list(self._segments) if names is None else \
                [n for n in names if n in self._segments]
            for n in targets:
                self._refcounts[n] = self._refcounts.get(n, 0) + 1
            return [self._segments[n] for n in targets]

    def release(self, segments: Sequence[ImmutableSegment]) -> None:
        doomed: List[ImmutableSegment] = []
        with self._lock:
            for seg in segments:
                if seg.name in self._refcounts:
                    self._refcounts[seg.name] -= 1
                    if self._refcounts[seg.name] <= 0 and seg.name not in self._segments:
                        self._refcounts.pop(seg.name)
                        if seg.name in self._deferred:
                            doomed.append(self._deferred.pop(seg.name))
        for seg in doomed:   # the last holder of an unloaded segment
            release_block(seg)
            get_ledger().release(table=self.table, segment=seg.name)

    def refcount(self, name: str) -> int:
        """In-flight acquisitions of `name`: the eviction's never-under-a-
        running-query check."""
        with self._lock:
            return self._refcounts.get(name, 0)

    def get(self, name: str) -> Optional[ImmutableSegment]:
        with self._lock:
            return self._segments.get(name)

    @property
    def segment_names(self) -> List[str]:
        with self._lock:
            return list(self._segments)


class ServerNode:
    """One server instance (the reference's HelixServerStarter + ServerInstance)."""

    #: a partial with less of the broker's deadline left than this is
    #: rejected at once with the deadline it missed
    MIN_DEADLINE_BUDGET_S = 0.005

    def __init__(self, instance_id: str, catalog: Catalog, deepstore: DeepStoreFS,
                 data_dir: str, tags: Optional[List[str]] = None, scheduler=None,
                 device=None, device_pipeline=None, completion=None,
                 auto_consume: bool = False):
        for knob, refused in UNPORTED_KNOBS.items():
            v = catalog.get_property(f"clusterConfig/{knob}")
            if v is not None and (refused is None or str(v).lower() == refused):
                raise NotImplementedError(
                    f"clusterConfig/{knob}={v!r}: this package's server does not take "
                    "the knob (ROADMAP.md queue 1)")
        self.instance_id = instance_id
        self.catalog = catalog
        self.deepstore = deepstore
        self.data_dir = data_dir
        if device is None and device_pipeline is not None:
            device = device_pipeline.mesh_exec.device
        self.executor = ServerQueryExecutor(device)
        # the host tier: what the tiering gate keeps off the card runs here
        self.host_executor = ServerQueryExecutor(self.executor.device, use_device=False)
        ledger = get_ledger()
        ledger.bind_device(self.executor.device)
        cap_raw = catalog.get_property("clusterConfig/server.hbm.capacity.bytes")
        if cap_raw is not None:
            try:
                ledger.set_capacity(int(cap_raw))
            except (TypeError, ValueError):
                pass   # a malformed knob keeps the probed capacity
        self.tiering = TieringManager(catalog, node=instance_id)
        self._pressure_scheduler: Optional[PeriodicTaskScheduler] = None
        # device-backed serving: broker-routed partials run on the set
        # executor with batched fetches (cluster/device_server.py)
        self.device_pipeline = device_pipeline
        # optional admission control (query/scheduler.py); None runs directly
        self.scheduler = scheduler
        self.tables: Dict[str, TableDataManager] = {}
        self._lock = threading.RLock()
        self._load_locks: Dict[tuple, threading.Lock] = {}
        # realtime: the LLC segment manager the consumers report to and one
        # RealtimeTableManager a realtime table
        self.completion = completion
        # True in a server process: each realtime manager pumps and completes
        # on its own loop; False where a caller drives them (tests, the smoke)
        self.auto_consume = auto_consume
        self._realtime_managers: Dict[str, object] = {}
        self.status = "STARTING"
        os.makedirs(data_dir, exist_ok=True)
        catalog.register_instance(InstanceInfo(instance_id, "server",
                                               tags=tags or ["DefaultTenant"]))
        catalog.subscribe(self._on_catalog_event)
        for table in list(catalog.ideal_state):   # catch up with the ideal state
            self.reconcile(table)
        self.status = "UP"

    # -- lifecycle ----------------------------------------------------------
    def startup_status(self) -> Dict[str, object]:
        """Ready when every segment the ideal state assigns ONLINE here is
        loaded and every CONSUMING one has its consumer."""
        with self.catalog._lock:
            ideal = {t: {s: dict(a) for s, a in ist.items()}
                     for t, ist in self.catalog.ideal_state.items()}
        assigned = loaded = 0
        for table, ist in ideal.items():
            mgr = self.tables.get(table)
            served = set(mgr.segment_names) if mgr else set()
            rt = self._realtime_managers.get(table)
            consuming = set(rt.consumers) if rt is not None else set()
            for seg, assignment in ist.items():
                if assignment.get(self.instance_id) in (ONLINE, CONSUMING):
                    assigned += 1
                    loaded += seg in served or seg in consuming
        return {"status": self.status, "assignedSegments": assigned,
                "loadedSegments": loaded,
                "ready": self.status == "UP" and loaded == assigned}

    def shutdown(self) -> None:
        """Leave routing and stop the consumers, the scheduler and the pipeline."""
        self.status = "SHUTTING_DOWN"
        self.catalog.set_instance_alive(self.instance_id, False)
        for handler in list(self._realtime_managers.values()):
            handler.stop()
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.device_pipeline is not None:
            self.device_pipeline.stop()
        self.stop_pressure_loop()

    def start_pressure_loop(self) -> None:
        """Run the tiering pressure sweep every PRESSURE_INTERVAL_S (a server
        process; tests call `tiering.run_pressure_sweep()` themselves)."""
        if self._pressure_scheduler is not None:
            return
        sched = PeriodicTaskScheduler()
        sched.register(PeriodicTask("HbmPressureLoop", PRESSURE_INTERVAL_S,
                                    self.tiering.run_pressure_sweep))
        sched.start()
        self._pressure_scheduler = sched

    def stop_pressure_loop(self) -> None:
        if self._pressure_scheduler is not None:
            self._pressure_scheduler.stop()
            self._pressure_scheduler = None

    def ingestion_snapshot(self) -> Dict[str, Dict[str, object]]:
        """{table: its realtime manager's `ingestion_status`} (which exports
        the partitions' lag gauges): the body of `GET /debug/consuming`, and
        what the controller's ingestion check polls (in process, this method
        itself)."""
        return {table: handler.ingestion_status()
                for table, handler in list(self._realtime_managers.items())}

    def memory_snapshot(self) -> Dict[str, object]:
        """The process ledger's snapshot with this server's id and its tiering
        counters: the body of `GET /debug/memory`, and what the controller's
        memory check polls (in process, this method itself). In-process
        servers share the ledger, so each reports the process view."""
        snap = get_ledger().snapshot()
        snap["instanceId"] = self.instance_id
        snap["tiering"] = self.tiering.snapshot()
        return snap

    # -- state transitions ------------------------------------------------
    def _on_catalog_event(self, event: str, key: str) -> None:
        if event == "ideal_state":
            self.reconcile(key)
        elif event == "table" and self.catalog.table_configs.get(key) is None:
            self.reconcile(key)   # the table was dropped
        elif event == "property" and key.startswith("pause/"):
            rt = self._realtime_managers.get(key.split("/", 1)[1])
            if rt is not None:
                rt.set_paused(self.catalog.get_property(key) is not None)
        elif event == "property" and key.startswith("reload/"):
            self.reload_table(key.split("/", 1)[1])

    def reconcile(self, table: str) -> None:
        """Converge the loaded segments and the consumers to the ideal state
        (the reference's OFFLINE->ONLINE, CONSUMING->ONLINE, ->CONSUMING,
        ONLINE->OFFLINE and ->DROPPED transitions)."""
        mgr = self._table_manager(table)
        desired = self._assigned(table)
        for seg_name, state in desired.items():
            if state == ONLINE and seg_name not in mgr.segment_names:
                handler = self._realtime_managers.get(table)
                try:
                    if handler is not None and seg_name in handler.consumers:
                        loaded = self._hand_over(table, seg_name, mgr, handler)
                    else:
                        loaded = self._load_online_segment(table, seg_name, mgr)
                except Exception:
                    self.catalog.report_state(table, seg_name, self.instance_id, "ERROR")
                    raise
                if loaded:
                    self.catalog.report_state(table, seg_name, self.instance_id, ONLINE)
            elif state == CONSUMING and seg_name not in mgr.segment_names:
                handler = self._ensure_realtime_manager(table)
                if handler is not None and seg_name not in handler.consumers:
                    handler.start_consuming(seg_name)
                    self.catalog.report_state(table, seg_name, self.instance_id, CONSUMING)
            elif state == COLD:
                self._demote_to_cold(table, seg_name, mgr)
        # unload against the ideal state as it is now: a reconcile racing
        # another upload's must not drop a segment assigned since it began
        current = self._assigned(table)
        for seg_name in mgr.segment_names:
            if seg_name not in current:
                mgr.remove_segment(seg_name)
                self.tiering.forget(table, seg_name)
                with self._lock:
                    self._load_locks.pop((table, seg_name), None)
                self.catalog.report_state(table, seg_name, self.instance_id, None)
        # consuming segments taken from this server (deleted, reassigned)
        # stop their consumers: they live in the realtime manager
        rt = self._realtime_managers.get(table)
        if rt is not None:
            for seg_name in list(rt.consumers):
                if seg_name not in current:
                    rt.stop_consuming(seg_name)
                    self.catalog.report_state(table, seg_name, self.instance_id, None)
        if self.catalog.table_configs.get(table) is None:
            # a dropped table's manager stops with it: a stale one would go on
            # consuming and shadow a table made again under the name
            with self._lock:
                handler = self._realtime_managers.pop(table, None)
                self.tables.pop(table, None)
                for k in [k for k in self._load_locks if k[0] == table]:
                    del self._load_locks[k]
            if handler is not None:
                handler.stop()
            # whatever residency is still attributed to the dropped table
            # (staging a racing stop missed) leaves no stale gauge
            get_ledger().release(table=table)
            return
        self._refresh_dim_table(table, mgr)

    def _demote_to_cold(self, table: str, seg_name: str, mgr: TableDataManager) -> None:
        """An ->COLD assignment: unload the local copy (the deep store keeps
        the bytes) and report COLD; the segment stays routable and its first
        query loads it again (`_run_partial`). Only on the transition's edge
        (the external view not yet COLD here): a later reconcile must not
        unload the copy a query loaded since."""
        with self.catalog._lock:
            ev_state = self.catalog.external_view.get(table, {}).get(seg_name, {}) \
                .get(self.instance_id)
        if ev_state == COLD:
            return
        if seg_name in mgr.segment_names:
            busy = mgr.refcount(seg_name) > 0
            mgr.remove_segment(seg_name)
            self.tiering.forget(table, seg_name)
            if not busy:
                # a running query may still open column files of its copy:
                # the disk is reclaimed only when no one holds the segment
                shutil.rmtree(os.path.join(self.data_dir, table, seg_name),
                              ignore_errors=True)
        self.catalog.report_state(table, seg_name, self.instance_id, COLD)

    def _hand_over(self, table: str, seg_name: str, mgr: TableDataManager, handler) -> bool:
        """A consuming segment's CONSUMING -> ONLINE here: register the local
        build where the handoff keeps it, else download the committed copy;
        then retire the consumer, which answered queries until now (also
        where the load failed: an ERROR segment keeps no consumer)."""
        try:
            local_dir = handler.on_segment_online(seg_name)
            if local_dir:
                self.add_local_segment(table, load_segment(local_dir))
                return True
            return self._load_online_segment(table, seg_name, mgr)
        finally:
            handler.retire_consumer(seg_name)

    def add_local_segment(self, table: str, segment: ImmutableSegment) -> None:
        """Register a segment built on this server (a realtime commit's)."""
        self._table_manager(table).add_segment(segment.name, segment)

    def _ensure_realtime_manager(self, table: str):
        """The table's realtime manager, made on its first CONSUMING
        assignment; None where the table has no stream or the server no
        completion endpoint."""
        with self._lock:
            handler = self._realtime_managers.get(table)
            if handler is None:
                cfg = self.catalog.table_configs.get(table)
                if cfg is None or cfg.stream is None or self.completion is None:
                    return None
                from ..ingest.realtime import RealtimeTableManager
                handler = RealtimeTableManager(self, table, cfg, self.completion)
                self._realtime_managers[table] = handler
                if self.auto_consume:
                    handler.start_loop()
            return handler

    def realtime_manager(self, table: str):
        """The table's `RealtimeTableManager` on this server, or None."""
        return self._realtime_managers.get(table)

    def _assigned(self, table: str) -> Dict[str, str]:
        """segment -> this server's state in the table's ideal state now."""
        with self.catalog._lock:
            return {seg: a[self.instance_id]
                    for seg, a in self.catalog.ideal_state.get(table, {}).items()
                    if self.instance_id in a}

    def _refresh_dim_table(self, table: str, mgr: TableDataManager) -> None:
        """Rebuild a dimension table's primary-key map after its segments change."""
        cfg = self.catalog.table_configs.get(table)
        schema = self.catalog.schema_for_table(table)
        if cfg is None or not cfg.is_dim_table or not schema or \
                not schema.primary_key_columns:
            return
        from ..query.lookup import register_dim_table_from_segments
        segments = mgr.acquire()
        try:
            register_dim_table_from_segments(cfg.name, schema.primary_key_columns, segments)
        finally:
            mgr.release(segments)

    def _load_online_segment(self, table: str, seg_name: str, mgr: TableDataManager,
                             wait: bool = False) -> bool:
        """Download, unpack and load one segment; False when another
        reconcile is loading it (that one reports it), so that reconciles
        racing on one table load different segments at once instead of
        queueing behind each other's. With `wait` (a query's cold load) it
        waits for that load instead."""
        lock = self._segment_load_lock(table, seg_name)
        if not lock.acquire(blocking=wait):
            return False
        try:
            local_dir = os.path.join(self.data_dir, table, seg_name)
            if not os.path.isdir(local_dir):
                with self.catalog._lock:
                    meta = self.catalog.segments.get(table, {}).get(seg_name)
                    path = meta.download_path if meta is not None else None
                if not path:
                    raise FileNotFoundError(f"no deep-store path for {table}/{seg_name}")
                tar_local = f"{local_dir}.{threading.get_ident()}.tar.gz"
                os.makedirs(os.path.dirname(local_dir), exist_ok=True)
                try:
                    download_segment_tar(self.deepstore, self.catalog, table, seg_name,
                                         tar_local, path, exclude_instance=self.instance_id)
                    untar_segment(tar_local, os.path.dirname(local_dir))
                finally:
                    if os.path.exists(tar_local):
                        os.remove(tar_local)
            if mgr.get(seg_name) is None:
                mgr.add_segment(seg_name, load_segment(local_dir))
            return True
        finally:
            lock.release()

    def _cold_unloaded(self, table: str, segment_names: Optional[Sequence[str]],
                       mgr: TableDataManager) -> List[str]:
        """The segments the partial wants that are assigned COLD here with no
        loaded copy: the cold tier's lazy loads."""
        with self.catalog._lock:
            ist = {s: dict(a) for s, a in self.catalog.ideal_state.get(table, {}).items()}
        loaded = set(mgr.segment_names)
        wanted = list(ist) if segment_names is None else list(segment_names)
        return [s for s in wanted
                if s not in loaded and ist.get(s, {}).get(self.instance_id) == COLD]

    def local_segment_dir(self, table: str, seg_name: str) -> Optional[str]:
        """The directory of a loaded segment (what `GET /segmentData` serves a
        peer), None where this server does not serve it."""
        mgr = self.tables.get(table)
        seg = mgr.get(seg_name) if mgr is not None else None
        path = getattr(seg, "path", None)
        return path if path and os.path.isdir(path) else None

    def _segment_load_lock(self, table: str, seg_name: str) -> threading.Lock:
        with self._lock:
            return self._load_locks.setdefault((table, seg_name), threading.Lock())

    def _table_manager(self, table: str) -> TableDataManager:
        with self._lock:
            if table not in self.tables:
                self.tables[table] = TableDataManager(table, os.path.join(self.data_dir, table))
            return self.tables[table]

    def reload_table(self, table: str) -> List[str]:
        """Bring every loaded segment's indexes in line with the table's current
        indexing config and swap in a fresh reader where anything changed (the
        reference's Helix RELOAD message). One segment's failure is reported
        in the returned list and does not stop the others."""
        from ..segment.preprocess import preprocess_segment
        cfg = self.catalog.table_configs.get(table)
        if cfg is None:
            return []
        mgr = self._table_manager(table)
        schema = self.catalog.schema_for_table(table)
        changes: List[str] = []
        segments = mgr.acquire()
        try:
            for seg in segments:
                try:
                    ch = preprocess_segment(seg.path, cfg.indexing, schema=schema)
                except Exception as e:
                    changes.append(f"{seg.name}: ERROR {type(e).__name__}: {e}")
                    continue
                if ch:
                    mgr.add_segment(seg.name, load_segment(seg.path))
                    changes.extend(f"{seg.name}/{c}" for c in ch)
        finally:
            mgr.release(segments)
        return changes

    def segments_served(self, table: str) -> List[str]:
        return self._table_manager(table).segment_names

    # -- query execution --------------------------------------------------
    def execute_partial(self, table: str, ctx: Union[str, QueryContext],
                        segment_names: Optional[Sequence[str]] = None,
                        time_filter: Optional[str] = None) -> SegmentResult:
        """The server-level partial over this server's copy of
        `segment_names` (all of the table's when None), its stats in
        `.stats` and the segments it covered in `.served`. `time_filter` is a
        SQL predicate ANDed into the WHERE clause (a hybrid table's time
        boundary)."""
        schema = self.catalog.schema_for_table(table)
        if isinstance(ctx, str):
            ctx = compile_query(ctx, schema)
        if time_filter:
            ctx = apply_time_filter(ctx, time_filter, schema)
        remaining_s = _deadline_remaining_s(ctx)
        if remaining_s is not None and remaining_s <= self.MIN_DEADLINE_BUDGET_S:
            d_ms = ctx.options.get("deadlineEpochMs")
            raise QueryTimeoutError(
                f"query deadline budget exhausted ({remaining_s * 1000:.1f}ms remaining, "
                f"floor {self.MIN_DEADLINE_BUDGET_S * 1000:.0f}ms) at {self.instance_id}",
                deadline_epoch_ms=float(d_ms))
        if self.scheduler is None:
            return self._execute_partial(table, ctx, segment_names)
        timeout_s = None
        t_ms = ctx.options.get("timeoutMs") if ctx.options else None
        if t_ms is not None:
            timeout_s = float(t_ms) / 1000.0
        if remaining_s is not None:
            timeout_s = remaining_s if timeout_s is None else min(timeout_s, remaining_s)
        tr, depth = current_trace(), current_depth()

        def run():
            if tr is None:
                return self._execute_partial(table, ctx, segment_names)
            with tr.activate(depth=depth):
                return self._execute_partial(table, ctx, segment_names)
        return self.scheduler.submit(table, run, timeout_s=timeout_s)

    def _execute_partial(self, table: str, ctx: QueryContext,
                         segment_names: Optional[Sequence[str]]) -> SegmentResult:
        with qstats.collect_stats() as st:
            merged = self._run_partial(table, ctx, segment_names)
        merged.stats = st.to_wire()
        return merged

    def _load_cold(self, table: str, ctx: QueryContext,
                   segment_names: Optional[Sequence[str]], mgr: TableDataManager
                   ) -> List[ImmutableSegment]:
        """Load the partial's COLD segments from the deep store, each under
        the broker's deadline: one whose budget is spent raises
        QueryTimeoutError before its download. Returns them acquired."""
        loaded: List[ImmutableSegment] = []
        try:
            for seg_name in self._cold_unloaded(table, segment_names, mgr):
                remaining_s = _deadline_remaining_s(ctx)
                if remaining_s is not None and remaining_s <= self.MIN_DEADLINE_BUDGET_S:
                    d_ms = ctx.options.get("deadlineEpochMs")
                    raise QueryTimeoutError(
                        f"deadline budget exhausted before cold-tier load of "
                        f"{table}/{seg_name} at {self.instance_id}",
                        deadline_epoch_ms=float(d_ms))
                t_load = time.perf_counter()
                with span(f"coldload:{seg_name}"):
                    self._load_online_segment(table, seg_name, mgr, wait=True)
                loaded.extend(mgr.acquire([seg_name]))
                load_ms = (time.perf_counter() - t_load) * 1000
                self.tiering.note_cold_load()
                emit_event("segment.cold.loaded", node=self.instance_id, table=table,
                           segment=seg_name, loadMs=round(load_ms, 3))
                qstats.record(qstats.SEGMENTS_COLD_LOADED, 1)
                qstats.record(qstats.COLD_LOAD_MS, load_ms)
        except BaseException:
            mgr.release(loaded)
            raise
        return loaded

    def _admit(self, table: str, segments: Sequence[ImmutableSegment],
               mgr: TableDataManager) -> tuple:
        """(admitted, host tier): the tiering gate's decision for each
        segment, before anything stages."""
        admitted, host_tier = [], []
        for seg in segments:
            fresh = not has_block(seg)
            if self.tiering.admit(table, seg, mgr):
                admitted.append(seg)
                if fresh:
                    self.tiering.note_promotion(table, seg.name)
                    qstats.record(qstats.TIER_PROMOTIONS, 1)
            else:
                host_tier.append(seg)
        if host_tier:
            qstats.record(qstats.SEGMENTS_SERVED_HOST_TIER, len(host_tier))
        return admitted, host_tier

    def _device_route(self, ctx: QueryContext, segments: Sequence[ImmutableSegment],
                      upsert=None) -> Optional[str]:
        """The kind of the set's plan when the pipeline takes the partial (an
        aggregation, a DISTINCT or a screened ORDER BY ... LIMIT whose plan
        is not a host plan, of a table without upsert), else None."""
        if self.device_pipeline is None or not segments or upsert is not None:
            return None
        if not (ctx.aggregations or ctx.distinct or device_topk_screen(ctx)):
            return None
        kind = plan_segment(ctx, segments[0]).kind
        return None if kind == "host" else kind

    def _run_partial(self, table: str, ctx: QueryContext,
                     segment_names: Optional[Sequence[str]]) -> SegmentResult:
        reg = get_registry()
        t0 = time.perf_counter()
        mgr = self._table_manager(table)
        handler = self._realtime_managers.get(table)
        upsert = handler.upsert if handler is not None else None
        segments = mgr.acquire(segment_names)
        admitted: List[ImmutableSegment] = []
        try:
            segments.extend(self._load_cold(table, ctx, segment_names, mgr))
            admitted, host_tier = self._admit(table, segments, mgr)
            kind = self._device_route(ctx, admitted, upsert)
            results = []
            if kind is not None:
                t_dev = time.perf_counter()
                with span("device"):
                    results.append(self.device_pipeline.execute_partial(ctx, admitted))
                reg.counter("pinot_server_device_queries", {"table": table}).inc()
                # the pipeline's threads serve many queries a drain: the set's
                # segment counts and operator rows are recorded here, on the
                # query's thread
                r = results[0]
                qstats.record(qstats.NUM_SEGMENTS_QUERIED, len(admitted))
                if r.num_docs_scanned > 0 or r.groups or r.rows or r.dense is not None:
                    qstats.record(qstats.NUM_SEGMENTS_MATCHED, len(admitted))
                ms = (time.perf_counter() - t_dev) * 1000
                for label in ("SEGMENT_PLAN", PLAN_OP_LABELS.get(kind, "DEVICE_FUSED")):
                    qstats.record_operator(label, rows=r.num_docs_scanned, ms=ms)
            on_device = {seg.name for seg in admitted} if kind is None else set()
            for seg in segments if kind is None else host_tier:
                with span(f"segment:{seg.name}"):
                    valid = upsert.valid_mask(seg.name, seg.num_docs) if upsert else None
                    ex = self.executor if seg.name in on_device else self.host_executor
                    results.append(ex.execute_segment(ctx, seg, valid))
            served = [seg.name for seg in segments]
            if handler is not None:
                # the consuming segments, from one snapshot that leaves out
                # those answered immutably above
                with span("consuming"):
                    rt_results, rt_served = handler.consuming_results(
                        ctx, segment_names, exclude=set(served))
                results.extend(rt_results)
                served.extend(rt_served)
                if rt_served:
                    qstats.record(qstats.NUM_CONSUMING_SEGMENTS_QUERIED, len(rt_served))
                    fresh = handler.min_freshness_ms(rt_served)
                    if fresh is not None:
                        qstats.record_min(qstats.MIN_CONSUMING_FRESHNESS_TIME_MS, fresh)
        finally:
            # the reservations of this query's admissions end: each block
            # staged (the ledger counts it) or will wait for a later admission
            self.tiering.settle(table, [seg.name for seg in admitted])
            mgr.release(segments)
        aggs = [make_agg(f) for f in ctx.aggregations]
        with span("merge"):
            merged = merge_segment_results(results, aggs)
            if not results:
                merged.kind = ("groups" if (ctx.group_by or ctx.distinct) else
                               "scalar" if aggs else "selection")
        merged.served = served
        reg.counter("pinot_server_queries", {"table": table}).inc()
        reg.counter("pinot_server_docs_scanned").inc(merged.num_docs_scanned)
        reg.counter("pinot_server_segments_queried").inc(len(segments))
        reg.timer("pinot_server_query_latency_ms").update((time.perf_counter() - t0) * 1000)
        return merged

    def explain_partial(self, table: str, ctx: Union[str, QueryContext],
                        segment_names: Optional[Sequence[str]] = None) -> List[List]:
        """EXPLAIN rows over this server's copy of the segments."""
        if isinstance(ctx, str):
            ctx = compile_query(ctx, self.catalog.schema_for_table(table))
        mgr = self._table_manager(table)
        segments = mgr.acquire(segment_names)
        try:
            return explain_result(ctx, segments, table=table).rows
        finally:
            mgr.release(segments)


def _deadline_remaining_s(ctx: QueryContext) -> Optional[float]:
    """Seconds left before the broker's `deadlineEpochMs`, or None."""
    d_ms = ctx.options.get("deadlineEpochMs") if ctx.options else None
    return None if d_ms is None else float(d_ms) / 1000.0 - time.time()


def apply_time_filter(ctx: QueryContext, time_filter: str, schema) -> QueryContext:
    """AND a SQL predicate into the context's filter, compiled as a WHERE is."""
    from ..sql.ast import Function
    from ..sql.parser import parse_query
    tf = compile_query(parse_query(f"SELECT * FROM t WHERE {time_filter}"), schema).filter
    return dataclasses.replace(ctx, filter=tf if ctx.filter is None
                               else Function("and", (ctx.filter, tf)))
