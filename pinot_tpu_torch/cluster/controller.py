"""Controller role: table CRUD, segment upload, assignment, retention, rebalance.

A trimmed copy of `pinot_tpu/cluster/controller.py` (the analog of the
reference's `PinotHelixResourceManager`, `ZKOperator.completeSegmentOperations`
(validate, copy to the deep store, write metadata, update the ideal state),
`RetentionManager`, `SegmentDeletionManager` and `TableRebalancer`'s converge
loop): the table and segment core, tenants, table state, rebalance and table
status, and realtime tables through the LLC segment manager (`self.llc`,
`cluster/completion.py`): `add_realtime_table` creates the CONSUMING segments
of each stream partition, `pause_consumption` and `resume_consumption` stop
and restart them, and the completion protocol commits them.
`demote_segment_to_cold` flips a segment's replicas to COLD (the servers
unload it, the deep store keeps it, its first query loads it again), and
retention demotes instead of deleting under `controller.retention.cold.demote`.
The memory plane: `run_memory_check` polls every server's memory ledger (an
in-process server's `memory_snapshot` registered in `memory_pollers`, else a
server process's `GET /debug/memory`, `remote.memory_poller`), publishes each
server's headroom and each table's residency, and gives each table a verdict
off `controller.memory.headroom.pct` (default 20%): HEALTHY, DEGRADED below
it or with a server unreachable, UNHEALTHY at a quarter of it, at none left,
or with no server reporting; `memory_status` is the table's
`/tables/{t}/memoryStatus`.
The ingestion plane (the reference's tableIngestionStatus over the servers'
consumingSegmentsInfo): `ingestion_status` polls every server's consuming
rollup (an in-process server's `ingestion_snapshot` registered in
`ingestion_pollers`, else a server process's `GET /debug/consuming`,
`remote.ingestion_poller`) and gives a realtime table a verdict: UNHEALTHY
with a consumer in ERROR, a consuming segment no server consumes (unless
paused) or no server reporting; DEGRADED while paused, with a server that
failed its poll, or past `controller.ingestion.offset.lag.threshold`
(default 10,000 messages) or `controller.ingestion.freshness.lag.ms.threshold`
(unset: freshness not judged); an OFFLINE table is HEALTHY. It is the
`/tables/{t}/ingestionStatus` body; `run_ingestion_status_check` (the
IngestionStatusChecker task) publishes each table's gauges and caches the
rollups that `/debug` shows. A verdict's change, in either plane, is counted,
logged and journaled (`verdict.memory`, `verdict.ingestion`: `_note_verdict`);
the incident recorder waits. A standby controller takes over through
`cluster/leadership.py`.
`self.scheduler` holds the periodic tasks (`utils/periodic.py`): retention,
the segment status gauges, the memory and ingestion checks and the LLC
validation round, which a controller process starts (`start_periodic_tasks`)
and a test ticks by hand (`scheduler.run_all_once()`, or each method alone).
The SLO, workload, event and incident planes and the minion's task manager
wait.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Callable, Dict, List, Optional

from ..schema import Schema
from ..segment.format import CREATION_META_FILE, SEGMENT_METADATA_FILE, read_json
from ..table import TableConfig, TableType
from ..utils.metrics import get_registry
from ..utils.periodic import PeriodicTask, PeriodicTaskScheduler
from .assignment import balanced_assign, compute_counts, rebalance_table, replica_group_assign
from ..utils.events import emit_event
from .catalog import (COLD, COLUMN_STATS_KEY, ONLINE, STATUS_IN_PROGRESS, STATUS_UPLOADED,
                      Catalog, InstanceInfo, SegmentMeta, column_stats_from_meta)
from .completion import LLCSegmentManager
from .deepstore import DeepStoreFS, tar_segment
from .remote import ingestion_poller, memory_poller
from .routing import partition_for_value

# deleted segments park in the deep store this long before the retention
# reaper removes them (the reference's Deleted_Segments retention)
DELETED_SEGMENTS_RETENTION_DAYS = 7.0

SELECTORS = ("balanced", "replicagroup", "strictreplicagroup")


class Controller:
    def __init__(self, instance_id: str, catalog: Catalog, deepstore: DeepStoreFS,
                 work_dir: str):
        self.instance_id = instance_id
        self.catalog = catalog
        self.deepstore = deepstore
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.llc = LLCSegmentManager(catalog, deepstore, os.path.join(work_dir, "llc"))
        self._status_tables: set = set()   # tables with exported status gauges
        # the reference's ControllerPeriodicTask registrations, at its periods
        self.scheduler = PeriodicTaskScheduler()
        self.scheduler.register(PeriodicTask("RetentionManager", 300.0, self.run_retention))
        self.scheduler.register(PeriodicTask("RealtimeSegmentValidationManager", 60.0,
                                             self.llc.validate))
        self.scheduler.register(PeriodicTask("SegmentStatusChecker", 300.0,
                                             self.run_segment_status_check))
        # the memory plane: every server's ledger into per-table verdicts;
        # in-process clusters register ServerNode.memory_snapshot here, server
        # processes are found by their advertised ports
        self._memory_tables: set = set()      # tables with exported gauges
        self._memory_instances: set = set()   # servers with headroom gauges
        self._memory_status: Dict[str, Dict[str, object]] = {}
        self.memory_pollers: Dict[str, Callable[[], Dict[str, object]]] = {}
        self.scheduler.register(PeriodicTask("MemoryStatusChecker", 60.0,
                                             self.run_memory_check))
        # the ingestion plane: every server's consuming rollup into per-table
        # verdicts, its pollers found as the memory plane's are
        self._ingestion_tables: set = set()   # tables with exported gauges
        self._ingestion_status: Dict[str, Dict[str, object]] = {}
        self.ingestion_pollers: Dict[str, Callable[[], Dict[str, dict]]] = {}
        self.scheduler.register(PeriodicTask("IngestionStatusChecker", 60.0,
                                             self.run_ingestion_status_check))
        # each verdict plane's last state a key, for the edge trigger
        self._verdict_prev: Dict[str, Dict[str, str]] = {"memory": {}, "ingestion": {}}
        catalog.register_instance(InstanceInfo(instance_id, "controller"))

    def start_periodic_tasks(self) -> None:
        self.scheduler.start()

    def stop_periodic_tasks(self) -> None:
        self.scheduler.stop()

    def debug_stats(self) -> Dict[str, object]:
        """The controller's /debug rollup: each periodic task's runs, errors
        and last run, the last ingestion verdicts (without the per-server
        detail) and memory verdicts, and the controller's metrics and gauge
        rings."""
        reg = get_registry()
        return {"instance": self.instance_id,
                "periodicTasks": self.scheduler.stats(),
                "ingestionStatus": {t: {k: v for k, v in st.items() if k != "servers"}
                                    for t, st in self._ingestion_status.items()},
                "memoryStatus": dict(self._memory_status),
                "controllerMetrics": {k: v for k, v in reg.snapshot().items()
                                      if k.startswith(("pinot_controller", "pinot_periodic"))},
                "gaugeHistories": reg.gauge_histories("pinot_controller")}

    # -- table CRUD -------------------------------------------------------
    def add_schema(self, schema: Schema) -> None:
        self.catalog.put_schema(schema)

    def add_table(self, config: TableConfig) -> None:
        if config.name not in self.catalog.schemas:
            raise ValueError(f"schema {config.name!r} must be added before the table")
        self._validate_table_config(config)
        self.catalog.put_table_config(config)

    @staticmethod
    def _validate_table_config(config: TableConfig) -> None:
        if config.routing_selector and \
                config.routing_selector.lower().replace("_", "") not in SELECTORS:
            # a typo would fall back to balanced and drop the upsert guard
            raise ValueError(f"unknown routingSelector {config.routing_selector!r} "
                             "(balanced | replicaGroup | strictReplicaGroup)")

    def add_realtime_table(self, config: TableConfig, num_partitions: int) -> List[str]:
        """A REALTIME table and its first CONSUMING segment of each partition
        (the reference's setUpNewTable); returns their names."""
        if config.table_type is not TableType.REALTIME or config.stream is None:
            raise ValueError(f"{config.name}: a realtime table needs tableType REALTIME "
                             "and a stream config")
        self.add_table(config)
        return self.llc.setup_realtime_table(config, num_partitions)

    def pause_consumption(self, table: str) -> Dict[str, object]:
        """The reference's pauseConsumption (`LLCSegmentManager.pause_consumption`)."""
        return self.llc.pause_consumption(table)

    def resume_consumption(self, table: str) -> Dict[str, object]:
        """The reference's resumeConsumption (`LLCSegmentManager.resume_consumption`)."""
        return self.llc.resume_consumption(table)

    def drop_table(self, table: str) -> None:
        """Delete the table's segments (a realtime table's consuming ones with
        them, whose servers stop their consumers) and the table. The FSMs go
        first, under the LLC manager's lock: a commit whose upload is in
        flight then fails at its flip, and writes no ONLINE segment and no
        successor for the table."""
        with self.llc._lock:
            with self.catalog._lock:
                segments = list(self.catalog.segments.get(table, {}))
            for seg in segments:
                self.llc.fsms.pop(seg, None)
        for seg in segments:
            self.delete_segment(table, seg)
        # a table recreated under the name inherits neither a disabled state
        # nor a pause
        self.catalog.put_property(f"tableState/{table}", None)
        self.catalog.put_property(f"pause/{table}", None)
        self.catalog.drop_table(table)

    # -- segment upload ---------------------------------------------------
    def upload_segment(self, table: str, segment_dir: str,
                       custom: Optional[Dict[str, str]] = None) -> SegmentMeta:
        """Validate the segment against the table's schema, copy it to the deep
        store as a gzip tar, write its metadata (the partition id and time
        range from its metadata.json, and the columns' min, max and bloom for
        the broker's pruners) and assign it to servers."""
        cfg = self.catalog.table_configs.get(table)
        if cfg is None:
            raise ValueError(f"unknown table {table!r}")
        seg_meta_json = read_json(os.path.join(segment_dir, SEGMENT_METADATA_FILE))
        seg_name = seg_meta_json["segmentName"]
        schema = self.catalog.schemas.get(cfg.name)
        seg_schema = Schema.from_json(seg_meta_json["schema"])
        for f in schema.fields:
            if not seg_schema.has_column(f.name):
                raise ValueError(f"segment {seg_name} missing column {f.name}")

        tar_path = os.path.join(self.work_dir, f"{seg_name}.{uuid.uuid4().hex}.tar.gz")
        tar_segment(segment_dir, tar_path)
        uri = f"{table}/{seg_name}.tar.gz"
        try:
            self.deepstore.upload(tar_path, uri)
            size = os.path.getsize(tar_path)
        finally:
            os.remove(tar_path)

        meta = SegmentMeta(
            name=seg_name, table=table, status=STATUS_UPLOADED,
            num_docs=seg_meta_json["totalDocs"],
            crc=read_json(os.path.join(segment_dir, CREATION_META_FILE))["crc"],
            size_bytes=size, download_path=uri, push_time_ms=int(time.time() * 1000),
            partition_id=self._partition_id(cfg, seg_meta_json),
            custom=dict(custom or {}))
        self._fill_time_range(cfg, seg_meta_json, meta)
        col_stats = column_stats_from_meta(seg_meta_json)
        if col_stats:
            meta.custom[COLUMN_STATS_KEY] = col_stats
        self.catalog.put_segment_meta(meta)
        self._assign_segment(table, cfg, meta)
        get_registry().counter("pinot_controller_segments_uploaded", {"table": table}).inc()
        return meta

    @staticmethod
    def _partition_id(cfg: TableConfig, seg_meta) -> Optional[int]:
        """Every row of a partitioned segment maps to one partition: the
        partition column's min value names it."""
        if not cfg.partition:
            return None
        col = seg_meta["columns"].get(cfg.partition.column)
        if col is None or col.get("minValue") is None:
            return None
        return partition_for_value(col["minValue"], cfg.partition.function,
                                   cfg.partition.num_partitions)

    @staticmethod
    def _fill_time_range(cfg: TableConfig, seg_meta, meta: SegmentMeta) -> None:
        if not cfg.time_column:
            return
        col = seg_meta["columns"].get(cfg.time_column)
        if col and col.get("minValue") is not None:
            meta.start_time_ms = int(col["minValue"])
            meta.end_time_ms = int(col["maxValue"])

    def _assign_segment(self, table: str, cfg: TableConfig, meta: SegmentMeta) -> None:
        servers = self.catalog.live_servers(cfg.tenant)
        with self.catalog._lock:   # other uploads update the ideal state meanwhile
            counts = compute_counts(self.catalog.ideal_state.get(table, {}))
        if cfg.is_dim_table:
            # a dimension table goes to every server of its tenant, so LOOKUP
            # resolves locally
            chosen = list(servers)
        elif cfg.partition and meta.partition_id is not None:
            chosen = replica_group_assign(meta.name, servers, cfg.replication,
                                          meta.partition_id, counts)
        else:
            chosen = balanced_assign(meta.name, servers, cfg.replication, counts)
        self.catalog.update_ideal_state(table, {meta.name: {s: ONLINE for s in chosen}})

    # -- segment replacement with lineage ---------------------------------
    def replace_segments(self, table: str, old_names: List[str],
                         new_segment_dirs: List[str],
                         custom: Optional[Dict[str, str]] = None) -> List[str]:
        """Swap `old_names` for the new segments atomically, as queries see
        it: while the lineage entry is IN_PROGRESS routing hides the new
        segments, after it flips to COMPLETED the old ones; the old segments
        are then deleted and the entry removed."""
        new_names = [read_json(os.path.join(d, SEGMENT_METADATA_FILE))["segmentName"]
                     for d in new_segment_dirs]
        entry_id = uuid.uuid4().hex
        key = f"lineage/{table}"
        self.catalog.mutate_property(key, lambda es: list(es or []) + [
            {"id": entry_id, "from": list(old_names), "to": new_names,
             "state": "IN_PROGRESS"}])

        def drop_entry(es):
            return [e for e in (es or []) if e["id"] != entry_id] or None
        try:
            for d in new_segment_dirs:
                self.upload_segment(table, d, custom=custom)
        except Exception:
            # revert: queries never saw the half-uploaded outputs
            for name in new_names:
                if name in self.catalog.segments.get(table, {}):
                    self.delete_segment(table, name, permanent=True)
            self.catalog.mutate_property(key, drop_entry)
            raise
        self.catalog.mutate_property(key, lambda es: [
            dict(e, state="COMPLETED") if e["id"] == entry_id else e for e in (es or [])])
        for name in old_names:
            self.delete_segment(table, name)
        self.catalog.mutate_property(key, drop_entry)
        return new_names

    def reload_table(self, table: str) -> None:
        """Ask every server of the table to bring its segments' indexes in
        line with the current config (a distinct nonce each call, so two
        reloads never coalesce)."""
        self.catalog.put_property(f"reload/{table}", uuid.uuid4().hex)

    def update_table(self, config: TableConfig, reload: bool = True) -> None:
        self._validate_table_config(config)
        self.catalog.put_table_config(config)
        if reload:
            self.reload_table(config.table_name_with_type)

    # -- deletion / retention ---------------------------------------------
    def delete_segment(self, table: str, segment: str, *, permanent: bool = False,
                       now_ms: Optional[int] = None) -> None:
        """Remove the segment from the ideal state and the metadata and park
        its deep-store copy under Deleted_Segments/ until `run_retention`
        reaps it past DELETED_SEGMENTS_RETENTION_DAYS; `permanent` deletes
        the copy at once (segments queries never saw)."""
        meta = self.catalog.segments.get(table, {}).get(segment)
        self.catalog.update_ideal_state(table, {segment: None})
        self.catalog.drop_segment_meta(table, segment)
        if meta and meta.download_path and self.deepstore.exists(meta.download_path):
            if permanent:
                self.deepstore.delete(meta.download_path)
                return
            parked = f"Deleted_Segments/{table}/{segment}.tar.gz"
            self.deepstore.move(meta.download_path, parked)
            self.catalog.put_property(f"deleted/{table}/{segment}",
                                      {"uri": parked,
                                       "deletedAtMs": now_ms or int(time.time() * 1000)})

    def demote_segment_to_cold(self, table: str, segment: str) -> bool:
        """Flip every replica's assignment of the segment to COLD: the servers
        unload their copy (the deep store keeps the bytes), routing keeps the
        segment routable, and its first query loads it again. False when the
        segment is unknown or already COLD everywhere."""
        with self.catalog._lock:
            ist = dict(self.catalog.ideal_state.get(table, {}).get(segment) or {})
        if not ist or all(st == COLD for st in ist.values()):
            return False
        self.catalog.update_ideal_state(table, {segment: {srv: COLD for srv in ist}})
        get_registry().counter("pinot_controller_cold_demotions", {"table": table}).inc()
        emit_event("segment.cold.demoted", node=self.instance_id, table=table,
                   segment=segment, replicas=len(ist))
        return True

    def run_retention(self, now_ms: Optional[int] = None) -> List[str]:
        """Delete the segments past their table's retention (demote them to
        the cold tier instead under `controller.retention.cold.demote`: still
        queryable, recoverable), then reap the parked copies past
        DELETED_SEGMENTS_RETENTION_DAYS."""
        now_ms = now_ms or int(time.time() * 1000)
        demote = str(self.catalog.get_property("clusterConfig/controller.retention.cold.demote",
                                               "false")).lower() == "true"
        deleted = []
        for table, cfg in list(self.catalog.table_configs.items()):
            if not cfg.retention_days or not cfg.time_column:
                continue
            cutoff = now_ms - cfg.retention_days * 24 * 3600 * 1000
            for seg, meta in list(self.catalog.segments.get(table, {}).items()):
                if meta.end_time_ms is not None and meta.end_time_ms < cutoff:
                    if demote:
                        if self.demote_segment_to_cold(table, seg):
                            deleted.append(f"cold:{table}/{seg}")
                        continue
                    self.delete_segment(table, seg, now_ms=now_ms)
                    deleted.append(f"{table}/{seg}")
        park_cutoff = now_ms - DELETED_SEGMENTS_RETENTION_DAYS * 86_400_000
        for key, note in list(self.catalog.properties.items()):
            if not key.startswith("deleted/") or not isinstance(note, dict):
                continue
            if note.get("deletedAtMs", 0) < park_cutoff:
                self.deepstore.delete(note["uri"])
                self.catalog.put_property(key, None)
                deleted.append(f"reaped:{note['uri']}")
        return deleted

    def run_segment_status_check(self) -> Dict[str, Dict[str, int]]:
        """Per-table segment and replica gauges (the reference's
        SegmentStatusChecker); a dropped table's gauges go."""
        reg = get_registry()
        gauges = ("pinot_controller_segments_total", "pinot_controller_segments_online",
                  "pinot_controller_table_converged")
        out: Dict[str, Dict[str, int]] = {}
        for table in list(self.catalog.ideal_state):
            st = self.table_status(table)
            online = sum(1 for n in st["replicas_online"].values() if n > 0)
            for g, v in zip(gauges, (st["segments"], online, 1 if st["converged"] else 0)):
                reg.gauge(g, {"table": table}).set(v)
            out[table] = {"segments": st["segments"], "online": online}
        for table in self._status_tables - set(out):
            for g in gauges:
                reg.remove(g, {"table": table})
        self._status_tables = set(out)
        return out

    # -- the memory plane: the cluster's view of the servers' ledgers ------

    _MEMORY_TABLE_GAUGES = ("pinot_controller_hbm_healthy",
                            "pinot_controller_hbm_resident_bytes")
    _MEMORY_INSTANCE_GAUGE = "pinot_controller_hbm_headroom_pct"
    #: least per-server headroom before a table degrades; a server at or
    #: under a quarter of it (or fully out) makes it UNHEALTHY
    DEFAULT_MEMORY_HEADROOM_PCT = 20.0
    VERDICT_LOGGER = "pinot_tpu_torch.verdicts"
    _VERDICT_SEVERITY = {"HEALTHY": "INFO", "DEGRADED": "WARN", "UNHEALTHY": "ERROR"}

    def _cluster_config_float(self, key: str, default: Optional[float]) -> Optional[float]:
        v = self.catalog.get_property(f"clusterConfig/{key}")
        if v is None:
            return default
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    def _iter_pollers(self, registered: Dict[str, Callable], remote: Callable):
        """(server id, poll) for every server: the registered in-process
        pollers first, then the live servers that advertise an HTTP port
        (server processes), each polled by `remote(url)`."""
        seen = set()
        for sid, poll in list(registered.items()):
            seen.add(sid)
            yield sid, poll
        with self.catalog._lock:
            infos = list(self.catalog.instances.values())
        for info in infos:
            if info.role != "server" or not info.port or not info.alive \
                    or info.instance_id in seen:
                continue
            yield info.instance_id, remote(info.url)

    def run_memory_check(self) -> Dict[str, str]:
        """Poll every server's ledger, publish each server's headroom and each
        table's residency, and give each table a verdict off the
        `controller.memory.headroom.pct` threshold: under it DEGRADED; at or
        under a quarter of it, at no headroom, or with no server reporting,
        UNHEALTHY; a server that failed its poll DEGRADED. A dropped table's
        or a departed server's series go. A table's bytes sum over the
        servers; in-process servers share one ledger, so each reports the
        process view (the `servers` map shows it)."""
        reg = get_registry()
        thr = self._cluster_config_float("controller.memory.headroom.pct",
                                         self.DEFAULT_MEMORY_HEADROOM_PCT)
        snaps: Dict[str, Dict[str, object]] = {}
        unreachable: List[str] = []
        for sid, poll in self._iter_pollers(self.memory_pollers, memory_poller):
            try:
                snaps[sid] = dict(poll() or {})
            except Exception:   # the verdict reports it; the check goes on
                unreachable.append(sid)

        for sid, snap in snaps.items():
            reg.gauge(self._MEMORY_INSTANCE_GAUGE, {"instance": sid}).set(
                float(snap.get("headroomPct") or 0.0))
        for sid in self._memory_instances - set(snaps):
            reg.remove(self._MEMORY_INSTANCE_GAUGE, {"instance": sid})
        self._memory_instances = set(snaps)

        headroom = {sid: float(snap.get("headroomPct") or 0.0) for sid, snap in snaps.items()}
        breached = {sid: h for sid, h in headroom.items() if thr is not None and h < thr}
        severe = {sid for sid, h in breached.items() if h <= thr / 4.0 or h <= 0.0}

        out: Dict[str, Dict[str, object]] = {}
        for table in list(self.catalog.table_configs):
            per_server = {sid: int((snap.get("tables") or {}).get(table, 0) or 0)
                          for sid, snap in snaps.items()}
            verdict = "HEALTHY"
            reasons: List[str] = []

            def degrade(to: str, reason: str) -> None:
                nonlocal verdict
                reasons.append(reason)
                order = ("HEALTHY", "DEGRADED", "UNHEALTHY")
                if order.index(to) > order.index(verdict):
                    verdict = to

            if not snaps:
                degrade("UNHEALTHY", "no server reported memory status"
                        + (f" (unreachable: {sorted(unreachable)})" if unreachable else ""))
            elif unreachable:
                degrade("DEGRADED", f"memory poll failed for: {sorted(unreachable)}")
            for sid, h in sorted(breached.items()):
                if sid in severe:
                    degrade("UNHEALTHY", f"server {sid} HBM headroom {h:g}% critically "
                            f"below threshold {thr:g}%")
                else:
                    degrade("DEGRADED", f"server {sid} HBM headroom {h:g}% below "
                            f"threshold {thr:g}%")
            # the tiers' counters summed: is the cluster riding the gate
            # (rejections and evictions climbing) or comfortably resident?
            tiering: Dict[str, int] = {}
            for snap in snaps.values():
                t_snap = snap.get("tiering")
                if isinstance(t_snap, dict):
                    for k in ("admissions", "rejections", "evictions", "promotions",
                              "coldLoads"):
                        tiering[k] = tiering.get(k, 0) + int(t_snap.get(k, 0) or 0)
            resident = sum(per_server.values())
            labels = {"table": table}
            reg.gauge(self._MEMORY_TABLE_GAUGES[0], labels).set(1 if verdict == "HEALTHY" else 0)
            reg.gauge(self._MEMORY_TABLE_GAUGES[1], labels).set(resident)
            out[table] = {
                "table": table, "memoryState": verdict, "reasons": reasons,
                "residentBytes": resident, "headroomThresholdPct": thr,
                "minServerHeadroomPct": min(headroom.values(), default=None),
                "servers": per_server, "unreachableServers": sorted(unreachable),
                "tiering": tiering,
            }
            self._note_verdict("memory", table, verdict, reasons)
        for table in self._memory_tables - set(out):
            for g in self._MEMORY_TABLE_GAUGES:
                reg.remove(g, {"table": table})
        self._memory_tables = set(out)
        self._memory_status = out
        self._prune_verdicts("memory", set(out))
        return {t: str(st["memoryState"]) for t, st in out.items()}

    def _note_verdict(self, plane: str, key: str, status: str, reasons: List[str]) -> None:
        """Edge-trigger one plane's verdict of a table: nothing while it is
        unchanged; a change counts `pinot_controller_verdict_transitions{kind}`,
        logs a line and journals `verdict.<plane>`."""
        prev_map = self._verdict_prev[plane]
        prev = prev_map.get(key, "HEALTHY")
        if status == prev:
            return
        prev_map[key] = status
        get_registry().counter("pinot_controller_verdict_transitions", {"kind": plane}).inc()
        logging.getLogger(self.VERDICT_LOGGER).warning(
            "%s verdict for %s: %s -> %s%s", plane, key, prev, status,
            f" ({'; '.join(map(str, reasons[:3]))})" if reasons else "")
        emit_event(f"verdict.{plane}", node=self.instance_id, table=key,
                   severity=self._VERDICT_SEVERITY.get(status, "WARN"),
                   fromState=prev, toState=status, reasons=[str(r) for r in reasons[:3]])

    def _prune_verdicts(self, plane: str, live_keys) -> None:
        """Forget the edge trigger's state of the keys a plane no longer
        judges (a dropped table)."""
        prev_map = self._verdict_prev[plane]
        for k in list(prev_map):
            if k not in live_keys:
                prev_map.pop(k)

    def memory_status(self, table: str) -> Dict[str, object]:
        """A table's memory verdict (the `/tables/{t}/memoryStatus` body);
        UNKNOWN before the check judged it; an unknown table raises
        ValueError."""
        st = self._memory_status.get(table)
        if st is None and table.endswith(("_OFFLINE", "_REALTIME")):
            st = self._memory_status.get(table.rsplit("_", 1)[0])
        if st is not None:
            return st
        if not any(name == table or name.rsplit("_", 1)[0] == table
                   for name in self.catalog.table_configs):
            raise ValueError(f"unknown table {table!r}")
        return {"table": table, "memoryState": "UNKNOWN", "reasons": [],
                "residentBytes": 0, "servers": {},
                "message": "memory check has not run yet"}

    # -- the ingestion plane: the cluster's view of the servers' consumers ---

    #: offset lag (messages) past which a table degrades, where the cluster
    #: config sets none
    DEFAULT_OFFSET_LAG_THRESHOLD = 10_000.0
    _INGESTION_GAUGES = ("pinot_controller_ingestion_healthy",
                         "pinot_controller_ingestion_offset_lag",
                         "pinot_controller_ingestion_freshness_lag_ms")

    def ingestion_status(self, table: str) -> Dict[str, object]:
        """A table's ingestion verdict (HEALTHY, DEGRADED or UNHEALTHY, with
        its reasons), read live from every server's consuming rollup; an
        unknown table raises ValueError."""
        cfg = self.catalog.table_configs.get(table)
        if cfg is None:
            raise ValueError(f"unknown table {table!r}")
        if cfg.stream is None or not cfg.stream.topic:
            return {"table": table, "ingestionState": "HEALTHY", "reasons": [],
                    "paused": False, "numConsumingSegments": 0, "maxOffsetLag": 0,
                    "maxFreshnessLagMs": 0, "totalRowsPerSecond": 0.0, "servers": {},
                    "unreachableServers": [], "message": "offline table: batch ingestion only"}
        paused = bool(self.catalog.get_property(f"pause/{table}"))
        with self.catalog._lock:
            consuming = [m.name for m in self.catalog.segments.get(table, {}).values()
                         if m.status == STATUS_IN_PROGRESS]
        statuses: Dict[str, Dict[str, object]] = {}
        unreachable: List[str] = []
        for sid, poll in self._iter_pollers(self.ingestion_pollers, ingestion_poller):
            try:
                snap = poll()
            except Exception:   # the verdict reports it
                unreachable.append(sid)
                continue
            st = snap.get(table)
            if st:
                statuses[sid] = st
        attached = {seg for st in statuses.values() for seg in st.get("segments", {})}
        error_segs = sorted({seg for st in statuses.values()
                             for seg in st.get("errorSegments", [])})
        max_offset_lag = max((st.get("maxOffsetLag") or 0 for st in statuses.values()),
                             default=0)
        max_fresh_lag = max((st.get("maxFreshnessLagMs") or 0 for st in statuses.values()),
                            default=0)
        rows_per_s = round(sum(st.get("totalRowsPerSecond") or 0.0
                               for st in statuses.values()), 3)
        missing = sorted(set(consuming) - attached)
        reasons: List[str] = []
        verdict = "HEALTHY"

        def degrade(to: str, reason: str) -> None:
            nonlocal verdict
            reasons.append(reason)
            order = ("HEALTHY", "DEGRADED", "UNHEALTHY")
            if order.index(to) > order.index(verdict):
                verdict = to

        if error_segs:
            degrade("UNHEALTHY", f"consumers in ERROR state: {error_segs}")
        if missing and not paused:
            degrade("UNHEALTHY", f"consuming segments with no attached consumer: {missing}")
        if consuming and not statuses:
            if unreachable:
                degrade("UNHEALTHY", f"no server reported ingestion status "
                        f"(unreachable: {sorted(unreachable)})")
        elif unreachable:
            degrade("DEGRADED", f"ingestion status poll failed for: {sorted(unreachable)}")
        if paused:
            degrade("DEGRADED", "consumption is paused")
        lag_thr = self._cluster_config_float("controller.ingestion.offset.lag.threshold",
                                             self.DEFAULT_OFFSET_LAG_THRESHOLD)
        if lag_thr is not None and max_offset_lag > lag_thr:
            degrade("DEGRADED", f"offset lag {max_offset_lag} exceeds threshold {lag_thr:g}")
        fresh_thr = self._cluster_config_float(
            "controller.ingestion.freshness.lag.ms.threshold", None)
        if fresh_thr is not None and max_fresh_lag > fresh_thr:
            degrade("DEGRADED", f"freshness lag {max_fresh_lag}ms exceeds threshold "
                    f"{fresh_thr:g}ms")
        return {"table": table, "ingestionState": verdict, "reasons": reasons,
                "paused": paused, "numConsumingSegments": len(consuming),
                "maxOffsetLag": max_offset_lag, "maxFreshnessLagMs": max_fresh_lag,
                "totalRowsPerSecond": rows_per_s, "servers": statuses,
                "unreachableServers": sorted(unreachable)}

    def run_ingestion_status_check(self) -> Dict[str, str]:
        """Every realtime table's verdict into its gauges and the cached
        rollups; a dropped table's series and edge-trigger state go."""
        reg = get_registry()
        out: Dict[str, Dict[str, object]] = {}
        for table, cfg in list(self.catalog.table_configs.items()):
            if cfg.stream is None or not cfg.stream.topic:
                continue
            st = self.ingestion_status(table)
            labels = {"table": table}
            reg.gauge(self._INGESTION_GAUGES[0], labels).set(
                1 if st["ingestionState"] == "HEALTHY" else 0)
            reg.gauge(self._INGESTION_GAUGES[1], labels).set(st["maxOffsetLag"])
            reg.gauge(self._INGESTION_GAUGES[2], labels).set(st["maxFreshnessLagMs"])
            out[table] = st
            self._note_verdict("ingestion", table, str(st["ingestionState"]),
                               list(st.get("reasons") or []))
        for table in self._ingestion_tables - set(out):
            for g in self._INGESTION_GAUGES:
                reg.remove(g, {"table": table})
        self._ingestion_tables = set(out)
        self._ingestion_status = out
        self._prune_verdicts("ingestion", set(out))
        return {t: str(st["ingestionState"]) for t, st in out.items()}

    def set_table_state(self, table: str, enabled: bool) -> None:
        """A disabled table keeps its segments loaded; brokers refuse its
        queries until it is enabled again."""
        if table not in self.catalog.table_configs:
            raise ValueError(f"unknown table {table!r}")
        self.catalog.put_property(f"tableState/{table}", None if enabled else "disabled")

    # -- tenants: a tenant is a tag on server instances --------------------
    def update_instance_tags(self, instance_id: str, tags: List[str]) -> None:
        """Re-tag an instance; tables pick the change up at their next
        assignment or rebalance."""
        self.catalog.update_instance_tags(instance_id, tags)

    def list_tenants(self) -> Dict[str, List[str]]:
        """tenant tag -> live servers carrying it."""
        out: Dict[str, List[str]] = {}
        with self.catalog._lock:
            for info in self.catalog.instances.values():
                if info.role != "server" or not info.alive:
                    continue
                for tag in info.tags:
                    out.setdefault(tag, []).append(info.instance_id)
        return {t: sorted(v) for t, v in sorted(out.items())}

    # -- rebalance --------------------------------------------------------
    def rebalance(self, table: str, min_available_replicas: int = 1
                  ) -> Dict[str, Dict[str, str]]:
        """A balanced target over the tenant's live servers, converged step by
        step, never dropping a segment below `min_available_replicas`
        online copies."""
        cfg = self.catalog.table_configs[table]
        current = {s: dict(a) for s, a in self.catalog.ideal_state.get(table, {}).items()}
        pool = self.catalog.live_servers(cfg.tenant)
        target = rebalance_table(current, pool, cfg.replication) if pool else current
        return self._converge_ideal_state(table, target, cfg.replication,
                                          min_available_replicas)

    def _converge_ideal_state(self, table: str, target: Dict[str, Dict[str, str]],
                              replication: int, min_available_replicas: int = 1
                              ) -> Dict[str, Dict[str, str]]:
        """Walk the ideal state toward `target`, adding a replica before
        dropping one and dropping only while `min_available_replicas` target
        copies are online (the reference's TableRebalancer)."""
        current = {s: dict(a) for s, a in self.catalog.ideal_state.get(table, {}).items()
                   if s in target}
        for _ in range(len(target) * (replication + 1) + 4):
            if current == target:
                break
            updates = {}
            for seg, want in target.items():
                have = current.get(seg, {})
                if have == want:
                    continue
                ev = self.catalog.external_view.get(table, {}).get(seg, {})
                online_now = [s for s, st in ev.items() if st == ONLINE]
                step = dict(have)
                missing = [s for s in want if s not in step]
                if missing:
                    step[missing[0]] = ONLINE   # add first ...
                else:
                    live_targets = [t for t in online_now if t in want]
                    removable = [s for s in step if s not in want]
                    if removable and len(live_targets) >= min_available_replicas:
                        step.pop(removable[0])  # ... then drop
                if step != have:
                    updates[seg] = step
                    current[seg] = step
            if not updates:
                break
            self.catalog.update_ideal_state(table, updates)
        return current

    def table_status(self, table: str) -> Dict[str, object]:
        with self.catalog._lock:
            ist = {s: dict(a) for s, a in self.catalog.ideal_state.get(table, {}).items()}
            ev = {s: dict(a) for s, a in self.catalog.external_view.get(table, {}).items()}
        return {
            "segments": len(ist),
            "converged": all(ev.get(seg, {}) == a for seg, a in ist.items()),
            "replicas_online": {seg: sum(1 for st in ev.get(seg, {}).values() if st == ONLINE)
                                for seg in ist},
        }
