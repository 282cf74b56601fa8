"""Cluster catalog: the metadata store replacing ZooKeeper/Helix.

A copy of `pinot_tpu/cluster/catalog.py`, without the cold tier's state.
The realtime lifecycle (`completion.py`) keeps its durable state here: a
consuming segment's `SegmentMeta` (status IN_PROGRESS, then DONE with its
end offset; partition group and sequence number), the CONSUMING and ONLINE
states of the ideal state and the external view, and the `pause/<table>`
property; the LLC segment manager reads these as copies taken under the
catalog's lock, as the other roles do.
`snapshot()` writes the JAX package's JSON, so a snapshot taken by either
package restores into the other's catalog.

Holds exactly what the reference keeps in ZK (SURVEY.md §1): table configs + schemas
(PropertyStore), `SegmentMeta` (= `SegmentZKMetadata`,
`pinot-common/.../metadata/segment/SegmentZKMetadata.java:34`), IdealState (desired
segment->server->state) and ExternalView (actual), plus live instances. Watches replace
Helix state-transition messages: writers mutate under a lock, subscribers get called
after the mutation (reference: Helix `SegmentOnlineOfflineStateModelFactory` transitions).

The in-proc implementation is authoritative for a single coordinator process; the HTTP
transport layer exposes it to remote roles. Persistence: `snapshot()`/`restore()` round-
trip the whole catalog as JSON (checkpoint/resume, SURVEY.md §5 "Checkpoint / resume").
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..schema import Schema
from ..table import TableConfig

# segment lifecycle states (reference: SegmentOnlineOfflineStateModel)
ONLINE = "ONLINE"
OFFLINE = "OFFLINE"
CONSUMING = "CONSUMING"
COLD = "COLD"        # the deep store holds it; the server loads it on a query
DROPPED = "DROPPED"
ERROR = "ERROR"

# segment metadata status (reference: SegmentZKMetadata.Status)
STATUS_IN_PROGRESS = "IN_PROGRESS"
STATUS_DONE = "DONE"
STATUS_UPLOADED = "UPLOADED"


@dataclass
class SegmentMeta:
    """Reference: SegmentZKMetadata — all durable per-segment facts."""

    name: str
    table: str                      # table name with type
    status: str = STATUS_UPLOADED
    num_docs: int = 0
    crc: int = 0
    size_bytes: int = 0
    download_path: str = ""         # deep-store location
    creation_time_ms: int = 0
    push_time_ms: int = 0
    start_time_ms: Optional[int] = None   # min of time column (time pruning)
    end_time_ms: Optional[int] = None
    partition_id: Optional[int] = None    # partition pruning
    # realtime (LLC) fields
    start_offset: Optional[str] = None
    end_offset: Optional[str] = None
    partition_group: Optional[int] = None
    sequence_number: Optional[int] = None
    # free-form marks (reference: SegmentZKMetadata custom map — e.g. which minion
    # task produced the segment, so generators don't re-process outputs)
    custom: Dict[str, Any] = field(default_factory=dict)

    def to_json(self):
        return {k: v for k, v in self.__dict__.items()}

    @staticmethod
    def from_json(d):
        return SegmentMeta(**d)


#: SegmentMeta.custom key holding per-column pruning metadata:
#: {column: {"min": v, "max": v, "bloom": "<hex>"}} lifted from the segment's
#: metadata.json at commit/upload so the broker can range/bloom-prune without
#: ever opening the segment (reference: ColumnValueSegmentPruner consuming
#: column metadata + bloom filters)
COLUMN_STATS_KEY = "columnStats"


def column_stats_from_meta(seg_meta_json: Dict[str, Any]) -> Dict[str, Any]:
    """Lift the broker-prunable per-column facts out of a segment's
    metadata.json `columns` block: min/max (range pruning) and the
    metadata-carried bloom payload (EQ/IN pruning)."""
    out: Dict[str, Any] = {}
    for col, cm in (seg_meta_json.get("columns") or {}).items():
        entry: Dict[str, Any] = {}
        if cm.get("minValue") is not None:
            entry["min"] = cm["minValue"]
            entry["max"] = cm.get("maxValue")
        if cm.get("bloomHex"):
            entry["bloom"] = cm["bloomHex"]
        if entry:
            out[col] = entry
    return out


@dataclass
class InstanceInfo:
    instance_id: str
    role: str                      # server | broker | controller | minion
    host: str = "localhost"
    port: int = 0
    tags: List[str] = field(default_factory=lambda: ["DefaultTenant"])
    alive: bool = True
    scheme: str = "http"           # https when the role serves TLS

    @property
    def url(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def to_json(self):
        return dict(self.__dict__)

    @staticmethod
    def from_json(d):
        return InstanceInfo(**d)


class Catalog:
    """Thread-safe in-memory metadata store with watch callbacks."""

    def __init__(self):
        self._lock = threading.RLock()
        self.schemas: Dict[str, Schema] = {}
        self.table_configs: Dict[str, TableConfig] = {}          # key: name_with_type
        self.segments: Dict[str, Dict[str, SegmentMeta]] = {}    # table -> seg -> meta
        self.ideal_state: Dict[str, Dict[str, Dict[str, str]]] = {}   # table->seg->srv->state
        self.external_view: Dict[str, Dict[str, Dict[str, str]]] = {}
        self.instances: Dict[str, InstanceInfo] = {}
        self.properties: Dict[str, Any] = {}                     # misc (lineage, jobs)
        self._watchers: List[Callable[[str, str], None]] = []    # (event, table)

    # -- watches -----------------------------------------------------------
    def subscribe(self, fn: Callable[[str, str], None]) -> None:
        """fn(event, table); events: ideal_state, external_view, table, schema, instance."""
        with self._lock:
            self._watchers.append(fn)

    def _notify(self, event: str, table: str) -> None:
        for fn in list(self._watchers):
            fn(event, table)

    # -- schemas / tables --------------------------------------------------
    def put_schema(self, schema: Schema) -> None:
        with self._lock:
            self.schemas[schema.name] = schema
        self._notify("schema", schema.name)

    def put_table_config(self, config: TableConfig) -> None:
        with self._lock:
            self.table_configs[config.table_name_with_type] = config
            self.segments.setdefault(config.table_name_with_type, {})
            self.ideal_state.setdefault(config.table_name_with_type, {})
            self.external_view.setdefault(config.table_name_with_type, {})
        self._notify("table", config.table_name_with_type)

    def drop_table(self, table: str) -> None:
        with self._lock:
            self.table_configs.pop(table, None)
            self.segments.pop(table, None)
            self.ideal_state.pop(table, None)
            self.external_view.pop(table, None)
        self._notify("table", table)

    def schema_for_table(self, table: str) -> Optional[Schema]:
        with self._lock:
            cfg = self.table_configs.get(table)
            if cfg is None:
                return None
            return self.schemas.get(cfg.name)

    # -- segment metadata --------------------------------------------------
    def put_segment_meta(self, meta: SegmentMeta) -> None:
        with self._lock:
            self.segments.setdefault(meta.table, {})[meta.name] = meta
        self._notify("segment", meta.table)

    def drop_segment_meta(self, table: str, segment: str) -> None:
        with self._lock:
            self.segments.get(table, {}).pop(segment, None)
        self._notify("segment", table)

    # -- ideal state (controller writes) -----------------------------------
    def update_ideal_state(self, table: str,
                           updates: Dict[str, Optional[Dict[str, str]]]) -> None:
        """updates: segment -> {server: state} (None value drops the segment entry)."""
        with self._lock:
            ist = self.ideal_state.setdefault(table, {})
            for seg, assignment in updates.items():
                if assignment is None:
                    ist.pop(seg, None)
                else:
                    ist[seg] = dict(assignment)
        self._notify("ideal_state", table)

    # -- external view (servers write) -------------------------------------
    def report_state(self, table: str, segment: str, server: str,
                     state: Optional[str]) -> None:
        with self._lock:
            ev = self.external_view.setdefault(table, {})
            entry = ev.setdefault(segment, {})
            if state is None or state == DROPPED:
                entry.pop(server, None)
                if not entry:
                    ev.pop(segment, None)
            else:
                entry[server] = state
        self._notify("external_view", table)

    # -- properties (reference: ZK property store misc nodes: lineage, tasks,
    # watermarks) ----------------------------------------------------------
    def put_property(self, key: str, value: Any) -> None:
        with self._lock:
            if value is None:
                self.properties.pop(key, None)
            else:
                self.properties[key] = value
        self._notify("property", key)

    def get_property(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self.properties.get(key, default)

    def mutate_property(self, key: str, fn: Callable[[Any], Any]) -> Any:
        """Atomic read-modify-write (the ZK compare-and-set analog)."""
        with self._lock:
            value = fn(self.properties.get(key))
            if value is None:
                self.properties.pop(key, None)
            else:
                self.properties[key] = value
        self._notify("property", key)
        return value

    # -- instances ---------------------------------------------------------
    def register_instance(self, info: InstanceInfo) -> None:
        with self._lock:
            self.instances[info.instance_id] = info
        self._notify("instance", info.instance_id)

    def set_instance_alive(self, instance_id: str, alive: bool) -> None:
        with self._lock:
            if instance_id in self.instances:
                self.instances[instance_id].alive = alive
        self._notify("instance", instance_id)

    def remove_instance(self, instance_id: str, only_if=None) -> bool:
        """Remove an instance; `only_if(info)` (evaluated under the lock)
        guards check-then-remove races — e.g. a dead-minion sweep must not
        delete an instance that was just marked alive again."""
        with self._lock:
            info = self.instances.get(instance_id)
            if info is None or (only_if is not None and not only_if(info)):
                return False
            del self.instances[instance_id]
        self._notify("instance", instance_id)
        return True

    def update_instance_tags(self, instance_id: str, tags: List[str]) -> None:
        with self._lock:
            info = self.instances.get(instance_id)
            if info is None:
                raise ValueError(f"unknown instance {instance_id!r}")
            info.tags = list(tags)
        self._notify("instance", instance_id)

    def live_servers(self, tenant: Optional[str] = None) -> List[str]:
        with self._lock:
            return [i.instance_id for i in self.instances.values()
                    if i.role == "server" and i.alive
                    and (tenant is None or tenant in i.tags)]

    # -- snapshots (checkpoint/resume) --------------------------------------
    def snapshot(self) -> str:
        with self._lock:
            return json.dumps({
                "schemas": {k: v.to_json() for k, v in self.schemas.items()},
                "tableConfigs": {k: v.to_json() for k, v in self.table_configs.items()},
                "segments": {t: {s: m.to_json() for s, m in segs.items()}
                             for t, segs in self.segments.items()},
                "idealState": self.ideal_state,
                "properties": self.properties,
            })

    def restore(self, blob: str) -> None:
        d = json.loads(blob)
        with self._lock:
            self.schemas = {k: Schema.from_json(v) for k, v in d["schemas"].items()}
            self.table_configs = {k: TableConfig.from_json(v)
                                  for k, v in d["tableConfigs"].items()}
            self.segments = {t: {s: SegmentMeta.from_json(m) for s, m in segs.items()}
                             for t, segs in d["segments"].items()}
            self.ideal_state = d["idealState"]
            self.external_view = {t: {} for t in self.ideal_state}
            self.properties = d.get("properties", {})
