"""Table configuration.

A trimmed copy of `pinot_tpu/table.py` (the analog of the reference's
`TableConfig`): the table's type (`table_name_with_type` is the catalog's
key), the segments config (replication, time column, retention), the routing
selector, the segment partition config, the tenant, the query quota, the dim
table flag, the indexing config, the stream configs and `upsertConfig` /
`dedupEnabled`. The controller and broker (`cluster/`) read the first ones;
a realtime consumer reads the indexing config (what its commit,
`build_immutable`, writes; a consuming segment keeps a realtime text or
inverted index where the config names one) and `upsert` (FULL or PARTIAL) and
`dedup_enabled`, which switch it to its per-row lane (`ingest/realtime.py`,
`upsert.py`). `to_json` / `from_json` read and write the JAX package's keys.
The tier configs wait for tiering, and the minion's task configs for the
minion: `from_json` ignores them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


class TableType(Enum):
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"


@dataclass
class SegmentPartitionConfig:
    """The reference's SegmentPartitionConfig: the column whose value picks a
    segment's partition, which lets the broker prune by partition."""
    column: str = ""
    function: str = "murmur"  # murmur | modulo
    num_partitions: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"column": self.column, "function": self.function,
                "numPartitions": self.num_partitions}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "SegmentPartitionConfig":
        return SegmentPartitionConfig(d.get("column", ""), d.get("function", "murmur"),
                                      d.get("numPartitions", 0))


@dataclass
class QuotaConfig:
    """The reference's QuotaConfig: the table's queries per second (split
    across live brokers) and storage bytes."""
    max_qps: Optional[float] = None
    storage_bytes: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        return {"maxQueriesPerSecond": self.max_qps, "storageBytes": self.storage_bytes}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "QuotaConfig":
        return QuotaConfig(d.get("maxQueriesPerSecond"), d.get("storageBytes"))


@dataclass
class StreamConfig:
    """The reference's stream configs (spi/stream/StreamConfig), subset.
    `stream_type` names the stream factory (`ingest/stream.py`: "memory", a
    `MemoryStream` topic, or "kafkalite", the socket log broker that
    `properties["bootstrap"]` locates)."""
    topic: str = ""
    decoder: str = "json"                 # "json" (row messages) or "columnar" (blocks)
    properties: Dict[str, Any] = field(default_factory=dict)
    # segment completion thresholds (the reference's realtime.segment.flush.*)
    flush_threshold_rows: int = 100_000
    flush_threshold_seconds: int = 6 * 3600
    stream_type: str = "memory"

    def to_json(self) -> Dict[str, Any]:
        return {"streamType": self.stream_type, "topic": self.topic, "decoder": self.decoder,
                "properties": self.properties,
                "flushThresholdRows": self.flush_threshold_rows,
                "flushThresholdSeconds": self.flush_threshold_seconds}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "StreamConfig":
        return StreamConfig(d.get("topic", ""), d.get("decoder", "json"),
                            d.get("properties", {}), d.get("flushThresholdRows", 100_000),
                            d.get("flushThresholdSeconds", 6 * 3600),
                            d.get("streamType", "memory"))


@dataclass
class IndexingConfig:
    """The reference's indexing config (`IndexingConfig`, `fieldConfigList`),
    as `segment.writer.SegmentGeneratorConfig.from_indexing` reads it."""
    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    bloom_filter_columns: List[str] = field(default_factory=list)
    no_dictionary_columns: List[str] = field(default_factory=list)
    json_index_columns: List[str] = field(default_factory=list)
    text_index_columns: List[str] = field(default_factory=list)
    # trigram regex prefilter over the dictionary (the reference's FST index)
    fst_index_columns: List[str] = field(default_factory=list)
    star_tree_configs: List[Dict[str, Any]] = field(default_factory=list)
    geo_index_pairs: List[str] = field(default_factory=list)  # "lngCol,latCol"
    raw_compression: str = ""  # chunk codec of raw forward indexes (zlib/lzma)

    _KEYS = (("inverted_index_columns", "invertedIndexColumns"),
             ("range_index_columns", "rangeIndexColumns"),
             ("bloom_filter_columns", "bloomFilterColumns"),
             ("no_dictionary_columns", "noDictionaryColumns"),
             ("json_index_columns", "jsonIndexColumns"),
             ("text_index_columns", "textIndexColumns"),
             ("fst_index_columns", "fstIndexColumns"),
             ("star_tree_configs", "starTreeIndexConfigs"),
             ("geo_index_pairs", "geoIndexPairs"))

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {key: getattr(self, attr) for attr, key in self._KEYS}
        d["rawCompression"] = self.raw_compression
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "IndexingConfig":
        cfg = IndexingConfig(raw_compression=d.get("rawCompression", ""))
        for attr, key in IndexingConfig._KEYS:
            setattr(cfg, attr, list(d.get(key, [])))
        return cfg


@dataclass
class UpsertConfig:
    """The reference's `UpsertConfig` (spi/config/table/UpsertConfig): FULL
    keeps the latest row per primary key; PARTIAL merges each new row into
    the key's previous one column by column (`upsert.merge_partial`).
    `comparison_column` orders the rows of a key (None: the stream offset)."""
    mode: str = "FULL"  # FULL | PARTIAL
    comparison_column: Optional[str] = None
    partial_strategies: Dict[str, str] = field(default_factory=dict)  # col -> strategy

    def to_json(self) -> Dict[str, Any]:
        return {"mode": self.mode, "comparisonColumn": self.comparison_column,
                "partialUpsertStrategies": self.partial_strategies}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "UpsertConfig":
        return UpsertConfig(d.get("mode", "FULL"), d.get("comparisonColumn"),
                            d.get("partialUpsertStrategies", {}))


@dataclass
class TableConfig:
    name: str                       # raw table name (no type suffix)
    table_type: TableType = TableType.OFFLINE
    replication: int = 1
    retention_days: Optional[float] = None
    time_column: Optional[str] = None
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    partition: Optional[SegmentPartitionConfig] = None
    stream: Optional[StreamConfig] = None
    upsert: Optional[UpsertConfig] = None
    dedup_enabled: bool = False
    tenant: str = "DefaultTenant"
    # a small table replicated to every server of its tenant, for LOOKUP
    is_dim_table: bool = False
    quota: Optional[QuotaConfig] = None
    # instance selector: "" picks strictReplicaGroup for an upsert table and
    # balanced otherwise; else "balanced" | "replicaGroup" | "strictReplicaGroup"
    routing_selector: str = ""

    @property
    def table_name_with_type(self) -> str:
        return f"{self.name}_{self.table_type.value}"

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"tableName": self.name, "tableType": self.table_type.value,
                             "replication": self.replication,
                             "retentionDays": self.retention_days,
                             "timeColumn": self.time_column,
                             "indexing": self.indexing.to_json(), "tenant": self.tenant,
                             "dedupEnabled": self.dedup_enabled,
                             "isDimTable": self.is_dim_table, "taskConfigs": {}}
        if self.routing_selector:
            d["routingSelector"] = self.routing_selector
        if self.partition:
            d["segmentPartitionConfig"] = self.partition.to_json()
        if self.stream:
            d["streamConfig"] = self.stream.to_json()
        if self.upsert:
            d["upsertConfig"] = self.upsert.to_json()
        if self.quota:
            d["quota"] = self.quota.to_json()
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TableConfig":
        """A table config in the JAX package's JSON; the keys not ported
        (tierConfigs, taskConfigs) are ignored."""
        return TableConfig(
            name=d["tableName"],
            table_type=TableType(d.get("tableType", "OFFLINE")),
            replication=d.get("replication", 1),
            retention_days=d.get("retentionDays"),
            time_column=d.get("timeColumn"),
            indexing=IndexingConfig.from_json(d.get("indexing", {})),
            partition=SegmentPartitionConfig.from_json(d["segmentPartitionConfig"])
            if d.get("segmentPartitionConfig") else None,
            stream=StreamConfig.from_json(d["streamConfig"]) if d.get("streamConfig") else None,
            upsert=UpsertConfig.from_json(d["upsertConfig"]) if d.get("upsertConfig") else None,
            dedup_enabled=d.get("dedupEnabled", False),
            tenant=d.get("tenant", "DefaultTenant"),
            is_dim_table=d.get("isDimTable", False),
            quota=QuotaConfig.from_json(d["quota"]) if d.get("quota") else None,
            routing_selector=d.get("routingSelector", ""))
