"""Table configuration: the realtime subset.

A trimmed copy of `pinot_tpu/table.py` (the analog of the reference's
`TableConfig` with its indexing config, the stream configs inside it and its
`upsertConfig` / `dedupEnabled`): what a realtime consumer reads. The
indexing config is what the consumer's commit (`build_immutable`) writes; a
consuming segment keeps a realtime text or inverted index where the config
names one (the row-append `segment.mutable.MutableSegment`). `upsert` (FULL
or PARTIAL) and `dedup_enabled` switch the consumer to its per-row lane
(`ingest/realtime.py`, `upsert.py`). `to_json` / `from_json` read and write
the JAX package's keys for these fields. The table's type, time column,
partitioning, tenant, quota and tier configs are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class StreamConfig:
    """The reference's stream configs (spi/stream/StreamConfig), subset. The
    stream is a `MemoryStream` topic, the one stream type ported."""
    topic: str = ""
    decoder: str = "json"                 # "json" (row messages) or "columnar" (blocks)
    properties: Dict[str, Any] = field(default_factory=dict)
    # segment completion thresholds (the reference's realtime.segment.flush.*)
    flush_threshold_rows: int = 100_000
    flush_threshold_seconds: int = 6 * 3600

    def to_json(self) -> Dict[str, Any]:
        return {"streamType": "memory", "topic": self.topic, "decoder": self.decoder,
                "properties": self.properties,
                "flushThresholdRows": self.flush_threshold_rows,
                "flushThresholdSeconds": self.flush_threshold_seconds}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "StreamConfig":
        return StreamConfig(d.get("topic", ""), d.get("decoder", "json"),
                            d.get("properties", {}), d.get("flushThresholdRows", 100_000),
                            d.get("flushThresholdSeconds", 6 * 3600))


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
    stream: Optional[StreamConfig] = None
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    upsert: Optional[UpsertConfig] = None
    dedup_enabled: bool = False

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"tableName": self.name, "indexing": self.indexing.to_json(),
                             "dedupEnabled": self.dedup_enabled}
        if self.stream:
            d["streamConfig"] = self.stream.to_json()
        if self.upsert:
            d["upsertConfig"] = self.upsert.to_json()
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TableConfig":
        """The ported fields of a table config in the JAX package's JSON; the
        others are ignored."""
        return TableConfig(
            name=d["tableName"],
            stream=StreamConfig.from_json(d["streamConfig"]) if d.get("streamConfig") else None,
            indexing=IndexingConfig.from_json(d.get("indexing", {})),
            upsert=UpsertConfig.from_json(d["upsertConfig"]) if d.get("upsertConfig") else None,
            dedup_enabled=d.get("dedupEnabled", False))
