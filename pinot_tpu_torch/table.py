"""Table configuration: the realtime subset.

A trimmed copy of `pinot_tpu/table.py` (the analog of the reference's
`TableConfig` with its indexing config and the stream configs inside it):
what a realtime consumer reads. The indexing config is what the consumer's
commit (`build_immutable`) writes; a consuming segment itself keeps no
auxiliary index. The table's type, time column, partitioning, upsert, dedup,
tenant, quota and tier configs are not ported, and a consumer of this package
runs no upsert or dedup.
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


@dataclass
class TableConfig:
    name: str                       # raw table name (no type suffix)
    stream: Optional[StreamConfig] = None
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
