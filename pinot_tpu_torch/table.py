"""Table configuration: the realtime subset.

A trimmed copy of `pinot_tpu/table.py` (the analog of the reference's
`TableConfig` and the stream configs inside it): what a realtime consumer
reads. The table's type, time column, indexing, partitioning, upsert, dedup,
tenant, quota and tier configs are not ported; a consumer of this package
indexes no auxiliary index and runs no upsert or dedup.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


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
class TableConfig:
    name: str                       # raw table name (no type suffix)
    stream: Optional[StreamConfig] = None
