"""Dataframe connector: bulk-build segments from pandas DataFrames.

Analog of the reference's Spark/Flink connectors
(`pinot-connectors/pinot-spark-3-connector`): distributed frameworks hand the
ingestion layer partitioned tabular batches; here the tabular lingua franca of
the Python ecosystem (pandas — already the parquet reader's substrate) maps a
DataFrame (or an iterator of partition DataFrames, which is what
`spark_df.toPandas()` per partition produces) onto built-and-pushed segments.

A copy of `pinot_tpu/ingest/dataframe.py`. pandas is never imported here:
the functions take its frames. `controller` is duck-typed, as in `batch.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..schema import DataType, FieldRole, FieldSpec, Schema
from ..segment.writer import SegmentBuilder, SegmentGeneratorConfig


def schema_from_dataframe(df, name: str,
                          metrics: Optional[List[str]] = None,
                          time_column: Optional[str] = None) -> Schema:
    """Infer a Schema from dtypes (reference: connector schema inference).
    Numeric columns listed in `metrics` become METRIC fields; the rest are
    dimensions; `time_column` becomes DATE_TIME."""
    metrics = set(metrics or [])
    fields: List[FieldSpec] = []
    for col in df.columns:
        kind = df[col].dtype.kind
        if kind == "u":
            # unsigned widths promote one step (uint32's top half would wrap a
            # signed INT); uint64 has no signed container -> DOUBLE, lossy past
            # 2^53 but never silently negative
            size = df[col].dtype.itemsize
            dt = (DataType.DOUBLE if size >= 8 else
                  DataType.LONG if size >= 4 else DataType.INT)
        elif kind == "i":
            dt = DataType.LONG if df[col].dtype.itemsize > 4 else DataType.INT
        elif kind == "f":
            dt = DataType.DOUBLE
        elif kind == "b":
            dt = DataType.BOOLEAN
        else:
            dt = DataType.STRING
        role = (FieldRole.DATE_TIME if col == time_column else
                FieldRole.METRIC if col in metrics else FieldRole.DIMENSION)
        fields.append(FieldSpec(col, dt, role))
    return Schema(name, fields)


def _columns_from_frame(df, schema: Schema) -> Dict[str, Any]:
    cols: Dict[str, Any] = {}
    for spec in schema.fields:
        if spec.name not in df.columns:
            continue
        s = df[spec.name]
        # s.isna() covers None, NaN AND pd.NA (arrow-backed nullable dtypes from
        # spark_df.toPandas()) — hand-rolled checks miss pd.NA, whose truthiness
        # raises inside the writer
        na = s.isna()
        if spec.data_type.is_numeric and not na.any():
            cols[spec.name] = np.asarray(s.to_numpy())
        else:
            cols[spec.name] = [None if isna else v
                               for isna, v in zip(na.tolist(), s.tolist())]
    return cols


def segments_from_dataframe(df_or_parts, schema: Schema, out_dir: str,
                            base_name: str,
                            config: Optional[SegmentGeneratorConfig] = None,
                            rows_per_segment: int = 2_000_000) -> List[str]:
    """DataFrame (or iterable of partition frames) -> built segment dirs.

    One segment per partition frame; a single big frame splits at
    `rows_per_segment` (the connector's per-task segment sizing)."""
    builder = SegmentBuilder(schema, config or SegmentGeneratorConfig())
    parts: Iterable = ([df_or_parts] if hasattr(df_or_parts, "columns")
                       else df_or_parts)
    out: List[str] = []
    seq = 0
    for frame in parts:
        for lo in range(0, len(frame), rows_per_segment):
            chunk = frame.iloc[lo:lo + rows_per_segment]
            if len(chunk) == 0:  # empty partitions produce NO segment, ever
                continue
            out.append(builder.build(_columns_from_frame(chunk, schema),
                                     out_dir, f"{base_name}_{seq}"))
            seq += 1
    return out


def push_dataframe(df_or_parts, schema: Schema, controller, table: str,
                   work_dir: str, base_name: Optional[str] = None,
                   config: Optional[SegmentGeneratorConfig] = None) -> List[str]:
    """Build + upload in one call (`controller`: any object with
    `upload_segment(table, seg_dir)`) — the connector's write path."""
    names = []
    for seg_dir in segments_from_dataframe(df_or_parts, schema, work_dir,
                                           base_name or schema.name,
                                           config=config):
        controller.upload_segment(table, seg_dir)
        names.append(seg_dir)
    return names
