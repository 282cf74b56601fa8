"""Batch ingestion job: files -> transformed segments -> controller push.

Analog of the reference's batch ingestion framework
(`pinot-spi/.../ingestion/batch/IngestionJobLauncher.java:43,103` +
`pinot-plugins/pinot-batch-ingestion/pinot-batch-ingestion-standalone/...
SegmentGenerationJobRunner.java:61`): a job spec names inputs, the table, and
partitioning; the runner STREAMS records (O(segment)+O(dictionary) peak memory,
never O(job)), applies the transform pipeline, cuts segments at `segment_rows`,
builds them (aligned dictionaries per job, so that the set executor stacks
the job's output as one set), and pushes each via the controller as it is cut.

A copy of `pinot_tpu/ingest/batch.py`. `controller` is duck-typed, as there:
any object with `catalog.table_configs`, `catalog.schemas` and
`upload_segment(table, seg_dir) -> meta` (a meta with `.name`), as
`cluster.Controller` is (it packs the directory it is handed into the deep
store before the runner removes it). The distributed ingest-job fan-out of
the JAX package is not ported.

Under a stats record (`query.stats.collect_stats`) the ingestion records
the seconds its readers take and the rows they give, and the streaming
job's stats, write and push times (the `BATCH_*` keys of `query/stats.py`).
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..query import stats as qstats
from ..schema import Schema
from ..segment.writer import SegmentBuilder, SegmentGeneratorConfig
from ..table import TableConfig
from .readers import reader_for, rows_to_columns
from .transform import TransformPipeline


@dataclass
class BatchIngestionJobSpec:
    """Reference: SegmentGenerationJobSpec (YAML-mapped in the reference; a dataclass
    here — the CLI loads either JSON or YAML-subset)."""

    input_paths: List[str] = field(default_factory=list)
    input_format: Optional[str] = None                 # inferred from extension if None
    table: str = ""                                    # table name with type
    segment_name_prefix: str = ""
    segment_rows: int = 1_000_000
    filter_expr: Optional[str] = None
    column_transforms: Dict[str, str] = field(default_factory=dict)
    aligned_dictionaries: bool = True                  # the set executor stacks the output


def ingest_file_to_segments(schema: Schema, table_cfg: TableConfig, path: str,
                            *, input_format: Optional[str] = None,
                            filter_expr: Optional[str] = None,
                            column_transforms: Optional[Dict[str, str]] = None,
                            segment_rows: int = 1_000_000,
                            prefix: str, build_dir: str) -> List[str]:
    """The per-file ingestion unit (read -> transform -> chunk -> build), the
    JAX package's minion task body. Returns the built segment dirs (the
    caller pushes them)."""
    pipeline = TransformPipeline(schema, filter_expr, column_transforms or {})
    reader = reader_for(path, input_format)
    try:
        t0 = time.perf_counter()
        rows = list(reader.rows())
        qstats.record(qstats.BATCH_READ_MS, (time.perf_counter() - t0) * 1000)
        qstats.record(qstats.BATCH_ROWS_READ, len(rows))
    finally:
        reader.close()
    columns = pipeline.apply(rows_to_columns(rows, schema))
    n = len(next(iter(columns.values()))) if columns else 0
    if n == 0:
        return []
    builder = SegmentBuilder(
        schema, SegmentGeneratorConfig.from_indexing(table_cfg.indexing))
    seg_dirs = []
    for i in range(max(1, -(-n // segment_rows))):
        lo, hi = i * segment_rows, min(n, (i + 1) * segment_rows)
        part = {c: v[lo:hi] for c, v in columns.items()}
        seg_dirs.append(builder.build(part, build_dir, f"{prefix}_{i}"))
    return seg_dirs


# rows per streamed read chunk (bounds the stats pass's working set)
CHUNK_ROWS = 65536


def _iter_transformed_chunks(spec: BatchIngestionJobSpec, schema: Schema,
                             pipeline: TransformPipeline,
                             chunk_rows: int):
    """Stream `input_paths` in order as transformed column-dict chunks of at
    most `chunk_rows` rows — the O(chunk) unit both passes of the streaming
    runner consume (reference: the record-at-a-time loop of
    `SegmentIndexCreationDriverImpl.build():204`, chunk-vectorized here)."""
    for path in spec.input_paths:
        reader = reader_for(path, spec.input_format)
        try:
            it = iter(reader.rows())
            while True:
                t0 = time.perf_counter()
                rows = list(itertools.islice(it, chunk_rows))
                qstats.record(qstats.BATCH_READ_MS, (time.perf_counter() - t0) * 1000)
                qstats.record(qstats.BATCH_ROWS_READ, len(rows))
                if not rows:
                    break
                cols = pipeline.apply(rows_to_columns(rows, schema))
                if cols and len(next(iter(cols.values()))):
                    yield cols
        finally:
            reader.close()


def _collect_fixed_dictionaries(spec: BatchIngestionJobSpec, schema: Schema,
                                pipeline: TransformPipeline,
                                gen_cfg: SegmentGeneratorConfig,
                                chunk_rows: int):
    """Stats pass (reference: `SegmentPreIndexStatsCollectorImpl` feeding
    `SegmentDictionaryCreator`): one streaming read collecting per-column
    distinct values — memory is O(cardinality + chunk), never O(rows) — so
    the write pass can pin every segment to shared dictionaries (the set
    executor stacks a set whose dict-id spaces agree)."""
    from ..segment.dictionary import build_dictionary
    uniques: Dict[str, Any] = {}
    specs = {f.name: f for f in schema.fields}
    no_dict = set(gen_cfg.no_dictionary_columns)
    total = 0
    for cols in _iter_transformed_chunks(spec, schema, pipeline, chunk_rows):
        total += len(next(iter(cols.values())))
        for name, fs in specs.items():
            if name in no_dict or name not in cols:
                continue
            vals = cols[name]
            if fs.data_type.is_numeric:
                arr = np.asarray(
                    [fs.null_value if v is None else v for v in vals],
                    dtype=fs.data_type.numpy_dtype)
                prev = uniques.get(name)
                u = np.unique(arr)
                uniques[name] = u if prev is None else np.union1d(prev, u)
            else:
                uniques.setdefault(name, set()).update(
                    fs.null_value if v is None else v for v in vals)
    fixed: Dict[str, Any] = {}
    extra_no_dict: List[str] = []
    for name, u in uniques.items():
        fs = specs[name]
        if fs.data_type.is_numeric:
            if len(u) > gen_cfg.raw_cardinality_fraction * max(total, 1):
                # force raw in EVERY segment, like build_aligned_segments —
                # per-segment heuristics could diverge across the output set
                extra_no_dict.append(name)
                continue
            fixed[name], _ = build_dictionary(u, fs.data_type)
        else:
            fixed[name], _ = build_dictionary(sorted(u), fs.data_type)
    return fixed, extra_no_dict, total


def run_batch_ingestion(spec: BatchIngestionJobSpec, controller, *,
                        work_dir: str) -> List[str]:
    """Execute the job against a controller (duck-typed, as above). Returns
    segment names pushed (reference: IngestionJobLauncher.runIngestionJob ->
    SegmentGenerationJobRunner + SegmentTarPushJobRunner).

    STREAMING: segments are cut incrementally while reading — peak memory is
    O(segment_rows + dictionary), not O(total rows), so a job 10x larger than
    one segment never needs 10x the RAM (reference: the two-pass
    stats-then-write driver `SegmentIndexCreationDriverImpl.java:99,204`).
    With `aligned_dictionaries` a first stats pass streams the inputs to
    collect shared dictionaries; the write pass then streams again, buffering
    only one segment's rows at a time and pushing each segment as it is cut."""
    table_cfg: TableConfig = controller.catalog.table_configs[spec.table]
    schema: Schema = controller.catalog.schemas[table_cfg.name]
    pipeline = TransformPipeline(schema, spec.filter_expr, spec.column_transforms)
    prefix = spec.segment_name_prefix or table_cfg.name
    build_dir = os.path.join(work_dir, "batch_build")
    os.makedirs(build_dir, exist_ok=True)

    import dataclasses
    gen_cfg = dataclasses.replace(
        SegmentGeneratorConfig.from_indexing(table_cfg.indexing))
    gen_cfg.no_dictionary_columns = list(gen_cfg.no_dictionary_columns)
    chunk_rows = min(spec.segment_rows, CHUNK_ROWS)

    fixed = None
    if spec.aligned_dictionaries:
        t0 = time.perf_counter()
        fixed, extra_no_dict, total = _collect_fixed_dictionaries(
            spec, schema, pipeline, gen_cfg, chunk_rows)
        qstats.record(qstats.BATCH_STATS_PASS_MS, (time.perf_counter() - t0) * 1000)
        if total == 0:
            return []
        gen_cfg.no_dictionary_columns.extend(extra_no_dict)

    builder = SegmentBuilder(schema, gen_cfg)
    pushed: List[str] = []
    buf: Dict[str, List[Any]] = {}
    buffered = 0
    seq = 0
    push_s = 0.0

    def flush() -> None:
        nonlocal buffered, seq, buf, push_s
        if buffered == 0:
            return
        seg_dir = builder.build(buf, build_dir, f"{prefix}_{seq}",
                                fixed_dictionaries=fixed)
        t0 = time.perf_counter()
        meta = controller.upload_segment(spec.table, seg_dir)
        push_s += time.perf_counter() - t0
        pushed.append(meta.name)
        # free the built segment's rows AND its on-disk build dir promptly:
        # the runner's footprint must stay O(one segment)
        import shutil
        shutil.rmtree(seg_dir, ignore_errors=True)
        buf = {c: [] for c in buf}
        buffered = 0
        seq += 1

    t_write = time.perf_counter()
    for cols in _iter_transformed_chunks(spec, schema, pipeline, chunk_rows):
        if not buf:
            buf = {c: [] for c in cols}
        n = len(next(iter(cols.values())))
        off = 0
        while off < n:
            take = min(spec.segment_rows - buffered, n - off)
            for c, acc in buf.items():
                v = cols.get(c)
                seg = (v[off:off + take] if v is not None
                       else [None] * take)
                acc.extend(seg.tolist() if isinstance(seg, np.ndarray) else seg)
            buffered += take
            off += take
            if buffered >= spec.segment_rows:
                flush()
    flush()
    qstats.record(qstats.BATCH_WRITE_PASS_MS,
                  (time.perf_counter() - t_write - push_s) * 1000)
    qstats.record(qstats.BATCH_PUSH_MS, push_s * 1000)
    return pushed
