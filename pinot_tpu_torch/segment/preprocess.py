"""Segment preprocessing: reconcile an existing segment's indexes with table config.

Analog of the reference's `SegmentPreProcessor` + `IndexHandler` factories
(`pinot-segment-local/src/main/java/org/apache/pinot/segment/local/segment/index/loader/
SegmentPreProcessor.java`, `IndexHandlerFactory.java`): when a table's indexing config
changes, servers rebuild the segment's auxiliary indexes IN PLACE from the data already
on disk — no re-ingestion. Forward index and dictionaries are immutable here (encoding
changes require a rebuild, same as most of the reference's paths); inverted / range /
bloom / json / text / fst indexes are added or removed to match config.

A copy of `pinot_tpu/segment/preprocess.py` over this package's writer and
index creators, which write the JAX package's bytes: a segment preprocessed
by either package holds the same files.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from . import format as fmt
from .reader import ImmutableSegment, load_segment


def desired_indexes(col_meta: Dict[str, Any], name: str, indexing) -> List[str]:
    """Index types the config wants for this column, limited to what the stored
    encoding supports (inverted/range need dict ids; json/text need strings)."""
    out = []
    mv = col_meta.get("multiValue", False)
    if col_meta["hasDictionary"]:
        if name in indexing.inverted_index_columns:
            out.append("inverted")
        # MV supports inverted (per-value postings) but not range/json/text:
        # those index builders consume one value per doc (the writer skips them
        # for MV too, so want/have stay converged)
        if name in indexing.range_index_columns and not mv:
            out.append("range")
        if name in getattr(indexing, "fst_index_columns", []) \
                and col_meta.get("dataType") != "BYTES":
            out.append("fst")
    if name in indexing.bloom_filter_columns:
        out.append("bloom")
    if name in getattr(indexing, "json_index_columns", []) and not mv:
        out.append("json")
    if name in getattr(indexing, "text_index_columns", []) and not mv:
        out.append("text")
    return out


_SUFFIX = {"inverted": fmt.INVERTED_SUFFIX, "range": fmt.RANGE_SUFFIX,
           "bloom": fmt.BLOOM_SUFFIX, "json": fmt.JSON_SUFFIX,
           "text": fmt.TEXT_SUFFIX, "fst": fmt.FST_SUFFIX}


def preprocess_segment(seg_dir: str, indexing, schema=None) -> List[str]:
    """Bring one on-disk segment's aux indexes in line with `indexing`
    (an IndexingConfig or SegmentGeneratorConfig — duck-typed column lists).

    `schema` (the CURRENT table schema) additionally backfills columns the
    segment predates with their default values — the reference's
    DefaultColumnHandler in SegmentPreProcessor: schema evolution must not
    break queries over old segments.

    Returns human-readable change descriptions ([] when already converged).
    Metadata (`indexes` per column) is rewritten at the end; superseded
    index files are deleted at once (the JAX package's `defer_removals`, for
    a live reload, is not ported: this package reloads no segment in place).
    """
    meta_path = os.path.join(seg_dir, fmt.SEGMENT_METADATA_FILE)
    meta = fmt.read_json(meta_path)
    changes: List[str] = []
    seg = None  # lazy-loaded only if something must be built

    try:
        if schema is not None:
            added = _add_default_columns(seg_dir, meta, schema)
            if added:
                # persist NOW: the index loop below may load_segment(seg_dir),
                # which reads metadata from disk — it must see the new columns
                # (their files are already written) or index builds on a
                # backfilled column crash with an unknown-column error
                fmt.write_json(meta_path, meta)
            changes.extend(added)

        for name, col_meta in meta["columns"].items():
            have = set(col_meta.get("indexes", []))
            want = set(desired_indexes(col_meta, name, indexing))
            prefix = os.path.join(seg_dir, fmt.COLS_DIR, name)

            for idx in sorted(have - want):
                path = prefix + _SUFFIX[idx]
                if os.path.exists(path):
                    os.remove(path)
                changes.append(f"{name}: removed {idx} index")
            for idx in sorted(want - have):
                if seg is None:
                    seg = load_segment(seg_dir)
                _build_index(idx, seg, name, col_meta, prefix)
                changes.append(f"{name}: added {idx} index")
            if have != want:
                col_meta["indexes"] = sorted(want)
    finally:
        # persist on failure TOO: `meta` only records columns/indexes whose
        # files landed (each step updates it after its writes), so writing it
        # plus a fresh CRC keeps the segment self-consistent even when a later
        # step raised — otherwise orphan files fail CRC verification forever
        if changes:
            fmt.write_json(meta_path, meta)
            cm_path = os.path.join(seg_dir, fmt.CREATION_META_FILE)
            cm = fmt.read_json(cm_path)
            cm["crc"] = fmt.segment_crc(seg_dir)
            fmt.write_json(cm_path, cm)
    return changes


def _add_default_columns(seg_dir: str, meta: Dict[str, Any],
                         schema) -> List[str]:
    """Write default-filled physical columns for schema fields the segment
    lacks (reference: DefaultColumnHandler, defaultColumnAction=ADD). The
    stored schema is upgraded too, so readers see one consistent view."""
    from .writer import SegmentBuilder, SegmentGeneratorConfig
    changes: List[str] = []
    num_docs = meta["totalDocs"]
    cols_dir = os.path.join(seg_dir, fmt.COLS_DIR)
    builder = None
    for spec in schema.fields:
        if spec.name in meta["columns"]:
            continue
        if builder is None:
            builder = SegmentBuilder(schema, SegmentGeneratorConfig())
            os.makedirs(cols_dir, exist_ok=True)
        meta["columns"][spec.name] = builder.write_default_column(
            cols_dir, spec, num_docs)
        changes.append(f"{spec.name}: added default column "
                       f"({spec.data_type.value})")
    if changes:
        meta["schema"] = schema.to_json()
    return changes


def _build_index(idx: str, seg: ImmutableSegment, name: str,
                 col_meta: Dict[str, Any], prefix: str) -> None:
    reader = seg.column(name)
    if idx == "inverted":
        from .indexes.inverted import create_inverted_index
        dict_ids = np.asarray(reader.fwd).astype(np.int64)
        doc_ids = None
        if getattr(reader, "is_multi_value", False):
            doc_ids = np.repeat(np.arange(reader.num_docs, dtype=np.int64),
                                reader.mv_counts())
        create_inverted_index(prefix + fmt.INVERTED_SUFFIX, dict_ids,
                              reader.cardinality, doc_ids=doc_ids)
    elif idx == "range":
        from .indexes.range import create_range_index
        dict_ids = np.asarray(reader.fwd).astype(np.int64)
        create_range_index(prefix + fmt.RANGE_SUFFIX, dict_ids, reader.cardinality)
    elif idx == "bloom":
        from .indexes.bloom import create_bloom_filter
        values = reader.dictionary.values if reader.has_dictionary \
            else np.asarray(reader.fwd)
        create_bloom_filter(prefix + fmt.BLOOM_SUFFIX, values)
    elif idx == "json":
        from .indexes.jsonidx import create_json_index
        create_json_index(prefix + fmt.JSON_SUFFIX, list(reader.values()))
    elif idx == "text":
        from .indexes.text import create_text_index
        create_text_index(prefix + fmt.TEXT_SUFFIX, list(reader.values()))
    elif idx == "fst":
        from .indexes.fst import create_fst_index
        create_fst_index(prefix + fmt.FST_SUFFIX, list(reader.dictionary.values))
    else:
        raise ValueError(f"unknown index type {idx!r}")
