"""Segment creation: raw columns -> immutable on-disk columnar segment.

A subset of `pinot_tpu/segment/writer.py` that writes the same on-disk format:
the dict-vs-raw decision, sorted dictionaries, minimal-width forward indexes,
chunk-compressed raw forward indexes (`raw_compression`, `compression.py`),
null bitmaps, dictionary-aligned segment sets, the inverted, range, bloom,
JSON, text and FST indexes and the geo cell index of a coordinate pair
(`indexes/`), the bloom payload that rides a column's metadata (`bloomHex`:
every dictionary column up to 1,024 values, and a raw column with a bloom
index), star-trees (`startree.build_star_tree`, built over the written
segment) and multi-value columns (`_write_mv_column`: a CSR forward index).
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..schema import DataType, FieldSpec, Schema, normalize_mv_column
from . import format as fmt
from .compression import write_chunked
from .dictionary import Dictionary, build_dictionary
from .indexes.bloom import bloom_hex, create_bloom_filter
from .indexes.fst import create_fst_index
from .indexes.inverted import create_inverted_index
from .indexes.jsonidx import create_json_index
from .indexes.range import create_range_index
from .indexes.text import create_text_index


@dataclass
class SegmentGeneratorConfig:
    """Analog of `pinot-segment-spi/.../creator/SegmentGeneratorConfig.java` (subset)."""

    no_dictionary_columns: List[str] = field(default_factory=list)
    # raw-encode numeric columns whose cardinality exceeds this fraction of num_docs
    raw_cardinality_fraction: float = 0.7
    # inverted and range indexes are built for dictionary columns only, bloom
    # filters for any column
    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    bloom_filter_columns: List[str] = field(default_factory=list)
    # star-tree pre-aggregations: `startree.StarTreeIndexConfig`s, or their
    # JSON form (dicts)
    star_tree_configs: List[Any] = field(default_factory=list)
    json_index_columns: List[str] = field(default_factory=list)
    text_index_columns: List[str] = field(default_factory=list)
    # trigram regex prefilters over dictionary columns (not BYTES)
    fst_index_columns: List[str] = field(default_factory=list)
    # geo cell indexes over (lngColumn, latColumn) pairs, as "lng,lat" strings
    # (the reference's H3 index config; see indexes/geo.py)
    geo_index_pairs: List[str] = field(default_factory=list)
    geo_resolution_deg: float = 0.1
    # chunk compression codec of raw (no-dictionary) forward indexes: "" for
    # uncompressed npy, else one of `compression.CODECS`
    raw_compression: str = ""

    @staticmethod
    def from_indexing(idx) -> "SegmentGeneratorConfig":
        """A table's `IndexingConfig` (`table.py`) as the writer's config."""
        return SegmentGeneratorConfig(
            no_dictionary_columns=list(idx.no_dictionary_columns),
            inverted_index_columns=list(idx.inverted_index_columns),
            range_index_columns=list(idx.range_index_columns),
            bloom_filter_columns=list(idx.bloom_filter_columns),
            json_index_columns=list(idx.json_index_columns),
            text_index_columns=list(idx.text_index_columns),
            fst_index_columns=list(idx.fst_index_columns),
            geo_index_pairs=list(idx.geo_index_pairs),
            raw_compression=idx.raw_compression,
            star_tree_configs=list(idx.star_tree_configs))


class SegmentBuilder:
    """Builds one immutable segment directory from fully materialized columns."""

    def __init__(self, schema: Schema, config: Optional[SegmentGeneratorConfig] = None):
        self.schema = schema
        self.config = config or SegmentGeneratorConfig()

    def build(self, columns: Dict[str, Union[np.ndarray, Sequence[Any]]],
              out_dir: str, segment_name: str,
              fixed_dictionaries: Optional[Dict[str, Dictionary]] = None) -> str:
        """Write segment `<out_dir>/<segment_name>/`; returns the segment path.

        Missing schema columns are filled with default nulls; `None` entries
        become the type's default null and are recorded in the null bitmap.
        `fixed_dictionaries` pins columns to pre-built dictionaries so a set of
        segments shares dict-id space (see `build_aligned_segments`)."""
        num_docs = self._num_docs(columns)
        seg_dir = os.path.join(out_dir, segment_name)
        cols_dir = os.path.join(seg_dir, fmt.COLS_DIR)
        os.makedirs(cols_dir, exist_ok=True)

        col_meta: Dict[str, Dict[str, Any]] = {}
        for spec in self.schema.fields:
            raw = columns.get(spec.name)
            if raw is None:
                raw = [spec.null_value] * num_docs
            fixed = (fixed_dictionaries or {}).get(spec.name)
            col_meta[spec.name] = self._write_column(cols_dir, spec, raw, num_docs, fixed)
        geo_meta = [self._write_geo_index(cols_dir, pair, columns, num_docs)
                    for pair in self.config.geo_index_pairs]

        meta = {
            "formatVersion": fmt.FORMAT_VERSION,
            "segmentName": segment_name,
            "tableName": self.schema.name,
            "totalDocs": num_docs,
            "schema": self.schema.to_json(),
            "columns": col_meta,
        }
        if geo_meta:
            meta["geoIndexes"] = geo_meta
        fmt.write_json(os.path.join(seg_dir, fmt.SEGMENT_METADATA_FILE), meta)
        fmt.write_json(os.path.join(seg_dir, fmt.CREATION_META_FILE), {
            "creationTimeMs": int(time.time() * 1000),
            "crc": fmt.segment_crc(seg_dir),
        })
        if self.config.star_tree_configs:
            from .reader import load_segment
            from .startree import StarTreeIndexConfig, build_star_tree
            built = load_segment(seg_dir)
            for i, st_cfg in enumerate(self.config.star_tree_configs):
                if isinstance(st_cfg, dict):
                    st_cfg = StarTreeIndexConfig.from_json(st_cfg)
                build_star_tree(built, st_cfg, i)
        return seg_dir

    # ------------------------------------------------------------------
    def write_default_column(self, cols_dir: str, spec: FieldSpec,
                             num_docs: int) -> Dict[str, Any]:
        """Write one default-filled column (the schema-evolution backfill of
        `segment/preprocess.py`, the reference's DefaultColumnHandler)."""
        raw = ([spec.null_value] * num_docs if spec.single_value
               else [[spec.null_value]] * num_docs)
        return self._write_column(cols_dir, spec, raw, num_docs)

    def _write_geo_index(self, cols_dir: str, pair: str, columns, num_docs: int
                         ) -> Dict[str, Any]:
        """The geo cell index of a "lng,lat" column pair, over the values the
        columns store: nulls as the spec's null fill, as `_write_column` writes
        them, so that the index buckets every row where the column holds it."""
        # imported here: indexes.geo needs engine.geo_fns, whose expression
        # library imports the segment package
        from .indexes.geo import create_geo_index, geo_index_path
        lng_col, lat_col = [c.strip() for c in pair.split(",")]

        def coord(col: str) -> np.ndarray:
            spec = self.schema.field_spec(col)
            raw = columns.get(col)
            vals = ([spec.null_value] * num_docs if raw is None else
                    [spec.null_value if v is None else v for v in raw])
            return np.asarray(vals, dtype=np.float64)

        create_geo_index(geo_index_path(os.path.join(cols_dir, ""), lng_col, lat_col),
                         coord(lng_col), coord(lat_col), self.config.geo_resolution_deg)
        return {"lngColumn": lng_col, "latColumn": lat_col,
                "resolution": self.config.geo_resolution_deg}

    def _num_docs(self, columns: Dict[str, Any]) -> int:
        sizes = {len(v) for v in columns.values()}
        if len(sizes) > 1:
            raise ValueError(f"ragged columns: lengths {sorted(sizes)}")
        return sizes.pop() if sizes else 0

    def _write_column(self, cols_dir: str, spec: FieldSpec,
                      raw: Union[np.ndarray, Sequence[Any]], num_docs: int,
                      fixed_dict: Optional[Dictionary] = None) -> Dict[str, Any]:
        name, data_type = spec.name, spec.data_type
        prefix = os.path.join(cols_dir, name)
        if not spec.single_value:
            return self._write_mv_column(prefix, spec, raw, num_docs, fixed_dict)

        # -- null extraction -------------------------------------------
        null_mask = None
        if isinstance(raw, np.ndarray) and raw.dtype == object:
            raw = list(raw)  # object arrays may carry None; route through the list path
        if not isinstance(raw, np.ndarray):
            vals = list(raw)
            if any(v is None for v in vals):
                null_mask = np.array([v is None for v in vals], dtype=bool)
                null_default = spec.null_value
                vals = [null_default if v is None else v for v in vals]
            raw = vals

        # -- encode decision + stats -----------------------------------
        # np.unique is at once the stats pass, the cardinality count for the
        # dict-vs-raw decision, and the dictionary build
        dictionary = dict_ids = None
        if fixed_dict is not None:
            dictionary = fixed_dict
            dict_ids = _encode_with_fixed_dict(raw, fixed_dict, name)
            use_dict = True
        elif name in self.config.no_dictionary_columns:
            if not data_type.is_numeric:
                raise ValueError(f"column {name}: non-numeric columns must be "
                                 "dictionary-encoded")
            use_dict = False
        elif not data_type.is_numeric or num_docs == 0:
            use_dict = True
        else:
            dictionary, dict_ids = build_dictionary(raw, data_type)
            # high-cardinality numeric columns gain nothing from a dictionary
            use_dict = dictionary.cardinality <= self.config.raw_cardinality_fraction * num_docs

        meta: Dict[str, Any] = {"dataType": data_type.value, "totalDocs": num_docs}
        indexes: List[str] = []
        if use_dict:
            if dictionary is None:
                dictionary, dict_ids = build_dictionary(raw, data_type)
            card = dictionary.cardinality
            fwd = dict_ids.astype(fmt.minimal_dtype_for_cardinality(card))
            np.save(prefix + fmt.FWD_SUFFIX, fwd)
            if data_type.is_numeric:
                np.save(prefix + fmt.DICT_NUMERIC_SUFFIX, np.asarray(dictionary.values))
            elif data_type is DataType.BYTES:
                fmt.write_string_dictionary(prefix, [v.hex() for v in dictionary.values])
                meta["bytesHex"] = True
            else:
                fmt.write_string_dictionary(prefix, list(dictionary.values))
            meta.update({
                "hasDictionary": True,
                "cardinality": card,
                "fwdDtype": str(fwd.dtype),
                "sorted": bool(np.all(dict_ids[1:] >= dict_ids[:-1])) if num_docs else True,
                "minValue": _jsonable(dictionary.min_value),
                "maxValue": _jsonable(dictionary.max_value),
                # segments with equal dictHash share dict-id space
                "dictHash": _dict_hash(dictionary),
            })
            if name in self.config.inverted_index_columns:
                create_inverted_index(prefix + fmt.INVERTED_SUFFIX, dict_ids, card)
                indexes.append("inverted")
            if name in self.config.range_index_columns:
                create_range_index(prefix + fmt.RANGE_SUFFIX, dict_ids, card)
                indexes.append("range")
            if name in self.config.fst_index_columns and data_type is not DataType.BYTES:
                # not over BYTES: the index must never change an answer, and
                # REGEXP_LIKE without it matches no bytes value
                create_fst_index(prefix + fmt.FST_SUFFIX, list(dictionary.values))
                indexes.append("fst")
        else:
            arr = np.asarray(raw, dtype=data_type.numpy_dtype)
            codec = self.config.raw_compression
            if codec:
                write_chunked(prefix + fmt.FWD_COMPRESSED_SUFFIX, arr, codec)
                meta["compression"] = codec
            else:
                np.save(prefix + fmt.FWD_SUFFIX, arr)
            meta.update({
                "hasDictionary": False,
                "cardinality": -1,
                "fwdDtype": str(arr.dtype),
                "sorted": bool(np.all(arr[1:] >= arr[:-1])) if num_docs else True,
                "minValue": _jsonable(arr.min() if num_docs else None),
                "maxValue": _jsonable(arr.max() if num_docs else None),
            })

        if name in self.config.bloom_filter_columns:
            create_bloom_filter(prefix + fmt.BLOOM_SUFFIX,
                                dictionary.values if use_dict else raw)
            indexes.append("bloom")
        if use_dict or name in self.config.bloom_filter_columns:
            hx = _meta_bloom_hex(dictionary.values if use_dict else raw, deduped=use_dict)
            if hx is not None:
                meta["bloomHex"] = hx
        if name in self.config.json_index_columns:
            create_json_index(prefix + fmt.JSON_SUFFIX, raw)
            indexes.append("json")
        if name in self.config.text_index_columns:
            create_text_index(prefix + fmt.TEXT_SUFFIX, raw)
            indexes.append("text")
        if null_mask is not None and null_mask.any():
            np.save(prefix + fmt.NULLS_SUFFIX, fmt.pack_bitmap(null_mask))
            meta["hasNulls"] = True
        meta["indexes"] = indexes
        return meta

    def _write_mv_column(self, prefix: str, spec: FieldSpec, raw, num_docs: int,
                         fixed_dict: Optional[Dictionary] = None) -> Dict[str, Any]:
        """A multi-value column: `<col>.fwd.npy` holds every row's dict ids
        concatenated, `<col>.mvoff.npy` the int64 row offsets (num_docs + 1), a
        CSR over rows. Always dictionary-encoded: the device form is a padded
        id matrix whose fill is the out-of-dictionary id `cardinality`. A None
        or empty row stores one default null value. `fixed_dict` (an aligned
        set's) must hold every value."""
        name, data_type = spec.name, spec.data_type
        flat, counts, null_mask = normalize_mv_column(spec, raw)
        offsets = np.zeros(num_docs + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])

        if fixed_dict is not None:
            dictionary = fixed_dict
            dict_ids = _encode_with_fixed_dict(flat, fixed_dict, name)
        else:
            dictionary, dict_ids = build_dictionary(flat, data_type)
        card = dictionary.cardinality
        fwd = dict_ids.astype(fmt.minimal_dtype_for_cardinality(card))
        np.save(prefix + fmt.FWD_SUFFIX, fwd)
        np.save(prefix + fmt.MV_OFFSETS_SUFFIX, offsets)
        if data_type.is_numeric:
            np.save(prefix + fmt.DICT_NUMERIC_SUFFIX, np.asarray(dictionary.values))
        else:
            fmt.write_string_dictionary(prefix, list(dictionary.values))

        meta: Dict[str, Any] = {
            "dataType": data_type.value, "totalDocs": num_docs,
            "multiValue": True, "hasDictionary": True,
            "cardinality": card, "fwdDtype": str(fwd.dtype),
            "maxNumValues": int(counts.max()) if num_docs else 0,
            "totalNumValues": int(offsets[-1]),
            "sorted": False,
            "minValue": _jsonable(dictionary.min_value),
            "maxValue": _jsonable(dictionary.max_value),
            "dictHash": _dict_hash(dictionary),
        }
        indexes: List[str] = []
        if name in self.config.inverted_index_columns:
            create_inverted_index(prefix + fmt.INVERTED_SUFFIX, dict_ids, card,
                                  doc_ids=np.repeat(np.arange(num_docs, dtype=np.int64),
                                                    counts))
            indexes.append("inverted")
        if name in self.config.bloom_filter_columns:
            create_bloom_filter(prefix + fmt.BLOOM_SUFFIX, dictionary.values)
            indexes.append("bloom")
        hx = _meta_bloom_hex(dictionary.values, deduped=True)
        if hx is not None:
            meta["bloomHex"] = hx
        if null_mask.any():
            np.save(prefix + fmt.NULLS_SUFFIX, fmt.pack_bitmap(null_mask))
            meta["hasNulls"] = True
        meta["indexes"] = indexes
        return meta


# distinct values past which a column's metadata carries no bloom payload (the
# JAX writer's bound: pruning wants small catalog entries)
_META_BLOOM_MAX_CARD = 1024


def _meta_bloom_hex(values, deduped: bool) -> Optional[str]:
    """The hex bloom payload of a column's metadata (`bloomHex`), or None past
    `_META_BLOOM_MAX_CARD` distinct values."""
    if deduped:
        vals = list(values)
    else:
        try:
            vals = list(dict.fromkeys(values.tolist() if isinstance(values, np.ndarray)
                                      else values))
        except TypeError:   # unhashable cells: no metadata copy
            return None
    if len(vals) > _META_BLOOM_MAX_CARD:
        return None
    return bloom_hex(vals)


def _encode_with_fixed_dict(raw, dictionary: Dictionary, name: str) -> np.ndarray:
    values = np.asarray(dictionary.values) if not isinstance(dictionary.values, np.ndarray) \
        else dictionary.values
    arr = np.asarray(raw, dtype=values.dtype if values.dtype.kind != "O" else object)
    ids = np.searchsorted(values, arr)
    ids = np.clip(ids, 0, len(values) - 1)
    if not np.all(values[ids] == arr):
        raise ValueError(f"column {name}: value absent from fixed dictionary")
    return ids.astype(np.int64)


def _mv_union_dictionary(spec: FieldSpec, raw) -> Dictionary:
    """The sorted dictionary of every value of a multi-value column's rows."""
    flat = normalize_mv_column(spec, raw)[0]
    if spec.data_type.is_numeric:
        return Dictionary(np.unique(flat), spec.data_type)
    return Dictionary(sorted(set(flat.tolist())), spec.data_type)


def _dict_hash(dictionary: Dictionary) -> int:
    vals = dictionary.values
    if isinstance(vals, np.ndarray):
        return zlib.crc32(np.ascontiguousarray(vals).tobytes())
    joined = "\x00".join(v.hex() if isinstance(v, bytes) else str(v) for v in vals)
    return zlib.crc32(joined.encode("utf-8"))


def _build_part(schema: Schema, config: SegmentGeneratorConfig, part: Dict[str, Any],
                out_dir: str, name: str, fixed: Dict[str, Any]) -> str:
    """One segment of an aligned set (a worker process's task)."""
    return SegmentBuilder(schema, config).build(part, out_dir, name, fixed_dictionaries=fixed)


def build_aligned_segments(schema: Schema, columns: Dict[str, Union[np.ndarray, Sequence[Any]]],
                           out_dir: str, base_name: str, num_segments: int,
                           config: Optional[SegmentGeneratorConfig] = None,
                           executor=None) -> List[str]:
    """Split one column batch into `num_segments` row-range segments that share
    dictionaries (computed over the union), so every segment of the set has
    the same dict-id space. With an `executor` (a process pool) the segments
    build side by side, each from its pickled rows and the shared
    dictionaries; the files are the same."""
    config = dataclasses.replace(config or SegmentGeneratorConfig())
    config.no_dictionary_columns = list(config.no_dictionary_columns)  # private copy
    builder = SegmentBuilder(schema, config)
    num_docs = builder._num_docs(columns)
    fixed: Dict[str, Any] = {}
    for spec in builder.schema.fields:
        raw = columns.get(spec.name)
        if raw is None or spec.name in builder.config.no_dictionary_columns:
            continue  # missing -> per-segment default fill; no-dict -> raw everywhere
        if not spec.single_value:
            # the union of every row's values (the JAX writer keeps a
            # multi-value column's dictionary per segment; a shared one keeps
            # the set aligned where a segment lacks a value)
            fixed[spec.name] = _mv_union_dictionary(spec, raw)
            continue
        if spec.data_type.is_numeric:
            d, _ = build_dictionary(np.asarray(raw), spec.data_type)
            if d.cardinality > builder.config.raw_cardinality_fraction * num_docs:
                # force raw in *every* segment (per-segment heuristics could diverge)
                builder.config.no_dictionary_columns.append(spec.name)
                continue
            fixed[spec.name] = d
        else:
            fixed[spec.name], _ = build_dictionary(raw, spec.data_type)

    bounds = np.linspace(0, num_docs, num_segments + 1, dtype=np.int64)
    paths = []
    for i in range(num_segments):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        part = {c: (v[lo:hi] if isinstance(v, np.ndarray) else list(v[lo:hi]))
                for c, v in columns.items()}
        if executor is not None:
            paths.append(executor.submit(_build_part, builder.schema, builder.config, part,
                                         out_dir, f"{base_name}_{i}", fixed))
        else:
            paths.append(builder.build(part, out_dir, f"{base_name}_{i}",
                                       fixed_dictionaries=fixed))
    return [p.result() for p in paths] if executor is not None else paths


def segments_from_columns(schema: Schema, columns: Dict[str, np.ndarray], out_dir: str,
                          n_segments: int,
                          config: Optional[SegmentGeneratorConfig] = None) -> list:
    """Build a dictionary-aligned table of `n_segments` segments from numpy
    columns and load it: the one call that turns generated data into the
    segments `execute_query` takes."""
    from .reader import load_segment
    paths = build_aligned_segments(schema, columns, out_dir, schema.name,
                                   n_segments, config)
    return [load_segment(p) for p in paths]


def _jsonable(v: Any) -> Any:
    if v is None:
        return None
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v
