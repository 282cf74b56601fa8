"""Immutable segment loading and column readers.

A subset of `pinot_tpu/segment/reader.py` (analog of the reference's
`ImmutableSegmentLoader.load()` and forward-index reader SPI) with the
inverted, range, bloom, JSON, text and FST index readers, the geo cell
indexes and the segment's star-trees, and multi-value columns (a CSR forward
index: `mv_offsets`, `mv_counts`, `max_num_values`). Columns are `np.load(...,
mmap_mode='r')`-mapped on first touch and moved to the device lazily by
`engine/datablock.py`; a chunk-compressed raw column is a
`compression.ChunkedArrayReader`, decoded once when first read whole.
"""

from __future__ import annotations

import os
from functools import cached_property
from typing import Any, Dict, List, Optional

import numpy as np

from ..schema import DataType, Schema
from . import format as fmt
from .compression import ChunkedArrayReader
from .dictionary import Dictionary
from .indexes.bloom import BloomFilterReader
from .indexes.fst import FstIndexReader
from .indexes.inverted import InvertedIndexReader
from .indexes.jsonidx import JsonIndexReader
from .indexes.range import RangeIndexReader
from .indexes.text import TextIndexReader


class ColumnReader:
    """Per-column access: forward index (dict ids or raw), dictionary, null
    bitmap and auxiliary indexes."""

    def __init__(self, seg_dir: str, name: str, meta: Dict[str, Any]):
        self._prefix = os.path.join(seg_dir, fmt.COLS_DIR, name)
        self.name = name
        self.meta = meta
        self.data_type = DataType(meta["dataType"])
        self.has_dictionary: bool = meta["hasDictionary"]
        self.cardinality: int = meta["cardinality"]
        self.num_docs: int = meta["totalDocs"]
        self.is_multi_value: bool = meta.get("multiValue", False)
        self.max_num_values: int = meta.get("maxNumValues", 1)

    @cached_property
    def fwd(self) -> np.ndarray:
        """Dict ids (minimal-width uint) if dict-encoded, else raw values; a
        multi-value column's every row's ids, concatenated (rows split at
        `mv_offsets`). A chunk-compressed column's reader is its array surface:
        a slice decodes only the covering chunks, `np.asarray()` decodes the
        whole column once."""
        if self.meta.get("compression"):
            return ChunkedArrayReader(self._prefix + fmt.FWD_COMPRESSED_SUFFIX)
        return np.load(self._prefix + fmt.FWD_SUFFIX, mmap_mode="r")

    @cached_property
    def mv_offsets(self) -> Optional[np.ndarray]:
        """int64[num_docs + 1] row offsets into a multi-value column's `fwd`."""
        if not self.is_multi_value:
            return None
        return np.load(self._prefix + fmt.MV_OFFSETS_SUFFIX, mmap_mode="r")

    def mv_counts(self) -> np.ndarray:
        return np.diff(np.asarray(self.mv_offsets))

    @cached_property
    def dictionary(self) -> Optional[Dictionary]:
        if not self.has_dictionary:
            return None
        if self.data_type.is_numeric:
            return Dictionary(np.load(self._prefix + fmt.DICT_NUMERIC_SUFFIX), self.data_type)
        values = fmt.read_string_dictionary(self._prefix)
        if self.meta.get("bytesHex"):
            return Dictionary([bytes.fromhex(v) for v in values], self.data_type)
        return Dictionary(values, self.data_type)

    def values(self) -> np.ndarray:
        """Fully decoded column values (host-side); a multi-value column's is an
        object array of per-row value arrays."""
        if self.is_multi_value:
            return mv_rows(self.dictionary.take(np.asarray(self.fwd).astype(np.int64)),
                           np.asarray(self.mv_offsets))
        if not self.has_dictionary:
            return np.asarray(self.fwd)
        return self.dictionary.take(np.asarray(self.fwd).astype(np.int64))

    @property
    def min_value(self) -> Any:
        v = self.meta.get("minValue")
        return bytes.fromhex(v) if v is not None and self.data_type is DataType.BYTES else v

    @property
    def max_value(self) -> Any:
        v = self.meta.get("maxValue")
        return bytes.fromhex(v) if v is not None and self.data_type is DataType.BYTES else v

    @property
    def index_types(self) -> List[str]:
        return self.meta.get("indexes", [])

    @cached_property
    def inverted_index(self) -> Optional[InvertedIndexReader]:
        if "inverted" not in self.index_types:
            return None
        return InvertedIndexReader(self._prefix + fmt.INVERTED_SUFFIX)

    @cached_property
    def range_index(self) -> Optional[RangeIndexReader]:
        if "range" not in self.index_types:
            return None
        return RangeIndexReader(self._prefix + fmt.RANGE_SUFFIX)

    @cached_property
    def bloom_filter(self) -> Optional[BloomFilterReader]:
        if "bloom" not in self.index_types:
            return None
        return BloomFilterReader(self._prefix + fmt.BLOOM_SUFFIX)

    @cached_property
    def json_index(self) -> Optional[JsonIndexReader]:
        if "json" not in self.index_types:
            return None
        return JsonIndexReader(self._prefix + fmt.JSON_SUFFIX, self.num_docs)

    @cached_property
    def text_index(self) -> Optional[TextIndexReader]:
        if "text" not in self.index_types:
            return None
        return TextIndexReader(self._prefix + fmt.TEXT_SUFFIX, self.num_docs)

    @cached_property
    def fst_index(self) -> Optional[FstIndexReader]:
        if "fst" not in self.index_types:
            return None
        return FstIndexReader(self._prefix + fmt.FST_SUFFIX)

    @cached_property
    def null_bitmap(self) -> Optional[np.ndarray]:
        """bool[num_docs] of null positions, or None."""
        if not self.meta.get("hasNulls"):
            return None
        packed = np.load(self._prefix + fmt.NULLS_SUFFIX)
        return fmt.unpack_bitmap(packed, self.num_docs)


class MVValues:
    """A multi-value column's rows on the host, kept as CSR: dict ids `ids`
    split at `offsets`, decoded through `dictionary` only where asked. The
    host evaluator reads it where it would read an object array of per-row
    value arrays (`np.asarray` gives that array); `take` selects rows without
    decoding, `values` decodes every selected row's values at once, and
    `counts` gives each row's number of values."""

    ndim = 1
    dtype = np.dtype(object)

    def __init__(self, dictionary, ids: np.ndarray, offsets: np.ndarray):
        self.dictionary = dictionary
        self.ids = np.asarray(ids)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def values(self) -> np.ndarray:
        """Every row's values, decoded and concatenated."""
        return self.dictionary.take(
            self.ids[self.offsets[0]:self.offsets[-1]].astype(np.int64))

    def take(self, rows) -> "MVValues":
        """The rows `rows` names (indices, a bool mask or a slice), in order."""
        rows = np.arange(len(self))[rows] if isinstance(rows, slice) else np.asarray(rows)
        if rows.dtype == bool:
            rows = np.flatnonzero(rows)
        lo, counts = self.offsets[rows], self.counts[rows]
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        pick = np.repeat(lo - offsets[:-1], counts) + np.arange(int(offsets[-1]))
        return MVValues(self.dictionary, self.ids[pick], offsets)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            a, b = self.offsets[key], self.offsets[key + 1]
            return self.dictionary.take(self.ids[a:b].astype(np.int64))
        return self.take(key)

    def __array__(self, dtype=None, copy=None):
        return mv_rows(self.values(), self.offsets - self.offsets[0])

    def __iter__(self):
        return iter(np.asarray(self))


def mv_values(reader) -> MVValues:
    """A multi-value column reader's rows as `MVValues`; a consuming
    segment's from one `dict_snapshot`."""
    snapshot = getattr(reader, "dict_snapshot", None)
    if snapshot is not None:
        _, d, ids, offsets = snapshot()
        return MVValues(d, ids, offsets)
    return MVValues(reader.dictionary, np.asarray(reader.fwd), np.asarray(reader.mv_offsets))


def mv_rows(flat: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """An object array of the per-row slices of `flat` at CSR `offsets`."""
    out = np.empty(len(offsets) - 1, dtype=object)
    for i, part in enumerate(np.split(flat, offsets[1:-1]) if len(out) else ()):
        out[i] = part
    return out


class ImmutableSegment:
    """A loaded immutable segment (reference: ImmutableSegmentImpl)."""

    def __init__(self, seg_dir: str):
        self.path = seg_dir
        self.metadata = fmt.read_json(os.path.join(seg_dir, fmt.SEGMENT_METADATA_FILE))
        if self.metadata.get("formatVersion") != fmt.FORMAT_VERSION:
            raise ValueError(f"unsupported segment format: {self.metadata.get('formatVersion')}")
        self.schema = Schema.from_json(self.metadata["schema"])
        self.name: str = self.metadata["segmentName"]
        self.num_docs: int = self.metadata["totalDocs"]
        self._columns: Dict[str, ColumnReader] = {}
        self._geo_cache: Dict[tuple, Any] = {}

    def column(self, name: str) -> ColumnReader:
        if name not in self._columns:
            if name not in self.metadata["columns"]:
                raise KeyError(f"segment {self.name}: no column {name!r}")
            self._columns[name] = ColumnReader(self.path, name, self.metadata["columns"][name])
        return self._columns[name]

    @property
    def column_names(self) -> List[str]:
        return list(self.metadata["columns"].keys())

    @property
    def has_star_tree(self) -> bool:
        """True when the segment carries star-tree pre-aggregations."""
        return os.path.isdir(os.path.join(self.path, fmt.STARTREE_DIR))

    @cached_property
    def star_trees(self) -> list:
        """The segment's loaded star-trees (`startree.StarTree`), in build order."""
        from .startree import load_star_trees
        return load_star_trees(self)

    def geo_index(self, lng_col: str, lat_col: str):
        """The `GeoIndexReader` of a (lng, lat) column pair, or None."""
        key = (lng_col, lat_col)
        if key not in self._geo_cache:
            # imported here: indexes.geo needs engine.geo_fns, whose expression
            # library imports the segment package
            from .indexes.geo import GeoIndexReader, geo_index_path
            self._geo_cache[key] = next(
                (GeoIndexReader(geo_index_path(os.path.join(self.path, fmt.COLS_DIR, ""),
                                               lng_col, lat_col))
                 for g in self.metadata.get("geoIndexes", [])
                 if (g["lngColumn"], g["latColumn"]) == key), None)
        return self._geo_cache[key]

    def __repr__(self) -> str:
        return f"ImmutableSegment({self.name!r}, docs={self.num_docs})"


def load_segment(seg_dir: str) -> ImmutableSegment:
    """Reference: ImmutableSegmentLoader.load (mmap mode)."""
    return ImmutableSegment(seg_dir)
