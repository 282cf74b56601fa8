"""Immutable segment loading and column readers.

A subset of `pinot_tpu/segment/reader.py` (analog of the reference's
`ImmutableSegmentLoader.load()` and forward-index reader SPI) with the
inverted, range and bloom index readers and the segment's star-trees. Columns
are `np.load(..., mmap_mode='r')`-mapped on first touch and moved to the
device lazily by `engine/datablock.py`. The json, text, fst and geo indexes
are not read.
"""

from __future__ import annotations

import os
from functools import cached_property
from typing import Any, Dict, List, Optional

import numpy as np

from ..schema import DataType, Schema
from . import format as fmt
from .dictionary import Dictionary
from .indexes.bloom import BloomFilterReader
from .indexes.inverted import InvertedIndexReader
from .indexes.range import RangeIndexReader


class ColumnReader:
    """Per-column access: forward index (dict ids or raw), dictionary, null bitmap."""

    def __init__(self, seg_dir: str, name: str, meta: Dict[str, Any]):
        self._prefix = os.path.join(seg_dir, fmt.COLS_DIR, name)
        self.name = name
        self.meta = meta
        self.data_type = DataType(meta["dataType"])
        self.has_dictionary: bool = meta["hasDictionary"]
        self.cardinality: int = meta["cardinality"]
        self.num_docs: int = meta["totalDocs"]
        self.is_multi_value: bool = meta.get("multiValue", False)

    @cached_property
    def fwd(self) -> np.ndarray:
        """Dict ids (minimal-width uint) if dict-encoded, else raw values."""
        if self.is_multi_value:
            raise NotImplementedError(
                f"multi-value column {self.name!r} is not supported by pinot_tpu_torch")
        if self.meta.get("compression"):
            raise NotImplementedError(
                f"chunk-compressed column {self.name!r} is not supported by "
                "pinot_tpu_torch")
        return np.load(self._prefix + fmt.FWD_SUFFIX, mmap_mode="r")

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
        """Fully decoded column values (host-side)."""
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
    def null_bitmap(self) -> Optional[np.ndarray]:
        """bool[num_docs] of null positions, or None."""
        if not self.meta.get("hasNulls"):
            return None
        packed = np.load(self._prefix + fmt.NULLS_SUFFIX)
        return fmt.unpack_bitmap(packed, self.num_docs)


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

    def __repr__(self) -> str:
        return f"ImmutableSegment({self.name!r}, docs={self.num_docs})"


def load_segment(seg_dir: str) -> ImmutableSegment:
    """Reference: ImmutableSegmentLoader.load (mmap mode)."""
    return ImmutableSegment(seg_dir)
