"""Merged-dictionary segment view: the set path for unaligned segment sets.

Counterpart of `pinot_tpu/parallel/merged.py`. Segments committed at
different times, and consuming views, have dictionaries of their own, so
their dict ids disagree and one plan's id bands and dense group keys cannot
cover the set. The set agrees on ids before the scan instead: one global
sorted dictionary per referenced column (the sorted union of the members'
dictionaries), and each member's local ids remapped to global ids on the host
once, when the set block is stacked. The set then runs as an aligned set.

`MergedSegmentView` presents the merged column surface, so `plan_segment`
and `compile_filter` plan in global-id space unchanged; `remap(col)` hands
the per-member translation tables to `SegmentSetBlock`. A member whose
reader offers `dict_snapshot()` (a consuming view) gives its dictionary and
ids from one snapshot. `view_key` changes when a consuming member grows, so
the executor rebuilds the view and restacks the set.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..schema import DataType
from ..segment.dictionary import Dictionary


def _merge_sorted_values(dicts: List[Dictionary], data_type: DataType):
    """Sorted union of the members' dictionary values, and one remap per
    member: remap[i][local_id] -> global id. A member whose dictionary equals
    the union gets remap None: its local ids are the global ids."""
    if data_type.is_numeric:
        merged = np.unique(np.concatenate([np.asarray(d.values) for d in dicts]))
        remaps = [None if len(d.values) == len(merged) else
                  np.searchsorted(merged, np.asarray(d.values)).astype(np.int32)
                  for d in dicts]
        return Dictionary(merged, data_type), remaps
    arrays = [np.array(list(d.values), dtype=object) for d in dicts]
    merged = np.unique(np.concatenate(arrays)) if arrays else np.array([], dtype=object)
    remaps = [None if len(a) == len(merged) else
              np.searchsorted(merged, a).astype(np.int32) for a in arrays]
    return Dictionary(list(merged), data_type), remaps


class MergedColumnReader:
    """ColumnReader surface of one column across a segment set.

    Dictionary-encoded in every member: the merged global dictionary and the
    remaps. Otherwise a metadata proxy (merged min/max/nulls) over the raw
    columns. The members' auxiliary indexes stay per segment: the set
    executor sends a JSON_MATCH or TEXT_MATCH to the per-segment executor
    before it builds a view."""

    json_index = None
    text_index = None

    def __init__(self, name: str, readers: Sequence[Any], seg_docs: Sequence[int]):
        self.name = name
        self._readers = list(readers)
        self.data_type = readers[0].data_type
        self.has_dictionary = all(r.has_dictionary for r in readers)
        self.num_docs = sum(seg_docs)
        self.is_multi_value = False
        self._dictionary: Optional[Dictionary] = None
        # per-member local -> global tables; an entry is None when that
        # member's ids are already global
        self.remaps: Optional[List[Optional[np.ndarray]]] = None
        # a snapshotting member's ids, taken with the dictionary its remap was
        # built from: read later, its ids could come from another snapshot
        self._fwd_snap: Dict[int, np.ndarray] = {}
        if self.has_dictionary:
            dicts = []
            for i, r in enumerate(readers):
                snapshot = getattr(r, "dict_snapshot", None)
                if snapshot is not None:
                    _, d, ids = snapshot()
                    dicts.append(d)
                    self._fwd_snap[i] = np.asarray(ids)[:seg_docs[i]].astype(np.int64)
                else:
                    dicts.append(r.dictionary)
            self._dictionary, self.remaps = _merge_sorted_values(dicts, self.data_type)

    def local_ids(self, i: int) -> np.ndarray:
        """Member i's local dict ids, in the space of remaps[i]."""
        snap = self._fwd_snap.get(i)
        if snap is not None:
            return snap
        return np.asarray(self._readers[i].fwd).astype(np.int64)

    @property
    def dictionary(self) -> Optional[Dictionary]:
        return self._dictionary

    @property
    def cardinality(self) -> int:
        return len(self._dictionary) if self._dictionary is not None else -1

    @property
    def meta(self) -> Dict[str, Any]:
        if self.has_dictionary:
            fwd_dtype = "int32"   # remapped ids
        else:
            # the value dtype across members: a member that is dict-encoded
            # where others are raw has an id width as its fwd dtype
            def value_dtype(r):
                if r.has_dictionary and r.data_type.is_numeric:
                    return np.asarray(r.dictionary.values).dtype
                return np.dtype(r.meta["fwdDtype"])
            fwd_dtype = str(np.result_type(*[value_dtype(r) for r in self._readers]))
        return {"dataType": self.data_type.value, "hasDictionary": self.has_dictionary,
                "hasNulls": any(r.meta.get("hasNulls", False) for r in self._readers),
                "fwdDtype": fwd_dtype, "cardinality": self.cardinality}

    def _merged_bound(self, attr: str, combine) -> Any:
        """min/max over the members with rows; a member with rows and no
        bound makes the bound unknown (None)."""
        vals = []
        for r in self._readers:
            v = getattr(r, attr)
            if v is None:
                if r.num_docs > 0:
                    return None
                continue
            vals.append(v)
        return combine(vals) if vals else None

    @property
    def min_value(self) -> Any:
        return self._merged_bound("min_value", min)

    @property
    def max_value(self) -> Any:
        return self._merged_bound("max_value", max)

    def values(self) -> np.ndarray:
        raise NotImplementedError(
            "MergedColumnReader is a planning surface; row data stays per segment")


class MergedSegmentView:
    """A virtual segment over an unaligned set, planned as one segment.

    Each member's row count is frozen when the view is built (`seg_docs`);
    the set block slices every member to it."""

    is_mutable = False

    def __init__(self, segments: Sequence[Any]):
        self.segments = list(segments)
        self.schema = segments[0].schema
        self.name = "merged:" + ",".join(s.name for s in segments)
        self.seg_docs: Tuple[int, ...] = tuple(s.num_docs for s in segments)
        self.num_docs = sum(self.seg_docs)
        self._columns: Dict[str, MergedColumnReader] = {}

    def column(self, name: str) -> MergedColumnReader:
        if name not in self._columns:
            self._columns[name] = MergedColumnReader(
                name, [s.column(name) for s in self.segments], self.seg_docs)
        return self._columns[name]

    @property
    def column_names(self) -> List[str]:
        return self.segments[0].column_names

    def remap(self, col: str) -> Optional[List[Optional[np.ndarray]]]:
        """Per-member local -> global id tables (None for a column without a
        dictionary everywhere; a None entry: that member's ids are global)."""
        return self.column(col).remaps

    def __repr__(self) -> str:
        return f"MergedSegmentView({len(self.segments)} segments, docs={self.num_docs})"


def view_key(segments: Sequence[Any]) -> Tuple:
    """Cache key of a segment set's view and block: each member's identity
    and row count, so that a consuming member that grew (a new view of more
    rows) replaces the stale view and block."""
    return tuple((getattr(s, "path", s.name), s.num_docs) for s in segments)
