"""The row-append consuming segment: an in-memory columnar store of Python lists.

A copy of `pinot_tpu/segment/mutable.py` (the analog of the reference's
`MutableSegmentImpl`). One writer appends decoded rows (`index`, or
`index_batch` for a column batch); queries see a consistent prefix through
the row counter, published last. It has the column reader surface of an
immutable segment, and `is_mutable`: the planner routes it to the host, as
the JAX planner does (the device path begins at commit, when the rows become
an immutable segment).

This is the store the consumer's per-row lane needs (`ingest/realtime.py`):
upsert and dedup index row by row in arrival order, and the realtime text
and inverted indexes (`indexes/text.py` `MutableTextIndex`,
`indexes/inverted.py` `MutableInvertedIndex`) post one row at a time. The
chunked store (`mutable_device.py`) serves every other consuming segment.

Dictionaries: a string or multi-value column keeps its values in append
order; a query-time snapshot builds a sorted `Dictionary` and the ids in its
id space, cached per row count (`dict_snapshot`). A multi-value cell is
normalized as the writer normalizes it (`schema.normalize_mv_cell`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..schema import FieldSpec, Schema, normalize_mv_cell
from .dictionary import Dictionary
from .indexes.inverted import MutableInvertedIndex, MutableInvertedView
from .indexes.text import MutableTextIndex


class MutableColumnReader:
    """The ColumnReader surface over an appending column."""

    def __init__(self, spec: FieldSpec, store: "MutableSegment"):
        self.spec = spec
        self.store = store
        self.name = spec.name
        self.data_type = spec.data_type
        # one tuple attribute (rows, dictionary, ids[, offsets]): a single
        # attribute load, so a reader never pairs a dictionary with ids of a
        # newer snapshot (those are ids over another sorted value set)
        self._snap: tuple = (-1, None, None)
        # (rows, array) caches of a raw column's `fwd` and of `values()`
        self._fwd_snap: tuple = (-1, None)
        self._vals_snap: tuple = (-1, None)

    # -- reader surface ----------------------------------------------------
    @property
    def has_dictionary(self) -> bool:
        # a multi-value column is always dictionary-encoded, as on disk
        return not self.data_type.is_numeric or self.is_multi_value

    @property
    def is_multi_value(self) -> bool:
        return not self.spec.single_value

    @property
    def max_num_values(self) -> int:
        if not self.is_multi_value:
            return 1
        n = self.store.num_docs
        return max((len(v) for v in self.store.columns[self.name][:n]), default=0)

    @property
    def mv_offsets(self) -> Optional[np.ndarray]:
        if not self.is_multi_value:
            return None
        return self._snapshot()[3]

    def mv_counts(self) -> np.ndarray:
        return np.diff(np.asarray(self.mv_offsets))

    @property
    def num_docs(self) -> int:
        return self.store.num_docs

    @property
    def is_sorted(self) -> bool:
        return False

    @property
    def cardinality(self) -> int:
        d = self._snapshot()[1]
        return len(d) if d is not None else -1

    @property
    def meta(self) -> Dict[str, Any]:
        return {"hasNulls": bool(self.store.null_rows.get(self.name)),
                "dataType": self.data_type.value,
                "fwdDtype": str(self.fwd.dtype)}

    @property
    def dictionary(self) -> Optional[Dictionary]:
        return self._snapshot()[1]

    @property
    def fwd(self) -> np.ndarray:
        """Dict ids of a dictionary column, raw values of a numeric one."""
        if self.has_dictionary:
            return self._snapshot()[2]
        n = self.store.num_docs
        snap = self._fwd_snap
        if snap[0] == n:
            return snap[1]
        arr = np.asarray(self.store.columns[self.name][:n], dtype=self.data_type.numpy_dtype)
        self._fwd_snap = (n, arr)
        return arr

    def dict_snapshot(self) -> tuple:
        """The atomic (rows, dictionary, ids) triple, with the row offsets last
        for a multi-value column, or (-1, None, None) for a raw column: the
        ids are in this dictionary's id space."""
        return self._snapshot()

    def values(self) -> np.ndarray:
        n = self.store.num_docs
        vals = self.store.columns[self.name][:n]
        if self.is_multi_value:
            out = np.empty(n, dtype=object)
            dt = self.data_type.numpy_dtype
            for i, row in enumerate(vals):
                out[i] = np.asarray(row, dtype=dt if dt.kind != "O" else object)
            return out
        if not self.has_dictionary:
            return self.fwd
        snap = self._vals_snap
        if snap[0] == n:
            return snap[1]
        arr = np.array(vals, dtype=object)
        self._vals_snap = (n, arr)
        return arr

    @property
    def text_index(self):
        """A point-in-time view of the realtime text index, or None when the
        column has none (TEXT_MATCH then scans the values)."""
        idx = self.store.text_indexes.get(self.name)
        return idx.view() if idx is not None else None

    @property
    def null_bitmap(self) -> Optional[np.ndarray]:
        nulls = self.store.null_rows.get(self.name)
        if not nulls:
            return None
        n = self.store.num_docs
        out = np.zeros(n, dtype=bool)
        out[[i for i in nulls if i < n]] = True
        return out

    @property
    def min_value(self):
        if self.is_multi_value:
            d = self.dictionary
            return d.min_value if d is not None and len(d) else None
        v = self.values()
        return None if not len(v) else (v.min() if not self.has_dictionary else min(v))

    @property
    def max_value(self):
        if self.is_multi_value:
            d = self.dictionary
            return d.max_value if d is not None and len(d) else None
        v = self.values()
        return None if not len(v) else (v.max() if not self.has_dictionary else max(v))

    @property
    def inverted_index(self) -> Optional[MutableInvertedView]:
        """A point-in-time view of the realtime inverted index, in this
        reader's current snapshot's id space; None when the column has none."""
        return self.inverted_view(self._snapshot())

    def inverted_view(self, snapshot: tuple) -> Optional[MutableInvertedView]:
        """The realtime inverted index bound to a caller-held snapshot: dict
        ids remap as the sorted dictionary grows, so a filter that pairs the
        index with a LUT or the forward ids binds all of them to the same
        (rows, dictionary) pair."""
        idx = self.store.inverted_indexes.get(self.name)
        if idx is None or not self.has_dictionary:
            return None
        n, d = snapshot[:2]
        return idx.view(d, n) if d is not None else None

    # no other auxiliary index while consuming: range and bloom start at commit
    range_index = None
    bloom_filter = None
    index_types: List[str] = []

    def _snapshot(self) -> tuple:
        if not self.has_dictionary:
            return (-1, None, None)
        snap = self._snap
        n = self.store.num_docs
        if n == snap[0]:
            return snap
        vals = self.store.columns[self.name][:n]
        if self.is_multi_value:
            # (rows, dictionary, flat ids, offsets): the on-disk CSR layout
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(r) for r in vals], out=offsets[1:])
            flat = [x for r in vals for x in r]
            if self.data_type.is_numeric:
                arr = np.asarray(flat, dtype=self.data_type.numpy_dtype)
                uniq, inverse = np.unique(arr, return_inverse=True)
                d = Dictionary(uniq, self.data_type)
            else:
                uniq, inverse = np.unique(np.array(flat, dtype=object), return_inverse=True)
                d = Dictionary(list(uniq), self.data_type)
            snap = (n, d, inverse.astype(np.int64), offsets)
        else:
            uniq, inverse = np.unique(np.array(vals, dtype=object), return_inverse=True)
            snap = (n, Dictionary(list(uniq), self.data_type), inverse.astype(np.int64))
        self._snap = snap   # one store publishes the consistent tuple
        return snap


class MutableSegment:
    """Row-append segment: one writer, many readers. `text_index_columns` and
    `inverted_index_columns` name the columns whose realtime indexes it keeps
    (an inverted index serves a dictionary column: a string or multi-value
    one)."""

    is_mutable = True

    def __init__(self, name: str, schema: Schema,
                 text_index_columns: Sequence[str] = (),
                 inverted_index_columns: Sequence[str] = ()):
        self.name = name
        self.schema = schema
        self.columns: Dict[str, List[Any]] = {f.name: [] for f in schema.fields}
        self.null_rows: Dict[str, List[int]] = {}
        self._num_docs = 0          # the row counter, published last
        self._readers: Dict[str, MutableColumnReader] = {}
        self._snap_cols: tuple = (-1, None)
        self.start_time_ms = int(time.time() * 1000)
        self.text_indexes: Dict[str, MutableTextIndex] = {
            c: MutableTextIndex() for c in text_index_columns if schema.has_column(c)}
        self.inverted_indexes: Dict[str, MutableInvertedIndex] = {
            c: MutableInvertedIndex() for c in inverted_index_columns if schema.has_column(c)}
        # what `index` reads of each field, looked up once
        self._appenders = [(f.name, f, f.single_value, f.null_value, f.data_type.coerce,
                            self.columns[f.name], self.text_indexes.get(f.name),
                            self.inverted_indexes.get(f.name)) for f in schema.fields]

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def column_names(self) -> List[str]:
        return self.schema.column_names

    def index(self, row: Dict[str, Any]) -> None:
        """Append one decoded and transformed row (the reference's
        MutableSegmentImpl.index)."""
        n = self._num_docs
        for name, spec, single, null_value, coerce, col, text, inv in self._appenders:
            v = row.get(name)
            if not single:
                v, is_null = normalize_mv_cell(spec, v)
                if is_null:
                    self.null_rows.setdefault(name, []).append(n)
            elif v is None:
                self.null_rows.setdefault(name, []).append(n)
                v = null_value
            else:
                v = coerce(v)
            col.append(v)
            if text is not None:
                text.add_doc(v)
            if inv is not None:
                inv.add_doc(v, n)
        self._num_docs = n + 1   # publishes the row

    def index_batch(self, cols: Dict[str, List[Any]], coerced: bool = False) -> int:
        """Append a batch of column lists, one pass per column; `coerced`
        skips the per-value coercion when the transform pipeline already
        coerced. The rows publish at once at the end. Returns rows appended."""
        m = len(next(iter(cols.values()))) if cols else 0
        if m == 0:
            return 0
        n0 = self._num_docs
        for spec in self.schema.fields:
            name = spec.name
            vals = cols.get(name)
            if vals is None:
                vals = [None] * m
            out: List[Any] = []
            if not spec.single_value:
                for i, v in enumerate(vals):
                    v2, is_null = normalize_mv_cell(spec, v)
                    if is_null:
                        self.null_rows.setdefault(name, []).append(n0 + i)
                    out.append(v2)
            elif coerced and isinstance(vals, list) and None not in vals:
                out = vals     # already coerced, no nulls: adopt the list
            else:
                nv, coerce = spec.null_value, spec.data_type.coerce
                for i, v in enumerate(vals):
                    if v is None:
                        self.null_rows.setdefault(name, []).append(n0 + i)
                        out.append(nv)
                    else:
                        out.append(v if coerced else coerce(v))
            self.columns[name].extend(out)
            tidx = self.text_indexes.get(name)
            if tidx is not None:
                for v in out:
                    tidx.add_doc(v)
            inv = self.inverted_indexes.get(name)
            if inv is not None:
                for i, v in enumerate(out):
                    inv.add_doc(v, n0 + i)
        self._num_docs = n0 + m   # publishes the batch
        return m

    def column(self, name: str) -> MutableColumnReader:
        if name not in self._readers:
            if name not in self.columns:
                raise KeyError(f"segment {self.name}: no column {name!r}")
            self._readers[name] = MutableColumnReader(self.schema.field_spec(name), self)
        return self._readers[name]

    def snapshot_columns(self) -> Dict[str, list]:
        """A consistent copy of every column with None at null rows (the
        commit's input to `SegmentBuilder.build`), cached per row count;
        callers treat the lists as read-only."""
        n = self._num_docs
        cached = self._snap_cols
        if cached[0] == n:
            return cached[1]
        cols = {}
        for name, vals in self.columns.items():
            col = list(vals[:n])
            for i in self.null_rows.get(name, []):
                if i < n:
                    col[i] = None
            cols[name] = col
        self._snap_cols = (n, cols)
        return cols

    def __repr__(self) -> str:
        return f"MutableSegment({self.name!r}, docs={self._num_docs})"
