"""The consuming segment: a chunked columnar store with device-staged chunks.

Counterpart of `pinot_tpu/segment/mutable_device.py`. One `index_arrays` /
`index_batch` call appends one typed chunk per column, so indexing costs
O(columns) Python operations per batch whatever its row count. A string
column's append-order dictionary grows by a vectorized merge
(`BatchDictBuilder`): a chunk's append-order ids never change, and a
query-time snapshot remaps them to the sorted-id space with one gather.

A multi-value column is always dictionary-encoded: its chunk is the rows'
append-order ids concatenated with each row's value count (`_mv_chunk`,
which normalizes each cell as the writer does), and a snapshot gives the
sorted ids with the row offsets (a CSR, the writer's layout). Its rows come
through `index_batch` (the JSON lane); the columnar block codec carries no
multi-value column. On the device the view's block builds its id matrix
from the snapshot, as it does a string column's ids.

With `device_staging`, every numeric chunk is also copied to the device when
it is indexed, narrowed as `engine.datablock._narrow` narrows (an integer
chunk to int32 with its frame-of-reference base added, a float chunk to
float32). `query_view()` then hands the planner a `ConsumingView` with
`is_mutable=False` whose `SegmentBlock` already holds the concatenated staged
chunks, so a consuming segment's queries run the same device path as an
immutable segment's. A column whose values leave the int32 range (epoch-ms
timestamps) stops staging; a failed device copy raises. Without staging the
view is mutable: the per-segment executor plans it on the host, its readers'
`dict_snapshot()` binding each dictionary to its ids, and the set executor
plans a set holding it on the merged-dictionary view (`parallel/merged.py`).

Concurrency: one writer (the consumer's pump) and many readers. The writer
appends each column's chunk, then the chunk's row count (`_chunk_rows`), and
publishes the new row count (`_num_docs`) last; a reader freezes a row count
and reads only the chunks it covers.

Memory ledger (`utils/memledger.py`): every staged chunk registers as
`consuming` under the segment's name, and so does every tensor of a view's
block; `release_device` (a consumer's retire or stop) releases them all.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.datablock import SegmentBlock, _narrow, device_key
from ..ingest.vectorized import widen_num
from ..query.executor import resolve_device
from ..schema import DataType, FieldSpec, Schema, normalize_mv_column
from ..utils.memledger import get_ledger, staged
from .dictionary import Dictionary
from .reader import mv_rows

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _wide_dtype(data_type: DataType) -> np.dtype:
    """In-store numeric width: int64 for integer types, float64 for floats."""
    return np.dtype(np.int64) if np.dtype(data_type.numpy_dtype).kind in "iu" \
        else np.dtype(np.float64)


class BatchDictBuilder:
    """Append-order dictionary with a vectorized merge per batch.

    Ids are assigned in first-seen order and never move. A sorted mirror of
    the values and the append id of each sorted slot are republished as one
    tuple per merge (one store), so a concurrent reader always sees a
    consistent pair."""

    def __init__(self, data_type: DataType):
        self.data_type = data_type
        # (sorted values, append-order id of each sorted slot)
        self._pub = (np.empty(0, dtype=object), np.empty(0, dtype=np.int64))
        self._snap: tuple = (-1, None, None)

    def encode_distinct(self, vals: np.ndarray) -> np.ndarray:
        """Values -> append-order ids, registering unseen values."""
        sorted_v, sorted_ids = self._pub
        pos = np.searchsorted(sorted_v, vals)
        hit = pos < len(sorted_v)
        if hit.any():
            hit[hit] = sorted_v[pos[hit]] == vals[hit]
        if not hit.all():
            new = np.unique(np.asarray(vals, dtype=object)[~hit])
            base = len(sorted_v)
            ins = np.searchsorted(sorted_v, new)
            sorted_v = np.insert(sorted_v, ins, new)
            sorted_ids = np.insert(sorted_ids, ins, np.arange(base, base + len(new)))
            self._pub = (sorted_v, sorted_ids)   # one store publishes both
            pos = np.searchsorted(sorted_v, vals)
        return sorted_ids[pos]

    def snapshot(self) -> tuple:
        """(cardinality, sorted Dictionary, append id -> sorted id table),
        cached per cardinality (ids never move, so a dictionary of the same
        size is the same dictionary)."""
        sorted_v, sorted_ids = self._pub
        card = len(sorted_v)
        if self._snap[0] == card:
            return self._snap
        lut = np.empty(card, dtype=np.int64)
        lut[sorted_ids] = np.arange(card, dtype=np.int64)
        values = sorted_v.tolist()
        if self.data_type.is_numeric:   # a multi-value numeric column's
            values = np.asarray(values, dtype=self.data_type.numpy_dtype)
        self._snap = (card, Dictionary(values, self.data_type), lut)
        return self._snap


class DeviceColumnReader:
    """ColumnReader surface over the chunked store. `fixed_n` freezes it at
    one row count (a view's readers); without it, it follows the live store.
    Materializations are cached per row count."""

    def __init__(self, spec: FieldSpec, store: "DeviceMutableSegment",
                 fixed_n: Optional[int] = None):
        self.spec = spec
        self.store = store
        self.name = spec.name
        self.data_type = spec.data_type
        self._fixed_n = fixed_n
        self._snap: tuple = (-1, None)

    @property
    def has_dictionary(self) -> bool:
        return not self.data_type.is_numeric or self.is_multi_value

    @property
    def is_multi_value(self) -> bool:
        return not self.spec.single_value

    @property
    def max_num_values(self) -> int:
        if not self.is_multi_value:
            return 1
        counts = self.mv_counts()
        return int(counts.max()) if len(counts) else 0

    @property
    def mv_offsets(self) -> Optional[np.ndarray]:
        """int64 row offsets into `fwd` of a multi-value column."""
        return self._mat()[6] if self.is_multi_value else None

    def mv_counts(self) -> np.ndarray:
        return np.diff(np.asarray(self.mv_offsets))

    # a consuming segment keeps no auxiliary index: JSON_MATCH and TEXT_MATCH
    # over it resolve by scanning `values()`
    json_index = None
    text_index = None
    inverted_index = None

    @property
    def num_docs(self) -> int:
        return self._fixed_n if self._fixed_n is not None else self.store.num_docs

    @property
    def cardinality(self) -> int:
        d = self._mat()[1]
        return len(d) if d is not None else -1

    @property
    def meta(self) -> Dict[str, Any]:
        return {"hasNulls": self.null_bitmap is not None,
                "dataType": self.data_type.value,
                "fwdDtype": str(self.fwd.dtype)}

    @property
    def dictionary(self) -> Optional[Dictionary]:
        return self._mat()[1]

    @property
    def fwd(self) -> np.ndarray:
        """Sorted dict ids of a string column (of a multi-value column, every
        row's, concatenated); raw values in the storage dtype of a numeric
        one."""
        m = self._mat()
        return m[2] if m[1] is not None else m[0]

    def dict_snapshot(self) -> tuple:
        """(rows, dictionary, ids) from one materialization, with the row
        offsets last for a multi-value column, or (-1, None, None) for a
        column without a dictionary."""
        m = self._mat()
        if m[1] is None:
            return (-1, None, None)
        if self.is_multi_value:
            return (self.num_docs, m[1], m[2], m[6])
        return (self.num_docs, m[1], m[2])

    def values(self) -> np.ndarray:
        """The decoded column; a multi-value column's an object array of
        per-row value arrays."""
        m = self._mat()
        if self.is_multi_value:
            return mv_rows(m[1].take(m[2]), m[6])
        return m[1].take(m[2]) if m[1] is not None else m[0]

    @property
    def null_bitmap(self) -> Optional[np.ndarray]:
        return self._mat()[3]

    @property
    def min_value(self):
        return self._mat()[4]

    @property
    def max_value(self):
        return self._mat()[5]

    def _mat(self) -> tuple:
        """(raw, dictionary, ids, nulls, min, max, row offsets) at this
        reader's row count; a frozen reader materializes once. The bounds are
        taken with the materialization: the planner reads them for every
        query, as it reads an immutable segment's from its metadata."""
        n = self.num_docs
        snap = self._snap
        if snap[0] == n:
            return snap[1]
        raw, d, ids, nulls, offsets = self.store._materialize(self.name, n)
        if d is not None:
            bounds = (d.min_value, d.max_value)
        else:
            bounds = (raw.min(), raw.max()) if len(raw) else (None, None)
        m = (raw, d, ids, nulls) + bounds + (offsets,)
        self._snap = (n, m)
        return m


class ConsumingView:
    """A consuming segment frozen at one row count: every reader is pinned
    there, so repeated queries share one materialization.

    `is_mutable` is False when the store stages chunks on the device: the
    planner then plans the view as an immutable segment, and its
    `SegmentBlock` is the one `_attach_device_block` built from the staged
    chunks (in `_device_blocks`, where `datablock.block_for` finds it)."""

    def __init__(self, store: "DeviceMutableSegment", n: int):
        self.name = store.name
        self.schema = store.schema
        self.num_docs = n
        self.is_mutable = not store.device_staging
        self._store = store
        self._readers: Dict[str, DeviceColumnReader] = {}
        self._device_blocks: Dict[str, SegmentBlock] = {}

    @property
    def column_names(self) -> List[str]:
        return self.schema.column_names

    def column(self, name: str) -> DeviceColumnReader:
        r = self._readers.get(name)
        if r is None:
            r = DeviceColumnReader(self.schema.field_spec(name), self._store,
                                   fixed_n=self.num_docs)
            self._readers[name] = r
        return r

    def __repr__(self) -> str:
        return f"ConsumingView({self.name!r}, docs={self.num_docs})"


class DeviceMutableSegment:
    """Chunk-append consuming segment; a single writer, many readers.

    Entry points: `index_arrays(ColumnarBatch)` (the block lane),
    `index_batch(columns)` (the JSON lane), `query_view()` and
    `snapshot_arrays()` (the commit). `device` is where staged chunks go:
    CUDA unless the caller names another device, and without a card asking
    for CUDA raises. A realtime text or inverted index (`text_index_columns`,
    `inverted_index_columns` naming a column of the schema) raises ValueError,
    as in the JAX package: those are per-row indexes, which the row-append
    `segment.mutable.MutableSegment` keeps (the consumer picks it for such a
    table)."""

    is_mutable = True

    def __init__(self, name: str, schema: Schema, device_staging: bool = False,
                 device=None, text_index_columns: Sequence[str] = (),
                 inverted_index_columns: Sequence[str] = ()):
        if any(schema.has_column(c) for c in (*text_index_columns, *inverted_index_columns)):
            raise ValueError(
                "DeviceMutableSegment does not maintain realtime text/inverted indexes "
                "(per-row by nature): use pinot_tpu_torch.segment.mutable.MutableSegment")
        self.name = name
        self.schema = schema
        self._num_docs = 0                    # published last
        self._chunk_rows: List[int] = []      # rows per appended batch
        # per-column chunk lists: (array, FOR base or None) for numeric
        # columns, append-order id arrays for string columns, (append-order
        # ids, per-row value counts) for multi-value columns
        self._chunks: Dict[str, List[Any]] = {f.name: [] for f in schema.fields}
        self._null_chunks: Dict[str, List[Optional[np.ndarray]]] = {
            f.name: [] for f in schema.fields}
        self._has_nulls: Dict[str, bool] = {f.name: False for f in schema.fields}
        self._dicts: Dict[str, BatchDictBuilder] = {
            f.name: BatchDictBuilder(f.data_type) for f in schema.fields
            if not f.data_type.is_numeric or not f.single_value}
        self._readers: Dict[str, DeviceColumnReader] = {}
        self._view: Optional[ConsumingView] = None
        self._snap_arrays: tuple = (-1, None)
        # device staging: per numeric column, its staged chunks, or None once
        # the column proves unstageable (values outside int32) or the store
        # released its device memory
        self.device_staging = bool(device_staging)
        self._dev_chunks: Dict[str, Optional[List[torch.Tensor]]] = {}
        self.device: Optional[torch.device] = None
        if self.device_staging:
            self.device = resolve_device(device)
            self._dev_chunks = {f.name: [] for f in schema.fields
                                if f.data_type.is_numeric and f.single_value}

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def column_names(self) -> List[str]:
        return self.schema.column_names

    def column(self, name: str) -> DeviceColumnReader:
        r = self._readers.get(name)
        if r is None:
            if not self.schema.has_column(name):
                raise KeyError(f"segment {self.name}: no column {name!r}")
            r = DeviceColumnReader(self.schema.field_spec(name), self)
            self._readers[name] = r
        return r

    # -- ingest entry points ------------------------------------------------
    def index_arrays(self, batch) -> int:
        """Append one decoded `ColumnarBatch`: O(columns) Python operations,
        the row work in numpy. The block lane's hot path."""
        n = batch.n
        if n == 0:
            return 0
        n0 = self._num_docs
        for spec in self.schema.fields:
            self._append_rep(spec, batch.cols.get(spec.name), n)
        self._chunk_rows.append(n)   # after the column chunks
        self._num_docs = n0 + n      # publishes the batch
        return n

    def index_batch(self, cols: Dict[str, List[Any]]) -> int:
        """Append a batch of column lists (the JSON lane, coerced by the
        transform pipeline), one chunk per column."""
        m = len(next(iter(cols.values()))) if cols else 0
        if m == 0:
            return 0
        n0 = self._num_docs
        for spec in self.schema.fields:
            vals = cols.get(spec.name)
            if vals is None:
                self._append_rep(spec, None, m)
            else:
                self._append_list(spec, vals, m)
        self._chunk_rows.append(m)
        self._num_docs = n0 + m
        return m

    # -- chunk appenders ----------------------------------------------------
    def _null_id(self, name: str, spec: FieldSpec) -> int:
        return int(self._dicts[name].encode_distinct(
            np.array([spec.null_value], dtype=object))[0])

    def _append_rep(self, spec: FieldSpec, rep: Optional[tuple], n: int) -> None:
        """One column's chunk from a ColumnarBatch rep (None: the batch lacks
        the column, an all-null chunk)."""
        name = spec.name
        if not spec.single_value:
            if rep is not None:
                raise ValueError(f"multi-value column {name!r}: the columnar block codec "
                                 "carries no multi-value column")
            self._mv_chunk(spec, [None] * n, n)
            return
        if rep is None:
            nulls = np.ones(n, dtype=bool)
            if spec.data_type.is_numeric:
                wide = _wide_dtype(spec.data_type)
                self._push_num(spec, np.full(n, spec.null_value, dtype=wide), None, nulls)
            else:
                self._push_dict(spec, np.full(n, self._null_id(name, spec), dtype=np.int64),
                                nulls)
            return
        kind, a, b, nulls = rep
        if spec.data_type.is_numeric:
            if kind == "num":
                if (a.dtype.kind in "iu") == (_wide_dtype(spec.data_type).kind == "i"):
                    self._push_num(spec, a, b, nulls)   # the block's own array
                else:
                    arr = widen_num(a, b, spec.data_type)  # a float block on an int column
                    if nulls is not None:
                        arr = arr.copy()
                        arr[nulls] = spec.null_value
                    self._push_num(spec, arr, None, nulls)
            else:   # a dictionary rep on a numeric column: decode its small table
                coerce = spec.data_type.coerce
                lut = np.array([coerce(v) for v in a], dtype=_wide_dtype(spec.data_type))
                arr = lut[np.asarray(b, dtype=np.int64)]
                if nulls is not None:
                    arr[nulls] = spec.null_value
                self._push_num(spec, arr, None, nulls)
            return
        builder = self._dicts[name]
        if kind == "dict":
            if spec.data_type is DataType.STRING:
                vals_obj = np.array(a, dtype=object)   # decoded str values already
            else:
                coerce = spec.data_type.coerce
                vals_obj = np.array([coerce(v) for v in a], dtype=object)
            ids = builder.encode_distinct(vals_obj)[np.asarray(b, dtype=np.int64)]
        else:   # a numeric rep on a string column: stringify its distinct values
            wide = widen_num(a, b, DataType.LONG if a.dtype.kind in "iu" else DataType.DOUBLE)
            uniq, inv = np.unique(wide, return_inverse=True)
            coerce = spec.data_type.coerce
            vals_obj = np.array([coerce(v) for v in uniq.tolist()], dtype=object)
            ids = builder.encode_distinct(vals_obj)[inv]
        if nulls is not None:
            ids[nulls] = self._null_id(name, spec)
        self._push_dict(spec, ids, nulls)

    def _append_list(self, spec: FieldSpec, vals, n: int) -> None:
        if not spec.single_value:
            self._mv_chunk(spec, vals, n)
            return
        if spec.data_type.is_numeric:
            wide = _wide_dtype(spec.data_type)
            arr = nulls = None
            if None not in vals:
                try:
                    arr = np.asarray(vals, dtype=wide)
                except (TypeError, ValueError):
                    arr = None   # strings or bools that need real coercion
            if arr is None:
                arr, nulls = _coerce_loop(spec, vals, wide)
            self._push_num(spec, arr, None, nulls)
            return
        obj = np.empty(n, dtype=object)
        obj[:] = list(vals)
        nulls = obj == None  # noqa: E711 -- elementwise None test
        nulls = nulls if nulls.any() else None
        if nulls is not None:
            obj[nulls] = spec.null_value
        uniq, inv = _obj_unique(spec, obj)
        self._push_dict(spec, self._dicts[spec.name].encode_distinct(uniq)[inv], nulls)

    def _mv_chunk(self, spec: FieldSpec, vals, n: int) -> None:
        """A multi-value chunk: each cell normalized as the writer normalizes
        it (ragged, so per row), then the values' ids by one merge into the
        column's dictionary."""
        flat, counts, nulls = normalize_mv_column(spec, vals[:n])
        uniq, inv = np.unique(flat, return_inverse=True)
        ids = self._dicts[spec.name].encode_distinct(uniq.astype(object))[inv] if len(flat) \
            else np.empty(0, dtype=np.int64)
        self._push_dict(spec, (ids, counts), nulls if nulls.any() else None)

    # -- chunk push and device staging ---------------------------------------
    def _push_num(self, spec: FieldSpec, arr: np.ndarray, base: Optional[int],
                  nulls: Optional[np.ndarray]) -> None:
        name = spec.name
        self._chunks[name].append((arr, base))
        self._null_chunks[name].append(nulls)
        if nulls is not None:
            self._has_nulls[name] = True
        dev = self._dev_chunks.get(name)
        if dev is not None:
            self._stage_chunk(spec, arr, base, dev)

    def _push_dict(self, spec: FieldSpec, ids: np.ndarray,
                   nulls: Optional[np.ndarray]) -> None:
        self._chunks[spec.name].append(ids)
        self._null_chunks[spec.name].append(nulls)
        if nulls is not None:
            self._has_nulls[spec.name] = True

    def _stage_chunk(self, spec: FieldSpec, arr: np.ndarray, base: Optional[int],
                     dev: List[torch.Tensor]) -> None:
        """Copy one numeric chunk to the device, narrowed as
        `datablock._narrow` narrows. A column whose values leave the int32
        range stops staging for good (its queries read the host column)."""
        if _wide_dtype(spec.data_type).kind == "i":
            if len(arr):
                lo = int(arr.min()) + (base or 0)
                hi = int(arr.max()) + (base or 0)
                if lo < _I32_MIN or hi > _I32_MAX:
                    self._dev_chunks[spec.name] = None
                    return
            host = np.add(arr, base, dtype=np.int32) if base else arr.astype(np.int32)
        else:
            host = arr.astype(np.float32)
        dev.append(staged(torch.from_numpy(host).to(self.device), self.name, "consuming",
                          name=f"{spec.name}#{len(dev)}"))

    # -- query-time materialization ----------------------------------------
    def _trim(self, items: list, n: int) -> list:
        """(rows to take, item) pairs covering the first n rows. The writer
        appends `_chunk_rows` after the chunks, so zipping with it pairs only
        complete chunks."""
        out = []
        got = 0
        for rows, item in zip(self._chunk_rows, items):
            if got >= n:
                break
            out.append((min(rows, n - got), item))
            got += min(rows, n - got)
        return out

    def _materialize(self, name: str, n: int) -> tuple:
        """(raw, dictionary, ids, nulls, row offsets) of column `name` frozen
        at `n` rows. A dictionary holds only the values present in those
        rows, sorted, and the ids live in its id space; the row offsets (a
        multi-value column's CSR, else None) split the ids into rows."""
        spec = self.schema.field_spec(name)
        nulls = self._mat_nulls(name, n)
        if not spec.single_value:
            ids, counts = [], []
            for take, (chunk_ids, chunk_counts) in self._trim(self._chunks[name], n):
                counts.append(chunk_counts[:take])
                ids.append(chunk_ids[:int(chunk_counts[:take].sum())])
            counts = np.concatenate(counts) if counts else np.empty(0, dtype=np.int64)
            offsets = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            append_ids = np.concatenate(ids) if ids else np.empty(0, dtype=np.int64)
            d, sorted_ids = self._remap(name, append_ids)
            return (None, d, sorted_ids, nulls, offsets)
        if spec.data_type.is_numeric:
            parts = [widen_num(arr[:take], base, spec.data_type)
                     for take, (arr, base) in self._trim(self._chunks[name], n)]
            wide = np.concatenate(parts) if parts else \
                np.empty(0, dtype=_wide_dtype(spec.data_type))
            storage = np.dtype(spec.data_type.numpy_dtype)
            raw = wide if wide.dtype == storage else wide.astype(storage)
            return (raw, None, None, nulls, None)
        parts = [ids[:take] for take, ids in self._trim(self._chunks[name], n)]
        append_ids = np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)
        d, sorted_ids = self._remap(name, append_ids)
        return (None, d, sorted_ids, nulls, None)

    def _remap(self, name: str, append_ids: np.ndarray):
        """Append-order ids -> (snapshot Dictionary, sorted ids). The builder
        may hold values of rows past the snapshot: the dictionary is cut to the
        values the rows reference."""
        card, d_full, lut = self._dicts[name].snapshot()
        full = lut[append_ids] if len(append_ids) else append_ids
        present = np.unique(full)
        if len(present) == card:
            return d_full, full
        vals = d_full.values
        kept = [vals[i] for i in present.tolist()]
        if isinstance(vals, np.ndarray):
            kept = np.asarray(kept, dtype=vals.dtype)
        return (Dictionary(kept, d_full.data_type), np.searchsorted(present, full))

    def _mat_nulls(self, name: str, n: int) -> Optional[np.ndarray]:
        if not self._has_nulls[name]:
            return None
        out = np.zeros(n, dtype=bool)
        got = 0
        for take, mask in self._trim(self._null_chunks[name], n):
            if mask is not None:
                out[got:got + take] = mask[:take]
            got += take
        return out if out.any() else None

    # -- query and commit -------------------------------------------------
    def query_view(self) -> ConsumingView:
        """The segment frozen at its current row count, cached per row count."""
        n = self._num_docs
        view = self._view
        if view is not None and view.num_docs == n:
            return view
        view = ConsumingView(self, n)
        if self.device_staging:
            self._attach_device_block(view)
        self._view = view
        return view

    def _attach_device_block(self, view: ConsumingView) -> None:
        """Build the view's `SegmentBlock` from the chunks staged at index
        time: each staged column is its chunks joined on the device and
        zero-padded to the block's rows. String columns stay lazy: their
        sorted-space ids come from the view's snapshot."""
        blk = SegmentBlock(view, self.device, ledger_kind="consuming")
        n = view.num_docs
        for name, dev in self._dev_chunks.items():
            if not dev:
                continue
            parts, got = [], 0
            for rows, chunk in zip(self._chunk_rows, dev):
                if got >= n:
                    break
                take = min(rows, n - got)
                parts.append(chunk if take == rows else chunk[:take])
                got += take
            if got < n:   # a chunk raced the publish: top up from the host
                host = _narrow(np.asarray(view.column(name).fwd[got:n]))
                parts.append(torch.from_numpy(host).to(self.device))
            if blk.padded > n:
                # dev's dtype: a view of no rows, taken while the first
                # chunk is staged but not yet published, joins no part
                parts.append(torch.zeros(blk.padded - n, dtype=dev[0].dtype,
                                         device=self.device))
            # one part is a staged chunk (or its slice), already registered
            blk.put_raw(name, torch.cat(parts) if len(parts) > 1 else parts[0],
                        register=len(parts) > 1)
        if self.device.type == "cuda":
            # joined on this thread's stream: finished before any stream reads it
            torch.cuda.current_stream(self.device).synchronize()
        view._device_blocks[device_key(self.device)] = blk

    def snapshot_arrays(self) -> Dict[str, Any]:
        """Column arrays for `SegmentBuilder.build` (None at null rows),
        cached per row count."""
        n = self._num_docs
        cached = self._snap_arrays
        if cached[0] == n:
            return cached[1]
        out: Dict[str, Any] = {}
        for spec in self.schema.fields:
            raw, d, ids, nulls, offsets = self._materialize(spec.name, n)
            if offsets is not None:
                col: Any = list(mv_rows(d.take(ids), offsets))
                if nulls is not None:
                    for i in np.flatnonzero(nulls).tolist():
                        col[i] = None
            elif d is not None:
                col = d.take(ids)
                if nulls is not None:
                    col = col.copy()
                    col[nulls] = None
            elif nulls is not None:
                col = raw.astype(object)
                col[nulls] = None
            else:
                col = raw
            out[spec.name] = col
        self._snap_arrays = (n, out)
        return out

    def release_device(self) -> None:
        """Drop the staged chunks and the cached view's device block, so that
        a retired consuming segment holds no device memory. Every column stops
        staging for good: rows indexed later are not staged, and later views
        build their blocks from the host columns."""
        for name in self._dev_chunks:
            self._dev_chunks[name] = None
        if self._view is not None:
            self._view._device_blocks.clear()
        get_ledger().release(segment=self.name, kind="consuming")

    def __repr__(self) -> str:
        return f"DeviceMutableSegment({self.name!r}, docs={self._num_docs})"


def _coerce_loop(spec: FieldSpec, vals, wide: np.dtype):
    """Per-value coercion of a numeric column with nulls or non-numeric
    inputs: (values with nulls filled, null mask or None)."""
    coerce = spec.data_type.coerce
    out = np.empty(len(vals), dtype=wide)
    null_idx = []
    for i, v in enumerate(vals):
        if v is None:
            null_idx.append(i)
            out[i] = spec.null_value
        else:
            out[i] = coerce(v)
    nulls = None
    if null_idx:
        nulls = np.zeros(len(vals), dtype=bool)
        nulls[null_idx] = True
    return out, nulls


def _obj_unique(spec: FieldSpec, obj: np.ndarray):
    """(distinct values, inverse ids) of an object column, coercing each value
    first where mixed types got past the pipeline."""
    try:
        return np.unique(obj, return_inverse=True)
    except TypeError:
        pass
    coerce = spec.data_type.coerce
    for i, v in enumerate(obj):
        obj[i] = coerce(v)
    return np.unique(obj, return_inverse=True)
