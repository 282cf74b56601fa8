"""Vectorized ingest: the PCB1 columnar block codec and `ColumnarBatch`.

A copy of the codec in `pinot_tpu/ingest/vectorized.py`: one stream message
carries a whole block of rows in columnar form, so framing and decode cost per
row amortize to almost nothing. Strings are dictionary-encoded (a block-local
dictionary plus narrow ids), integers frame-of-reference encoded (a base plus
u1/u2/u4 deltas), floats raw f8. The bytes equal the JAX package's in both
directions.

`decode_columnar_blocks` walks a buffer of blocks (as the socket broker's
splicing fetch joins them, `BLOCK_SEP` between two) with `np.frombuffer` views
into `ColumnarBatch`es, the typed-array form `DeviceMutableSegment.
index_arrays` appends. `columnar_batch_from_json` is the JSON stream's array
lane over a spliced fetch: the native flat-JSON column walk (`native/`) kept as
typed arrays, string columns dictionary-encoded with one fixed-width
`np.unique`.

Column representations inside a `ColumnarBatch` (plain tuples):

* ``("num", arr, base, nulls)`` — numeric values; ``arr`` may be a narrow
  frame-of-reference array with integer ``base`` (``base is None`` for
  floats). Null rows hold the spec's null fill.
* ``("dict", values, ids, nulls)`` — dictionary-encoded: ``values`` is the
  block-local value list, ``ids`` index into it. Null rows hold the id of the
  spec's null fill value.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..schema import DataType, FieldSpec, Schema

_MAGIC = b"PCB1"
#: the one-byte separator a splicing transport puts between two blocks (the
#: native splicer needs one; blocks describe their own length)
BLOCK_SEP = b"\n"
_K_RAW, _K_DICT, _K_FOR = 0, 1, 2
_F_NULLS = 1

#: single-value types the codec carries: fixed-width numerics and strings
_INT_TYPES = (DataType.INT, DataType.LONG, DataType.BOOLEAN, DataType.TIMESTAMP)
_FLOAT_TYPES = (DataType.FLOAT, DataType.DOUBLE)
_STR_TYPES = (DataType.STRING,)


class ColumnarBatch:
    """One decoded block: typed column arrays ready for O(batch) indexing."""

    __slots__ = ("n", "cols")

    def __init__(self, n: int, cols: Dict[str, tuple]):
        self.n = n
        self.cols = cols

    def max_of(self, name: str) -> Optional[float]:
        """The largest non-null value of a numeric column (a consumer's event
        time), None for a string column or one with no values."""
        rep = self.cols.get(name)
        if rep is None or self.n == 0 or rep[0] != "num":
            return None
        _, arr, base, nulls = rep
        if nulls is not None:
            if nulls.all():
                return None
            arr = arr[~nulls]
        return float(arr.max()) + (base or 0)

    def to_lists(self, schema: Schema) -> Dict[str, List[Any]]:
        """Python column lists with None at null rows: the shape of
        `TransformPipeline.apply`, for a table whose ingestion filter or
        transforms the arrays cannot take."""
        out: Dict[str, List[Any]] = {}
        for spec in schema.fields:
            rep = self.cols.get(spec.name)
            if rep is None:
                out[spec.name] = [None] * self.n
                continue
            if rep[0] == "num":
                _, arr, base, nulls = rep
                vals = widen_num(arr, base, spec.data_type).tolist()
            else:
                _, values, ids, nulls = rep
                vals = [values[i] for i in ids.tolist()]
            if nulls is not None and nulls.any():
                for i in np.nonzero(nulls)[0].tolist():
                    vals[i] = None
            out[spec.name] = vals
        return out


def widen_num(arr: np.ndarray, base: Optional[int], data_type: DataType) -> np.ndarray:
    """A (possibly frame-of-reference) numeric array in the wide dtype of its
    type: int64 for integer types, float64 for floats."""
    wide = np.int64 if np.dtype(data_type.numpy_dtype).kind in "iu" else np.float64
    if base:
        return np.add(arr, base, dtype=wide)
    if arr.dtype == wide:
        return arr
    return arr.astype(wide)


def _narrow_int(arr: np.ndarray) -> Tuple[int, np.ndarray]:
    """Frame-of-reference encoding: (base, narrowest unsigned delta array)."""
    if not len(arr):
        return 0, arr.astype("<u1")
    base = int(arr.min())
    spread = int(arr.max()) - base
    for ch, bits in (("<u1", 8), ("<u2", 16), ("<u4", 32)):
        if spread < (1 << bits):
            return base, (arr - base).astype(ch)
    return 0, arr.astype("<i8")


def _null_fill(spec: FieldSpec, vals) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(object value array with nulls filled, null mask or None)."""
    arr = np.empty(len(vals), dtype=object)
    arr[:] = vals
    nulls = np.array([v is None or (isinstance(v, float) and v != v) for v in vals],
                     dtype=bool)
    if not nulls.any():
        return arr, None
    arr[nulls] = spec.null_value
    return arr, nulls


def encode_columnar_block(schema: Schema, cols: Dict[str, Sequence[Any]]) -> bytes:
    """Column lists or arrays -> one PCB1 block message.

    None marks a null row: the encoder fills it with the spec's null value and
    carries a packed bitmap. Raises ValueError on multi-value, BYTES and JSON
    fields, which the codec does not carry."""
    n = len(next(iter(cols.values()))) if cols else 0
    specs = list(schema.fields)
    for s in specs:
        if not s.single_value or s.data_type not in _INT_TYPES + _FLOAT_TYPES + _STR_TYPES:
            raise ValueError(f"column {s.name}: {s.data_type.value}"
                             f"{'' if s.single_value else ' MV'} is not "
                             "wire-codec eligible (produce JSON rows instead)")
    parts = [_MAGIC, struct.pack("<IH", n, len(specs))]
    for spec in specs:
        vals = cols.get(spec.name)
        if vals is None:
            vals = [None] * n
        obj, nulls = _null_fill(spec, list(vals))
        flags = _F_NULLS if nulls is not None else 0
        name_b = spec.name.encode("utf-8")
        parts.append(struct.pack("<B", len(name_b)) + name_b)
        if spec.data_type in _STR_TYPES:
            uniq, inv = np.unique(obj.astype("U"), return_inverse=True)
            blob = "\x00".join(uniq.tolist()).encode("utf-8")
            _, ids = _narrow_int(inv.astype(np.int64))
            parts.append(struct.pack("<BB", _K_DICT, flags))
            if nulls is not None:
                parts.append(np.packbits(nulls, bitorder="little").tobytes())
            parts.append(struct.pack("<IIB", len(uniq), len(blob), ord(ids.dtype.char)))
            parts.append(blob)
            parts.append(ids.tobytes())
        elif spec.data_type in _INT_TYPES:
            try:
                arr = obj.astype(np.int64)
            except (TypeError, ValueError):
                arr = np.array([spec.data_type.coerce(v) for v in obj], dtype=np.int64)
            base, narrow = _narrow_int(arr)
            parts.append(struct.pack("<BB", _K_FOR, flags))
            if nulls is not None:
                parts.append(np.packbits(nulls, bitorder="little").tobytes())
            parts.append(struct.pack("<Bq", ord(narrow.dtype.char), base))
            parts.append(narrow.tobytes())
        else:
            arr = obj.astype("<f8")
            parts.append(struct.pack("<BB", _K_RAW, flags))
            if nulls is not None:
                parts.append(np.packbits(nulls, bitorder="little").tobytes())
            parts.append(struct.pack("<B", ord(arr.dtype.char)))
            parts.append(arr.tobytes())
    return b"".join(parts)


def _decode_one(mv: memoryview, pos: int) -> Tuple[ColumnarBatch, int]:
    """Decode the block that starts at `pos`: (batch, end position). Array
    columns are `frombuffer` views into the buffer, not copies."""
    if bytes(mv[pos:pos + 4]) != _MAGIC:
        raise ValueError("bad columnar block magic")
    n, ncols = struct.unpack_from("<IH", mv, pos + 4)
    p = pos + 10
    nb = (n + 7) // 8
    cols: Dict[str, tuple] = {}
    for _ in range(ncols):
        (nl,) = struct.unpack_from("<B", mv, p)
        p += 1
        name = bytes(mv[p:p + nl]).decode("utf-8")
        p += nl
        kind, flags = struct.unpack_from("<BB", mv, p)
        p += 2
        nulls = None
        if flags & _F_NULLS:
            nulls = np.unpackbits(np.frombuffer(mv, dtype=np.uint8, count=nb, offset=p),
                                  count=n, bitorder="little").astype(bool)
            p += nb
        if kind == _K_DICT:
            card, blob_len, idc = struct.unpack_from("<IIB", mv, p)
            p += 9
            blob = bytes(mv[p:p + blob_len]).decode("utf-8")
            p += blob_len
            values = blob.split("\x00") if blob_len else ([""] if card else [])
            dt = np.dtype("<" + chr(idc))
            ids = np.frombuffer(mv, dtype=dt, count=n, offset=p)
            p += dt.itemsize * n
            if len(values) != card:
                raise ValueError(f"column {name}: dict count drift")
            cols[name] = ("dict", values, ids, nulls)
        elif kind == _K_FOR:
            ch, base = struct.unpack_from("<Bq", mv, p)
            p += 9
            dt = np.dtype("<" + chr(ch))
            arr = np.frombuffer(mv, dtype=dt, count=n, offset=p)
            p += dt.itemsize * n
            cols[name] = ("num", arr, base, nulls)
        elif kind == _K_RAW:
            (ch,) = struct.unpack_from("<B", mv, p)
            p += 1
            dt = np.dtype("<" + chr(ch))
            arr = np.frombuffer(mv, dtype=dt, count=n, offset=p)
            p += dt.itemsize * n
            cols[name] = ("num", arr, None, nulls)
        else:
            raise ValueError(f"column {name}: unknown block kind {kind}")
    return ColumnarBatch(n, cols), p


def decode_columnar_block(data) -> ColumnarBatch:
    """One block message -> ColumnarBatch."""
    batch, _ = _decode_one(memoryview(_as_bytes(data)), 0)
    return batch


def decode_columnar_blocks(data: bytes, n_msgs: int) -> List[ColumnarBatch]:
    """Walk a buffer of `n_msgs` blocks joined by one separator byte each
    (blocks describe their own length, so the walk skips it), with no copy
    per block."""
    mv = memoryview(data)
    out: List[ColumnarBatch] = []
    pos = 0
    for _ in range(n_msgs):
        batch, pos = _decode_one(mv, pos)
        pos += 1   # the separator byte (absent after the last block)
        out.append(batch)
    return out


class ColumnarBlockDecoder:
    """The block decoder of "columnar" streams: `sep` is the transport's splice
    separator, `decode_spliced` walks a whole spliced fetch, `decode_one`
    decodes one message value."""

    sep = BLOCK_SEP

    @staticmethod
    def decode_spliced(data: bytes, n_msgs: int) -> List[ColumnarBatch]:
        return decode_columnar_blocks(data, n_msgs)

    @staticmethod
    def decode_one(value) -> ColumnarBatch:
        return decode_columnar_block(value)


def _as_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, memoryview):
        return bytes(v)
    return str(v).encode("utf-8", "surrogateescape")


#: the schema types the array lane decodes (as `transform.columns_from_spliced_json`)
_JSON_OK = ("INT", "LONG", "FLOAT", "DOUBLE", "STRING")


def columnar_batch_from_json(data: bytes, n: int, schema: Schema
                             ) -> Optional[ColumnarBatch]:
    """Columnar decode of n spliced flat JSON records to typed arrays: the
    native `json_columns` walk of `transform.columns_from_spliced_json`, kept
    as a `ColumnarBatch`. A string column is dictionary-encoded with one
    fixed-width `np.unique` over an [n, max_len] byte matrix.

    None where a column needs the per-cell path (mixed cell types, escaped
    strings, flagged rows): the caller then takes the list lane,
    `columns_from_spliced_json`, which handles those exactly."""
    from ..native import json_columns
    fields = list(schema.fields)
    if any(not f.single_value or f.data_type.value not in _JSON_OK
           for f in fields):
        return None
    out = json_columns(data, n, [f.name for f in fields])
    if out is None:
        return None
    nums, lints, types, str_off, str_len, rec_ranges, bad = out
    if bad.any():
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    cols: Dict[str, tuple] = {}
    for c, f in enumerate(fields):
        t = types[c]
        dt = f.data_type.value
        null_mask = (t == 0) | (t == 5)
        nulls = null_mask if null_mask.any() else None
        if dt in ("INT", "LONG"):
            ok = (t == 8) | null_mask
            f_mask = t == 1
            if not (ok | f_mask).any() or not (ok | f_mask).all():
                return None
            vals = lints[c].copy() if (f_mask.any() or nulls is not None) \
                else lints[c]
            if f_mask.any():
                fvals = nums[c][f_mask]
                if not (np.isfinite(fvals).all()
                        and (np.abs(fvals) < float(1 << 62)).all()):
                    return None   # doubles past int64: the exact per-cell path
                vals[f_mask] = fvals.astype(np.int64)
            if nulls is not None:
                vals[nulls] = f.null_value
            cols[f.name] = ("num", vals, None, nulls)
        elif dt in ("FLOAT", "DOUBLE"):
            i_mask = t == 8
            if not (i_mask | (t == 1) | null_mask).all():
                return None
            vals = nums[c].copy()
            if i_mask.any():
                vals[i_mask] = lints[c][i_mask].astype(np.float64)
            if nulls is not None:
                vals[nulls] = f.null_value
            cols[f.name] = ("num", vals, None, nulls)
        else:  # STRING
            if not ((t == 2) | null_mask).all():
                return None   # escaped or mixed cells: the per-cell path
            # offsets and lengths are written for t == 2 cells only: the
            # null and missing ones hold uninitialized memory
            s_mask = t == 2
            so = np.where(s_mask, str_off[c], 0)
            sl = np.where(s_mask, str_len[c], 0)
            w = int(sl.max()) if n else 0
            if w > 256:
                return None   # wide strings: the list lane's interning wins
            # an [n, w] byte matrix gathered from the fetch buffer, viewed as
            # fixed-width bytes and made unique in one pass
            mat = np.zeros((n, max(w, 1)), dtype=np.uint8)
            idx = so[:, None] + np.arange(w, dtype=so.dtype)[None, :]
            mask = np.arange(w, dtype=sl.dtype)[None, :] < sl[:, None]
            np.copyto(mat[:, :w], buf[np.minimum(idx, len(buf) - 1)],
                      where=mask)
            fixed = mat.view(f"S{max(w, 1)}").ravel()
            if nulls is not None:
                fixed = fixed.copy()
                fixed[nulls] = np.bytes_(str(f.null_value).encode("utf-8"))
            uniq, inv = np.unique(fixed, return_inverse=True)
            try:
                values = [u.decode("utf-8") for u in uniq.tolist()]
            except UnicodeDecodeError:
                return None   # a multi-byte character cut by the width
            cols[f.name] = ("dict", values, inv.astype(np.int64), nulls)
    return ColumnarBatch(n, cols)
