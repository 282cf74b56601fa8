"""Record transform pipeline: filter -> expression transforms -> type coercion.

Counterpart of `pinot_tpu/ingest/transform.py` (analog of the reference's
ordered transformer chain, `CompositeTransformer.java:33`: FilterTransformer
-> ExpressionTransformer -> DataTypeTransformer). Transform and filter
expressions are SQL expressions parsed by this package's parser and
evaluated with `engine.expr.eval_host`, so ingestion-time and query-time
functions are one registry (the reference shares its `FunctionRegistry`
between both for the same reason). `columns_from_spliced_json` is the JSON
stream's list lane over a spliced fetch: the pipeline's output for a table
with no filter or transforms, from one native walk (`native.json_columns`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..engine.expr import eval_host
from ..schema import DataType, Schema
from ..sql.parser import Parser


def _parse_expr(text: str):
    p = Parser(text)
    e = p.expression()
    if p.cur.kind != "EOF":
        raise ValueError(f"trailing input in expression {text!r}")
    return e


class TransformPipeline:
    """Vectorized over row batches (a dict of column lists or arrays)."""

    def __init__(self, schema: Schema, filter_expr: Optional[str] = None,
                 column_transforms: Optional[Dict[str, str]] = None):
        """`filter_expr`: rows it matches are DROPPED (the reference's
        FilterTransformer: filterFunction selects the records to skip).
        `column_transforms`: dest column -> SQL expression over source fields."""
        self.schema = schema
        self.filter_expr = _parse_expr(filter_expr) if filter_expr else None
        self.column_transforms = {dest: _parse_expr(src)
                                  for dest, src in (column_transforms or {}).items()}

    def apply(self, columns: Dict[str, Any]) -> Dict[str, List[Any]]:
        """Schema columns only, each value coerced to its type, None kept as
        None (so that the segment records a null) and NaN read as null."""
        return self._apply(columns)[0]

    def apply_rows(self, rows: List[Dict[str, Any]]) -> List[Optional[Dict[str, Any]]]:
        """Each row's schema columns, or None where the filter drops it: the
        rows `apply_row` gives one at a time, the batch transformed at once
        (the consumer's per-row lane, which then indexes row by row)."""
        cols, keep = self._apply(rows_to_all_columns(rows))
        names = list(cols)
        out = [dict(zip(names, vals)) for vals in zip(*cols.values())]
        if keep is None:
            return out
        kept = iter(out)
        return [next(kept) if k else None for k in keep.tolist()]

    def apply_row(self, row: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """One row's schema columns, or None when the filter drops it."""
        return self.apply_rows([row])[0]

    def _apply(self, columns: Dict[str, Any]):
        """(`apply`'s columns, the bool mask of the rows the filter kept, or
        None without a filter)."""
        n = len(next(iter(columns.values()))) if columns else 0
        env = {k: _as_array(v) for k, v in columns.items()}
        # schema columns coerced first, so that filters and transforms see
        # typed values even from string inputs; other fields stay raw for the
        # transforms to consume
        coerced = set()
        for spec in self.schema.fields:
            if spec.name in env:
                env[spec.name] = _as_array(_coerce_list(spec, env[spec.name].tolist()))
                coerced.add(spec.name)
        for dest, expr in self.column_transforms.items():
            out = eval_host(expr, env)
            env[dest] = np.full(n, out, dtype=object) if np.isscalar(out) else _as_array(out)
        keep = None
        if self.filter_expr is not None:
            keep = ~np.asarray(eval_host(self.filter_expr, env), dtype=bool)
            env = {k: v[keep] for k, v in env.items()}
            n = int(keep.sum())
        out_cols: Dict[str, List[Any]] = {}
        for spec in self.schema.fields:
            if spec.name not in env:
                out_cols[spec.name] = [None] * n
                continue
            vals = env[spec.name].tolist()
            if spec.name in coerced and spec.name not in self.column_transforms:
                out_cols[spec.name] = vals
            else:
                out_cols[spec.name] = _coerce_list(spec, vals)
        return out_cols, keep


def _coerce_list(spec, vals: list) -> list:
    """Typed values with None preserved. A numeric column takes one numpy cast
    through int64/float64 when every value is clean; BOOLEAN coerces by
    truthiness, so it never takes the cast."""
    dt = spec.data_type
    if not spec.single_value:
        # a multi-value cell passes whole: the segment normalizes it per
        # element (`schema.normalize_mv_cell`) as it is appended
        return [None if v is None or _is_nan(v) else v for v in vals]
    if dt.is_numeric and dt is not DataType.BOOLEAN and vals:
        wide = np.float64 if np.dtype(dt.numpy_dtype).kind == "f" else np.int64
        try:
            arr = np.asarray(vals, dtype=wide)
        except (TypeError, ValueError, OverflowError):
            arr = None
        # numpy maps None to NaN for floats: NaN sends the batch to the loop
        if arr is not None and not (arr.dtype.kind == "f" and np.isnan(arr).any()):
            return arr.tolist()
    return [None if v is None or _is_nan(v) else dt.coerce(v) for v in vals]


def rows_to_all_columns(rows: List[Dict[str, Any]]) -> Dict[str, List[Any]]:
    """Row dicts -> column lists over the union of their keys."""
    keys: set = set()
    for r in rows:
        keys.update(r)
    return {k: [r.get(k) for r in rows] for k in keys}


_NUMERIC_TYPES = ("INT", "LONG", "FLOAT", "DOUBLE")


def columns_from_spliced_json(data: bytes, n: int, schema) -> \
        Optional[Dict[str, List[Any]]]:
    """Native columnar decode of n spliced flat JSON records to index-ready,
    coerced column lists: one C walk (`native.json_columns`) in place of a
    parse per row, `rows_to_all_columns` and a coercion per value.

    None where the shape cannot take it (a multi-value field, a type other
    than INT, LONG, FLOAT, DOUBLE or STRING, a malformed outer structure):
    the caller parses the batch instead. The output is `TransformPipeline.
    apply`'s for a pipeline with no filter or transforms: schema columns only,
    coerced, None at a null or missing cell. A record the walk flags (a
    nested value under a schema key, a number past int64) is parsed alone
    with `json.loads`."""
    from ..native import json_columns
    fields = list(schema.fields)
    if any(not f.single_value or f.data_type.value not in
           _NUMERIC_TYPES + ("STRING",) for f in fields):
        return None
    names = [f.name for f in fields]
    out = json_columns(data, n, names)
    if out is None:
        return None
    nums, lints, types, str_off, str_len, rec_ranges, bad = out
    cols: Dict[str, List[Any]] = {}
    for c, f in enumerate(fields):
        t = types[c]
        dt = f.data_type.value
        if dt in ("INT", "LONG"):
            if (t == 8).all():
                cols[f.name] = lints[c].tolist()
                continue
            f_mask = t == 1
            if ((t == 8) | f_mask).all():
                fvals = nums[c][f_mask]
                # cast at once only where every double fits int64: numpy casts
                # 1e300 to INT64_MIN where int() is exact (the per-cell loop
                # below takes those)
                if np.isfinite(fvals).all() and (np.abs(fvals) < float(1 << 62)).all():
                    ints = lints[c].copy()
                    ints[f_mask] = fvals.astype(np.int64)
                    cols[f.name] = ints.tolist()
                    continue
        elif dt in ("FLOAT", "DOUBLE"):
            i_mask = t == 8
            if (i_mask | (t == 1)).all():
                v = nums[c].copy()
                v[i_mask] = lints[c][i_mask].astype(np.float64)
                cols[f.name] = v.tolist()
                continue
        elif dt == "STRING" and ((t == 2).all()):
            so, sl = str_off[c], str_len[c]
            # one decode a distinct value (dimension columns repeat)
            cache: Dict[bytes, str] = {}
            out_s: List[Any] = []
            for o, l in zip(so.tolist(), sl.tolist()):
                b = data[o:o + l]
                s = cache.get(b)
                if s is None:
                    if len(cache) > 65536:
                        cache.clear()
                    s = cache[b] = b.decode("utf-8")
                out_s.append(s)
            cols[f.name] = out_s
            continue
        # mixed, missing or escaped cells: one cell at a time, with the
        # pipeline's null and coercion rules (the record is not parsed again)
        import json as _json
        coerce = f.data_type.coerce
        vals: List[Any] = []
        so, sl = str_off[c], str_len[c]
        for r in range(n):
            tv = t[r]
            if tv == 0 or tv == 5:
                vals.append(None)
            elif tv == 8:
                vals.append(coerce(int(lints[c, r])))
            elif tv == 1:
                vals.append(coerce(float(nums[c, r])))
            elif tv == 2:
                vals.append(coerce(
                    data[so[r]:so[r] + sl[r]].decode("utf-8")))
            elif tv == 6:
                raw = data[so[r] - 1:so[r] + sl[r] + 1]
                vals.append(coerce(_json.loads(raw)))
            elif tv == 3:
                vals.append(coerce(True))
            else:
                vals.append(coerce(False))
        cols[f.name] = vals
    if bad.any():
        import json as _json
        for r in np.nonzero(bad)[0].tolist():
            off, ln = rec_ranges[r]
            row = _json.loads(data[off:off + ln])
            for f in fields:
                if f.name in row:
                    v = row[f.name]
                    cols[f.name][r] = None if v is None \
                        else f.data_type.coerce(v)
                else:
                    cols[f.name][r] = None
    return cols


def _as_array(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    arr = np.empty(len(v), dtype=object)
    try:
        arr[:] = v
    except ValueError:   # list cells of one length, under an older numpy
        for i, x in enumerate(v):
            arr[i] = x
    return arr


def _is_nan(v: Any) -> bool:
    return isinstance(v, float) and v != v
