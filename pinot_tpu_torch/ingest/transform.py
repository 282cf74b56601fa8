"""Record transform pipeline: type coercion of decoded row batches.

A trimmed copy of `pinot_tpu/ingest/transform.py` (the analog of the
reference's `CompositeTransformer`): the DataTypeTransformer step alone. The
JAX package's filter and expression transforms evaluate SQL expressions on
the host, whose evaluator this package does not have (ROADMAP queue 1 item
2): a pipeline that asks for either raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..schema import DataType, Schema


class TransformPipeline:
    """Coerces column batches (dict of lists or arrays) to the schema's types."""

    def __init__(self, schema: Schema, filter_expr: Optional[str] = None,
                 column_transforms: Optional[Dict[str, str]] = None):
        if filter_expr or column_transforms:
            raise NotImplementedError(
                "ingestion filters and column transforms need the host expression "
                "evaluator, which is not ported to pinot_tpu_torch")
        self.schema = schema

    def apply(self, columns: Dict[str, Any]) -> Dict[str, List[Any]]:
        """Schema columns only, each value coerced to its type, None kept as
        None (so that the segment records a null) and NaN read as null."""
        n = len(next(iter(columns.values()))) if columns else 0
        out: Dict[str, List[Any]] = {}
        for spec in self.schema.fields:
            vals = columns.get(spec.name)
            out[spec.name] = [None] * n if vals is None else _coerce_list(spec, list(vals))
        return out


def _coerce_list(spec, vals: list) -> list:
    """Typed values with None preserved. A numeric column takes one numpy cast
    through int64/float64 when every value is clean; BOOLEAN coerces by
    truthiness, so it never takes the cast."""
    dt = spec.data_type
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


def _is_nan(v: Any) -> bool:
    return isinstance(v, float) and v != v
