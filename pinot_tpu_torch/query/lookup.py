"""Lookup join: dimension tables fully resident per server + LOOKUP() transform.

Analog of `DimensionTableDataManager` (`pinot-core/.../data/manager/offline/
DimensionTableDataManager.java:50`) and `LookupTransformFunction`
(`core/operator/transform/function/LookupTransformFunction.java:65`):
a dimension table (small, replicated to every server) is loaded into a primary-key
hash map; `LOOKUP('dimTable', 'valueColumn', 'pkColumn', pkExpression, ...)` resolves
at scan time on the host path (strings/PK hashing are host-side work in the reference
scan path too).

A copy of `pinot_tpu/query/lookup.py`. `lookup` is not in `expr.DEVICE_FUNCS`,
so the planner sends every plan that holds it to the host, as it does
FROMDATETIME; `engine.expr` imports this module, so the function is
registered wherever the expression library is.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine.expr import register_function


class DimensionTable:
    """PK -> row mapping over fully materialized columns."""

    def __init__(self, name: str, pk_columns: Sequence[str],
                 columns: Dict[str, np.ndarray]):
        self.name = name
        self.pk_columns = list(pk_columns)
        self.columns = {c: np.asarray(v) for c, v in columns.items()}
        # a table built from zero segments has no columns at all; treat it as an
        # empty dim table (every lookup misses) instead of KeyError-ing on the pk
        pk_arrays = ([self.columns[c] for c in self.pk_columns]
                     if all(c in self.columns for c in self.pk_columns) else [])
        n = len(pk_arrays[0]) if pk_arrays else 0
        self._index: Dict[Tuple, int] = {}
        for i in range(n):
            # last write wins on duplicate PKs, matching the reference's map put
            self._index[tuple(_py(a[i]) for a in pk_arrays)] = i

    def lookup_rows(self, pk_tuples: List[Tuple]) -> np.ndarray:
        """Row index per key; -1 for missing keys."""
        idx = np.empty(len(pk_tuples), dtype=np.int64)
        get = self._index.get
        for i, k in enumerate(pk_tuples):
            idx[i] = get(k, -1)
        return idx


class DimensionTableRegistry:
    """Server-wide registry (reference: DimensionTableDataManager statics)."""

    def __init__(self) -> None:
        self._tables: Dict[str, DimensionTable] = {}
        self._lock = threading.RLock()

    def register(self, table: DimensionTable) -> None:
        with self._lock:
            self._tables[table.name] = table

    def unregister(self, name: str) -> None:
        with self._lock:
            self._tables.pop(name, None)

    def get(self, name: str) -> Optional[DimensionTable]:
        with self._lock:
            return self._tables.get(name)


# process-wide default registry (one server per process in the reference too)
REGISTRY = DimensionTableRegistry()


def register_dim_table_from_segments(name: str, pk_columns: Sequence[str],
                                     segments) -> DimensionTable:
    """Materialize every segment's columns into one dimension table."""
    columns: Dict[str, List[np.ndarray]] = {}
    col_names: Optional[List[str]] = None
    for seg in segments:
        col_names = col_names or list(seg.column_names)
        for c in col_names:
            columns.setdefault(c, []).append(np.asarray(seg.column(c).values()))
    merged = {c: (np.concatenate([a.astype(object) for a in arrs])
                  if any(a.dtype == object for a in arrs) else np.concatenate(arrs))
              for c, arrs in columns.items()} if columns else {}
    table = DimensionTable(name, pk_columns, merged)
    REGISTRY.register(table)
    return table


def _py(v: Any) -> Any:
    return v.item() if isinstance(v, np.generic) else v


@register_function("lookup")
def _lookup(xp, table_name, value_col, *pk_pairs):
    """LOOKUP('dimTable', 'valueCol', 'pk1', expr1[, 'pk2', expr2...]).

    Missing keys produce Python None (object-dtype output); when every key hits, the
    value column's native dtype is preserved. Mirrors the reference's null-handling
    on lookup misses."""
    if xp is not np:
        raise ValueError("LOOKUP is host-side only")
    name = str(table_name)
    table = REGISTRY.get(name)
    if table is None:
        raise ValueError(f"dimension table {name!r} is not loaded")
    if len(pk_pairs) % 2 != 0 or not pk_pairs:
        raise ValueError("LOOKUP needs ('pkColumn', expression) pairs")
    pk_cols = [str(pk_pairs[i]) for i in range(0, len(pk_pairs), 2)]
    if pk_cols != table.pk_columns:
        raise ValueError(f"LOOKUP pk columns {pk_cols} != table pk {table.pk_columns}")
    exprs = [np.asarray(pk_pairs[i]) for i in range(1, len(pk_pairs), 2)]
    n = max((len(e) for e in exprs if e.ndim), default=1)
    tuples = list(zip(*[
        [_py(v) for v in (e if e.ndim else np.full(n, e.item()))] for e in exprs]))
    rows = table.lookup_rows(tuples)
    if str(value_col) not in table.columns:  # zero-segment table: every key misses
        return np.full(n, None, dtype=object)
    values = table.columns[str(value_col)]
    missing = rows < 0
    safe = np.clip(rows, 0, max(len(values) - 1, 0))
    if not missing.any() and len(values):
        return values[safe]  # keep the column's native dtype when every key hits
    # misses present: surface them as None in an object array so hits keep their
    # native values (int stays int) and the same column is type-stable across
    # segments with and without misses
    out = (values[safe].astype(object) if len(values)
           else np.full(n, None, dtype=object))
    out[missing] = None
    return out
