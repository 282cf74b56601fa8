"""Sorted dictionaries: value <-> dict-id mapping, and predicate -> dict-id resolution.

A copy of `pinot_tpu/segment/dictionary.py`, the analog of the reference's immutable dictionaries
(`pinot-segment-local/.../segment/index/readers/BaseImmutableDictionary.java` and the
per-type subclasses). Values are stored sorted, so:

* value -> id is binary search (`np.searchsorted`), exactly like the reference;
* range predicates resolve to **contiguous dict-id ranges** and equality/IN to id sets —
  the core trick that lets every predicate on a dict-encoded column become integer work on
  device (see `query/predicate.py`).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..schema import DataType


class Dictionary:
    """Immutable sorted dictionary over one column's distinct values.

    `values` is either a sorted 1-D numpy array (numeric types) or a sorted list of
    python strings (STRING/JSON) / bytes (BYTES).
    """

    def __init__(self, values: Union[np.ndarray, List[str], List[bytes]], data_type: DataType):
        self.data_type = data_type
        self.values = values
        self._is_numeric = isinstance(values, np.ndarray)
        if self._is_numeric:
            self._np_values = values
        else:
            # numpy array of objects for vectorized searchsorted on strings
            self._np_values = np.array(values, dtype=object)

    def __len__(self) -> int:
        return len(self.values)

    @property
    def cardinality(self) -> int:
        return len(self.values)

    # -- lookups -----------------------------------------------------------
    def get(self, dict_id: int) -> Any:
        """dict id -> value (reference: Dictionary.get)."""
        return self.values[dict_id]

    def take(self, dict_ids: np.ndarray) -> np.ndarray:
        """Vectorized dict decode: ids[n] -> values[n]."""
        return self._np_values[dict_ids]

    def index_of(self, value: Any) -> int:
        """value -> dict id, or -1 if absent (reference: Dictionary.indexOf)."""
        value = self._coerce(value)
        i = int(np.searchsorted(self._np_values, value))
        if i < len(self._np_values) and self._np_values[i] == value:
            return i
        return -1

    def insertion_index(self, value: Any, side: str = "left") -> int:
        value = self._coerce(value)
        return int(np.searchsorted(self._np_values, value, side=side))

    def _coerce(self, value: Any) -> Any:
        if self._is_numeric:
            # Only cast when lossless: a float predicate against an integer dictionary
            # must keep its fractional part so searchsorted places it *between* ids
            # (e.g. `x > 2.5` on INT must exclude 2) instead of truncating to a wrong id.
            cast = self._np_values.dtype.type(value)
            return cast if cast == value else value
        if self.data_type is DataType.BYTES and isinstance(value, str):
            return bytes.fromhex(value)
        return value if isinstance(value, (str, bytes)) else str(value)

    # -- predicate resolution (PredicateEvaluator analog) -------------------
    def id_range(self, lower: Optional[Any], upper: Optional[Any],
                 lower_inclusive: bool = True, upper_inclusive: bool = True) -> Tuple[int, int]:
        """Resolve a value range to a half-open dict-id range [lo, hi).

        Mirrors the reference's `RangePredicateEvaluatorFactory` dictionary-based path,
        which exploits the sorted dictionary to turn a value range into an id range.
        """
        lo = 0 if lower is None else self.insertion_index(lower, "left" if lower_inclusive else "right")
        hi = len(self) if upper is None else self.insertion_index(upper, "right" if upper_inclusive else "left")
        return lo, max(lo, hi)

    def ids_for_values(self, values: Sequence[Any]) -> np.ndarray:
        """IN-list -> sorted array of matching dict ids (absent values dropped)."""
        ids = [self.index_of(v) for v in values]
        return np.array(sorted(i for i in ids if i >= 0), dtype=np.int64)

    def ids_matching_regex(self, pattern: str) -> np.ndarray:
        """REGEXP_LIKE over the dictionary (reference: RegexpLikePredicateEvaluatorFactory).

        Runs the regex once per *distinct* value host-side; the scan itself stays on
        device as an id-set membership test.
        """
        rx = re.compile(pattern)
        if self._is_numeric:
            return np.array([i for i, v in enumerate(self.values) if rx.search(str(v))], dtype=np.int64)
        return np.array([i for i, v in enumerate(self.values) if isinstance(v, str) and rx.search(v)],
                        dtype=np.int64)

    def ids_matching_like(self, pattern: str) -> np.ndarray:
        """SQL LIKE -> regex over dictionary (%, _ wildcards)."""
        rx = "^" + "".join(
            ".*" if ch == "%" else "." if ch == "_" else re.escape(ch) for ch in pattern
        ) + "$"
        return self.ids_matching_regex(rx)

    @property
    def min_value(self) -> Any:
        return self.values[0] if len(self.values) else None

    @property
    def max_value(self) -> Any:
        return self.values[-1] if len(self.values) else None


def build_dictionary(raw: Union[np.ndarray, Sequence[Any]], data_type: DataType
                     ) -> Tuple[Dictionary, np.ndarray]:
    """Build a sorted dictionary + dict-id forward column from raw values.

    Analog of the reference's `SegmentDictionaryCreator`
    (`pinot-segment-local/.../creator/impl/SegmentDictionaryCreator.java`) fused with the
    stats-collection pass: `np.unique` gives sorted distinct values and inverse indices in
    one shot.
    """
    if data_type.is_numeric:
        arr = np.asarray(raw, dtype=data_type.numpy_dtype)
        values, inverse = np.unique(arr, return_inverse=True)
        return Dictionary(values, data_type), inverse.astype(np.int64)
    # strings/bytes/json: a hash set and one sort of the distinct values (the
    # same dictionary and ids as np.unique, without sorting every row's
    # Python object); cells that do not hash or order take np.unique
    objs = list(raw)
    try:
        uniq = sorted(set(objs))
    except TypeError:
        values_arr, inverse = np.unique(np.array(objs, dtype=object), return_inverse=True)
        return Dictionary(list(values_arr), data_type), inverse.astype(np.int64)
    index = {v: i for i, v in enumerate(uniq)}
    inverse = np.fromiter((index[v] for v in objs), dtype=np.int64, count=len(objs))
    return Dictionary(uniq, data_type), inverse
