"""Table schema model: typed field specs for dimensions, metrics and time columns.

A copy of `pinot_tpu/schema.py` (itself modelled on the reference's
`pinot-spi/.../data/Schema.java` and `FieldSpec.java`), kept here so that
`pinot_tpu_torch` imports nothing of the JAX package. Every field declares a
fixed-width *storage dtype* so a column can live in device memory as a dense
tensor; STRING/BYTES/JSON columns are always dictionary-encoded and their
device form is an int32 dict-id tensor.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np


class DataType(Enum):
    """Logical column types (reference: FieldSpec.DataType)."""

    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BOOLEAN = "BOOLEAN"
    TIMESTAMP = "TIMESTAMP"  # epoch millis, stored as int64
    STRING = "STRING"
    JSON = "JSON"
    BYTES = "BYTES"

    @property
    def is_numeric(self) -> bool:
        return self in (DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE,
                        DataType.BOOLEAN, DataType.TIMESTAMP)

    @property
    def numpy_dtype(self) -> np.dtype:
        """Host/disk representation of *raw* (non-dict-encoded) values."""
        return {
            DataType.INT: np.dtype(np.int32),
            DataType.LONG: np.dtype(np.int64),
            DataType.FLOAT: np.dtype(np.float32),
            DataType.DOUBLE: np.dtype(np.float64),
            DataType.BOOLEAN: np.dtype(np.int32),
            DataType.TIMESTAMP: np.dtype(np.int64),
            DataType.STRING: np.dtype(object),
            DataType.JSON: np.dtype(object),
            DataType.BYTES: np.dtype(object),
        }[self]

    @property
    def default_null(self) -> Any:
        """Default placeholder for nulls (reference: FieldSpec default null values)."""
        return {
            DataType.INT: -(2 ** 31),
            DataType.LONG: -(2 ** 63),
            DataType.FLOAT: float("-inf"),
            DataType.DOUBLE: float("-inf"),
            DataType.BOOLEAN: 0,
            DataType.TIMESTAMP: 0,
            DataType.STRING: "null",
            DataType.JSON: "null",
            DataType.BYTES: b"",
        }[self]


    def coerce(self, value: Any) -> Any:
        """Coerce an ingested Python value to this type (the reference's
        DataTypeTransformer); None becomes the type's default null."""
        if value is None:
            return self.default_null
        if self in (DataType.INT, DataType.LONG, DataType.TIMESTAMP):
            return int(value)
        if self in (DataType.FLOAT, DataType.DOUBLE):
            return float(value)
        if self is DataType.BOOLEAN:
            if isinstance(value, str):
                return 1 if value.lower() in ("true", "1", "t", "yes") else 0
            return int(bool(value))
        if self is DataType.BYTES:
            return bytes.fromhex(value) if isinstance(value, str) else bytes(value)
        if self is DataType.JSON:
            return value if isinstance(value, str) else json.dumps(value)
        return str(value)


class FieldRole(Enum):
    """Reference: FieldSpec.FieldType (DIMENSION / METRIC / DATE_TIME)."""

    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    DATE_TIME = "DATE_TIME"


@dataclass
class FieldSpec:
    name: str
    data_type: DataType
    role: FieldRole = FieldRole.DIMENSION
    single_value: bool = True
    # DATE_TIME metadata (reference: DateTimeFieldSpec format/granularity)
    format: Optional[str] = None
    granularity: Optional[str] = None
    default_null_value: Optional[Any] = None

    @property
    def null_value(self) -> Any:
        if self.default_null_value is not None:
            return self.default_null_value
        # Metrics default to 0 (reference: FieldSpec.DEFAULT_METRIC_NULL_VALUE_OF_*) so a
        # null-filled metric can't poison SUM/MIN; dimensions use type sentinels.
        if self.role is FieldRole.METRIC and self.data_type.is_numeric:
            return 0 if self.data_type.numpy_dtype.kind == "i" else 0.0
        return self.data_type.default_null

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "dataType": self.data_type.value,
            "role": self.role.value,
            "singleValue": self.single_value,
        }
        if self.format:
            d["format"] = self.format
        if self.granularity:
            d["granularity"] = self.granularity
        if self.default_null_value is not None:
            d["defaultNullValue"] = self.default_null_value
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "FieldSpec":
        return FieldSpec(
            name=d["name"],
            data_type=DataType(d["dataType"]),
            role=FieldRole(d.get("role", "DIMENSION")),
            single_value=d.get("singleValue", True),
            format=d.get("format"),
            granularity=d.get("granularity"),
            default_null_value=d.get("defaultNullValue"),
        )


@dataclass
class Schema:
    """Reference: pinot-spi Schema (JSON-serialized, stored in the catalog)."""

    name: str
    fields: List[FieldSpec] = field(default_factory=list)
    primary_key_columns: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._by_name = {f.name: f for f in self.fields}
        if len(self._by_name) != len(self.fields):
            raise ValueError(f"duplicate column names in schema {self.name}")

    # -- accessors ---------------------------------------------------------
    def field_spec(self, name: str) -> FieldSpec:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"unknown column {name!r} in schema {self.name}") from None

    def has_column(self, name: str) -> bool:
        return name in self._by_name

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.fields]

    # -- serde -------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "schemaName": self.name,
            "fields": [f.to_json() for f in self.fields],
            "primaryKeyColumns": self.primary_key_columns,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Schema":
        fields = [FieldSpec.from_json(f) for f in d.get("fields", [])]
        if not fields:
            # accept the reference's schema JSON layout too
            # (dimensionFieldSpecs / metricFieldSpecs / dateTimeFieldSpecs),
            # so schemas written for Apache Pinot load unchanged
            for key, role in (("dimensionFieldSpecs", FieldRole.DIMENSION),
                              ("metricFieldSpecs", FieldRole.METRIC),
                              ("dateTimeFieldSpecs", FieldRole.DATE_TIME)):
                for f in d.get(key, []):
                    fields.append(FieldSpec(
                        name=f["name"],
                        data_type=DataType(f["dataType"]),
                        role=role,
                        single_value=f.get("singleValueField", True),
                        format=f.get("format"),
                        granularity=f.get("granularity"),
                        default_null_value=f.get("defaultNullValue"),
                    ))
        return Schema(
            name=d["schemaName"],
            fields=fields,
            primary_key_columns=d.get("primaryKeyColumns", []),
        )


def normalize_mv_cell(spec: FieldSpec, v: Any):
    """(values list, is_null) of one multi-value cell: the one normalization
    of the batch writer and the consuming segment, so both store the same
    values. A None or empty cell is one default null value (Pinot's MV null is
    a one-element array); a scalar is wrapped; each element is coerced."""
    if v is None or (hasattr(v, "__len__") and len(v) == 0
                     and not isinstance(v, (str, bytes))):
        return [spec.null_value], True
    if isinstance(v, (list, tuple, np.ndarray)):
        return [spec.data_type.coerce(x) for x in v], False
    return [spec.data_type.coerce(v)], False


# what DataType.coerce does to a value that is not None, where that is one
# builtin call
_MV_CASTS = {"INT": int, "LONG": int, "TIMESTAMP": int, "FLOAT": float, "DOUBLE": float,
             "STRING": str}


def normalize_mv_column(spec: FieldSpec, cells) -> tuple:
    """`normalize_mv_cell` over a column's cells at once: (every row's values
    concatenated, int64 values a row, bool null rows). The values are a
    numpy array in the type's storage dtype (object for strings). Cells that
    are all lists (or None) of non-None values take one pass per column;
    any other cell sends the column through `normalize_mv_cell` cell by cell,
    with the same result."""
    cells = list(cells)
    n = len(cells)
    dt = spec.data_type
    cast = _MV_CASTS.get(dt.value)
    flat = None
    if cast is not None and all(type(v) is list or v is None for v in cells):
        counts = np.fromiter((0 if v is None else len(v) for v in cells), np.int64, n)
        flat = list(itertools.chain.from_iterable(v for v in cells if v))
        if None in flat:
            flat = None
        else:
            flat = list(map(cast, flat))
    if flat is None:
        normalized = [normalize_mv_cell(spec, v) for v in cells]
        counts = np.fromiter((0 if null else len(vals) for vals, null in normalized),
                             np.int64, n)
        flat = [x for vals, null in normalized if not null for x in vals]
    values = np.empty(len(flat), dtype=object)
    values[:] = flat
    nulls = counts == 0
    if nulls.any():
        # each null row holds the one default null value, at its offset
        starts = np.cumsum(counts) - counts
        values = np.insert(values, starts[nulls], spec.null_value)
        counts[nulls] = 1
    if dt.is_numeric:
        values = values.astype(dt.numpy_dtype)
    return values, counts, nulls


def dimension(name: str, data_type: DataType = DataType.STRING, **kw) -> FieldSpec:
    return FieldSpec(name, data_type, FieldRole.DIMENSION, **kw)


def metric(name: str, data_type: DataType = DataType.DOUBLE, **kw) -> FieldSpec:
    return FieldSpec(name, data_type, FieldRole.METRIC, **kw)


def date_time(name: str, data_type: DataType = DataType.TIMESTAMP, **kw) -> FieldSpec:
    return FieldSpec(name, data_type, FieldRole.DATE_TIME, **kw)
