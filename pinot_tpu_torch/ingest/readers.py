"""Record readers: pluggable input formats -> row dicts.

Analog of the reference's record I/O SPI (`pinot-spi/.../data/readers/RecordReader.java`,
`GenericRow`, `RecordReaderFactory`) and the input-format plugins
(`pinot-plugins/pinot-input-format/`: csv/json/parquet/avro/...). Rows are plain dicts
(GenericRow analog); readers are iterators so batch jobs stream arbitrarily large files.

A copy of `pinot_tpu/ingest/readers.py`. The Parquet and ORC readers import
pandas and pyarrow when they read, and the Avro, Protobuf and Thrift readers
load their codec modules when they are made, so importing this module needs
neither.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

from ..schema import Schema


class RecordReader:
    def rows(self) -> Iterator[Dict[str, Any]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CsvRecordReader(RecordReader):
    def __init__(self, path: str, delimiter: str = ","):
        self.path = path
        self.delimiter = delimiter

    def rows(self) -> Iterator[Dict[str, Any]]:
        with open(self.path, newline="") as f:
            for row in csv.DictReader(f, delimiter=self.delimiter):
                yield {k: (v if v != "" else None) for k, v in row.items()}


class JsonLineRecordReader(RecordReader):
    def __init__(self, path: str):
        self.path = path

    def rows(self) -> Iterator[Dict[str, Any]]:
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


class ParquetRecordReader(RecordReader):
    """Via pandas; requires a parquet engine in the environment (gated)."""

    def __init__(self, path: str):
        self.path = path

    def rows(self) -> Iterator[Dict[str, Any]]:
        import pandas as pd
        try:
            frame = pd.read_parquet(self.path)
        except ImportError as e:
            raise RuntimeError("no parquet engine available in this environment") from e
        for rec in frame.to_dict(orient="records"):
            yield rec


class OrcRecordReader(RecordReader):
    """ORC via pyarrow (reference: pinot-orc/.../ORCRecordReader.java);
    streams stripe batches, never the whole file."""

    def __init__(self, path: str):
        self.path = path

    def rows(self) -> Iterator[Dict[str, Any]]:
        try:
            import pyarrow.orc as orc
        except ImportError as e:
            raise RuntimeError("pyarrow ORC support unavailable") from e
        f = orc.ORCFile(self.path)
        for si in range(f.nstripes):
            for rec in f.read_stripe(si).to_pylist():
                yield rec


class DictRecordReader(RecordReader):
    """In-memory rows (tests, realtime decoding output)."""

    def __init__(self, records: Sequence[Dict[str, Any]]):
        self.records = records

    def rows(self) -> Iterator[Dict[str, Any]]:
        return iter(self.records)


def _avro_reader(path: str) -> RecordReader:
    from .avro import AvroRecordReader   # lazy: avro codec loads on demand
    return AvroRecordReader(path)


def _proto_reader(path: str) -> RecordReader:
    from .proto import ProtoRecordReader   # lazy; sidecar <path>.desc schema
    return ProtoRecordReader(path)


def _thrift_reader(path: str) -> RecordReader:
    from .thriftfmt import ThriftRecordReader   # lazy; <path>.thrift sidecar
    return ThriftRecordReader(path)


_READERS: Dict[str, Callable[[str], RecordReader]] = {
    "csv": CsvRecordReader,
    "json": JsonLineRecordReader,
    "jsonl": JsonLineRecordReader,
    "parquet": ParquetRecordReader,
    "orc": OrcRecordReader,
    "avro": _avro_reader,
    "pb": _proto_reader,
    "protobuf": _proto_reader,
    "thrift": _thrift_reader,
}


def register_reader(fmt: str, factory: Callable[[str], RecordReader]) -> None:
    """Plugin hook (reference: RecordReaderFactory registration)."""
    _READERS[fmt.lower()] = factory


def reader_for(path: str, fmt: Optional[str] = None) -> RecordReader:
    fmt = (fmt or os.path.splitext(path)[1].lstrip(".")).lower()
    if fmt not in _READERS:
        raise ValueError(f"no record reader for format {fmt!r}")
    return _READERS[fmt](path)


def rows_to_columns(rows: Sequence[Dict[str, Any]], schema: Schema) -> Dict[str, List[Any]]:
    """Pivot row dicts into column lists ordered by the schema."""
    cols: Dict[str, List[Any]] = {f.name: [] for f in schema.fields}
    for row in rows:
        for f in schema.fields:
            cols[f.name].append(row.get(f.name))
    return cols
