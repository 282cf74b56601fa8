"""Pure-Python Avro: binary codec, object-container files, confluent stream wire.

Analog of the reference's flagship input format
(`pinot-plugins/pinot-input-format/pinot-avro/src/main/java/org/apache/pinot/
plugin/inputformat/avro/AvroRecordReader.java`) and its realtime decoders
(`SimpleAvroMessageDecoder`, `KafkaConfluentSchemaRegistryAvroMessageDecoder`
in `pinot-plugins/pinot-input-format/pinot-confluent-avro/`). Implemented
from the public Avro 1.11 specification — no avro library in this
environment: the wire format is produced and parsed entirely by this
module.

Supported schema subset (the verdict-scoped resolution subset): records,
all primitives (null/boolean/int/long/float/double/bytes/string), unions,
arrays, maps, enums, fixed. Schema resolution: reader-field defaults,
writer-field skipping, numeric promotion (int->long->float->double,
string<->bytes), union member resolution by branch type. Container codecs:
`null` and `deflate` (raw zlib); `snappy` is rejected loudly (no snappy in
this environment).

A copy of `pinot_tpu/ingest/avro.py`: the container files and confluent
frames it writes are the JAX package's, byte for byte.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Callable, Dict, Iterator, List, Optional, Tuple

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double",
               "bytes", "string"}


class AvroError(ValueError):
    pass


# ---------------------------------------------------------------------------
# schema model
# ---------------------------------------------------------------------------

def parse_schema(schema) -> Any:
    """JSON text/object -> normalized schema tree. Named types are registered
    so later references by name resolve (spec: named type references)."""
    if isinstance(schema, (str, bytes)):
        try:
            schema = json.loads(schema)
        except ValueError:
            schema = schema.decode() if isinstance(schema, bytes) else schema
            # a bare primitive name like "string" is a valid schema
    names: Dict[str, Any] = {}
    return _norm(schema, names)


def _norm(s, names: Dict[str, Any]):
    if isinstance(s, str):
        if s in _PRIMITIVES:
            return s
        if s in names:
            return names[s]
        raise AvroError(f"unknown schema name {s!r}")
    if isinstance(s, list):  # union
        return {"type": "union", "branches": [_norm(b, names) for b in s]}
    if not isinstance(s, dict):
        raise AvroError(f"bad schema node {s!r}")
    t = s.get("type")
    if t in _PRIMITIVES:
        # spec: unknown attributes on a type dict (logicalType,
        # avro.java.string, precision, ...) are ignored, never errors —
        # real Java-written files carry them
        return t
    if t == "record":
        node = {"type": "record", "name": s["name"], "fields": []}
        names[s["name"]] = node
        if s.get("namespace"):
            names[f"{s['namespace']}.{s['name']}"] = node
        for f in s["fields"]:
            fld = {"name": f["name"], "type": _norm(f["type"], names)}
            if "default" in f:
                fld["default"] = f["default"]
            node["fields"].append(fld)
        return node
    if t == "enum":
        node = {"type": "enum", "name": s["name"], "symbols": list(s["symbols"])}
        names[s["name"]] = node
        return node
    if t == "fixed":
        node = {"type": "fixed", "name": s["name"], "size": int(s["size"])}
        names[s["name"]] = node
        return node
    if t == "array":
        return {"type": "array", "items": _norm(s["items"], names)}
    if t == "map":
        return {"type": "map", "values": _norm(s["values"], names)}
    if isinstance(t, (list, dict)):
        return _norm(t, names)
    raise AvroError(f"unsupported schema type {t!r}")


def _type_of(s) -> str:
    return s if isinstance(s, str) else s["type"]


# ---------------------------------------------------------------------------
# binary codec (spec: zig-zag varint ints, little-endian IEEE floats,
# length-prefixed bytes/strings, block-encoded arrays/maps)
# ---------------------------------------------------------------------------

class BinaryEncoder:
    def __init__(self, out: Optional[io.BytesIO] = None):
        self.out = out if out is not None else io.BytesIO()

    def write_long(self, v: int) -> None:
        v = (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1  # zig-zag
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.write(bytes([b | 0x80]))
            else:
                self.out.write(bytes([b]))
                return

    def write_float(self, v: float) -> None:
        self.out.write(struct.pack("<f", v))

    def write_double(self, v: float) -> None:
        self.out.write(struct.pack("<d", v))

    def write_bytes(self, v: bytes) -> None:
        self.write_long(len(v))
        self.out.write(v)

    def getvalue(self) -> bytes:
        return self.out.getvalue()


class BinaryDecoder:
    def __init__(self, data) -> None:
        self.buf = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) \
            else data

    def _read(self, n: int) -> bytes:
        b = self.buf.read(n)
        if len(b) < n:
            raise AvroError("truncated avro data")
        return b

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            (b,) = self._read(1)
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 70:
                raise AvroError("varint too long")
        return (acc >> 1) ^ -(acc & 1)  # un-zig-zag

    def read_float(self) -> float:
        return struct.unpack("<f", self._read(4))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self._read(8))[0]

    def read_bytes(self) -> bytes:
        n = self.read_long()
        if n < 0:
            raise AvroError("negative byte length")
        return self._read(n)


def write_datum(enc: BinaryEncoder, schema, v: Any) -> None:
    t = _type_of(schema)
    if t == "null":
        if v is not None:
            raise AvroError(f"null schema got {v!r}")
    elif t == "boolean":
        enc.out.write(b"\x01" if v else b"\x00")
    elif t in ("int", "long"):
        enc.write_long(int(v))
    elif t == "float":
        enc.write_float(float(v))
    elif t == "double":
        enc.write_double(float(v))
    elif t == "bytes":
        enc.write_bytes(bytes(v))
    elif t == "string":
        enc.write_bytes(v.encode("utf-8"))
    elif t == "record":
        for f in schema["fields"]:
            write_datum(enc, f["type"], v.get(f["name"]) if isinstance(v, dict)
                        else getattr(v, f["name"]))
    elif t == "enum":
        enc.write_long(schema["symbols"].index(v))
    elif t == "fixed":
        if len(v) != schema["size"]:
            raise AvroError("fixed size mismatch")
        enc.out.write(bytes(v))
    elif t == "array":
        if v:
            enc.write_long(len(v))
            for item in v:
                write_datum(enc, schema["items"], item)
        enc.write_long(0)
    elif t == "map":
        if v:
            enc.write_long(len(v))
            for k, item in v.items():
                enc.write_bytes(k.encode("utf-8"))
                write_datum(enc, schema["values"], item)
        enc.write_long(0)
    elif t == "union":
        idx = _union_index(schema["branches"], v)
        enc.write_long(idx)
        write_datum(enc, schema["branches"][idx], v)
    else:
        raise AvroError(f"unsupported schema {t!r}")


def _union_index(branches, v) -> int:
    for i, b in enumerate(branches):
        bt = _type_of(b)
        if v is None and bt == "null":
            return i
        if isinstance(v, bool):
            if bt == "boolean":
                return i
            continue
        if isinstance(v, int) and bt in ("int", "long"):
            return i
        if isinstance(v, float) and bt in ("float", "double"):
            return i
        if isinstance(v, str) and bt in ("string", "enum"):
            return i
        if isinstance(v, (bytes, bytearray)) and bt in ("bytes", "fixed"):
            return i
        if isinstance(v, dict) and bt in ("record", "map"):
            return i
        if isinstance(v, (list, tuple)) and bt == "array":
            return i
    if isinstance(v, int) and not isinstance(v, bool):
        # promotion pass: an int encodes into a float/double-only union (the
        # read path promotes the same way; JSON whole numbers arrive as int)
        for i, b in enumerate(branches):
            if _type_of(b) in ("float", "double"):
                return i
    raise AvroError(f"no union branch for {type(v).__name__}")


def read_datum(dec: BinaryDecoder, writer, reader=None) -> Any:
    """Decode one datum written with `writer`, resolved to `reader` when given
    (spec: schema resolution — defaults, skipped fields, promotions)."""
    wt = _type_of(writer)
    if reader is not None and _type_of(reader) == "union" and wt != "union":
        # writer non-union read by union reader: resolve to the matching branch
        reader = _resolve_branch(reader["branches"], writer)
    if wt == "null":
        return None
    if wt == "boolean":
        return dec._read(1) != b"\x00"
    if wt in ("int", "long"):
        v = dec.read_long()
        if reader is not None and _type_of(reader) in ("float", "double"):
            return float(v)
        return v
    if wt == "float":
        return dec.read_float()
    if wt == "double":
        return dec.read_double()
    if wt == "bytes":
        raw = dec.read_bytes()
        if reader is not None and _type_of(reader) == "string":
            return raw.decode("utf-8")
        return raw
    if wt == "string":
        return dec.read_bytes().decode("utf-8")
    if wt == "record":
        reader_fields = ({f["name"]: f for f in reader["fields"]}
                         if reader is not None and _type_of(reader) == "record"
                         else None)
        out: Dict[str, Any] = {}
        for f in writer["fields"]:
            rf = reader_fields.get(f["name"]) if reader_fields is not None else None
            v = read_datum(dec, f["type"], rf["type"] if rf else None)
            if reader_fields is None or rf is not None:
                out[f["name"]] = v     # reader-absent writer fields are skipped
        if reader_fields is not None:
            for name, rf in reader_fields.items():
                if name not in out:
                    if "default" not in rf:
                        raise AvroError(f"missing field {name!r} has no default")
                    out[name] = rf["default"]
        return out
    if wt == "enum":
        idx = dec.read_long()
        try:
            return writer["symbols"][idx]
        except IndexError:
            raise AvroError(f"enum index {idx} out of range") from None
    if wt == "fixed":
        return dec._read(writer["size"])
    if wt == "array":
        items = writer["items"]
        ritems = (reader["items"] if reader is not None
                  and _type_of(reader) == "array" else None)
        out_list: List[Any] = []
        while True:
            n = dec.read_long()
            if n == 0:
                return out_list
            if n < 0:  # negative count: block byte size follows (spec)
                n = -n
                dec.read_long()
            for _ in range(n):
                out_list.append(read_datum(dec, items, ritems))
    if wt == "map":
        values = writer["values"]
        rvalues = (reader["values"] if reader is not None
                   and _type_of(reader) == "map" else None)
        out_map: Dict[str, Any] = {}
        while True:
            n = dec.read_long()
            if n == 0:
                return out_map
            if n < 0:
                n = -n
                dec.read_long()
            for _ in range(n):
                k = dec.read_bytes().decode("utf-8")
                out_map[k] = read_datum(dec, values, rvalues)
    if wt == "union":
        idx = dec.read_long()
        try:
            branch = writer["branches"][idx]
        except IndexError:
            raise AvroError(f"union index {idx} out of range") from None
        rbranch = None
        if reader is not None:
            rb = reader["branches"] if _type_of(reader) == "union" else [reader]
            try:
                rbranch = _resolve_branch(rb, branch)
            except AvroError:
                rbranch = None
        return read_datum(dec, branch, rbranch)
    raise AvroError(f"unsupported schema {wt!r}")


def _resolve_branch(branches, writer):
    wt = _type_of(writer)
    promotions = {"int": {"int", "long", "float", "double"},
                  "long": {"long", "float", "double"},
                  "float": {"float", "double"},
                  "string": {"string", "bytes"},
                  "bytes": {"bytes", "string"}}
    for b in branches:
        if _type_of(b) == wt:
            return b
    for b in branches:
        if _type_of(b) in promotions.get(wt, ()):
            return b
    raise AvroError(f"no reader branch for writer type {wt!r}")


# ---------------------------------------------------------------------------
# object container files (spec: magic, metadata map, sync-delimited blocks)
# ---------------------------------------------------------------------------

class AvroFileWriter:
    def __init__(self, path: str, schema, codec: str = "null",
                 sync_interval: int = 4000):
        if codec not in ("null", "deflate"):
            raise AvroError(f"unsupported codec {codec!r}")
        self.schema = parse_schema(schema)
        self._schema_json = (schema if isinstance(schema, str)
                             else json.dumps(schema))
        self.codec = codec
        self.sync = os.urandom(SYNC_SIZE)
        self.sync_interval = sync_interval
        self._f: BinaryIO = open(path, "wb")
        self._buf = BinaryEncoder()
        self._count = 0
        header = BinaryEncoder()
        header.out.write(MAGIC)
        write_datum(header, {"type": "map", "values": "bytes"},
                    {"avro.schema": self._schema_json.encode(),
                     "avro.codec": self.codec.encode()})
        header.out.write(self.sync)
        self._f.write(header.getvalue())

    def append(self, record: Dict[str, Any]) -> None:
        write_datum(self._buf, self.schema, record)
        self._count += 1
        if self._count >= self.sync_interval:
            self._flush_block()

    def _flush_block(self) -> None:
        if not self._count:
            return
        payload = self._buf.getvalue()
        if self.codec == "deflate":
            payload = zlib.compress(payload)[2:-4]  # raw deflate (spec)
        head = BinaryEncoder()
        head.write_long(self._count)
        head.write_long(len(payload))
        self._f.write(head.getvalue())
        self._f.write(payload)
        self._f.write(self.sync)
        self._buf = BinaryEncoder()
        self._count = 0

    def close(self) -> None:
        self._flush_block()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AvroFileReader:
    """Streams records out of an .avro object-container file; an optional
    `reader_schema` resolves against the file's writer schema."""

    def __init__(self, path: str, reader_schema=None):
        self._f = open(path, "rb")
        if self._f.read(4) != MAGIC:
            self._f.close()
            raise AvroError(f"{path}: not an avro object-container file")
        dec = BinaryDecoder(self._f)
        meta = read_datum(dec, {"type": "map", "values": "bytes"})
        self.codec = meta.get("avro.codec", b"null").decode()
        if self.codec not in ("null", "deflate"):
            self._f.close()
            raise AvroError(f"unsupported codec {self.codec!r} "
                            f"(null/deflate only in this environment)")
        self.writer_schema = parse_schema(meta["avro.schema"].decode())
        self.reader_schema = (parse_schema(reader_schema)
                              if reader_schema is not None else None)
        self.sync = self._f.read(SYNC_SIZE)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            head = self._f.read(1)
            if not head:
                return
            self._f.seek(-1, 1)
            dec = BinaryDecoder(self._f)
            count = dec.read_long()
            size = dec.read_long()
            payload = self._f.read(size)
            if len(payload) < size:
                raise AvroError("truncated avro block")
            if self.codec == "deflate":
                payload = zlib.decompress(payload, wbits=-15)
            block = BinaryDecoder(payload)
            for _ in range(count):
                yield read_datum(block, self.writer_schema, self.reader_schema)
            if self._f.read(SYNC_SIZE) != self.sync:
                raise AvroError("sync marker mismatch (corrupt avro file)")

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# RecordReader plugin (batch ingestion of .avro files)
# ---------------------------------------------------------------------------

class AvroRecordReader:
    """Reference: `pinot-avro/.../AvroRecordReader.java` — streams GenericRow
    dicts out of an object-container file. Restartable like every other
    RecordReader: each rows() call opens a fresh pass over the file (the
    streaming batch runner's stats-then-write shape re-iterates readers)."""

    def __init__(self, path: str):
        self.path = path
        AvroFileReader(path).close()   # validate magic/codec eagerly
        self._open: List[AvroFileReader] = []

    def rows(self) -> Iterator[Dict[str, Any]]:
        reader = AvroFileReader(self.path)
        self._open.append(reader)
        return iter(reader)

    def close(self) -> None:
        for r in self._open:
            r.close()
        self._open = []


# ---------------------------------------------------------------------------
# confluent-style stream wire + decoders
# ---------------------------------------------------------------------------

class LocalSchemaRegistry:
    """In-process schema registry (the schema-registry-server analog for
    confluent-framed streams): id -> parsed schema. Thread-safe: concurrent
    producers must never be issued the same id."""

    def __init__(self):
        import threading
        self._by_id: Dict[int, Any] = {}
        self._next = 1
        self._lock = threading.Lock()

    def register(self, schema) -> int:
        parsed = parse_schema(schema)
        with self._lock:
            sid = self._next
            self._next += 1
            self._by_id[sid] = parsed
        return sid

    def get(self, schema_id: int):
        s = self._by_id.get(schema_id)
        if s is None:
            raise AvroError(f"unknown schema id {schema_id}")
        return s


DEFAULT_REGISTRY = LocalSchemaRegistry()


_PARSE_CACHE: Dict[str, Any] = {}


def _parse_cached(schema) -> Any:
    key = schema if isinstance(schema, str) else json.dumps(schema,
                                                            sort_keys=True)
    parsed = _PARSE_CACHE.get(key)
    if parsed is None:
        if len(_PARSE_CACHE) > 256:
            _PARSE_CACHE.clear()
        parsed = _PARSE_CACHE[key] = parse_schema(schema)
    return parsed


def encode_confluent(schema_id: int, schema, record: Dict[str, Any]) -> bytes:
    """Confluent wire format: magic 0x00 | schema-id u32 BE | avro binary
    (reference: KafkaConfluentSchemaRegistryAvroMessageDecoder's input).
    `schema` is JSON text/object (parse memoized — this is the per-message
    produce path)."""
    enc = BinaryEncoder()
    enc.out.write(b"\x00")
    enc.out.write(struct.pack(">I", schema_id))
    write_datum(enc, _parse_cached(schema), record)
    return enc.getvalue()


def confluent_avro_decoder(value: Any,
                           registry: Optional[LocalSchemaRegistry] = None
                           ) -> Dict[str, Any]:
    """StreamMessageDecoder: confluent-framed avro message bytes -> row dict."""
    reg = registry if registry is not None else DEFAULT_REGISTRY
    data = bytes(value)
    if not data or data[0] != 0:
        raise AvroError("not a confluent-framed avro message (magic != 0)")
    if len(data) < 5:
        raise AvroError("truncated confluent header")
    (schema_id,) = struct.unpack(">I", data[1:5])
    return read_datum(BinaryDecoder(data[5:]), reg.get(schema_id))


def make_simple_avro_decoder(schema) -> Callable[[Any], Dict[str, Any]]:
    """Decoder closure for a FIXED schema with no framing (reference:
    SimpleAvroMessageDecoder with the schema in the table's stream config)."""
    parsed = parse_schema(schema)

    def decode(value: Any) -> Dict[str, Any]:
        return read_datum(BinaryDecoder(bytes(value)), parsed)
    return decode


# registration lives in the SPI modules (readers.py / stream.py) as lazy
# factories, so `reader_for("x.avro")` and decoder "avro" work without an
# explicit import of this module anywhere
