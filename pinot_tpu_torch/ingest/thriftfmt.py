"""Pure-Python Thrift: TBinaryProtocol codec + a .thrift IDL struct parser.

Analog of the reference's thrift input format
(`pinot-plugins/pinot-input-format/pinot-thrift/src/main/java/org/apache/
pinot/plugin/inputformat/thrift/ThriftRecordReader.java` — reads
back-to-back TBinaryProtocol-serialized structs from a file using a
generated thrift class). No generated classes here: field names come from a
parsed .thrift IDL subset (structs, enums, typedefs, base types,
list/set/map, nested structs) and values decode generically from the wire.

TBinaryProtocol (strict and non-strict struct bodies are identical): a
struct is a sequence of `type:i8 field-id:i16 value` entries terminated by
STOP(0). TCompactProtocol is not implemented (the reference's reader
defaults to binary too).

A copy of `pinot_tpu/ingest/thriftfmt.py`: the structs it writes are the
JAX package's, byte for byte.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

# TBinaryProtocol type ids
T_STOP, T_BOOL, T_BYTE, T_DOUBLE = 0, 2, 3, 4
T_I16, T_I32, T_I64, T_STRING = 6, 8, 10, 11
T_STRUCT, T_MAP, T_SET, T_LIST = 12, 13, 14, 15

_BASE_TYPES = {
    "bool": T_BOOL, "byte": T_BYTE, "i8": T_BYTE, "double": T_DOUBLE,
    "i16": T_I16, "i32": T_I32, "i64": T_I64, "string": T_STRING,
    "binary": T_STRING,
}


class ThriftError(ValueError):
    pass


# ---------------------------------------------------------------------------
# IDL subset parser
# ---------------------------------------------------------------------------

class ThriftField:
    __slots__ = ("fid", "name", "ttype", "spec")

    def __init__(self, fid: int, name: str, ttype: int, spec: str):
        self.fid = fid
        self.name = name
        self.ttype = ttype      # wire type id
        self.spec = spec        # resolved IDL type spec ("i64", "map<K,V>", ...)


_CONTAINER_RE = re.compile(r"(list|set|map)\s*<\s*(.*)\s*>$")


def _split_container(spec: str):
    """'list<X>'/'set<X>' -> (kind, None, X); 'map<K,V>' -> ('map', K, V);
    None for non-containers. Splits the map comma at top nesting level."""
    m = _CONTAINER_RE.fullmatch(spec.strip())
    if not m:
        return None
    kind, inner = m.group(1), m.group(2)
    if kind in ("list", "set"):
        return kind, None, inner.strip()
    depth = 0
    for i, ch in enumerate(inner):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "," and depth == 0:
            return "map", inner[:i].strip(), inner[i + 1:].strip()
    raise ThriftError(f"bad map spec {spec!r}")


class ThriftStruct:
    def __init__(self, name: str):
        self.name = name
        self.fields: Dict[int, ThriftField] = {}


class ThriftIDL:
    """Parsed .thrift schema: structs + enums (typedefs resolved inline)."""

    def __init__(self, source: str):
        self.structs: Dict[str, ThriftStruct] = {}
        self.enums: Dict[str, Dict[int, str]] = {}
        self.typedefs: Dict[str, str] = {}
        src = re.sub(r"//[^\n]*|#[^\n]*", "", source)
        src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
        for m in re.finditer(r"typedef\s+(\S+)\s+(\w+)", src):
            self.typedefs[m.group(2)] = m.group(1)
        for m in re.finditer(r"enum\s+(\w+)\s*\{([^}]*)\}", src):
            values: Dict[int, str] = {}
            auto = 0
            for item in m.group(2).split(","):
                item = item.strip().rstrip(";").strip()
                if not item:
                    continue
                if "=" in item:
                    nm, _, num = item.partition("=")
                    auto = int(num.strip(), 0)
                    values[auto] = nm.strip()
                else:
                    values[auto] = item
                auto += 1
            self.enums[m.group(1)] = values
        for m in re.finditer(r"struct\s+(\w+)\s*\{([^}]*)\}", src):
            st = ThriftStruct(m.group(1))
            body = m.group(2)
            # the type is either a container with (one level of nested)
            # generics matched as a UNIT, or a plain name — a lazy char class
            # would split "map<string, double>" at the comma
            for fm in re.finditer(
                    r"(\d+)\s*:\s*(?:required\s+|optional\s+)?"
                    r"([\w\.]+\s*<(?:[^<>]|<[^<>]*>)*>|[\w\.]+)"
                    r"\s+(\w+)\s*(?:=[^;,]+)?[;,]?", body):
                fid = int(fm.group(1))
                st.fields[fid] = self._field(fid, fm.group(2).strip(),
                                             fm.group(3))
            self.structs[st.name] = st

    def _resolve(self, tname: str) -> str:
        seen = set()
        while tname in self.typedefs and tname not in seen:
            seen.add(tname)
            tname = self.typedefs[tname]
        return tname

    def _field(self, fid: int, tname: str, fname: str) -> ThriftField:
        tname = self._resolve(tname)
        parts = _split_container(tname)
        if parts:
            ttype = {"list": T_LIST, "set": T_SET, "map": T_MAP}[parts[0]]
            return ThriftField(fid, fname, ttype, tname)
        if tname in _BASE_TYPES:
            return ThriftField(fid, fname, _BASE_TYPES[tname], tname)
        if tname in self.enums:
            return ThriftField(fid, fname, T_I32, tname)
        # struct reference (possibly forward): resolved at decode time
        return ThriftField(fid, fname, T_STRUCT, tname)

    def struct(self, name: str) -> ThriftStruct:
        st = self.structs.get(name)
        if st is None:
            raise ThriftError(f"unknown struct {name!r} "
                              f"(have {sorted(self.structs)})")
        return st


def _wire_type(idl: ThriftIDL, tname: str) -> int:
    tname = idl._resolve(tname)
    if tname in _BASE_TYPES:
        return _BASE_TYPES[tname]
    if tname in idl.enums:
        return T_I32
    if tname in idl.structs:
        return T_STRUCT
    lm = re.fullmatch(r"(list|set)\s*<.*>", tname)
    if lm:
        return T_LIST if lm.group(1) == "list" else T_SET
    if re.fullmatch(r"map\s*<.*>", tname):
        return T_MAP
    raise ThriftError(f"unknown thrift type {tname!r}")


# ---------------------------------------------------------------------------
# TBinaryProtocol decode (spec: big-endian fixed-width everything)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, f):
        self.f = f

    def take(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) < n:
            raise ThriftError("truncated thrift data")
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def double(self) -> float:
        return struct.unpack(">d", self.take(8))[0]

    def binary(self) -> bytes:
        n = self.i32()
        if n < 0:
            raise ThriftError("negative thrift string length")
        return self.take(n)


_SKIP_STACK_CAP = 10_000


def _skip(r: _Reader, ttype: int) -> None:
    """Skip one value of a wire type (unknown fields, like generated code).

    ITERATIVE with an explicit work stack: nesting depth is wire-controlled
    (a few bytes per level of hostile input), so recursion would die with
    RecursionError — outside the ThriftError contract bad-record handlers
    catch. Container sizes are validated like the decode path (a negative
    count would silently misalign the stream into garbage fields)."""
    stack: List[Tuple] = [("val", ttype)]
    while stack:
        if len(stack) > _SKIP_STACK_CAP:
            raise ThriftError("thrift nesting too deep")
        frame = stack.pop()
        kind = frame[0]
        if kind == "val":
            t = frame[1]
            if t in (T_BOOL, T_BYTE):
                r.take(1)
            elif t == T_I16:
                r.take(2)
            elif t == T_I32:
                r.take(4)
            elif t in (T_I64, T_DOUBLE):
                r.take(8)
            elif t == T_STRING:
                r.binary()
            elif t == T_STRUCT:
                stack.append(("struct",))
            elif t in (T_LIST, T_SET):
                et = r.i8()
                n = r.i32()
                if n < 0:
                    raise ThriftError("negative thrift container size")
                stack.append(("rep", et, None, n))
            elif t == T_MAP:
                kt = r.i8()
                vt = r.i8()
                n = r.i32()
                if n < 0:
                    raise ThriftError("negative thrift map size")
                stack.append(("rep", kt, vt, n))
            else:
                raise ThriftError(f"bad thrift type {t}")
        elif kind == "struct":
            ft = r.i8()
            if ft != T_STOP:
                r.i16()
                stack.append(frame)          # resume this struct afterwards
                stack.append(("val", ft))
        else:  # ("rep", t1, t2|None, remaining)
            _, t1, t2, n = frame
            if n:
                stack.append(("rep", t1, t2, n - 1))
                if t2 is not None:
                    stack.append(("val", t2))
                stack.append(("val", t1))


def _decode_value(idl: ThriftIDL, r: _Reader, ttype: int,
                  spec: Optional[str]):
    """Decode one value; `spec` is the resolved IDL type spec of THIS value
    (None = untyped — struct names and nested container shapes come from it)."""
    if ttype == T_BOOL:
        return r.take(1) != b"\x00"
    if ttype == T_BYTE:
        return r.i8()
    if ttype == T_DOUBLE:
        return r.double()
    if ttype == T_I16:
        return r.i16()
    if ttype == T_I32:
        return r.i32()
    if ttype == T_I64:
        return r.i64()
    if ttype == T_STRING:
        raw = r.binary()
        return raw if spec == "binary" else raw.decode("utf-8")
    if ttype == T_STRUCT:
        if spec and spec in idl.structs:
            return decode_struct(idl, idl.struct(spec), r)
        _skip(r, T_STRUCT)
        return None
    parts = _split_container(idl._resolve(spec)) if spec else None
    if ttype in (T_LIST, T_SET):
        et = r.i8()
        n = r.i32()
        if n < 0:
            raise ThriftError("negative thrift container size")
        espec = parts[2] if parts else None
        return [_decode_value(idl, r, et, espec) for _ in range(n)]
    if ttype == T_MAP:
        kt = r.i8()
        vt = r.i8()
        n = r.i32()
        if n < 0:
            raise ThriftError("negative thrift map size")
        kspec = parts[1] if parts else None
        vspec = parts[2] if parts else None
        out = {}
        for _ in range(n):
            k = _decode_value(idl, r, kt, kspec)
            out[k] = _decode_value(idl, r, vt, vspec)
        return out
    raise ThriftError(f"bad thrift type {ttype}")


def decode_struct(idl: ThriftIDL, st: ThriftStruct, r: _Reader
                  ) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    while True:
        ftype = r.i8()
        if ftype == T_STOP:
            return out
        fid = r.i16()
        f = st.fields.get(fid)
        if f is None or (f.ttype != ftype
                         and not (f.ttype in (T_LIST, T_SET)
                                  and ftype in (T_LIST, T_SET))):
            _skip(r, ftype)   # unknown/evolved field: skipped like generated code
            continue
        out[f.name] = _decode_value(idl, r, ftype, f.spec)


# ---------------------------------------------------------------------------
# TBinaryProtocol encode (tests + datagen)
# ---------------------------------------------------------------------------

def encode_struct(idl: ThriftIDL, st: ThriftStruct, row: Dict[str, Any]
                  ) -> bytes:
    out = bytearray()

    def enc_spec(spec: str, v) -> bytes:
        """Value bytes for a resolved type SPEC (containers nest naturally)."""
        spec = idl._resolve(spec)
        parts = _split_container(spec)
        if parts:
            kind, kspec, espec = parts
            if kind == "map":
                kt = _wire_type(idl, kspec)
                vt = _wire_type(idl, espec)
                body = b"".join(enc_spec(kspec, k) + enc_spec(espec, mv)
                                for k, mv in v.items())
                return struct.pack(">bbi", kt, vt, len(v)) + body
            et = _wire_type(idl, espec)
            body = b"".join(enc_spec(espec, item) for item in v)
            return struct.pack(">bi", et, len(v)) + body
        if spec in idl.structs:
            return encode_struct(idl, idl.struct(spec), v)
        ttype = T_I32 if spec in idl.enums else _BASE_TYPES.get(spec)
        if ttype is None:
            raise ThriftError(f"unknown thrift type {spec!r}")
        if ttype == T_BOOL:
            return b"\x01" if v else b"\x00"
        if ttype == T_BYTE:
            return struct.pack(">b", int(v))
        if ttype == T_DOUBLE:
            return struct.pack(">d", float(v))
        if ttype == T_I16:
            return struct.pack(">h", int(v))
        if ttype == T_I32:
            return struct.pack(">i", int(v))
        if ttype == T_I64:
            return struct.pack(">q", int(v))
        raw = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
        return struct.pack(">i", len(raw)) + bytes(raw)

    for f in st.fields.values():
        v = row.get(f.name)
        if v is None:
            continue
        out += struct.pack(">bh", f.ttype, f.fid)
        out += enc_spec(f.spec, v)
    out += struct.pack(">b", T_STOP)
    return bytes(out)


# ---------------------------------------------------------------------------
# RecordReader + stream decoder plugins
# ---------------------------------------------------------------------------

class ThriftRecordReader:
    """Back-to-back TBinaryProtocol structs from a file (structs are
    self-delimiting: fields until STOP), schema from a .thrift IDL sidecar
    `<path>.thrift` (+ `<path>.msg` naming the record struct when the IDL
    defines several). Streams one struct at a time."""

    def __init__(self, path: str, idl: Optional[ThriftIDL] = None,
                 struct_name: Optional[str] = None):
        self.path = path
        if idl is None:
            sidecar = path + ".thrift"
            if not os.path.exists(sidecar):
                raise ThriftError(
                    f"{path}: no IDL given and no sidecar {sidecar}")
            with open(sidecar) as f:
                idl = ThriftIDL(f.read())
        self.idl = idl
        if struct_name is None:
            msg_sidecar = path + ".msg"
            if os.path.exists(msg_sidecar):
                with open(msg_sidecar) as f:
                    struct_name = f.read().strip()
            elif len(idl.structs) == 1:
                struct_name = next(iter(idl.structs))
            else:
                raise ThriftError(
                    f"{path}: IDL defines {len(idl.structs)} structs — name "
                    f"the record struct in {msg_sidecar}")
        self.struct = idl.struct(struct_name)

    def rows(self) -> Iterator[Dict[str, Any]]:
        with open(self.path, "rb") as f:
            r = _Reader(f)
            while True:
                first = f.read(1)
                if not first:
                    return
                f.seek(-1, 1)
                yield decode_struct(self.idl, self.struct, r)

    def close(self) -> None:
        pass


def write_structs(path: str, idl: ThriftIDL, st: ThriftStruct, rows) -> None:
    with open(path, "wb") as f:
        for row in rows:
            f.write(encode_struct(idl, st, row))


def make_thrift_decoder(idl_source: str, struct_name: str):
    """StreamMessageDecoder: TBinaryProtocol struct payloads -> row dicts
    (reference: the thrift message decoder configured with a thrift class)."""
    import io
    idl = ThriftIDL(idl_source)
    st = idl.struct(struct_name)

    def decode(value) -> Dict[str, Any]:
        return decode_struct(idl, st, _Reader(io.BytesIO(bytes(value))))
    return decode
