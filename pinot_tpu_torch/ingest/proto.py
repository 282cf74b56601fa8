"""Pure-Python protobuf: wire codec + descriptor-driven decode/encode.

Analog of the reference's protobuf input format
(`pinot-plugins/pinot-input-format/pinot-protobuf/src/main/java/org/apache/
pinot/plugin/inputformat/protobuf/ProtoBufRecordReader.java` — reads
varint-length-delimited messages from a file using a compiled descriptor —
and its `ProtoBufMessageDecoder` for streams). Implemented from the public
protobuf wire specification; schemas come from a standard
`FileDescriptorSet` blob (`protoc --descriptor_set_out`), which is itself
protobuf-encoded — parsed here with the same generic wire walker against
descriptor.proto's well-known field numbers.

Supported: all scalar types (varint/zigzag/fixed/float/double/bool/enum),
string/bytes, repeated fields (packed and unpacked), nested messages
(decoded to dicts), proto2 + proto3 files. Unknown fields are skipped by
wire type, like every conforming decoder.

A copy of `pinot_tpu/ingest/proto.py`, with its own `write_uvarint`: the
bytes it writes and the rows it reads are the JAX package's.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5

# FieldDescriptorProto.Type numbers (descriptor.proto)
T_DOUBLE, T_FLOAT, T_INT64, T_UINT64, T_INT32 = 1, 2, 3, 4, 5
T_FIXED64, T_FIXED32, T_BOOL, T_STRING, T_GROUP = 6, 7, 8, 9, 10
T_MESSAGE, T_BYTES, T_UINT32, T_ENUM = 11, 12, 13, 14
T_SFIXED32, T_SFIXED64, T_SINT32, T_SINT64 = 15, 16, 17, 18

LABEL_REPEATED = 3

_PACKABLE = {T_DOUBLE, T_FLOAT, T_INT64, T_UINT64, T_INT32, T_FIXED64,
             T_FIXED32, T_BOOL, T_UINT32, T_ENUM, T_SFIXED32, T_SFIXED64,
             T_SINT32, T_SINT64}


class ProtoError(ValueError):
    pass


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

def write_uvarint(v: int) -> bytes:
    """A plain base-128 varint (zigzag only for sint*); this package's copy of
    the JAX package's `kafka_wire.uvarint`, byte for byte."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(data):
            raise ProtoError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ProtoError("varint too long")


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _i64_signed(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def _i32_signed(u: int) -> int:
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


def _skip_field(data: bytes, pos: int, wt: int) -> int:
    """Advance past one NON-GROUP field's payload (the one wire-type walk the
    group skipper reuses — a second inlined copy would drift)."""
    if wt == _VARINT:
        _, pos = read_uvarint(data, pos)
    elif wt == _I64:
        pos += 8
    elif wt == _I32:
        pos += 4
    elif wt == _LEN:
        n, pos = read_uvarint(data, pos)
        pos += n
    else:
        raise ProtoError(f"bad wire type {wt}")
    if pos > len(data):
        raise ProtoError("truncated field")
    return pos


def _skip_group(data: bytes, pos: int) -> int:
    """Scan past a group body to the matching end-group tag. ITERATIVE depth
    counter, not recursion: nesting depth is attacker-controlled (600 nested
    group tags fit in ~1.2KB of input) and must never exhaust the stack."""
    depth = 1
    while depth:
        tag, pos = read_uvarint(data, pos)
        wt = tag & 7
        if wt == _SGROUP:
            depth += 1
        elif wt == _EGROUP:
            depth -= 1
        else:
            pos = _skip_field(data, pos, wt)
    return pos


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Walk one message's (field number, wire type, raw value) tags."""
    pos = 0
    while pos < len(data):
        tag, pos = read_uvarint(data, pos)
        num, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            v, pos = read_uvarint(data, pos)
        elif wt == _I64:
            if pos + 8 > len(data):
                raise ProtoError("truncated fixed64")
            v = data[pos:pos + 8]
            pos += 8
        elif wt == _LEN:
            n, pos = read_uvarint(data, pos)
            if pos + n > len(data):
                raise ProtoError("truncated length-delimited field")
            v = data[pos:pos + n]
            pos += n
        elif wt == _I32:
            if pos + 4 > len(data):
                raise ProtoError("truncated fixed32")
            v = data[pos:pos + 4]
            pos += 4
        elif wt == _SGROUP:
            # legacy group field: a conforming decoder SKIPS it by scanning
            # to the matching end-group tag, nesting included (groups are
            # deprecated since proto2's earliest days; declared group fields
            # decode as absent — see decode_message's default fill)
            pos = _skip_group(data, pos)
            continue
        elif wt == _EGROUP:
            raise ProtoError("unmatched end-group tag")
        else:
            raise ProtoError(f"bad wire type {wt}")
        yield num, wt, v


# ---------------------------------------------------------------------------
# descriptor model (parsed from a FileDescriptorSet with the wire walker)
# ---------------------------------------------------------------------------

class FieldSchema:
    __slots__ = ("name", "number", "type", "repeated", "type_name",
                 "in_oneof", "default")

    def __init__(self, name, number, ftype, repeated, type_name,
                 in_oneof=False, default=None):
        self.name = name
        self.number = number
        self.type = ftype
        self.repeated = repeated
        self.type_name = type_name   # fully-qualified for message/enum
        self.in_oneof = in_oneof     # incl. proto3 `optional` synthetic oneofs
        self.default = default       # proto2 declared default (already typed)


class MessageSchema:
    def __init__(self, full_name: str):
        self.full_name = full_name
        self.fields: Dict[int, FieldSchema] = {}
        self.by_name: Dict[str, FieldSchema] = {}


def _c_unescape(txt: str) -> bytes:
    """Descriptor default_value for bytes is C-escaped text — unescape it."""
    out = bytearray()
    i = 0
    while i < len(txt):
        c = txt[i]
        if c != "\\":
            out += c.encode("latin-1")
            i += 1
            continue
        i += 1
        e = txt[i]
        simple = {"n": 10, "r": 13, "t": 9, "a": 7, "b": 8, "f": 12, "v": 11,
                  "\\": 92, "'": 39, '"': 34, "?": 63}
        if e in simple:
            out.append(simple[e])
            i += 1
        elif e == "x":
            j = i + 1
            while j < len(txt) and j <= i + 2 and txt[j] in "0123456789abcdefABCDEF":
                j += 1
            out.append(int(txt[i + 1:j], 16))
            i = j
        elif e.isdigit():
            j = i
            while j < len(txt) and j < i + 3 and txt[j] in "01234567":
                j += 1
            out.append(int(txt[i:j], 8))
            i = j
        else:
            out += e.encode("latin-1")
            i += 1
    return bytes(out)


def _parse_default(ftype: int, txt: Optional[str]):
    """proto2 declared default (descriptor carries it as TEXT) -> typed value.
    Enum defaults arrive as SYMBOLIC names; the pool resolves them to numbers
    after all enum descriptors are loaded (decode yields enum NUMBERS)."""
    if txt is None:
        return None
    if ftype in (T_DOUBLE, T_FLOAT):
        return float(txt)
    if ftype == T_BOOL:
        return txt == "true"
    if ftype == T_STRING:
        return txt
    if ftype == T_BYTES:
        return _c_unescape(txt)
    if ftype == T_ENUM:
        return txt                    # symbolic; resolved by the pool
    try:
        return int(txt)
    except ValueError:
        return txt


class DescriptorPool:
    """Message schemas from a `FileDescriptorSet` (protoc --descriptor_set_out)."""

    def __init__(self, descriptor_set: bytes):
        self.messages: Dict[str, MessageSchema] = {}
        self.enums: Dict[str, Dict[str, int]] = {}   # full name -> symbol -> num
        for num, _wt, v in iter_fields(descriptor_set):
            if num == 1:   # FileDescriptorSet.file
                self._load_file(v)
        # resolve symbolic enum defaults to NUMBERS now that every enum
        # descriptor is loaded (decode yields enum numbers; a string default
        # would make the same column int-or-str depending on field presence)
        for schema in self.messages.values():
            for f in schema.fields.values():
                if f.type == T_ENUM and isinstance(f.default, str):
                    f.default = self.enums.get(f.type_name, {}).get(f.default)

    def _load_file(self, fdp: bytes) -> None:
        package = ""
        msgs: List[bytes] = []
        enums: List[bytes] = []
        for num, _wt, v in iter_fields(fdp):
            if num == 2:           # FileDescriptorProto.package
                package = v.decode()
            elif num == 4:         # message_type
                msgs.append(v)
            elif num == 5:         # enum_type
                enums.append(v)
        prefix = f".{package}" if package else ""
        for e in enums:
            self._load_enum(e, prefix)
        for m in msgs:
            self._load_message(m, prefix)

    def _load_enum(self, edp: bytes, prefix: str) -> None:
        name = ""
        values: Dict[str, int] = {}
        for num, _wt, v in iter_fields(edp):
            if num == 1:           # EnumDescriptorProto.name
                name = v.decode()
            elif num == 2:         # value: EnumValueDescriptorProto
                vname, vnum = "", 0
                for n2, _w2, v2 in iter_fields(v):
                    if n2 == 1:
                        vname = v2.decode()
                    elif n2 == 2:
                        vnum = v2
                values[vname] = vnum
        self.enums[f"{prefix}.{name}"] = values

    def _load_message(self, dp: bytes, prefix: str) -> None:
        name = ""
        fields: List[bytes] = []
        nested: List[bytes] = []
        nested_enums: List[bytes] = []
        for num, _wt, v in iter_fields(dp):
            if num == 1:           # DescriptorProto.name
                name = v.decode()
            elif num == 2:         # field
                fields.append(v)
            elif num == 3:         # nested_type
                nested.append(v)
            elif num == 4:         # enum_type (nested)
                nested_enums.append(v)
        full = f"{prefix}.{name}"
        for e in nested_enums:
            self._load_enum(e, full)
        schema = MessageSchema(full)
        for f in fields:
            fname = ""
            number = ftype = 0
            label = 1
            type_name = ""
            in_oneof = False
            default_txt: Optional[str] = None
            for num, _wt, v in iter_fields(f):
                if num == 1:
                    fname = v.decode()
                elif num == 3:
                    number = v
                elif num == 4:
                    label = v
                elif num == 5:
                    ftype = v
                elif num == 6:
                    type_name = v.decode()
                elif num == 7:        # proto2 default_value (text form)
                    default_txt = v.decode()
                elif num == 9:        # oneof_index (proto3 `optional` uses a
                    in_oneof = True   # synthetic oneof too: field 17)
                elif num == 17 and v:
                    in_oneof = True
            fs = FieldSchema(fname, number, ftype, label == LABEL_REPEATED,
                             type_name, in_oneof,
                             _parse_default(ftype, default_txt))
            schema.fields[number] = fs
            schema.by_name[fname] = fs
        self.messages[full] = schema
        for n in nested:
            self._load_message(n, full)

    def message(self, name: str) -> MessageSchema:
        key = name if name.startswith(".") else f".{name}"
        m = self.messages.get(key)
        if m is None:
            # tolerate unqualified names (single-package descriptor sets)
            cands = [v for k, v in self.messages.items()
                     if k.endswith(f".{name}")]
            if len(cands) == 1:
                return cands[0]
            raise ProtoError(f"unknown message {name!r} "
                             f"(have {sorted(self.messages)})")
        return m


# ---------------------------------------------------------------------------
# descriptor-driven decode / encode
# ---------------------------------------------------------------------------

def _scalar(ftype: int, wt: int, v) -> Any:
    if ftype in (T_DOUBLE, T_FLOAT, T_FIXED64, T_SFIXED64, T_FIXED32,
                 T_SFIXED32, T_STRING, T_BYTES):
        if not isinstance(v, (bytes, bytearray)):
            raise ProtoError(
                f"wire/type mismatch for field type {ftype} (wrong schema?)")
    elif not isinstance(v, int):
        raise ProtoError(
            f"wire/type mismatch for field type {ftype} (wrong schema?)")
    if ftype in (T_INT64, T_INT32, T_ENUM):
        # enums have int32 wire semantics: a negative constant arrives as a
        # sign-extended 64-bit varint, NOT a huge unsigned value
        return _i64_signed(v)
    if ftype in (T_UINT64, T_UINT32):
        return v
    if ftype in (T_SINT32, T_SINT64):
        return _unzigzag(v)
    if ftype == T_BOOL:
        return bool(v)
    if ftype == T_DOUBLE:
        return struct.unpack("<d", v)[0]
    if ftype == T_FLOAT:
        return struct.unpack("<f", v)[0]
    if ftype == T_FIXED64:
        return struct.unpack("<Q", v)[0]
    if ftype == T_SFIXED64:
        return struct.unpack("<q", v)[0]
    if ftype == T_FIXED32:
        return struct.unpack("<I", v)[0]
    if ftype == T_SFIXED32:
        return struct.unpack("<i", v)[0]
    if ftype == T_STRING:
        return v.decode("utf-8")
    if ftype == T_BYTES:
        return bytes(v)
    raise ProtoError(f"unsupported field type {ftype}")


def _unpack_packed(ftype: int, v: bytes) -> List[Any]:
    out = []
    if ftype in (T_DOUBLE, T_FIXED64, T_SFIXED64):
        if len(v) % 8:
            raise ProtoError("truncated packed fixed64 field")
        fmt = {T_DOUBLE: "<d", T_FIXED64: "<Q", T_SFIXED64: "<q"}[ftype]
        for i in range(0, len(v), 8):
            out.append(struct.unpack(fmt, v[i:i + 8])[0])
    elif ftype in (T_FLOAT, T_FIXED32, T_SFIXED32):
        if len(v) % 4:
            raise ProtoError("truncated packed fixed32 field")
        fmt = {T_FLOAT: "<f", T_FIXED32: "<I", T_SFIXED32: "<i"}[ftype]
        for i in range(0, len(v), 4):
            out.append(struct.unpack(fmt, v[i:i + 4])[0])
    else:
        pos = 0
        while pos < len(v):
            u, pos = read_uvarint(v, pos)
            out.append(_scalar(ftype, _VARINT, u))
    return out


_TYPE_DEFAULT = {T_STRING: "", T_BYTES: b"", T_BOOL: False,
                 T_DOUBLE: 0.0, T_FLOAT: 0.0}


def decode_message(pool: DescriptorPool, schema: MessageSchema,
                   data: bytes) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for num, wt, v in iter_fields(data):
        f = schema.fields.get(num)
        if f is None:
            continue   # unknown field: skipped (already consumed by wire type)
        if f.type == T_MESSAGE:
            sub = decode_message(pool, pool.message(f.type_name), v)
            if f.repeated:
                out.setdefault(f.name, []).append(sub)
            else:
                out[f.name] = sub
            continue
        if f.repeated:
            vals = out.setdefault(f.name, [])
            if wt == _LEN and f.type in _PACKABLE:
                vals.extend(_unpack_packed(f.type, v))
            else:
                vals.append(_scalar(f.type, wt, v))
        else:
            out[f.name] = _scalar(f.type, wt, v)
    # implicit defaults: a field holding its default value is OMITTED on the
    # wire; the reader contract (like the reference's generated getters) is
    # 0/""/false/[] (or the proto2 declared default), never a missing key —
    # without this, a .pb and a .jsonl of identical rows ingest differently.
    # ONEOF members (incl. proto3 `optional` synthetic oneofs) have explicit
    # presence: absent stays absent (null).
    for f in schema.fields.values():
        if f.name in out:
            continue
        if f.repeated:
            out[f.name] = []
        elif f.type in (T_MESSAGE, T_GROUP) or f.in_oneof:
            # absent submessage / skipped group / unset oneof arm stays null
            # (a 0 fill for a group column would read as data, not absence)
            continue
        elif f.default is not None:
            out[f.name] = f.default
        else:
            out[f.name] = _TYPE_DEFAULT.get(f.type, 0)
    return out


def encode_message(pool: DescriptorPool, schema: MessageSchema,
                   row: Dict[str, Any]) -> bytes:
    """Descriptor-driven encoder (tests + datagen; repeated scalars packed)."""
    by_name = schema.by_name   # built once at descriptor load, not per row
    out = bytearray()

    def scalar_bytes(f: FieldSchema, v) -> Tuple[int, bytes]:
        t = f.type
        if t in (T_INT64, T_INT32, T_UINT64, T_UINT32, T_ENUM, T_BOOL):
            return _VARINT, write_uvarint(int(v) & 0xFFFFFFFFFFFFFFFF)
        if t in (T_SINT32, T_SINT64):
            return _VARINT, write_uvarint(_zigzag(int(v)))
        if t == T_DOUBLE:
            return _I64, struct.pack("<d", float(v))
        if t == T_FIXED64:
            return _I64, struct.pack("<Q", int(v))
        if t == T_SFIXED64:
            return _I64, struct.pack("<q", int(v))
        if t == T_FLOAT:
            return _I32, struct.pack("<f", float(v))
        if t == T_FIXED32:
            return _I32, struct.pack("<I", int(v))
        if t == T_SFIXED32:
            return _I32, struct.pack("<i", int(v))
        if t == T_STRING:
            raw = str(v).encode("utf-8")
            return _LEN, write_uvarint(len(raw)) + raw
        if t == T_BYTES:
            raw = bytes(v)
            return _LEN, write_uvarint(len(raw)) + raw
        raise ProtoError(f"unsupported field type {t}")

    for name, v in row.items():
        f = by_name.get(name)
        if f is None or v is None:
            continue
        if f.type == T_MESSAGE:
            subs = v if f.repeated else [v]
            for sub in subs:
                raw = encode_message(pool, pool.message(f.type_name), sub)
                out += write_uvarint((f.number << 3) | _LEN)
                out += write_uvarint(len(raw)) + raw
        elif f.repeated:
            if f.type in _PACKABLE:
                payload = bytearray()
                for item in v:
                    wt, raw = scalar_bytes(f, item)
                    payload += raw
                out += write_uvarint((f.number << 3) | _LEN)
                out += write_uvarint(len(payload)) + bytes(payload)
            else:
                for item in v:
                    wt, raw = scalar_bytes(f, item)
                    out += write_uvarint((f.number << 3) | wt) + raw
        else:
            wt, raw = scalar_bytes(f, v)
            out += write_uvarint((f.number << 3) | wt) + raw
    return bytes(out)


# ---------------------------------------------------------------------------
# RecordReader + stream decoder plugins
# ---------------------------------------------------------------------------

class ProtoRecordReader:
    """Varint-length-delimited protobuf messages from a file (the reference
    ProtoBufRecordReader's format), schema from a descriptor set.

    `reader_for("x.pb")` convention: the descriptor lives in a sidecar
    `<path>.desc`; the record message name in `<path>.msg` (one line) —
    required only when the descriptor defines more than one message. The
    explicit constructor takes descriptor bytes + message name."""

    def __init__(self, path: str, descriptor_set: Optional[bytes] = None,
                 message: Optional[str] = None):
        self.path = path
        if descriptor_set is None:
            sidecar = path + ".desc"
            if not os.path.exists(sidecar):
                raise ProtoError(
                    f"{path}: no descriptor given and no sidecar {sidecar}")
            with open(sidecar, "rb") as f:
                descriptor_set = f.read()
        self.pool = DescriptorPool(descriptor_set)
        if message is None:
            msg_sidecar = path + ".msg"
            if os.path.exists(msg_sidecar):
                with open(msg_sidecar) as f:
                    message = f.read().strip()
            elif len(self.pool.messages) == 1:
                message = next(iter(self.pool.messages))
            else:
                raise ProtoError(
                    f"{path}: descriptor defines {len(self.pool.messages)} "
                    f"messages — name the record type in {msg_sidecar} "
                    f"(have {sorted(self.pool.messages)})")
        self.schema = self.pool.message(message)

    def rows(self) -> Iterator[Dict[str, Any]]:
        # STREAMING: one message at a time off the file object (like every
        # other reader — batch jobs must not materialize multi-GB inputs)
        with open(self.path, "rb") as f:
            while True:
                n = self._read_len_prefix(f)
                if n is None:
                    return
                raw = f.read(n)
                if len(raw) < n:
                    raise ProtoError("truncated delimited message")
                yield decode_message(self.pool, self.schema, raw)

    @staticmethod
    def _read_len_prefix(f) -> Optional[int]:
        out = shift = 0
        first = True
        while True:
            b = f.read(1)
            if not b:
                if first:
                    return None   # clean EOF at a message boundary
                raise ProtoError("truncated varint length prefix")
            first = False
            out |= (b[0] & 0x7F) << shift
            if not b[0] & 0x80:
                return out
            shift += 7
            if shift > 70:
                raise ProtoError("varint too long")

    def close(self) -> None:
        pass


def write_delimited(path: str, pool: DescriptorPool, schema: MessageSchema,
                    rows) -> None:
    """Companion writer: varint-length-delimited messages."""
    with open(path, "wb") as f:
        for row in rows:
            raw = encode_message(pool, schema, row)
            f.write(write_uvarint(len(raw)) + raw)


def make_proto_decoder(descriptor_set: bytes, message: str):
    """StreamMessageDecoder for raw protobuf message payloads (reference:
    ProtoBufMessageDecoder with descriptorFile + protoClassName props)."""
    pool = DescriptorPool(descriptor_set)
    schema = pool.message(message)

    def decode(value) -> Dict[str, Any]:
        return decode_message(pool, schema, bytes(value))
    return decode


def compile_proto(proto_source: str, workdir: str) -> bytes:
    """Run `protoc --descriptor_set_out` on inline .proto source -> the
    FileDescriptorSet blob (tests/tools; protoc ships in the image)."""
    import subprocess
    src = os.path.join(workdir, "schema.proto")
    out = os.path.join(workdir, "schema.desc")
    with open(src, "w") as f:
        f.write(proto_source)
    subprocess.run(["protoc", f"--proto_path={workdir}",
                    f"--descriptor_set_out={out}", src],
                   check=True, capture_output=True)
    with open(out, "rb") as f:
        return f.read()
