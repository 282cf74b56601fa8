"""Wire format: versioned binary serialization for query requests and partials.

A copy of `pinot_tpu/cluster/wire.py` (the analog of the reference's
versioned DataTable, `DataTableImplV3.java`, and the thrift
`InstanceRequest`): the same magic, version and tags, so every value it
encodes (scalars, strings, containers, ndarrays, a `SegmentResult` of each
kind with its `DensePartial`, the theta, t-digest and idset states) is the
very bytes the JAX package writes, and each package decodes the other's.
A `SegmentResult` that took the exact top-k path carries one more key,
`topkExact`, which the JAX package's decoder skips; every other partial
encodes without it. No pickle: every byte is written and parsed here.

Layout: `MAGIC(4) | version(u8) | tagged-value tree`. Tags are single ASCII
bytes; containers carry u32 counts; ndarrays carry dtype string, shape and
raw little-endian bytes.

Zero copy, both ways:

* decode: a `_Cursor` walks one memoryview over the frame, and ndarray
  payloads come back as `np.frombuffer` views ALIASING the frame (read-only
  when the frame is immutable `bytes`). The merges of `query.reduce` are
  copy-on-write, so read-only partials are safe downstream; a caller that
  needs a private mutable array copies it.
* encode: `_PartsWriter` gathers scalar fields into one accumulator and
  appends large array payloads as memoryviews of the source arrays (no
  `tobytes()`). `encode_*_parts` hands the buffer list to a vectored writer
  (the mux transport); `encode_*` joins it once. The source arrays must not
  change until the parts are written.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np

from ..query.reduce import SegmentResult

MAGIC = b"PTPU"
VERSION = 1

#: array payloads at or above this size ride as standalone zero-copy buffer
#: parts; smaller ones are cheaper to copy into the accumulator than to
#: fragment the socket writes over
GATHER_MIN_BYTES = 1024

Buffer = Union[bytes, bytearray, memoryview]

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
# a tag byte and its field in one pack: the same bytes as two writes
_TAG_I64 = struct.Struct("<cq")
_TAG_F64 = struct.Struct("<cd")
_TAG_U32 = struct.Struct("<cI")
_INT64_MIN, _INT64_END = -(1 << 63), 1 << 63

# -- object registry (sketch states etc.) -----------------------------------
# name -> (type, to_bytes, from_bytes); mirrors the reference's custom serde for
# sketch aggregation intermediates (ObjectSerDeUtils in pinot-core).
_OBJ_REGISTRY: Dict[str, Tuple[type, Callable[[Any], bytes], Callable[[bytes], Any]]] = {}
_OBJ_BY_TYPE: Dict[type, str] = {}


def register_wire_type(name: str, cls: type, to_bytes: Callable[[Any], bytes],
                       from_bytes: Callable[[bytes], Any]) -> None:
    _OBJ_REGISTRY[name] = (cls, to_bytes, from_bytes)
    _OBJ_BY_TYPE[cls] = name


def _register_builtin_types() -> None:
    from ..query.sketches import TDigest, ThetaSketch
    register_wire_type("theta", ThetaSketch, lambda s: s.to_bytes(),
                       ThetaSketch.from_bytes)
    register_wire_type("tdigest", TDigest, lambda s: s.to_bytes(), TDigest.from_bytes)
    from ..query.idset import IdSet
    register_wire_type("idset", IdSet, lambda s: s.to_bytes(), IdSet.from_bytes)


_register_builtin_types()


# -- encoder sink ------------------------------------------------------------

class _PartsWriter:
    """Gathered-write encoder sink: scalar fields accumulate into a bytearray,
    large array payloads are appended as zero-copy memoryviews of the source
    arrays. `parts()` returns the frame as an ordered buffer list."""

    __slots__ = ("_parts", "_buf")

    def __init__(self):
        self._parts: List[Buffer] = []
        self._buf = bytearray()

    def write(self, b: Buffer) -> None:
        self._buf += b

    def write_buffer(self, mv: memoryview) -> None:
        """Append a large payload as its own part (no copy); flushes the
        scalar accumulator first to preserve byte order."""
        if self._buf:
            self._parts.append(self._buf)
            self._buf = bytearray()
        self._parts.append(mv)

    def parts(self) -> List[Buffer]:
        if self._buf:
            self._parts.append(self._buf)
            self._buf = bytearray()
        return self._parts


# -- tagged value codec ------------------------------------------------------

def _write_value(out: _PartsWriter, v: Any) -> None:
    # the common exact types first (a selection's rows, a partial's group
    # keys and states): the same bytes as the tagged chain below
    t = type(v)
    if t is float:
        out.write(_TAG_F64.pack(b"f", v))
        return
    if t is int and _INT64_MIN <= v < _INT64_END:
        out.write(_TAG_I64.pack(b"i", v))
        return
    if t is str:
        raw = v.encode("utf-8")
        out.write(_TAG_U32.pack(b"s", len(raw)))
        out.write(raw)
        return
    if t is tuple or t is list:
        write = out.write
        write(_TAG_U32.pack(b"t" if t is tuple else b"l", len(v)))
        for item in v:
            ti = type(item)
            if ti is float:
                write(_TAG_F64.pack(b"f", item))
            elif ti is int and _INT64_MIN <= item < _INT64_END:
                write(_TAG_I64.pack(b"i", item))
            else:
                _write_value(out, item)
        return
    if v is None:
        out.write(b"N")
    elif v is True:
        out.write(b"T")
    elif v is False:
        out.write(b"F")
    elif isinstance(v, (int, np.integer)):
        v = int(v)
        if -(1 << 63) <= v < (1 << 63):
            out.write(b"i")
            out.write(_I64.pack(v))
        else:  # arbitrary-precision fallback
            raw = str(v).encode()
            out.write(b"I")
            out.write(_U32.pack(len(raw)))
            out.write(raw)
    elif isinstance(v, (float, np.floating)):
        out.write(b"f")
        out.write(_F64.pack(float(v)))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.write(b"s")
        out.write(_U32.pack(len(raw)))
        out.write(raw)
    elif isinstance(v, (bytes, bytearray)):
        out.write(b"b")
        out.write(_U32.pack(len(v)))
        out.write(bytes(v))
    elif isinstance(v, np.ndarray):
        dt = v.dtype
        if dt == object:  # object arrays decay to a list of tagged values
            out.write(b"l")
            out.write(_U32.pack(v.size))
            for item in v.reshape(-1):
                _write_value(out, item)
            return
        dts = dt.str.encode()  # e.g. b"<i4"
        out.write(b"a")
        out.write(_U8.pack(len(dts)))
        out.write(dts)
        out.write(_U8.pack(v.ndim))
        for d in v.shape:
            out.write(_U32.pack(d))
        a = np.ascontiguousarray(v)
        out.write(_U32.pack(a.nbytes))
        if a.nbytes >= GATHER_MIN_BYTES and a.ndim:
            out.write_buffer(a.data.cast("B"))  # alias, not tobytes()
        else:
            out.write(a.tobytes())
    elif isinstance(v, tuple):
        out.write(b"t")
        out.write(_U32.pack(len(v)))
        for item in v:
            _write_value(out, item)
    elif isinstance(v, list):
        out.write(b"l")
        out.write(_U32.pack(len(v)))
        for item in v:
            _write_value(out, item)
    elif isinstance(v, (set, frozenset)):
        out.write(b"S")
        out.write(_U32.pack(len(v)))
        for item in v:
            _write_value(out, item)
    elif isinstance(v, dict):
        out.write(b"d")
        out.write(_U32.pack(len(v)))
        for k, item in v.items():
            _write_value(out, k)
            _write_value(out, item)
    else:
        name = _OBJ_BY_TYPE.get(type(v))
        if name is None:
            raise TypeError(f"no wire encoding for {type(v).__name__}")
        raw = _OBJ_REGISTRY[name][1](v)
        nm = name.encode()
        out.write(b"O")
        out.write(_U8.pack(len(nm)))
        out.write(nm)
        out.write(_U32.pack(len(raw)))
        out.write(raw)


class _Cursor:
    """Zero-copy decode cursor: `take` returns SLICES of the frame buffer."""

    __slots__ = ("mv", "off")

    def __init__(self, data: Buffer):
        mv = data if isinstance(data, memoryview) else memoryview(data)
        if mv.ndim != 1 or mv.format != "B":
            mv = mv.cast("B")
        self.mv = mv
        self.off = 0

    def take(self, n: int) -> memoryview:
        off = self.off
        end = off + n
        if end > len(self.mv):
            raise ValueError("truncated wire frame")
        self.off = end
        return self.mv[off:end]

    def u8(self) -> int:
        (v,) = _U8.unpack_from(self.mv, self.off)
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = _U32.unpack_from(self.mv, self.off)
        self.off += 4
        return v

    def i64(self) -> int:
        (v,) = _I64.unpack_from(self.mv, self.off)
        self.off += 8
        return v

    def f64(self) -> float:
        (v,) = _F64.unpack_from(self.mv, self.off)
        self.off += 8
        return v


def _read_value(cur: _Cursor) -> Any:
    # the common tags first, read in place (the chain below handles the rest)
    mv, off = cur.mv, cur.off
    if off >= len(mv):
        raise ValueError("truncated wire frame")
    code = mv[off]
    if code == 0x66:    # f
        (v,) = _F64.unpack_from(mv, off + 1)
        cur.off = off + 9
        return v
    if code == 0x69:    # i
        (v,) = _I64.unpack_from(mv, off + 1)
        cur.off = off + 9
        return v
    if code == 0x74 or code == 0x6C:    # t, l
        (n,) = _U32.unpack_from(mv, off + 1)
        cur.off = off + 5
        items = [_read_value(cur) for _ in range(n)]
        return tuple(items) if code == 0x74 else items
    if code == 0x73:    # s
        (n,) = _U32.unpack_from(mv, off + 1)
        cur.off = off + 5
        return str(cur.take(n), "utf-8")
    tag = cur.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return cur.i64()
    if tag == b"I":
        return int(str(cur.take(cur.u32()), "ascii"))
    if tag == b"f":
        return cur.f64()
    if tag == b"s":
        return str(cur.take(cur.u32()), "utf-8")
    if tag == b"b":
        # private bytes on purpose: sketch from_bytes implementations may
        # retain the buffer past the frame's lifetime
        return bytes(cur.take(cur.u32()))
    if tag == b"a":
        dt = np.dtype(str(cur.take(cur.u8()), "ascii"))
        shape = tuple(cur.u32() for _ in range(cur.u8()))
        # the array ALIASES the frame buffer — read-only when the frame is
        # immutable bytes; reduce's merge paths are copy-on-write
        return np.frombuffer(cur.take(cur.u32()), dtype=dt).reshape(shape)
    if tag == b"t":
        return tuple(_read_value(cur) for _ in range(cur.u32()))
    if tag == b"l":
        return [_read_value(cur) for _ in range(cur.u32())]
    if tag == b"S":
        return {_read_value(cur) for _ in range(cur.u32())}
    if tag == b"d":
        return {_read_value(cur): _read_value(cur) for _ in range(cur.u32())}
    if tag == b"O":
        name = str(cur.take(cur.u8()), "ascii")
        entry = _OBJ_REGISTRY.get(name)
        if entry is None:
            raise ValueError(f"unknown wire object type {name!r}")
        return entry[2](bytes(cur.take(cur.u32())))
    raise ValueError(f"bad wire tag {bytes(tag)!r}")


def encode_value_parts(v: Any) -> List[Buffer]:
    """Encode as an ordered buffer list (vectored-write form): scalar runs are
    private bytearrays, large array payloads are zero-copy views of the source
    arrays. Concatenation of the parts == `encode_value(v)`."""
    out = _PartsWriter()
    out.write(MAGIC)
    out.write(_U8.pack(VERSION))
    _write_value(out, v)
    return out.parts()


def encode_value(v: Any) -> bytes:
    return b"".join(encode_value_parts(v))


def decode_value(data: Buffer) -> Any:
    """Decode one frame (bytes, bytearray, or memoryview). ndarray payloads
    are zero-copy views over `data` — keep the frame alive as long as the
    arrays; they are read-only when `data` is immutable."""
    cur = _Cursor(data)
    if cur.take(4) != MAGIC:
        raise ValueError("bad wire magic")
    ver = cur.u8()
    if ver != VERSION:
        raise ValueError(f"unsupported wire version {ver}")
    return _read_value(cur)


# -- message framing ---------------------------------------------------------

def _segment_result_doc(r: SegmentResult, trace_spans=None) -> Dict[str, Any]:
    doc = {
        "kind": r.kind,
        "numDocs": r.num_docs_scanned,
        "groups": [(k, v) for k, v in r.groups.items()],
        "scalar": r.scalar,
        "rows": r.rows,
        "sortKeys": r.sort_keys,
        "served": r.served,
        "trace": trace_spans,
        # per-query ExecutionStats counters (telemetry layer); absent/None on
        # old peers — decode is tolerant both ways
        "stats": getattr(r, "stats", None),
        # array-form high-card partial: flat ndarrays instead of per-group
        # state lists (reduce.DensePartial); `aggs` is build-side only
        "dense": None if r.dense is None else {
            "token": r.dense.token,
            "cards": r.dense.cards,
            "strides": r.dense.strides,
            "numKeysReal": r.dense.num_keys_real,
            "counts": r.dense.counts,
            "outs": r.dense.outs,
            "groupValues": [np.asarray(v) for v in r.dense.group_values],
        },
    }
    if getattr(r, "topk_exact", False):
        # this package's key: the selection took the exact top-k path
        doc["topkExact"] = True
    return doc


def encode_segment_result(r: SegmentResult, trace_spans=None) -> bytes:
    """SegmentResult -> bytes (reference: DataTable serialize on the server).

    `trace_spans` optionally carries the server's request-trace span rows back to
    the broker (reference: DataTable metadata TRACE_INFO key)."""
    return encode_value(_segment_result_doc(r, trace_spans))


def encode_segment_result_parts(r: SegmentResult, trace_spans=None
                                ) -> List[Buffer]:
    """Vectored-write form of `encode_segment_result` (the mux transport
    hands the parts straight to the chunked response writer — the dense
    arrays never transit an intermediate bytes copy)."""
    return encode_value_parts(_segment_result_doc(r, trace_spans))


def decode_segment_result(data: Buffer) -> SegmentResult:
    d = decode_value(data)
    r = SegmentResult(d["kind"])
    r.num_docs_scanned = d["numDocs"]
    r.groups = {k: v for k, v in d["groups"]}
    r.scalar = d["scalar"]
    r.rows = [tuple(row) if not isinstance(row, tuple) else row for row in d["rows"]]
    r.sort_keys = [tuple(k) if not isinstance(k, tuple) else k for k in d["sortKeys"]]
    r.served = d.get("served")
    r.topk_exact = bool(d.get("topkExact", False))
    dd = d.get("dense")
    if dd is not None:
        from ..query.reduce import DensePartial
        r.dense = DensePartial(
            token=dd["token"],
            cards=tuple(dd["cards"]),
            strides=tuple(dd["strides"]),
            num_keys_real=dd["numKeysReal"],
            counts=np.asarray(dd["counts"]),
            outs={k: np.asarray(v) for k, v in dd["outs"].items()},
            # string dictionaries decay to lists on the wire; rebuild them as
            # OBJECT arrays (same rationale as decode_block)
            group_values=[v if isinstance(v, np.ndarray)
                          else np.asarray(v, dtype=object)
                          for v in dd["groupValues"]])
    if d.get("trace"):
        r.trace_spans = d["trace"]  # spliced into the broker's trace by the caller
    if d.get("stats"):
        r.stats = d["stats"]  # merged into the broker's ExecutionStats
    return r


def decode_block(d: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Columnar block off the wire: numeric ndarrays roundtrip natively (tag
    'a'); OBJECT columns (strings) decay to lists and come back here as object
    arrays — never as numpy unicode, which would break null (None) cells."""
    return {k: (v if isinstance(v, np.ndarray)
                else np.asarray(v, dtype=object)) for k, v in d.items()}


def encode_query_request(table: str, sql: str, segments,
                         time_filter: str = None, trace: bool = False,
                         trace_id: str = "", sampled: bool = False) -> bytes:
    """Broker -> server query dispatch (reference: thrift InstanceRequest with the
    compiled query + searchSegments list, `InstanceRequestHandler.java:96`;
    `timeFilter` carries the hybrid time-boundary predicate, `trace` the request's
    trace-enabled flag — CommonConstants.Request.TRACE). `trace_id`/`sampled`
    propagate the dispatching broker's trace context so the server's spans splice
    into the SAME distributed trace (the trace-context header analog)."""
    return json.dumps({"table": table, "sql": sql, "segments": list(segments),
                       "timeFilter": time_filter, "trace": trace,
                       "traceId": trace_id, "sampled": sampled}).encode()


def decode_query_request(data: Buffer) -> Dict[str, Any]:
    if isinstance(data, memoryview):
        data = bytes(data)
    return json.loads(data if isinstance(data, (bytes, bytearray))
                      else data.decode())
