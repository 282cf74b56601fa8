"""pinot_tpu_torch's record readers and codecs against the JAX package's.

Each case runs on the CPU through both packages' modules:

* Avro: the spec's golden bytes; datums, container files (null and deflate,
  with one sync marker for both writers) and confluent frames written by
  either package are equal byte for byte and read by the other; schema
  resolution (defaults, skipped writer fields, promotions, unions); the
  decoders' errors on truncated or foreign input;
* Thrift: the binary protocol's golden bytes, structs written by either
  package read by the other, unknown fields skipped, truncation errors, the
  record reader's `.thrift` sidecar and the stream decoder;
* Protobuf: the golden varints and tags, messages and length-delimited files
  of either package read by the other, the committed `lineorder.desc` (equal
  to `protoc`'s output where `protoc` exists), proto2 defaults, oneof and
  groups, and truncation errors. The cases that compile a `.proto` need
  `protoc` and skip without it;
* CSV, JSON lines, Parquet and ORC (the last two behind `importorskip`)
  read the same rows through both packages' `reader_for`;
* the stream decoder registry: `avro`, and Protobuf and Thrift decoders
  registered under a name.
"""

import io
import os
import shutil
import struct
import subprocess
import sys

import pytest

from pinot_tpu.ingest import avro as ref_avro
from pinot_tpu.ingest import proto as ref_proto
from pinot_tpu.ingest import readers as ref_readers
from pinot_tpu.ingest import thriftfmt as ref_thrift
from pinot_tpu_torch import ssb
from pinot_tpu_torch.ingest import avro, proto, readers, stream, thriftfmt

HAVE_PROTOC = shutil.which("protoc") is not None
needs_protoc = pytest.mark.skipif(not HAVE_PROTOC, reason="protoc is not installed")
DATA = os.path.join(os.path.dirname(__file__), "torch_data")
SIDES = [(avro, ref_avro), (ref_avro, avro)]
SIDE_IDS = ["torch_to_jax", "jax_to_torch"]


# -- Avro ---------------------------------------------------------------------------

def _enc(mod, schema, value) -> bytes:
    e = mod.BinaryEncoder()
    mod.write_datum(e, mod.parse_schema(schema), value)
    return e.getvalue()


def _dec(mod, schema, data: bytes, reader=None):
    return mod.read_datum(mod.BinaryDecoder(data), mod.parse_schema(schema),
                          mod.parse_schema(reader) if reader is not None else None)


@pytest.mark.parametrize("v, raw", [(0, b"\x00"), (-1, b"\x01"), (1, b"\x02"), (-2, b"\x03"),
                                    (2, b"\x04"), (64, b"\x80\x01"), (-64, b"\x7f"),
                                    (100, b"\xc8\x01"), (-(1 << 63), b"\xff" * 9 + b"\x01")])
def test_avro_golden_zigzag_longs(v, raw):
    assert _enc(avro, '"long"', v) == raw == _enc(ref_avro, '"long"', v)
    assert _dec(avro, '"long"', raw) == v


@pytest.mark.parametrize("schema, value, raw", [
    ('"string"', "foo", b"\x06foo"),
    ('"boolean"', True, b"\x01"),
    ('"null"', None, b""),
    ('"float"', 1.5, struct.pack("<f", 1.5)),
    ('"double"', -2.25, struct.pack("<d", -2.25)),
    ('"bytes"', b"\x00\xff", b"\x04\x00\xff"),
    ({"type": "record", "name": "test", "fields": [
        {"name": "a", "type": "long"}, {"name": "b", "type": "string"}]},
     {"a": 27, "b": "foo"}, b"\x36\x06foo"),
    ({"type": "array", "items": "long"}, [3, 27], b"\x04\x06\x36\x00"),
    (["null", "string"], None, b"\x00"),
    (["null", "string"], "a", b"\x02\x02a"),
], ids=["string", "boolean", "null", "float", "double", "bytes", "record", "array",
        "union_null", "union_string"])
def test_avro_golden_datums(schema, value, raw):
    assert _enc(avro, schema, value) == raw == _enc(ref_avro, schema, value)
    assert _dec(avro, schema, raw) == value


COMPLEX = {
    "type": "record", "name": "Event", "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": ["null", "string"], "default": None},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "props", "type": {"type": "map", "values": "double"}},
        {"name": "kind", "type": {"type": "enum", "name": "Kind", "symbols": ["A", "B", "C"]}},
        {"name": "sig", "type": {"type": "fixed", "name": "Sig", "size": 4}},
        {"name": "nested", "type": {"type": "record", "name": "Inner",
                                    "fields": [{"name": "x", "type": "double"}]}},
    ]}
COMPLEX_ROWS = [
    {"id": 1, "name": "alpha", "tags": ["x", "y"], "props": {"p": 1.5},
     "kind": "A", "sig": b"\x01\x02\x03\x04", "nested": {"x": 0.5}},
    {"id": -7, "name": None, "tags": [], "props": {},
     "kind": "C", "sig": b"\xff\xfe\xfd\xfc", "nested": {"x": -1.25}},
]


@pytest.mark.parametrize("writer, reader", SIDES, ids=SIDE_IDS)
def test_avro_complex_datums_cross_read(writer, reader):
    for row in COMPLEX_ROWS:
        raw = _enc(writer, COMPLEX, row)
        assert raw == _enc(reader, COMPLEX, row)
        assert _dec(reader, COMPLEX, raw) == row
    # a negative block count carries the block's byte size
    assert _dec(reader, {"type": "array", "items": "long"}, b"\x03\x04\x06\x36\x00") == [3, 27]


def _fixed_sync(monkeypatch):
    for mod in (avro, ref_avro):
        monkeypatch.setattr(mod.os, "urandom", lambda n: bytes(range(n)))


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer, reader", SIDES, ids=SIDE_IDS)
def test_avro_container_files_are_byte_equal_and_cross_read(tmp_path, monkeypatch, codec,
                                                          writer, reader):
    _fixed_sync(monkeypatch)
    rows = COMPLEX_ROWS * 2500   # several sync-delimited blocks
    paths = []
    for mod in (writer, reader):
        path = str(tmp_path / f"{mod.__name__}.avro")
        w = mod.AvroFileWriter(path, COMPLEX, codec=codec)
        for r in rows:
            w.append(r)
        w.close()
        paths.append(path)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert list(reader.AvroFileReader(paths[0])) == rows
    rr = reader.AvroRecordReader(paths[0])
    assert list(rr.rows()) == rows and list(rr.rows()) == rows   # restartable
    rr.close()


def test_avro_container_errors(tmp_path):
    path = str(tmp_path / "x.avro")
    with avro.AvroFileWriter(path, COMPLEX) as w:
        w.append(COMPLEX_ROWS[0])
    data = open(path, "rb").read()
    for cut, match in ((data[:-3], "sync marker"), (data[:-30], "truncated")):
        (tmp_path / "cut.avro").write_bytes(cut)
        with pytest.raises(avro.AvroError, match=match):
            list(avro.AvroFileReader(str(tmp_path / "cut.avro")))
    (tmp_path / "bad.avro").write_bytes(b"nope")
    with pytest.raises(avro.AvroError, match="not an avro"):
        avro.AvroFileReader(str(tmp_path / "bad.avro"))
    with pytest.raises(avro.AvroError, match="codec"):
        avro.AvroFileWriter(str(tmp_path / "y.avro"), COMPLEX, codec="snappy")


@pytest.mark.parametrize("cut", [1, 3, 6], ids=["one_byte", "mid_string", "mid_double"])
def test_avro_truncated_datums_raise(cut):
    raw = _enc(avro, COMPLEX, COMPLEX_ROWS[0])
    with pytest.raises(avro.AvroError, match="truncated"):
        _dec(avro, COMPLEX, raw[:cut])
    with pytest.raises(ref_avro.AvroError, match="truncated"):
        _dec(ref_avro, COMPLEX, raw[:cut])


RESOLUTION = [
    ({"type": "record", "name": "R", "fields": [
        {"name": "a", "type": "int"}, {"name": "dropped", "type": "string"},
        {"name": "raw", "type": "bytes"}]},
     {"type": "record", "name": "R", "fields": [
         {"name": "a", "type": "double"}, {"name": "raw", "type": "string"},
         {"name": "added", "type": "long", "default": 42}]},
     {"a": 3, "dropped": "gone", "raw": b"hi"}),
    ('"string"', ["null", "string"], "v"),
    ('"int"', '"long"', -5),
    ('"long"', '"float"', 7),
    (["null", "int"], ["null", "long", "string"], 3),
]


@pytest.mark.parametrize("writer_schema, reader_schema, value", RESOLUTION,
                         ids=["record", "union_reader", "int_long", "long_float", "unions"])
def test_avro_schema_resolution_matches_the_reference(writer_schema, reader_schema, value):
    raw = _enc(avro, writer_schema, value)
    got = _dec(avro, writer_schema, raw, reader=reader_schema)
    want = _dec(ref_avro, writer_schema, raw, reader=reader_schema)
    assert got == want and type(got) is type(want)
    missing = {"type": "record", "name": "R", "fields": [{"name": "a", "type": "int"},
                                                          {"name": "b", "type": "int"}]}
    with pytest.raises(avro.AvroError, match="default"):
        _dec(avro, {"type": "record", "name": "R", "fields": [{"name": "a", "type": "int"}]},
             b"\x02", reader=missing)


@pytest.mark.parametrize("writer, reader", SIDES, ids=SIDE_IDS)
def test_avro_confluent_frames_cross_read(writer, reader):
    schema = {"type": "record", "name": "test", "fields": [
        {"name": "a", "type": "long"}, {"name": "b", "type": "string"}]}
    wreg, rreg = writer.LocalSchemaRegistry(), reader.LocalSchemaRegistry()
    sid = wreg.register(schema)
    assert rreg.register(schema) == sid
    msg = writer.encode_confluent(sid, schema, {"a": 27, "b": "foo"})
    assert msg == b"\x00" + struct.pack(">I", sid) + b"\x36\x06foo"
    assert msg == reader.encode_confluent(sid, schema, {"a": 27, "b": "foo"})
    assert reader.confluent_avro_decoder(msg, rreg) == {"a": 27, "b": "foo"}
    for bad, match in ((b"\x01junk", "magic"), (b"\x00\x00\x01", "truncated confluent"),
                       (msg[:-2], "truncated avro"), (b"\x00" + struct.pack(">I", 99),
                                                      "unknown schema id")):
        with pytest.raises(reader.AvroError, match=match):
            reader.confluent_avro_decoder(bad, rreg)
    simple = reader.make_simple_avro_decoder(schema)
    assert simple(msg[5:]) == {"a": 27, "b": "foo"}


# -- Thrift -------------------------------------------------------------------------

IDL = """
// test schema
enum Color { BLUE = 0, RED = 2, GREEN }

typedef i64 Timestamp

struct Inner {
  1: required string label;
  2: optional double weight;
}

struct Event {
  1: required string user;
  2: optional i64 clicks;
  3: optional double cost;
  4: optional bool active;
  5: optional list<i32> codes;
  6: optional map<string, double> props;
  7: optional Inner inner;
  8: optional Color color;
  9: optional Timestamp ts;
  10: optional binary blob;
  11: optional set<string> tags;
  12: optional list<list<i16>> grid;
  13: optional byte small;
}
"""
THRIFT_ROW = {
    "user": "alice", "clicks": -42, "cost": 3.75, "active": True,
    "codes": [1, -2, 300], "props": {"a": 1.5}, "inner": {"label": "x", "weight": 0.5},
    "color": 2, "ts": 1700000000000, "blob": b"\x00\xff", "tags": ["t1"],
    "grid": [[1, 2], [], [-3]], "small": -5,
}
THRIFT_SIDES = [(thriftfmt, ref_thrift), (ref_thrift, thriftfmt)]


def test_thrift_golden_binary_struct():
    idl = thriftfmt.ThriftIDL(IDL)
    assert idl.enums["Color"] == {0: "BLUE", 2: "RED", 3: "GREEN"}
    assert idl.struct("Event").fields[9].ttype == 10   # typedef Timestamp -> i64
    data = b"\x0b\x00\x01\x00\x00\x00\x02hi\x00"
    st = idl.struct("Inner")
    assert thriftfmt.encode_struct(idl, st, {"label": "hi"}) == data
    assert thriftfmt.decode_struct(idl, st, thriftfmt._Reader(io.BytesIO(data))) == \
        {"label": "hi"}
    data2 = (b"\x0b\x00\x01\x00\x00\x00\x01u"
             b"\x0a\x00\x02\xff\xff\xff\xff\xff\xff\xff\xd6\x00")
    assert thriftfmt.decode_struct(idl, idl.struct("Event"),
                                   thriftfmt._Reader(io.BytesIO(data2))) == \
        {"user": "u", "clicks": -42}


@pytest.mark.parametrize("writer, reader", THRIFT_SIDES, ids=SIDE_IDS)
def test_thrift_structs_cross_read(tmp_path, writer, reader):
    widl, ridl = writer.ThriftIDL(IDL), reader.ThriftIDL(IDL)
    raw = writer.encode_struct(widl, widl.struct("Event"), THRIFT_ROW)
    assert raw == reader.encode_struct(ridl, ridl.struct("Event"), THRIFT_ROW)
    assert reader.decode_struct(ridl, ridl.struct("Event"),
                                reader._Reader(io.BytesIO(raw))) == THRIFT_ROW
    # a file of back-to-back structs with its IDL sidecar; the record struct named
    path = str(tmp_path / "events.thrift")
    rows = [THRIFT_ROW, {"user": "bob"}, dict(THRIFT_ROW, user="cy", codes=[])] * 50
    writer.write_structs(path, widl, widl.struct("Event"), rows)
    with open(path + ".thrift", "w") as f:
        f.write(IDL)
    with open(path + ".msg", "w") as f:
        f.write("Event")
    side = readers if reader is thriftfmt else ref_readers
    assert list(side.reader_for(path).rows()) == rows
    decode = reader.make_thrift_decoder(IDL, "Event")
    assert decode(raw) == THRIFT_ROW


def test_thrift_unknown_fields_and_truncation():
    idl = thriftfmt.ThriftIDL(IDL)
    st = idl.struct("Inner")
    body = thriftfmt.encode_struct(idl, st, {"label": "x"})
    evolved = body[:-1] + b"\x08\x00\x63\x00\x00\x00\x2a" + b"\x00"
    assert thriftfmt.decode_struct(idl, st, thriftfmt._Reader(io.BytesIO(evolved))) == \
        {"label": "x"}
    raw = thriftfmt.encode_struct(idl, idl.struct("Event"), THRIFT_ROW)
    for cut in (1, 5, len(raw) - 4):
        with pytest.raises(thriftfmt.ThriftError, match="truncated"):
            thriftfmt.decode_struct(idl, idl.struct("Event"),
                                    thriftfmt._Reader(io.BytesIO(raw[:cut])))


def test_thrift_reader_needs_its_sidecar(tmp_path):
    path = str(tmp_path / "x.thrift")
    open(path, "wb").close()
    with pytest.raises(thriftfmt.ThriftError, match="sidecar"):
        readers.reader_for(path)
    with open(path + ".thrift", "w") as f:
        f.write(IDL)
    with pytest.raises(thriftfmt.ThriftError, match="structs"):
        readers.reader_for(path)


# -- Protobuf -----------------------------------------------------------------------

PROTO_SRC = """
syntax = "proto3";
package bench;

message Inner {
  string label = 1;
  double weight = 2;
}

enum Level { LOW = 0; HIGH = 5; }

message Event {
  string user = 1;
  int64 clicks = 2;
  double cost = 3;
  sint64 delta = 4;
  bool active = 5;
  fixed32 shard = 6;
  repeated int32 codes = 7;
  repeated string tags = 8;
  Inner inner = 9;
  bytes blob = 10;
  float ratio = 11;
  sfixed64 big = 12;
  uint32 count = 13;
  Level level = 14;
  repeated double xs = 15;
}
"""
PROTO_ROW = {"user": "alice", "clicks": -42, "cost": 3.75, "delta": -7, "active": True,
             "shard": 9, "codes": [1, -2, 300], "tags": ["a", "b"],
             "inner": {"label": "x", "weight": 0.5}, "blob": b"\x00\xff", "ratio": 0.25,
             "big": -(1 << 40), "count": 7, "level": 5, "xs": [1.5, -2.0]}
PROTO_SIDES = [(proto, ref_proto), (ref_proto, proto)]


@pytest.mark.parametrize("v, raw", [(0, b"\x00"), (1, b"\x01"), (127, b"\x7f"),
                                    (128, b"\x80\x01"), (300, b"\xac\x02"),
                                    ((1 << 64) - 1, b"\xff" * 9 + b"\x01")])
def test_proto_golden_varints(v, raw):
    assert proto.write_uvarint(v) == raw == ref_proto.write_uvarint(v)
    assert proto.read_uvarint(raw, 0) == (v, len(raw))


def test_proto_golden_field_tags():
    assert list(proto.iter_fields(b"\x08\x96\x01")) == [(1, 0, 150)]
    assert list(proto.iter_fields(b"\x12\x07testing")) == [(2, 2, b"testing")]
    with pytest.raises(proto.ProtoError, match="truncated"):
        list(proto.iter_fields(b"\x12\x07test"))
    with pytest.raises(proto.ProtoError, match="truncated"):
        proto.read_uvarint(b"\x80\x80", 0)


@pytest.fixture(scope="module")
def bench_desc(tmp_path_factory):
    if not HAVE_PROTOC:
        pytest.skip("protoc is not installed")
    return proto.compile_proto(PROTO_SRC, str(tmp_path_factory.mktemp("proto")))


@needs_protoc
def test_compile_proto_matches_the_reference(tmp_path, bench_desc):
    assert bench_desc == ref_proto.compile_proto(PROTO_SRC, str(tmp_path))


@needs_protoc
@pytest.mark.parametrize("writer, reader", PROTO_SIDES, ids=SIDE_IDS)
def test_proto_messages_cross_read(tmp_path, bench_desc, writer, reader):
    wpool, rpool = writer.DescriptorPool(bench_desc), reader.DescriptorPool(bench_desc)
    raw = writer.encode_message(wpool, wpool.message("bench.Event"), PROTO_ROW)
    assert raw == reader.encode_message(rpool, rpool.message("bench.Event"), PROTO_ROW)
    assert reader.decode_message(rpool, rpool.message("bench.Event"), raw) == PROTO_ROW
    path = str(tmp_path / "events.pb")
    rows = [PROTO_ROW, {"user": "bob"}, dict(PROTO_ROW, codes=[], tags=["z"])] * 40
    writer.write_delimited(path, wpool, wpool.message("bench.Event"), rows)
    with open(path + ".desc", "wb") as f:
        f.write(bench_desc)
    with open(path + ".msg", "w") as f:
        f.write("bench.Event")
    side = readers if reader is proto else ref_readers
    got = list(side.reader_for(path).rows())
    assert got == [reader.decode_message(rpool, rpool.message("bench.Event"),
                                         writer.encode_message(wpool, wpool.message(
                                             "bench.Event"), r)) for r in rows]
    assert got[0] == PROTO_ROW and got[1]["clicks"] == 0   # proto3 implicit default
    decode = reader.make_proto_decoder(bench_desc, "bench.Event")
    assert decode(raw) == PROTO_ROW


@needs_protoc
def test_proto_reads_protoc_encoded_bytes(tmp_path, bench_desc):
    pool = proto.DescriptorPool(bench_desc)
    (tmp_path / "schema.proto").write_text(PROTO_SRC)
    text = ('user: "bob" clicks: 5 cost: 1.5 delta: -3 active: true shard: 2 codes: 1 '
            'codes: 2 tags: "t1" inner { label: "in" weight: 2.25 } blob: "hi" level: HIGH')
    enc = subprocess.run(["protoc", f"--proto_path={tmp_path}", "--encode=bench.Event",
                          str(tmp_path / "schema.proto")],
                         input=text.encode(), capture_output=True, check=True)
    out = proto.decode_message(pool, pool.message("bench.Event"), enc.stdout)
    assert out == ref_proto.decode_message(ref_proto.DescriptorPool(bench_desc),
                                           ref_proto.DescriptorPool(bench_desc).message(
                                               "bench.Event"), enc.stdout)
    assert out["codes"] == [1, 2] and out["level"] == 5 and out["inner"]["weight"] == 2.25


@needs_protoc
def test_proto2_defaults_oneof_and_groups_match_the_reference(tmp_path):
    src = """
syntax = "proto2";
package p2;
enum Color { BLUE = 0; RED = 2; }
message Legacy {
  optional int32 retries = 1 [default = 3];
  optional string mode = 2 [default = "auto"];
  oneof id { int64 uid = 3; string name = 4; }
  optional Color c = 5 [default = RED];
  optional bytes magic = 6 [default = "\\001\\377A"];
  optional group Old = 7 { optional int32 x = 1; }
  repeated int32 packed = 8 [packed = true];
}
"""
    desc = proto.compile_proto(src, str(tmp_path))
    pool, rpool = proto.DescriptorPool(desc), ref_proto.DescriptorPool(desc)
    for row in ({"name": "x"}, {"uid": 9, "packed": [1, 2, 3]}, {}):
        raw = proto.encode_message(pool, pool.message("p2.Legacy"), row)
        assert raw == ref_proto.encode_message(rpool, rpool.message("p2.Legacy"), row)
        got = proto.decode_message(pool, pool.message("p2.Legacy"), raw)
        assert got == ref_proto.decode_message(rpool, rpool.message("p2.Legacy"), raw)
        assert got["retries"] == 3 and got["mode"] == "auto" and got["c"] == 2
        assert got["magic"] == b"\x01\xffA"
    grouped = proto.encode_message(pool, pool.message("p2.Legacy"), {"retries": 7}) + \
        b"\x3b\x08\x01\x3c"
    assert proto.decode_message(pool, pool.message("p2.Legacy"), grouped)["retries"] == 7


def test_lineorder_descriptor_reads_ssb_rows_in_both_packages(tmp_path):
    """The committed descriptor set (the chip smoke's Protobuf schema) round
    trips SSB rows through either package's delimited writer and reader."""
    with open(os.path.join(DATA, "lineorder.desc"), "rb") as f:
        desc = f.read()
    cols = ssb.make_columns(500, 20261115)
    names = [f.name for f in ssb.ssb_schema().fields]
    rows = [dict(zip(names, r)) for r in zip(*[cols[c].tolist() for c in names])]
    outs = []
    for mod, side in ((proto, readers), (ref_proto, ref_readers)):
        pool = mod.DescriptorPool(desc)
        assert len(pool.messages) == 1 and pool.message("ssb.LineOrder").fields
        path = str(tmp_path / f"{mod.__name__}.pb")
        mod.write_delimited(path, pool, pool.message("ssb.LineOrder"), rows)
        shutil.copy(os.path.join(DATA, "lineorder.desc"), path + ".desc")
        assert list(side.reader_for(path).rows()) == rows
        outs.append(open(path, "rb").read())
    assert outs[0] == outs[1]


@needs_protoc
def test_committed_lineorder_descriptor_is_protocs_output(tmp_path):
    out = tmp_path / "lineorder.desc"
    subprocess.run(["protoc", f"--proto_path={DATA}", f"--descriptor_set_out={out}",
                    os.path.join(DATA, "lineorder.proto")], check=True, capture_output=True)
    with open(os.path.join(DATA, "lineorder.desc"), "rb") as f:
        assert out.read_bytes() == f.read()


def test_proto_truncated_files_and_missing_sidecar(tmp_path):
    with open(os.path.join(DATA, "lineorder.desc"), "rb") as f:
        desc = f.read()
    pool = proto.DescriptorPool(desc)
    path = str(tmp_path / "t.pb")
    proto.write_delimited(path, pool, pool.message("ssb.LineOrder"),
                          [{"lo_region": "ASIA", "lo_custkey": 5}] * 3)
    data = open(path, "rb").read()
    for cut, match in ((data[:-2], "truncated delimited"), (data + b"\x80", "truncated varint")):
        with open(path, "wb") as f:
            f.write(cut)
        with pytest.raises(proto.ProtoError, match=match):
            list(proto.ProtoRecordReader(path, desc).rows())
    with pytest.raises(proto.ProtoError, match="sidecar"):
        readers.reader_for(path)
    with pytest.raises(proto.ProtoError, match="packed"):
        proto._unpack_packed(proto.T_FIXED64, b"\x00" * 12)


# -- CSV, JSON lines, Parquet, ORC --------------------------------------------------

ROWS = [{"user": "a", "country": "us", "value": "1.5", "clicks": "3"},
        {"user": "b,c", "country": "", "value": "2", "clicks": "4"},
        {"user": "d\"e", "country": "fr", "value": "-3.25", "clicks": "0"}]


def test_csv_rows_match_the_reference(tmp_path):
    import csv
    path = tmp_path / "x.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(ROWS[0]))
        w.writeheader()
        w.writerows(ROWS)
    got = list(readers.reader_for(str(path)).rows())
    assert got == list(ref_readers.reader_for(str(path)).rows())
    assert got[1]["country"] is None and got[1]["user"] == "b,c"
    tsv = tmp_path / "x.tsv"
    tsv.write_text("a\tb\n1\t\n")
    assert list(readers.CsvRecordReader(str(tsv), delimiter="\t").rows()) == \
        [{"a": "1", "b": None}]


def test_json_lines_rows_match_the_reference(tmp_path):
    import json
    path = tmp_path / "x.json"
    path.write_text("\n".join(json.dumps(r) for r in ROWS) + "\n\n")
    for ext in ("json", "jsonl"):
        got = list(readers.reader_for(str(path), ext).rows())
        assert got == list(ref_readers.reader_for(str(path), ext).rows()) == ROWS


def test_rows_to_columns_and_the_registry():
    schema = ssb.ssb_schema()
    rows = [{"lo_region": "ASIA", "lo_quantity": 3}, {"lo_custkey": 9}]
    from pinot_tpu.schema import Schema as JSchema
    assert readers.rows_to_columns(rows, schema) == \
        ref_readers.rows_to_columns(rows, JSchema.from_json(schema.to_json()))
    assert list(readers.DictRecordReader(rows).rows()) == rows
    with pytest.raises(ValueError, match="no record reader"):
        readers.reader_for("x.xyz")
    readers.register_reader("xyz", lambda path: readers.DictRecordReader([{"p": path}]))
    assert list(readers.reader_for("a.XYZ").rows()) == [{"p": "a.XYZ"}]


def test_parquet_rows_match_the_reference(tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    frame = pd.DataFrame({"user": ["a", "b", None], "value": [1.5, 2.0, -3.25],
                          "clicks": [3, 4, 0]})
    path = str(tmp_path / "x.parquet")
    frame.to_parquet(path)
    got = list(readers.reader_for(path).rows())
    assert got == list(ref_readers.reader_for(path).rows())
    assert got[0] == {"user": "a", "value": 1.5, "clicks": 3}


def test_orc_rows_match_the_reference(tmp_path):
    pa = pytest.importorskip("pyarrow")
    orc = pytest.importorskip("pyarrow.orc")
    table = pa.table({"user": ["a", "b", None], "value": [1.5, 2.0, -3.25],
                      "clicks": [3, 4, 0]})
    path = str(tmp_path / "x.orc")
    orc.write_table(table, path, stripe_size=64)
    got = list(readers.reader_for(path).rows())
    assert got == list(ref_readers.reader_for(path).rows()) == table.to_pylist()


def test_no_reader_imports_pandas_pyarrow_or_a_codec_until_asked():
    code = ("import sys; import pinot_tpu_torch.ingest.readers, pinot_tpu_torch.ingest.stream, "
            "pinot_tpu_torch.ingest.batch, pinot_tpu_torch.ingest.dataframe; "
            "bad = [m for m in ('pandas', 'pyarrow', 'pinot_tpu_torch.ingest.avro', "
            "'pinot_tpu_torch.ingest.proto', 'pinot_tpu_torch.ingest.thriftfmt', 'subprocess') "
            "if m in sys.modules]; print(bad); assert not [m for m in bad if m != 'subprocess']")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr


# -- the stream decoder registry ----------------------------------------------------

def test_stream_decoders_are_registered_as_in_the_reference():
    assert stream.get_decoder("json")(b'{"a": 1}') == {"a": 1}
    assert stream.get_decoder("dict")({"a": 1}) == {"a": 1}
    schema = {"type": "record", "name": "t", "fields": [{"name": "v", "type": "double"}]}
    sid = avro.DEFAULT_REGISTRY.register(schema)
    assert stream.get_decoder("avro")(avro.encode_confluent(sid, schema, {"v": 2.5})) == \
        {"v": 2.5}
    with pytest.raises(NotImplementedError, match="no stream decoder 'columnar'"):
        stream.get_decoder("columnar")   # a block stream: no row decoder
    assert stream.get_block_decoder("columnar") is not None
    assert stream.get_block_decoder("json") is None
    assert stream.get_batch_decoder("json")([b'{"a": 1}', '{"a": 2}']) == [{"a": 1}, {"a": 2}]
    with pytest.raises(NotImplementedError, match="no stream decoder 'thrift_events'"):
        stream.get_decoder("thrift_events")
    stream.register_decoder("thrift_events", thriftfmt.make_thrift_decoder(IDL, "Inner"))
    idl = thriftfmt.ThriftIDL(IDL)
    assert stream.get_decoder("thrift_events")(
        thriftfmt.encode_struct(idl, idl.struct("Inner"), {"label": "q"})) == {"label": "q"}
