"""The port's Kafka wire format (`pinot_tpu_torch/ingest/kafka_wire.py`) and its
native helpers (`pinot_tpu_torch/native/`) against the JAX package's.

* The JAX package's vectors (`tests/test_kafka_wire.py`): CRC-32C, zigzag
  varints, the record batch v2 and request frame golden bytes, the API bodies.
* The port's encoded bytes equal the JAX package's for the same seeded inputs,
  and each package decodes the other's.
* The native CRC-32C against the JAX package's pure-Python CRC (the yardstick),
  and the native library builds into `pinot_tpu_torch/_build/`.
"""

import os
import struct

import numpy as np
import pytest

from pinot_tpu.ingest import kafka_wire as jkw
from pinot_tpu_torch import native
from pinot_tpu_torch.ingest import kafka_wire as kw

SEED = 20261018


def test_crc32c_standard_vectors():
    assert kw.crc32c(b"123456789") == 0xE3069283
    assert kw.crc32c(b"") == 0
    assert kw.crc32c(bytes(32)) == 0x8A9136AA   # the iSCSI vector: 32 zero bytes


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 63, 64, 65, 1000, 65_537])
def test_native_crc32c_equals_the_python_yardstick(size):
    """Every length around the slice-by-8 walk's edges, and a continued CRC."""
    data = np.random.default_rng(SEED + size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert native.crc32c(data) == jkw._crc32c_py(data)
    head = data[:size // 3]
    assert native.crc32c(data[size // 3:], native.crc32c(head)) == jkw._crc32c_py(data)


def test_native_library_builds_into_the_build_dir():
    native.get_lib()
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), "_build")


def test_zigzag_varint():
    cases = {0: b"\x00", -1: b"\x01", 1: b"\x02", -2: b"\x03",
             7: b"\x0e", 63: b"\x7e", 64: b"\x80\x01", -64: b"\x7f"}
    for v, raw in cases.items():
        assert kw.varint(v) == raw, v
        assert kw.Reader(raw).varint() == v


def test_record_batch_v2_golden_bytes():
    """One record (no key, value b'x', ts 1000) at base offset 5, every field
    assembled by hand from the v2 spec."""
    got = kw.encode_record_batch(5, [(None, b"x", 1000)])
    record_body = b"\x00" + b"\x00" + b"\x00" + b"\x01" + b"\x02" + b"x" + b"\x00"
    records = kw.varint(len(record_body)) + record_body
    crc_part = (struct.pack(">h", 0) + struct.pack(">i", 0) + struct.pack(">q", 1000)
                + struct.pack(">q", 1000) + struct.pack(">q", -1) + struct.pack(">h", -1)
                + struct.pack(">i", -1) + struct.pack(">i", 1) + records)
    inner = (struct.pack(">i", -1) + b"\x02"
             + struct.pack(">I", jkw._crc32c_py(crc_part)) + crc_part)
    assert got == struct.pack(">q", 5) + struct.pack(">i", len(inner)) + inner


def test_record_batch_roundtrip_and_corruption():
    recs = [(b"k0", b"value-zero", 1_700_000_000_000), (None, b"v1", 1_700_000_000_050),
            (b"k2", b"", 1_700_000_000_100)]
    data = kw.encode_record_batch(40, recs)
    assert kw.decode_record_batches(data) == [
        (40, 1_700_000_000_000, b"k0", b"value-zero"), (41, 1_700_000_000_050, None, b"v1"),
        (42, 1_700_000_000_100, b"k2", b"")]
    data2 = data + kw.encode_record_batch(43, [(None, b"tail", 7)])
    assert [v for *_x, v in kw.decode_record_batches(data2)] == \
        [b"value-zero", b"v1", b"", b"tail"]
    bad = bytearray(kw.encode_record_batch(0, [(None, b"payload", 1)]))
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        kw.decode_record_batches(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        kw.splice_record_batches(bytes(bad), 0)


def test_a_malformed_record_section_raises():
    """A batch whose CRC holds but whose records do not walk raises: there
    is no second lane to take it."""
    frame = bytes(kw.encode_record_batch(0, [(None, b"abc", 1)]))
    body = bytearray(frame[21:])
    body[40] = 0x7e   # the record's length (the section's first byte): past the end
    broken = frame[:17] + struct.pack(">I", kw.crc32c(bytes(body))) + bytes(body)
    with pytest.raises(ValueError):
        kw.decode_record_batches(broken)
    with pytest.raises(ValueError):
        kw.splice_record_batches(broken, 0)


def test_request_frame_golden_bytes():
    got = kw.encode_request(kw.API_PRODUCE, 3, 7, "pinot", b"BODY")
    payload = (struct.pack(">h", 0) + struct.pack(">h", 3) + struct.pack(">i", 7)
               + struct.pack(">h", 5) + b"pinot" + b"BODY")
    assert got == struct.pack(">i", len(payload)) + payload
    api, version, cid, client, r = kw.decode_request_header(payload)
    assert (api, version, cid, client) == (0, 3, 7, "pinot")
    assert r.data[r.pos:] == b"BODY"


def test_api_bodies_roundtrip():
    meta = kw.decode_metadata_response(1, kw.Reader(
        kw.encode_metadata_response(1, "127.0.0.1", 9092, {"t": 3})))
    assert meta["brokers"][0]["port"] == 9092 and len(meta["topics"][0]["partitions"]) == 3
    assert kw.decode_list_offsets_response(kw.Reader(
        kw.encode_list_offsets_response([("t", 0, 0, -1, 42)]))) == [
        {"topic": "t", "partition": 0, "error": 0, "timestamp": -1, "offset": 42}]
    rs = kw.encode_record_batch(10, [(None, b"a", 1), (None, b"b", 2)])
    out = kw.decode_fetch_response(kw.Reader(kw.encode_fetch_response([("t", 1, 0, 12, rs)])))
    assert out[0]["highWatermark"] == 12 and [v for *_x, v in out[0]["records"]] == [b"a", b"b"]
    assert kw.decode_produce_response(kw.Reader(
        kw.encode_produce_response([("t", 0, 0, 99)])))[0]["offset"] == 99
    assert kw.decode_api_versions_response(
        kw.Reader(kw.encode_api_versions_response())) == kw.SUPPORTED == jkw.SUPPORTED
    body = kw.encode_fetch_request("topic", 2, 1234, 500, 1 << 20)
    assert kw.decode_fetch_request(kw.Reader(body)) == (500, 1 << 20,
                                                        [("topic", 2, 1234, 1 << 20)])


def _seeded_records(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = None if rng.random() < 0.4 else rng.bytes(int(rng.integers(0, 12)))
        value = rng.bytes(int(rng.integers(0, 300)))
        out.append((key, value, 1_700_000_000_000 + int(rng.integers(0, 10_000))))
    return out


def _encodings(mod, records):
    """Every encoder of a wire module over the same inputs."""
    batch = mod.encode_record_batch(77, records)
    return {
        "batch": batch,
        "request": mod.encode_request(mod.API_FETCH, 4, 9, "c", b"xyz"),
        "response": mod.encode_response(9, b"body"),
        "api_versions": mod.encode_api_versions_response(),
        "metadata_req": mod.encode_metadata_request(["a", "b"]),
        "metadata_v0": mod.encode_metadata_response(0, "h", 1, {"b": 2, "a": 1}),
        "metadata_v1": mod.encode_metadata_response(1, "h", 1, {"b": 2, "a": 1}),
        "list_offsets_req": mod.encode_list_offsets_request("t", 3, -2),
        "list_offsets": mod.encode_list_offsets_response([("t", 0, 0, -1, 5), ("u", 1, 3, 7, 9)]),
        "fetch_req": mod.encode_fetch_request("t", 1, 42, 100, 1 << 16),
        "fetch": mod.encode_fetch_response([("t", 0, 0, 80, batch), ("t", 1, 3, -1, b"")]),
        "produce_req": mod.encode_produce_request("t", 0, batch),
        "produce": mod.encode_produce_response([("t", 0, 0, 77)]),
        "create_req": mod.encode_create_topics_request("t", 4),
        "create": mod.encode_create_topics_response([("t", 0), ("u", 36)]),
    }


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_encoded_bytes_equal_the_reference(seed):
    records = _seeded_records(SEED + seed, 40)
    ours, ref = _encodings(kw, records), _encodings(jkw, records)
    assert ours.keys() == ref.keys()
    for name in ours:
        assert ours[name] == ref[name], name
    # each decodes the other's batches, with the same records and splices
    data = ours["batch"] + jkw.encode_record_batch(117, records[:5])
    assert kw.decode_record_batches(data) == jkw.decode_record_batches(data)
    for min_offset in (0, 90, 200):
        for sep in (b",", b"\n"):
            assert kw.splice_record_batches(data, min_offset, sep) == \
                jkw.splice_record_batches(data, min_offset, sep)
    assert kw.splice_record_batches(data, 0, max_records=7) == \
        jkw.splice_record_batches(data, 0, max_records=7)
    fetch = kw.decode_fetch_response(kw.Reader(ref["fetch"]))
    assert fetch == jkw.decode_fetch_response(jkw.Reader(ours["fetch"]))
