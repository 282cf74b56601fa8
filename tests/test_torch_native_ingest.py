"""The realtime consume path's native lanes, the port's against the JAX package's.

* The C splice against the record walk (`splice_record_batches` against
  `decode_record_batches`), its record cap exact.
* `columns_from_spliced_json` against the transform pipeline over fuzzed rows
  and against the JAX package's function; `columnar_batch_from_json` against
  the JAX package's.
* The consumer over a kafkalite partition (`RealtimePartitionConsumer` through
  the stream factory): the spliced block lane, the JSON array lane, the raw
  lane (a batch decoder that cannot read spliced values) and the per-row lane,
  each pumped beside the JAX package's consumer on the same broker, with the
  same offsets, lanes and consuming-segment arrays; `close()` releases the
  socket.
"""

import json

import numpy as np
import pytest

from pinot_tpu.ingest import realtime as jax_realtime
from pinot_tpu.ingest import stream as jax_stream
from pinot_tpu.ingest.transform import columns_from_spliced_json as jax_columns
from pinot_tpu.ingest.vectorized import columnar_batch_from_json as jax_batch_from_json
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.table import StreamConfig as JaxStreamConfig
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu.table import TableType as JaxTableType
from pinot_tpu_torch.ingest import kafka_wire as kw
from pinot_tpu_torch.ingest import stream
from pinot_tpu_torch.ingest.kafkalite import LogBrokerClient, LogBrokerServer
from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
from pinot_tpu_torch.ingest.transform import (TransformPipeline, columns_from_spliced_json,
                                              rows_to_all_columns)
from pinot_tpu_torch.ingest.vectorized import columnar_batch_from_json, encode_columnar_block
from pinot_tpu_torch.schema import DataType, Schema, date_time, dimension, metric

SEG_NAME = "events__0__0__20261018T0000Z"
PUMP = 7   # messages a pump takes, on both sides


def _schema():
    return Schema("events", [dimension("site", DataType.STRING), metric("clicks", DataType.LONG),
                             metric("cost", DataType.DOUBLE), date_time("ts", DataType.LONG)])


def test_splice_matches_decode():
    rng = np.random.default_rng(3)
    values = [json.dumps({"v": int(v), "s": f"x{v % 7}"}).encode()
              for v in rng.integers(0, 1000, 500)]
    batches, off = b"", 0
    for lo in range(0, len(values), 37):
        chunk = values[lo:lo + 37]
        batches += kw.encode_record_batch(off, [(None, v, 1_700_000_000_000 + i)
                                                for i, v in enumerate(chunk)])
        off += len(chunk)
    for min_off in (0, 100, 499, 500):
        data, n, last = kw.splice_record_batches(batches, min_off)
        want = [v for o, _ts, _k, v in kw.decode_record_batches(batches) if o >= min_off]
        assert n == len(want) and data == b",".join(want)
        if want:
            assert last == off - 1
    data, n, last = kw.splice_record_batches(batches, 0, max_records=50)
    assert n == 50 and data == b",".join(values[:50]) and last == 49


def _fuzz_rows(rng, n):
    rows = []
    for _ in range(n):
        row = {}
        if rng.random() < 0.95:
            row["site"] = str(rng.choice(["plain", 'quo"te', "unié", "", "tab\there"]))
        if rng.random() < 0.9:
            row["clicks"] = int(rng.integers(-2**40, 2**40))
        if rng.random() < 0.9:
            row["cost"] = [1.5, -0.25, 1e12, 3, None][rng.integers(0, 5)]
        if rng.random() < 0.8:
            row["ts"] = int(rng.integers(0, 2**45))
        if rng.random() < 0.3:
            row["extra"] = {"nested": [1, {"deep": "x"}]}
        rows.append(row)
    return rows


@pytest.mark.parametrize("trial", range(6))
def test_columns_match_the_pipeline_and_the_reference(trial):
    rng = np.random.default_rng(11 + trial)
    schema = _schema()
    rows = _fuzz_rows(rng, int(rng.integers(1, 120)))
    data = ",".join(json.dumps(r) for r in rows).encode()
    got = columns_from_spliced_json(data, len(rows), schema)
    want = TransformPipeline(schema).apply(rows_to_all_columns(rows))
    assert set(got) == set(want)
    for k in want:
        for a, b in zip(got[k], want[k], strict=True):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12), (k, a, b)
            else:
                assert a == b and type(a) is type(b), (k, a, b)
    assert got == jax_columns(data, len(rows), JSchema.from_json(schema.to_json()))


def test_columns_int64_overflow_missing_and_multi_value():
    schema = _schema()
    rows = [{"site": "a", "clicks": 2**70, "cost": 1.0, "ts": 1}, {"site": "b"}]
    data = ",".join(json.dumps(r) for r in rows).encode()
    got = columns_from_spliced_json(data, 2, schema)
    assert got == TransformPipeline(schema).apply(rows_to_all_columns(rows))
    assert got["clicks"] == [2**70, None]
    mv = Schema("t", [dimension("tags", DataType.STRING, single_value=False)])
    assert columns_from_spliced_json(b'{"tags":["a"]}', 1, mv) is None


@pytest.mark.parametrize("case", ["plain", "nulls", "escaped"])
def test_columnar_batch_from_json_matches_the_reference(case):
    rng = np.random.default_rng(5)
    n = 300
    rows = [{"site": f"s{int(k)}", "clicks": int(c), "cost": float(x), "ts": 1_700_000_000_000 + i}
            for i, (k, c, x) in enumerate(zip(rng.integers(0, 9, n), rng.integers(-9, 9, n),
                                              np.round(rng.random(n), 3)))]
    if case == "nulls":
        for r in rows[::4]:
            r["cost"] = None
            del r["site"]
    if case == "escaped":
        rows[3]["site"] = 'with "quote"'
    data = ",".join(json.dumps(r) for r in rows).encode()
    got = columnar_batch_from_json(data, n, _schema())
    want = jax_batch_from_json(data, n, JSchema.from_json(_schema().to_json()))
    if case == "escaped":
        assert got is None and want is None   # the per-cell lane takes it
        return
    assert got.n == want.n == n and list(got.cols) == list(want.cols)
    for c, rep in want.cols.items():
        ours = got.cols[c]
        assert ours[0] == rep[0], c
        for a, b in zip(ours[1:], rep[1:]):
            assert (a is None and b is None) or np.asarray(a).tolist() == np.asarray(b).tolist(), c


# -- the consumer's lanes over a kafkalite partition ---------------------------

@pytest.fixture()
def broker():
    srv = LogBrokerServer()
    yield srv
    srv.stop()


def _assert_arrays_equal(a, b):
    assert list(a) == list(b)
    for c in b:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype and x.tolist() == y.tolist(), c


def _pair(tmp_path, bootstrap, topic, decoder, dedup=False):
    """The port's consumer (`device="cpu"`, staged) and the JAX package's on
    the same kafkalite partition."""
    props = {"bootstrap": bootstrap, "realtime.ingest.device.staging": "true",
             "realtime.ingest.batch.size": PUMP}
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
    from pinot_tpu_torch.upsert import PartitionDedupMetadataManager
    ours = RealtimePartitionConsumer(
        SEG_NAME, TableConfig("events", table_type=TableType.REALTIME, stream=StreamConfig(
            stream_type="kafkalite", topic=topic, decoder=decoder, properties=props,
            flush_threshold_rows=100_000)),
        _schema(), 0, str(tmp_path / "ours"), device="cpu",
        dedup=PartitionDedupMetadataManager() if dedup else None)
    jdedup = None
    if dedup:
        from pinot_tpu.upsert import PartitionDedupMetadataManager as JaxDedup
        jdedup = JaxDedup()
    ref = jax_realtime.RealtimePartitionConsumer(
        SEG_NAME, JaxTableConfig("events", table_type=JaxTableType.REALTIME,
                                 stream=JaxStreamConfig(
                                     stream_type="kafkalite", topic=topic, decoder=decoder,
                                     properties=props, flush_threshold_rows=100_000)),
        JSchema.from_json(_schema().to_json()), 0, "server_0", None, str(tmp_path / "ref"),
        dedup=jdedup)
    return ours, ref


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"site": f"s{int(k)}.com", "clicks": int(c), "cost": float(x),
             "ts": 1_700_000_000_000 + i}
            for i, (k, c, x) in enumerate(zip(rng.integers(0, 11, n), rng.integers(0, 99, n),
                                              np.round(rng.random(n) * 50, 3)))]


def _pump_both(ours, ref, total):
    lanes = set()
    while ours.offset < total:
        got, want = ours.pump(), ref.pump()
        assert got == want and ours.offset == ref.offset, (got, want)
        assert ours.last_decode_path == ref.last_decode_path
        lanes.add(ours.last_decode_path)
    return lanes


@pytest.mark.parametrize("lane", ["blocks", "columnar-array", "raw", "row"])
def test_consumer_lanes_over_kafkalite_match_the_reference(tmp_path, broker, lane):
    client = LogBrokerClient(broker.bootstrap)
    topic = f"ev_{lane.replace('-', '_')}"
    client.create_topic(topic, 1)
    n = 600
    rows = _rows(n, seed=17)
    if lane == "blocks":
        cols = {c: [r[c] for r in rows] for c in rows[0]}
        payloads = [encode_columnar_block(_schema(), {c: v[lo:lo + 50] for c, v in cols.items()})
                    for lo in range(0, n, 50)]
        decoder = "columnar"
    else:
        payloads = [json.dumps(r) for r in rows]
        decoder = "json"
    if lane == "raw":
        # a batch decoder with no spliced form: the consumer takes fetch_raw
        decoder = "json_unspliced"

        def unspliced(values):
            return [json.loads(v) for v in values]
        stream.register_batch_decoder(decoder, unspliced)
        stream.register_decoder(decoder, stream.json_decoder)
        jax_stream.register_batch_decoder(decoder, unspliced)
        jax_stream.register_decoder(decoder, jax_stream.json_decoder)
    for lo in range(0, len(payloads), 40):
        client.produce_many(topic, payloads[lo:lo + 40], partition=0,
                            timestamp_ms=1_700_000_000_000)
    ours, ref = _pair(tmp_path, broker.bootstrap, topic, decoder, dedup=lane == "row")
    try:
        assert _pump_both(ours, ref, len(payloads)) == {lane}
        assert ours.mutable.num_docs == ref.mutable.num_docs == n
        if lane == "row":
            got = ours.mutable.snapshot_columns()
            want = ref.mutable.snapshot_columns()
            assert {c: list(v) for c, v in got.items()} == {c: list(v) for c, v in want.items()}
        else:
            _assert_arrays_equal(ours.mutable.snapshot_arrays(), ref.mutable.snapshot_arrays())
        assert ours.pump() == 0 and ours.offset == len(payloads)
    finally:
        ours.close()
        ref.close()
    assert ours.halted and ours.consumer.client._sock.fileno() == -1   # the socket released


def test_a_consumer_waits_for_its_broker(tmp_path):
    """A kafkalite partition whose broker is not up yet: the consumer is made,
    its pumps index nothing, and once the broker comes it consumes."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ours, _ = _pair(tmp_path, f"127.0.0.1:{port}", "late", "json")
    assert ours.consumer is None and ours.pump() == 0
    srv = LogBrokerServer(port=port)
    try:
        client = LogBrokerClient(srv.bootstrap)
        client.create_topic("late", 1)
        client.produce_many("late", [json.dumps(r) for r in _rows(5, 1)])
        assert ours.pump() == 5 and ours.last_decode_path == "columnar-array"
        ours.close()
    finally:
        srv.stop()
