"""The port's Pulsar-protocol broker and stream plugin
(`pinot_tpu_torch/ingest/pulsarlite.py`) against the JAX package's.

* Frames: `encode_frame` and `parse_frame` byte-equal to the reference's for
  the same commands, simple and payload frames, negative ids included.
* Each package's producer and consumer against each package's broker: the
  same offsets, payloads and timestamps, the reader's seek semantics, the
  quick empty fetch, and a corrupted payload's CRC dropping the connection.
* A lag probe between two fetches loses no message (the reference's
  consumer drops the messages pushed ahead of a probe's answer).
* A REALTIME table over a `ProcessCluster(device="cpu")` consumes 300 JSON
  events through stream type "pulsar" and answers as the JAX package's
  cluster does over the same broker.
"""

import contextlib
import json
import socket
import struct
import time

import pytest

from pinot_tpu.ingest import pulsarlite as jpl
from pinot_tpu_torch.ingest import pulsarlite as tpl
from pinot_tpu_torch.ingest.kafka_wire import crc32c
from pinot_tpu_torch.ingest.stream import get_stream_factory

from conftest import wait_until

PKGS = {"port": tpl, "jax": jpl}
# (broker's package, clients' package)
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]


@pytest.fixture()
def brokers():
    made = []

    def make(pkg):
        b = PKGS[pkg].PulsarLiteBroker()
        made.append(b)
        return b
    yield make
    for b in made:
        b.stop()


FRAMES = [
    ("connect", lambda m: m._base_command(m.CONNECT, {1: "pinot-tpu-pulsarlite", 4: 21}), None,
     b""),
    ("producer", lambda m: m._base_command(m.PRODUCER, {
        1: m.partition_topic("t", 3), 2: 1, 3: 7}), None, b""),
    ("producer_success", lambda m: m._base_command(m.PRODUCER_SUCCESS,
                                                   {1: 7, 2: "p-1", 3: -1}), None, b""),
    ("send", lambda m: m._base_command(m.SEND, {1: 1, 2: 42}),
     lambda m: m._msg({1: "p", 2: 42, 3: 1_700_000_000_123}), b"\x00payload\xff" * 50),
    ("message", lambda m: m._base_command(m.MESSAGE, {1: 1, 2: m._message_id(0, 9)}),
     lambda m: m._msg({1: "p", 2: 9, 3: 5}), b'{"i": 9}'),
    ("seek", lambda m: m._base_command(m.SEEK, {1: 1, 2: 3, 3: m._message_id(0, 2**40)}),
     None, b""),
    ("last_id", lambda m: m._base_command(m.GET_LAST_MESSAGE_ID_RESPONSE,
                                          {1: m._message_id(0, -1), 2: 5}), None, b""),
    ("flow", lambda m: m._base_command(m.FLOW, {1: 1, 2: 10_000}), None, b""),
    ("pong", lambda m: m._base_command(m.PONG, {}), None, b""),
]


@pytest.mark.parametrize("name,cmd,meta,payload", FRAMES, ids=[f[0] for f in FRAMES])
def test_frames_byte_equal_to_the_reference(name, cmd, meta, payload):
    ours = tpl.encode_frame(cmd(tpl), meta(tpl) if meta else None, payload)
    theirs = jpl.encode_frame(cmd(jpl), meta(jpl) if meta else None, payload)
    assert ours == theirs
    assert tpl.parse_frame(ours[4:]) == jpl.parse_frame(theirs[4:])
    cmd_fields, md, body = tpl.parse_frame(ours[4:])
    if meta:
        assert body == payload and md == tpl._decode(meta(tpl))
    else:
        assert md is None and body is None
    if name == "last_id":   # int64 -1 as a varint, read back signed
        mid = tpl._decode(tpl._one(tpl._decode(tpl._one(cmd_fields, tpl.GET_LAST_MESSAGE_ID_RESPONSE)), 1))
        assert tpl._signed(tpl._one(mid, 2)) == -1


@pytest.mark.parametrize("broker_pkg,client_pkg", PAIRS)
def test_produce_consume_roundtrip(brokers, broker_pkg, client_pkg):
    b, m = brokers(broker_pkg), PKGS[client_pkg]
    prod = m.PulsarLiteProducer(b.service_url, "t0")
    offs = [prod.send(json.dumps({"i": i}).encode(), ts=1000 + i) for i in range(40)]
    assert offs == list(range(40))
    prod.close()
    cons = m.PulsarLiteConsumer(b.service_url, "t0", 0)
    batch = cons.fetch(0, 25)
    assert [x.offset for x in batch.messages] == list(range(25))
    assert json.loads(batch.messages[7].value) == {"i": 7}
    assert batch.messages[7].timestamp_ms == 1007 and batch.next_offset == 25
    batch2 = cons.fetch(25, 100)
    assert [x.offset for x in batch2.messages] == list(range(25, 40))
    assert cons.latest_offset() == 40
    cons.close()
    assert [e[1] for e in b.topics[m.partition_topic("t0", 0)].entries] == \
        [1000 + i for i in range(40)]


@pytest.mark.parametrize("broker_pkg,client_pkg", PAIRS)
def test_seek_semantics(brokers, broker_pkg, client_pkg):
    b, m = brokers(broker_pkg), PKGS[client_pkg]
    prod = m.PulsarLiteProducer(b.service_url, "t1")
    for i in range(30):
        prod.send(f"v{i}".encode())
    cons = m.PulsarLiteConsumer(b.service_url, "t1", 0)
    cons.fetch(0, 10)
    # a restart past the cursor seeks instead of delivering stale entries
    assert [x.offset for x in cons.fetch(20, 10).messages] == list(range(20, 30))
    # a rewind replays
    assert [x.value for x in cons.fetch(5, 3).messages] == ["v5", "v6", "v7"]
    cons.close()
    prod.close()


@pytest.mark.parametrize("broker_pkg,client_pkg", PAIRS)
def test_empty_fetch_returns_quickly(brokers, broker_pkg, client_pkg):
    b, m = brokers(broker_pkg), PKGS[client_pkg]
    m.PulsarLiteProducer(b.service_url, "t2").close()
    cons = m.PulsarLiteConsumer(b.service_url, "t2", 0)
    t0 = time.perf_counter()
    batch = cons.fetch(0, 10, timeout_ms=100)
    assert batch.messages == [] and batch.next_offset == 0
    assert time.perf_counter() - t0 < 2.0
    assert cons.latest_offset() == 0
    cons.close()


@pytest.mark.parametrize("broker_pkg", ["port", "jax"])
def test_crc_rejects_corruption(brokers, broker_pkg):
    b = brokers(broker_pkg)
    s = socket.create_connection((b.host, b.port))
    s.sendall(tpl.encode_frame(tpl._base_command(tpl.CONNECT, {1: "x", 4: 21})))
    assert tpl._one(tpl.read_frame(s)[0], 1) == tpl.CONNECTED
    s.sendall(tpl.encode_frame(tpl._base_command(tpl.PRODUCER, {
        1: tpl.partition_topic("t3", 0), 2: 1, 3: 1})))
    tpl.read_frame(s)
    cmd = tpl._base_command(tpl.SEND, {1: 1, 2: 1})
    meta = tpl._msg({1: "p", 2: 1, 3: 0})
    meta_part = struct.pack(">I", len(meta)) + meta + b"payload"
    crc = crc32c(meta_part)
    corrupted = meta_part[:-1] + b"X"
    s.sendall(struct.pack(">II", 4 + len(cmd) + 2 + 4 + len(corrupted), len(cmd)) + cmd
              + tpl.MAGIC + struct.pack(">I", crc) + corrupted)
    with contextlib.suppress(OSError):   # the broker drops the connection
        assert tpl.read_frame(s) is None
    s.close()
    assert b.topics[tpl.partition_topic("t3", 0)].entries == []
    with pytest.raises(ValueError, match="CRC"):
        tpl.parse_frame(struct.pack(">I", len(cmd)) + cmd + tpl.MAGIC + struct.pack(">I", crc)
                        + corrupted)


def test_a_lag_probe_between_fetches_loses_no_message(brokers):
    """Permits left from earlier fetches let the broker push past a fetch's
    batch; a `latest_offset` probe that reads those pushed frames keeps them
    for the next fetch, so the offsets stay contiguous."""
    b = brokers("port")
    prod = tpl.PulsarLiteProducer(b.service_url, "t4")
    for i in range(5):
        prod.send(f"a{i}".encode())
    cons = tpl.PulsarLiteConsumer(b.service_url, "t4", 0)
    assert len(cons.fetch(0, 10).messages) == 5        # 5 permits left over
    for i in range(20):
        prod.send(f"b{i}".encode())
    first = cons.fetch(5, 10)                          # the broker pushes 15
    assert [x.offset for x in first.messages] == list(range(5, 15))
    time.sleep(0.1)
    assert cons.latest_offset() == 25                  # reads the 5 pushed ahead
    second = cons.fetch(15, 10)
    assert [x.offset for x in second.messages] == list(range(15, 25))
    assert [x.value for x in second.messages][:2] == ["b10", "b11"]
    cons.close()
    prod.close()


def test_factory_and_registry(brokers):
    b = brokers("port")
    factory = get_stream_factory("pulsar", "t5", {"serviceUrl": b.service_url})
    assert isinstance(factory, tpl.PulsarLiteFactory)
    cons = factory.create_consumer("t5", 1)
    assert cons.fetch(0, 5).messages == [] and cons.latest_offset() == 0
    cons.close()
    assert tpl.partition_topic("t5", 1) in b.topics
    with pytest.raises(ValueError):
        tpl.PulsarLiteClient("http://127.0.0.1:1")


def _jax_answers(schema_json, cfg_json, tmp_path):
    from pinot_tpu.cluster.enclosure import QuickCluster
    from pinot_tpu.schema import Schema as JSchema
    from pinot_tpu.table import TableConfig as JTableConfig
    cluster = QuickCluster(num_servers=1, work_dir=str(tmp_path / "jax"))
    cluster.controller.add_schema(JSchema.from_json(schema_json))
    cluster.controller.add_realtime_table(JTableConfig.from_json(cfg_json), 1)
    table = "pev_REALTIME"
    for _ in range(20):
        cluster.pump_realtime(table)
    return {q: cluster.query(sql).rows for q, sql in QUERIES.items()}


QUERIES = {"count": "SELECT COUNT(*), SUM(clicks) FROM pev",
           "by_site": "SELECT site, SUM(clicks), COUNT(*) FROM pev GROUP BY site ORDER BY site"}


def test_realtime_table_consumes_via_pulsar_across_processes(tmp_path):
    """Server processes of the port dial the broker over TCP and consume
    the table; its answers equal the JAX package's cluster over the same
    stream."""
    from pinot_tpu_torch.cluster.process import ProcessCluster
    from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType

    schema = Schema("pev", [dimension("site", DataType.STRING), metric("clicks", DataType.LONG)])
    broker = tpl.PulsarLiteBroker()
    try:
        prod = tpl.PulsarLiteProducer(broker.service_url, "pulsar_ev")
        for i in range(300):
            prod.send(json.dumps({"site": f"s{i % 3}", "clicks": i % 7}).encode())
        prod.close()
        cfg = TableConfig("pev", table_type=TableType.REALTIME, stream=StreamConfig(
            stream_type="pulsar", topic="pulsar_ev", decoder="json",
            properties={"serviceUrl": broker.service_url}, flush_threshold_rows=10_000))
        want = _jax_answers(schema.to_json(), cfg.to_json(), tmp_path)
        assert want["count"] == [[300, sum(i % 7 for i in range(300))]]
        with ProcessCluster(num_servers=2, device="cpu", work_dir=str(tmp_path / "port"),
                            startup_timeout_s=90.0) as pc:
            pc.controller.add_schema(schema)
            pc.controller.add_table(cfg, num_partitions=1)

            def counted():
                rows = pc.query(QUERIES["count"])["resultTable"]["rows"]
                return rows == want["count"]
            assert wait_until(counted, timeout=120, interval=0.3)
            got = {q: pc.query(sql)["resultTable"]["rows"] for q, sql in QUERIES.items()}
            status = pc.controller.ingestion_status("pev_REALTIME")
        assert got == want
        assert status["ingestionState"] == "HEALTHY" and status["maxOffsetLag"] == 0
        seg = next(iter(next(iter(status["servers"].values()))["segments"].values()))
        assert seg["latestStreamOffset"] == 300 and seg["currentOffset"] == 300
    finally:
        broker.stop()
