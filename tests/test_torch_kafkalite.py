"""The port's socket log broker (`pinot_tpu_torch/ingest/kafkalite.py`) against
the JAX package's.

* The cases of `tests/test_kafkalite.py` on the port's broker and client:
  produce and fetch, key partitioning and metadata, the long-poll fetch, the
  durable log (raw CRC'd batches, restart, torn tail, legacy JSONL), the
  client's reconnect, and a realtime table consuming from it through the
  stream factory (`QuickCluster` on the CPU).
* Each package's client against the other's broker, and the spliced and raw
  fetches equal.
* The two packages' partition logs byte-equal for the same produces.
"""

import json
import os
import socket
import threading
import time

import pytest

from pinot_tpu.ingest import kafkalite as jkl
from pinot_tpu_torch import plugins
from pinot_tpu_torch.ingest import kafka_wire as kw
from pinot_tpu_torch.ingest.kafkalite import (KafkaLiteConsumer, KafkaLiteFactory,
                                              LogBrokerClient, LogBrokerServer, _recv_payload)
from pinot_tpu_torch.ingest.stream import get_stream_factory

TS = 1_700_000_000_000   # fixed timestamps: the batches' bytes depend on them


@pytest.fixture()
def broker():
    srv = LogBrokerServer()
    yield srv
    srv.stop()


def test_produce_fetch_roundtrip(broker):
    client = LogBrokerClient(broker.bootstrap)
    client.create_topic("t", 2)
    offsets = [client.produce("t", f"m{i}", partition=i % 2) for i in range(6)]
    assert offsets == [0, 0, 1, 1, 2, 2]
    consumer = KafkaLiteConsumer(broker.bootstrap, "t", 0)
    batch = consumer.fetch(0, 100)
    assert [m.value for m in batch.messages] == ["m0", "m2", "m4"]
    assert batch.next_offset == 3 and consumer.latest_offset() == 3
    batch2 = consumer.fetch(batch.messages[1].offset, 100)
    assert [m.value for m in batch2.messages] == ["m2", "m4"]
    assert consumer.fetch_raw(1, 100) == ([b"m2", b"m4"], 3)
    assert consumer.fetch_spliced(0, 2, sep=b"|") == (b"m0|m2", 2, 2)
    consumer.close()
    client.close()


def test_key_partitioning_and_metadata(broker):
    client = LogBrokerClient(broker.bootstrap)
    client.create_topic("keyed", 4)
    factory = get_stream_factory("kafkalite", "keyed", {"bootstrap": broker.bootstrap})
    assert isinstance(factory, KafkaLiteFactory)
    assert plugins.get("stream", "kafkalite") is KafkaLiteFactory
    assert factory.metadata_provider().partition_count("keyed") == 4
    p1 = client.partition_for("keyed", "k1")
    assert client.partition_for("keyed", "k1") == p1
    client.produce("keyed", "a", key="k1")
    client.produce("keyed", "b", key="k1")
    assert client.list_offsets("keyed", p1) == 2
    with pytest.raises(ValueError, match="bootstrap"):
        get_stream_factory("kafkalite", "keyed", {})
    with pytest.raises(NotImplementedError, match="no stream type"):
        get_stream_factory("kafka", "keyed", {})
    client.close()


def test_fetch_long_poll_wakes_on_produce(broker):
    client = LogBrokerClient(broker.bootstrap)
    client.create_topic("lp", 1)
    consumer = KafkaLiteConsumer(broker.bootstrap, "lp", 0)

    def produce_later():
        time.sleep(0.1)
        client.produce("lp", "late", partition=0)
    th = threading.Thread(target=produce_later)
    th.start()
    batch = consumer.fetch(0, 10, timeout_ms=5000)
    th.join()
    assert [m.value for m in batch.messages] == ["late"]
    consumer.close()
    client.close()


def test_unsupported_version_gets_downgrade_answer(broker):
    s = socket.create_connection((broker.host, broker.port), timeout=5)
    s.sendall(kw.encode_request(kw.API_API_VERSIONS, 99, 1, "x", b""))
    r = kw.Reader(_recv_payload(s))
    assert r.i32() == 1 and r.i16() == kw.ERR_UNSUPPORTED_VERSION
    s.close()


def test_list_offsets_by_timestamp(broker):
    c = LogBrokerClient(broker.bootstrap)
    c.create_topic("t", 1)
    for i, ts in enumerate((100, 200, 300)):
        c.produce("t", f"m{i}", partition=0, timestamp_ms=ts)
    assert [c.list_offsets("t", 0, timestamp=t) for t in (-2, -1, 150, 300, 301)] == \
        [0, 3, 1, 2, -1]
    c.produce("t", "zero", partition=0, timestamp_ms=0)
    assert c.fetch("t", 0, 3)[0][1] == 0
    c.close()


def test_broker_restart_recovers_log(tmp_path):
    srv = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    client = LogBrokerClient(srv.bootstrap)
    client.create_topic("durable", 1)
    for i in range(5):
        client.produce("durable", f"r{i}", partition=0)
    client.close()
    srv.stop()
    srv2 = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    consumer = KafkaLiteConsumer(srv2.bootstrap, "durable", 0)
    assert [m.value for m in consumer.fetch(0, 100).messages] == [f"r{i}" for i in range(5)]
    consumer.close()
    srv2.stop()


def test_log_stores_raw_crc_batches(tmp_path):
    """The partition log is the producers' v2 batches with their base offsets
    patched in; a restart serves the same records."""
    srv = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    client = LogBrokerClient(srv.bootstrap)
    client.create_topic("t", 1)
    client.produce_many("t", [f"m{i}" for i in range(5)], timestamp_ms=TS)
    client.produce("t", "single", timestamp_ms=123)
    before = client.fetch("t", 0, 0)
    srv.stop()
    data = (tmp_path / "logs" / "t" / "0.log").read_bytes()
    frames, pos = [], 0
    while pos + 12 <= len(data):
        n = int.from_bytes(data[pos + 8:pos + 12], "big")
        frames.append(data[pos:pos + 12 + n])
        pos += 12 + n
    assert len(frames) == 2
    for f in frames:
        assert kw.crc32c(f[21:]) == int.from_bytes(f[17:21], "big")
    assert [int.from_bytes(f[:8], "big") for f in frames] == [0, 5]
    srv2 = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    try:
        after = LogBrokerClient(srv2.bootstrap).fetch("t", 0, 0)
        assert after == before and after[-1][1] == 123
        assert [v for *_x, v in after] == [f"m{i}".encode() for i in range(5)] + [b"single"]
    finally:
        srv2.stop()


def test_torn_tail_truncated_on_recovery(tmp_path):
    srv = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    client = LogBrokerClient(srv.bootstrap)
    client.create_topic("t", 1)
    client.produce_many("t", ["a", "b", "c"])
    srv.stop()
    log_path = tmp_path / "logs" / "t" / "0.log"
    intact = log_path.read_bytes()
    log_path.write_bytes(intact + intact[:20])
    srv2 = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    try:
        client2 = LogBrokerClient(srv2.bootstrap)
        assert [v for *_x, v in client2.fetch("t", 0, 0)] == [b"a", b"b", b"c"]
        assert client2.list_offsets("t", 0) == 3
        assert log_path.read_bytes() == intact
    finally:
        srv2.stop()


def test_legacy_jsonl_log_converted(tmp_path):
    tdir = tmp_path / "logs" / "t"
    tdir.mkdir(parents=True)
    with open(tdir / "0.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"v": f"old{i}", "k": None, "t": 1000 + i}) + "\n")
    (tdir / "0.log.tmp.999").write_bytes(b"\x00" * 10)   # a crashed conversion's temp
    srv = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    try:
        client = LogBrokerClient(srv.bootstrap)
        recs = client.fetch("t", 0, 0)
        assert [v for *_x, v in recs] == [f"old{i}".encode() for i in range(4)]
        assert [t for _o, t, *_x in recs] == [1000, 1001, 1002, 1003]
        client.produce("t", "new")
        assert client.list_offsets("t", 0) == 5
    finally:
        srv.stop()


def test_client_reconnects_after_broker_restart(tmp_path):
    srv = LogBrokerServer(log_dir=str(tmp_path / "logs"))
    client = LogBrokerClient(srv.bootstrap)
    client.create_topic("t", 1)
    client.produce_many("t", ["a", "b"])
    assert len(client.fetch("t", 0, 0)) == 2
    port = srv.port
    srv.stop()
    srv2 = None
    for _ in range(100):
        try:
            srv2 = LogBrokerServer(log_dir=str(tmp_path / "logs"), port=port)
            break
        except OSError:
            time.sleep(0.1)
    assert srv2 is not None
    try:
        assert [v for *_x, v in client.fetch("t", 0, 0)] == [b"a", b"b"]
        client.produce("t", "c")
        assert client.list_offsets("t", 0) == 3
    finally:
        srv2.stop()


def test_realtime_table_consumes_from_the_socket_broker(tmp_path, broker):
    """The completion FSM (consuming, commit, ONLINE) against the socket
    broker on a QuickCluster, the stream type set by the config alone; the
    JSON lane takes the native array decode."""
    from pinot_tpu_torch.cluster import QuickCluster
    from pinot_tpu_torch.cluster.catalog import STATUS_DONE
    from pinot_tpu_torch.schema import DataType, Schema, date_time, dimension, metric
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
    schema = Schema("clickstream", [dimension("user", DataType.STRING),
                                    metric("value", DataType.LONG),
                                    date_time("ts", DataType.LONG)])
    client = LogBrokerClient(broker.bootstrap)
    client.create_topic("clicks", 2)
    cluster = QuickCluster(num_servers=1, work_dir=str(tmp_path), device="cpu")
    cfg = TableConfig("clickstream", table_type=TableType.REALTIME, time_column="ts",
                      stream=StreamConfig(stream_type="kafkalite", topic="clicks",
                                          properties={"bootstrap": broker.bootstrap},
                                          flush_threshold_rows=10))
    cluster.create_realtime_table(schema, cfg, 2)
    for i in range(25):
        client.produce("clicks", json.dumps({"user": f"u{i % 5}", "value": i, "ts": TS + i}),
                       partition=i % 2)
    table = cfg.table_name_with_type
    for _ in range(6):
        if cluster.query("SELECT COUNT(*) FROM clickstream").rows[0][0] == 25:
            break
        cluster.pump_realtime(table)
    assert cluster.query("SELECT COUNT(*) FROM clickstream").rows[0][0] == 25
    rows = cluster.query("SELECT user, SUM(value) FROM clickstream GROUP BY user "
                         "ORDER BY user LIMIT 10").rows
    assert {r[0]: r[1] for r in rows} == {f"u{k}": sum(range(k, 25, 5)) for k in range(5)}
    assert any(m.status == STATUS_DONE for m in cluster.catalog.segments[table].values())
    paths = {c.last_decode_path for c in cluster.servers[0].realtime_manager(table)
             .consumers.values()}
    assert paths <= {"columnar-array", None}, paths
    cluster.shutdown()
    client.close()


@pytest.mark.parametrize("server_pkg,client_pkg", [("torch", "jax"), ("jax", "torch")])
def test_each_client_works_against_the_other_broker(tmp_path, server_pkg, client_pkg):
    """Produce, produce_many, keyed produce, metadata, list offsets, fetch,
    fetch_raw and fetch_spliced across the packages."""
    ours = {"torch": (LogBrokerServer, LogBrokerClient, KafkaLiteConsumer),
            "jax": (jkl.LogBrokerServer, jkl.LogBrokerClient, jkl.KafkaLiteConsumer)}
    srv = ours[server_pkg][0]()
    try:
        client = ours[client_pkg][1](srv.bootstrap)
        client.create_topic("x", 3)
        assert client.partition_count("x") == 3
        assert client.produce("x", "a", partition=0, timestamp_ms=TS) == 0
        assert client.produce_many("x", [f"v{i}" for i in range(5)], partition=0,
                                   timestamp_ms=TS) == 5
        client.create_topic("k", 3)
        client.produce("k", "keyed", key="key", timestamp_ms=TS)
        assert client.list_offsets("k", client.partition_for("k", "key")) == 1
        got = client.fetch("x", 0, 2)
        assert [(o, v) for o, _t, _k, v in got] == [(i, f"v{i - 1}".encode()) for i in range(2, 6)]
        consumer = ours[client_pkg][2](srv.bootstrap, "x", 0)
        assert consumer.fetch_raw(0, 3) == ([b"a", b"v0", b"v1"], 3)
        assert consumer.fetch_spliced(1, 10, sep=b",") == (b"v0,v1,v2,v3,v4", 5, 6)
        assert consumer.latest_offset() == 6
        consumer.close()
        client.close()
    finally:
        srv.stop()


def _produce_all(client, topic):
    client.create_topic(topic, 2)
    client.produce(topic, "one", partition=0, timestamp_ms=TS)
    client.produce_many(topic, [json.dumps({"i": i}) for i in range(50)], partition=1,
                        timestamp_ms=TS + 1)
    client.produce(topic, "keyed", partition=0, key="k", timestamp_ms=TS + 2)
    client.produce_many(topic, [b"\x00\x01" * i for i in range(1, 9)], partition=0,
                        timestamp_ms=TS + 3)


def test_partition_logs_byte_equal_the_reference(tmp_path):
    """The same produces through each package's client into each package's
    broker leave byte-equal partition logs."""
    logs = {}
    for name, server, client in (("torch", LogBrokerServer, LogBrokerClient),
                                 ("jax", jkl.LogBrokerServer, jkl.LogBrokerClient)):
        srv = server(log_dir=str(tmp_path / name))
        try:
            c = client(srv.bootstrap)
            _produce_all(c, "t")
            c.close()
        finally:
            srv.stop()
        logs[name] = {p: (tmp_path / name / "t" / f"{p}.log").read_bytes() for p in (0, 1)}
    assert logs["torch"] == logs["jax"]
    assert all(len(b) > 0 for b in logs["torch"].values())
    # each package's broker serves the other's log
    for server in (LogBrokerServer, jkl.LogBrokerServer):
        srv = server(log_dir=str(tmp_path / "jax"))
        try:
            recs = LogBrokerClient(srv.bootstrap).fetch("t", 1, 0)
            assert [json.loads(v)["i"] for *_x, v in recs] == list(range(50))
        finally:
            srv.stop()
    assert os.path.exists(tmp_path / "torch" / "t" / "0.log")
