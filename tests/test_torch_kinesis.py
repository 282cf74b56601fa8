"""The port's Kinesis JSON API stub and stream plugin
(`pinot_tpu_torch/ingest/kinesislite.py`, signing through
`pinot_tpu_torch/cluster/s3store.py`) against the JAX package's.

* SigV4: `sign_request` headers and `sigv4_verify` verdicts equal the
  reference's for fixed dates, keys, services and bodies.
* Each package's client against each package's stub with SigV4 on; a wrong
  or missing signature is AccessDenied on both stubs.
* The wire shapes (shards by partition key, sequence numbers, the AWS error
  envelope) and the consumer's contract and batching, on both stubs.
* A `QuickCluster` table on 2 shards commits past its flush threshold and
  answers as the JAX package's cluster does on the same stream, with equal
  committed offsets and an ingestion status whose offset lag is unknown.
"""

import base64
import json

import pytest

from pinot_tpu.cluster import s3store as js3
from pinot_tpu.ingest import kinesislite as jkl
from pinot_tpu_torch.cluster import s3store as ts3
from pinot_tpu_torch.ingest import kinesislite as tkl
from pinot_tpu_torch.ingest.stream import get_stream_factory

from conftest import wait_until

PKGS = {"port": tkl, "jax": jkl}
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]

SIGNED = [
    ("POST", "http://127.0.0.1:4567/", b'{"StreamName": "s"}', "AK", "SK", "us-east-1",
     "kinesis", "20261019T010203Z"),
    ("PUT", "http://minio:9000/bucket/a%20b/seg.tar.gz?partNumber=2&uploadId=x", b"\x00" * 1000,
     "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "eu-west-1", "s3",
     "20150830T123600Z"),
    ("GET", "http://h:1/b?list-type=2&prefix=x%2Fy", b"", "k", "s", "us-east-1", "s3",
     "20200101T000000Z"),
]


@pytest.mark.parametrize("case", SIGNED, ids=["kinesis", "s3_put", "s3_list"])
def test_sigv4_equal_to_the_reference(case):
    method, url, body, ak, sk, region, service, date = case
    ours = ts3.sign_request(method, url, body, ak, sk, region, amz_date=date, service=service)
    theirs = js3.sign_request(method, url, body, ak, sk, region, amz_date=date,
                              service=service)
    assert ours == theirs
    from urllib.parse import urlparse
    u = urlparse(url)
    headers = dict(ours, Host=u.netloc)
    for verify in (ts3.sigv4_verify, js3.sigv4_verify):
        assert verify(headers, method, u.path, u.query, body, ak, sk, region, service=service)
        assert not verify(headers, method, u.path, u.query, body + b"x", ak, sk, region,
                          service=service)
        assert not verify(headers, method, u.path, u.query, body, ak, sk + "x", region,
                          service=service)
        assert not verify(headers, method, u.path, u.query, body, "other", sk, region,
                          service=service)
    assert ts3.sigv4_canonical(method, u.path, u.query, u.netloc, date, "h") == \
        js3.sigv4_canonical(method, u.path, u.query, u.netloc, date, "h")


@pytest.fixture()
def stubs():
    made = []

    def make(pkg, **kw):
        s = PKGS[pkg].KinesisStub(**kw)
        made.append(s)
        return s
    yield make
    for s in made:
        s.stop()


@pytest.mark.parametrize("stub_pkg,client_pkg", PAIRS)
def test_sigv4_enforced_across_packages(stubs, stub_pkg, client_pkg):
    stub, m = stubs(stub_pkg, access_key="AK", secret_key="SK"), PKGS[client_pkg]
    good = m.KinesisClient(stub.url, access_key="AK", secret_key="SK")
    good.create_stream("s", 1)
    assert good.put_record("s", b"x", "k") == {"ShardId": "shardId-000000000000",
                                               "SequenceNumber": "0"}
    for bad in (m.KinesisClient(stub.url, access_key="AK", secret_key="WRONG"),
                m.KinesisClient(stub.url)):
        with pytest.raises(m.KinesisError, match="AccessDenied"):
            bad.put_record("s", b"x", "k")
    consumer = m.KinesisConsumer(good, "s", 0)
    assert [x.value for x in consumer.fetch(0, 10).messages] == ["x"]


@pytest.mark.parametrize("stub_pkg,client_pkg", PAIRS)
def test_wire_shapes_and_put_get(stubs, stub_pkg, client_pkg):
    stub, m = stubs(stub_pkg), PKGS[client_pkg]
    c = m.KinesisClient(stub.url)
    c.create_stream("events", 2)
    assert c.shard_count("events") == 2
    out = c.put_record("events", b"hello", "pk1")
    assert set(out) == {"ShardId", "SequenceNumber"}
    out2 = c.put_record("events", b"world", "pk1")    # the same key, the same shard
    assert out2["ShardId"] == out["ShardId"]
    assert int(out2["SequenceNumber"]) == int(out["SequenceNumber"]) + 1
    it = c.call("GetShardIterator", {"StreamName": "events", "ShardId": out["ShardId"],
                                     "ShardIteratorType": "TRIM_HORIZON"})["ShardIterator"]
    d = c.call("GetRecords", {"ShardIterator": it, "Limit": 100})
    assert [base64.b64decode(r["Data"]) for r in d["Records"]] == [b"hello", b"world"]
    assert d["MillisBehindLatest"] == 0
    with pytest.raises(m.KinesisError, match="ResourceNotFoundException"):
        c.put_record("nope", b"x", "k")
    with pytest.raises(m.KinesisError, match="ValidationException"):
        c.call("GetRecords", {"ShardIterator": "not json"})
    stub.outage = True
    with pytest.raises(m.KinesisError, match="ServiceUnavailable"):
        c.shard_count("events")


@pytest.mark.parametrize("stub_pkg", ["port", "jax"])
def test_consumer_contract_and_batching(stubs, stub_pkg):
    stub = stubs(stub_pkg)
    c = tkl.KinesisClient(stub.url)
    c.create_stream("t", 1)
    c.put_records("t", [("k", f"m{i}") for i in range(25)])
    consumer = tkl.KinesisConsumer(c, "t", 0)
    batch = consumer.fetch(0, 10)
    assert len(batch.messages) == 10 and batch.next_offset == 10
    assert batch.messages[0].value == "m0" and batch.messages[0].offset == 0
    assert batch.messages[0].key == "k" and batch.messages[0].timestamp_ms > 0
    calls = []
    call = c.call
    c.call = lambda action, req: calls.append(action) or call(action, req)
    batch2 = consumer.fetch(batch.next_offset, 100)    # the cached iterator: one call
    assert len(batch2.messages) == 15 and batch2.next_offset == 25
    assert calls == ["GetRecords"]
    empty = consumer.fetch(batch2.next_offset, 100)
    assert empty.messages == [] and empty.next_offset == 25
    again = consumer.fetch(7, 3)                       # a replay anchors a new iterator
    assert [x.value for x in again.messages] == ["m7", "m8", "m9"]
    assert calls[-2:] == ["GetShardIterator", "GetRecords"]
    with pytest.raises(NotImplementedError):           # no latest-sequence query
        consumer.latest_offset()


def test_factory_registry_and_metadata(stubs):
    stub = stubs("port", access_key="AK", secret_key="SK")
    factory = get_stream_factory("kinesis", "clicks", {
        "endpoint": stub.url, "accessKey": "AK", "secretKey": "SK", "region": "us-east-1"})
    assert isinstance(factory, tkl.KinesisFactory)
    factory.client.create_stream("clicks", 3)
    assert factory.metadata_provider().partition_count("clicks") == 3
    assert isinstance(factory.create_consumer("clicks", 2), tkl.KinesisConsumer)


def _records(n):
    return [(f"u{i % 5}", json.dumps({"u": f"u{i % 5}", "n": i})) for i in range(n)]


def _cluster_rounds(pkg, stub_url, tmp_path, put):
    """Consume 100 records, then 30 more past the flush threshold, on the
    package's QuickCluster; -> (answers, committed offsets, status)."""
    if pkg == "port":
        from pinot_tpu_torch.cluster.enclosure import QuickCluster
        from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
        from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
        cluster = QuickCluster(num_servers=1, work_dir=str(tmp_path / pkg), device="cpu")
    else:
        from pinot_tpu.cluster.enclosure import QuickCluster
        from pinot_tpu.schema import DataType, Schema, dimension, metric
        from pinot_tpu.table import StreamConfig, TableConfig, TableType
        cluster = QuickCluster(num_servers=1, work_dir=str(tmp_path / pkg))
    schema = Schema("ev", [dimension("u"), metric("n", DataType.LONG)])
    cfg = TableConfig("ev", table_type=TableType.REALTIME, replication=1,
                      stream=StreamConfig(stream_type="kinesis", topic=f"clicks_{pkg}",
                                          decoder="json",
                                          properties={"endpoint": stub_url, "accessKey": "AK",
                                                      "secretKey": "SK"},
                                          flush_threshold_rows=40))
    table = cfg.table_name_with_type
    cluster.create_realtime_table(schema, cfg, 2)
    put(f"clicks_{pkg}", _records(100))
    cluster.pump_realtime(table)
    first = cluster.query("SELECT COUNT(*), SUM(n) FROM ev").rows
    put(f"clicks_{pkg}", [("late", json.dumps({"u": "late", "n": 1}))] * 30)

    def counted():
        cluster.pump_realtime(table)
        return cluster.query("SELECT COUNT(*) FROM ev").rows[0][0] == 130
    assert wait_until(counted, timeout=30)
    answers = [first, cluster.query("SELECT u, COUNT(*), SUM(n) FROM ev GROUP BY u "
                                    "ORDER BY u").rows]
    done = sorted((m.partition_group, m.sequence_number, int(m.start_offset), int(m.end_offset))
                  for m in cluster.catalog.segments[table].values() if m.status == "DONE")
    status = cluster.controller.ingestion_status(table)
    if pkg == "port":
        cluster.shutdown()
    return answers, done, status


def test_realtime_table_consumes_kinesis_as_the_reference(stubs, tmp_path):
    """Stream type "kinesis" on 2 shards, every request signed with the
    table's keys: shard discovery, sequence offsets, a commit past the flush
    threshold, equal answers and commits."""
    stub = stubs("port", access_key="AK", secret_key="SK")
    c = tkl.KinesisClient(stub.url, access_key="AK", secret_key="SK")

    def put(stream, items):
        for lo in range(0, len(items), 500):   # PutRecords takes at most 500
            c.put_records(stream, items[lo:lo + 500])
    for pkg in ("port", "jax"):
        c.create_stream(f"clicks_{pkg}", 2)
    ours = _cluster_rounds("port", stub.url, tmp_path, put)
    theirs = _cluster_rounds("jax", stub.url, tmp_path, put)
    assert ours[0] == theirs[0]
    assert ours[0][0] == [[100, sum(range(100))]]
    assert ours[1] == theirs[1] and ours[1]            # committed at the same offsets
    for st in (ours[2], theirs[2]):
        assert st["ingestionState"] == "HEALTHY" and st["maxOffsetLag"] == 0
        segs = [s for srv in st["servers"].values() for s in srv["segments"].values()]
        assert segs and all(s["offsetLag"] is None and s["latestStreamOffset"] is None
                            for s in segs)


def test_builtin_stream_types_match_the_reference():
    from pinot_tpu import plugins as jplugins
    from pinot_tpu_torch import plugins
    assert plugins.available("stream") == jplugins.available("stream") == \
        ["kafkalite", "kinesis", "memory", "pulsar"]
    assert plugins.get("stream", "kinesis") is tkl.KinesisFactory
    with pytest.raises(NotImplementedError):
        get_stream_factory("nats", "t")
