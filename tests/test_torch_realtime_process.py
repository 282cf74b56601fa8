"""Realtime tables over OS processes: the port's `ProcessCluster(device="cpu")`
against the JAX package's, on the same kafkalite broker.

The test process runs only the socket log broker (`LogBrokerServer`) and the
clients; the controller, the servers and the broker are processes joined over
HTTP. Each server process consumes its partitions on its own loop
(`auto_consume`) and reports to the controller over HTTP
(`RemoteCompletion`), whose commit end uploads the segment's tar.

* One stream of SSB lineorder rows as JSON, 2 partitions, written before the
  table exists (so the consumers' offsets are the data's, not the timing's),
  consumed by the JAX package's cluster and by the port's: equal answers for
  COUNT, a Q1.1-shaped sum and a GROUP BY, and equal committed segments
  (partition, sequence, start and end offsets, doc counts); the port's
  server process never imported `jax` or `pinot_tpu`.
* A consuming server killed and restarted (`tests/test_realtime_process.py`):
  the new process consumes again from the committed offsets, every row once.
* Pause and resume over HTTP: a paused table's consuming segment with rows
  commits, and the resume creates its successor.

Every wait is bounded, and every process is killed by the context managers.
"""

import json
import math

import numpy as np
import pytest

from pinot_tpu.cluster.process import ProcessCluster as JaxProcessCluster
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu_torch.cluster.http_service import get_json
from pinot_tpu_torch.cluster.process import ProcessCluster
from pinot_tpu_torch.ingest.kafkalite import LogBrokerClient, LogBrokerServer
from pinot_tpu_torch.schema import DataType, Schema, date_time, dimension, metric
from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY, make_columns, ssb_schema
from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType

from conftest import wait_until

ROWS = 6000                 # 3,000 a partition
PARTITIONS = 2
FLUSH_ROWS = 2048           # each partition commits once, at offset 2,048
BATCH = 512                 # messages a pump takes: commits at multiples of it
TS = 1_700_000_000_000
QUERIES = {"count": "SELECT COUNT(*) FROM lineorder", "q1_1": QUERY, "group_by": GROUP_QUERY}


@pytest.fixture()
def log_broker():
    srv = LogBrokerServer()
    yield srv
    srv.stop()


def _json_rows(n, seed):
    cols = make_columns(n, seed)
    names = list(cols)
    lists = [np.asarray(cols[c]).tolist() for c in names]
    return [json.dumps(dict(zip(names, vals))) for vals in zip(*lists)]


def _config(bootstrap, topic, flush=FLUSH_ROWS, name="lineorder", time_column="lo_orderdate"):
    return TableConfig(name, table_type=TableType.REALTIME, time_column=time_column,
                       stream=StreamConfig(stream_type="kafkalite", topic=topic,
                                           properties={"bootstrap": bootstrap,
                                                       "realtime.ingest.batch.size": BATCH},
                                           flush_threshold_rows=flush))


def _count(cluster, table="lineorder"):
    rows = cluster.query(f"SELECT COUNT(*) FROM {table}")["resultTable"]["rows"]
    return rows[0][0] if rows else 0


def _committed(cluster, table):
    metas = cluster.controller.segments_meta(table)["segments"]
    return sorted((m["partition_group"], m["sequence_number"], int(m["start_offset"]),
                   int(m["end_offset"]), m["num_docs"])
                  for m in metas.values() if m["status"] == "DONE")


def _consume(cluster, schema, cfg, want_committed):
    cluster.controller.add_schema(schema)
    cluster.controller.add_table(cfg, num_partitions=PARTITIONS)
    table = cfg.table_name_with_type
    assert wait_until(lambda: _count(cluster) == ROWS, timeout=90), _count(cluster)
    assert wait_until(lambda: len(_committed(cluster, table)) == want_committed, timeout=90)
    return ({q: cluster.query(sql)["resultTable"]["rows"] for q, sql in QUERIES.items()},
            _committed(cluster, table))


def _rows_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b, strict=True):
            if isinstance(y, float):
                assert math.isclose(x, y, rel_tol=1e-5, abs_tol=0.05), (a, b)
            else:
                assert x == y, (a, b)


def test_a_stream_consumed_over_processes_matches_the_reference(tmp_path, log_broker):
    rows = _json_rows(ROWS, seed=21)
    client = LogBrokerClient(log_broker.bootstrap)
    client.create_topic("lo_stream", PARTITIONS)
    for p in range(PARTITIONS):
        part = rows[p::PARTITIONS]
        for lo in range(0, len(part), 250):
            client.produce_many("lo_stream", part[lo:lo + 250], partition=p, timestamp_ms=TS)
    cfg = _config(log_broker.bootstrap, "lo_stream")
    want_segments = [(p, 0, 0, 2048, 2048) for p in range(PARTITIONS)]
    with ProcessCluster(num_servers=1, device="cpu", work_dir=str(tmp_path / "port"),
                        startup_timeout_s=90.0) as pc:
        ours, our_segments = _consume(pc, ssb_schema(), cfg, len(want_segments))
        metas = pc.controller.segments_meta(cfg.table_name_with_type)["segments"]
        debug = get_json(f"{pc.server_url('server_0')}/debug")
    assert debug["importedPackages"] == {"jax": False, "pinot_tpu": False}
    with JaxProcessCluster(num_servers=1, work_dir=str(tmp_path / "jax")) as jc:
        ref, ref_segments = _consume(jc, JSchema.from_json(ssb_schema().to_json()),
                                     JaxTableConfig.from_json(cfg.to_json()),
                                     len(want_segments))
    assert our_segments == ref_segments == want_segments
    assert ours["count"] == ref["count"] == [[ROWS]]
    for q in ("q1_1", "group_by"):
        _rows_close(ours[q], ref[q])
    consuming = [m for m in metas.values() if m["status"] == "IN_PROGRESS"]
    assert sorted(int(m["start_offset"]) for m in consuming) == [2048] * PARTITIONS


def _events_schema(name="evr"):
    return Schema(name, [dimension("user", DataType.STRING), metric("value", DataType.LONG),
                          date_time("ts", DataType.LONG)])


def _sums(cluster):
    rows = cluster.query("SELECT user, SUM(value) FROM evr GROUP BY user ORDER BY user "
                         "LIMIT 10")["resultTable"]["rows"]
    return {r[0]: r[1] for r in rows}


def test_consuming_server_killed_and_restarted_replays_offsets(tmp_path, log_broker):
    """SIGKILL the consuming server mid-stream and restart it under the same
    id: it consumes again from the committed offsets, so every produced row
    appears exactly once."""
    client = LogBrokerClient(log_broker.bootstrap)
    client.create_topic("evr", 1)

    def produce(lo, hi):
        for i in range(lo, hi):
            client.produce("evr", json.dumps({"user": f"u{i % 3}", "value": i, "ts": TS + i}))
    with ProcessCluster(num_servers=1, device="cpu", work_dir=str(tmp_path),
                        startup_timeout_s=90.0) as cluster:
        cluster.controller.add_schema(_events_schema())
        cfg = _config(log_broker.bootstrap, "evr", flush=25, name="evr", time_column="ts")
        cluster.controller.add_table(cfg, num_partitions=1)
        produce(0, 40)
        assert wait_until(lambda: _count(cluster, "evr") == 40, timeout=60), \
            _count(cluster, "evr")
        assert wait_until(lambda: len(_committed(cluster, cfg.table_name_with_type)) >= 1,
                          timeout=60)
        cluster.kill_server("server_0")
        produce(40, 55)   # rows produced while the server is dead
        cluster.restart_server("server_0")
        assert wait_until(lambda: _count(cluster, "evr") == 55, timeout=90), \
            _count(cluster, "evr")
        want = {f"u{k}": sum(range(k, 55, 3)) for k in range(3)}
        assert _sums(cluster) == want


def test_pause_and_resume_over_http(tmp_path, log_broker):
    """A paused table stops fetching, its consuming segment with rows
    commits and gets no successor; the resume creates the successor, which
    consumes what arrived meanwhile."""
    client = LogBrokerClient(log_broker.bootstrap)
    client.create_topic("evp", 1)
    with ProcessCluster(num_servers=1, device="cpu", work_dir=str(tmp_path),
                        startup_timeout_s=90.0) as cluster:
        cluster.controller.add_schema(_events_schema("evp"))
        cfg = _config(log_broker.bootstrap, "evp", flush=10_000, name="evp", time_column="ts")
        table = cfg.table_name_with_type
        cluster.controller.add_table(cfg, num_partitions=1)
        for i in range(12):
            client.produce("evp", json.dumps({"user": "u", "value": i, "ts": TS + i}))
        assert wait_until(lambda: _count(cluster, "evp") == 12, timeout=60)
        paused = cluster.controller.pause_consumption(table)
        assert paused["paused"] and len(paused["consumingSegments"]) == 1
        assert wait_until(lambda: _committed(cluster, table) == [(0, 0, 0, 12, 12)], timeout=60)
        metas = cluster.controller.segments_meta(table)["segments"]
        assert all(m["status"] == "DONE" for m in metas.values())
        for i in range(12, 20):
            client.produce("evp", json.dumps({"user": "u", "value": i, "ts": TS + i}))
        resumed = cluster.controller.resume_consumption(table)
        assert not resumed["paused"] and len(resumed["created"]) == 1
        assert wait_until(lambda: _count(cluster, "evp") == 20, timeout=60)
        assert cluster.query("SELECT SUM(value) FROM evp")["resultTable"]["rows"] == \
            [[float(sum(range(20)))]]
