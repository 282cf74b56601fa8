"""The port's ingestion health plane against the JAX package's: the consumers'
lag trackers and gauges (`ingest/realtime.py`), the servers' consuming
rollups (`ServerNode.ingestion_snapshot`, `GET /debug/consuming`) and the
controller's verdict (`Controller.ingestion_status`,
`GET /tables/{t}/ingestionStatus`, `run_ingestion_status_check`).

* Units: the lag tracker, the min merge of `minConsumingFreshnessTimeMs`,
  the gauges' bounded history ring, the periodic task's error metrics.
* Scenarios on both packages' `QuickCluster`s, from the same seeded
  `MemoryStream` messages with fixed event times: lag growth that degrades
  the verdict, pause and resume, the gauges published and removed with a
  dropped table, the servers' lag gauges removed on drop and on shutdown,
  the consuming stats' min merge, unknown and offline tables. Verdicts,
  reasons, offsets and offset lags are equal exactly; the freshness times
  are equal, and each freshness lag is the test's clock less that time.
* The HTTP plane on the port: readiness, `/debug/consuming`,
  `ingestionStatus` through pause and resume, and its 404.
"""

import json
import re
import time

import numpy as np
import pytest

import pinot_tpu.utils.metrics as jmetrics
from pinot_tpu.cluster.enclosure import QuickCluster as JaxQuickCluster
from pinot_tpu.ingest.stream import MemoryStream as JaxMemoryStream
from pinot_tpu_torch.cluster.enclosure import QuickCluster
from pinot_tpu_torch.ingest.stream import MemoryStream
from pinot_tpu_torch.query import stats as qstats
from pinot_tpu_torch.schema import DataType, Schema, date_time, dimension, metric
from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
from pinot_tpu_torch.utils.events import get_journal
from pinot_tpu_torch.utils.metrics import get_registry

from conftest import wait_until

TS = 1_700_000_000_000   # event times: freshness is the data's, not the clock's
LAG_GAUGES = tuple(f"pinot_server_realtime_{g}" for g in (
    "offset_lag", "freshness_lag_ms", "rows_per_s", "last_consumed_ts_ms"))


@pytest.fixture(autouse=True)
def _reset():
    MemoryStream.reset_all()
    JaxMemoryStream.reset_all()
    get_registry().reset()
    jmetrics.get_registry().reset()
    yield
    MemoryStream.reset_all()
    JaxMemoryStream.reset_all()


def _schema_json():
    return Schema("events", [dimension("user", DataType.STRING),
                             metric("value", DataType.DOUBLE),
                             date_time("ts", DataType.LONG)]).to_json()


def _config_json(flush_rows=200):
    return TableConfig("events", table_type=TableType.REALTIME, replication=1,
                       time_column="ts",
                       stream=StreamConfig(stream_type="memory", topic="events_topic",
                                           decoder="json",
                                           flush_threshold_rows=flush_rows)).to_json()


class Side:
    """One package's cluster, stream and registry, driven alike."""

    def __init__(self, pkg, tmp_path, num_servers=2):
        self.pkg = pkg
        if pkg == "port":
            self.cluster = QuickCluster(num_servers=num_servers,
                                        work_dir=str(tmp_path / pkg), device="cpu")
            self.stream_cls, self.reg = MemoryStream, get_registry()
            from pinot_tpu_torch.schema import Schema as S
            from pinot_tpu_torch.table import TableConfig as T
        else:
            self.cluster = JaxQuickCluster(num_servers=num_servers,
                                           work_dir=str(tmp_path / pkg))
            self.stream_cls, self.reg = JaxMemoryStream, jmetrics.get_registry()
            from pinot_tpu.schema import Schema as S
            from pinot_tpu.table import TableConfig as T
        self.S, self.T = S, T
        self.table = "events_REALTIME"
        self.cluster.create_realtime_table(S.from_json(_schema_json()),
                                           T.from_json(_config_json()), num_partitions=2)
        self.controller = self.cluster.controller

    def produce(self, partition, n, ts_base=TS, seed=0):
        rng = np.random.default_rng(seed * 10 + partition)
        stream = self.stream_cls.get("events_topic")
        for i, v in enumerate(rng.integers(0, 1000, n)):
            stream.produce(json.dumps({"user": f"u{i}", "value": float(v), "ts": ts_base + i}),
                           partition=partition)

    def pump(self):
        self.cluster.pump_realtime(self.table)

    def status(self, table=None):
        return self.controller.ingestion_status(table or self.table)

    def snapshot(self):
        return self.reg.snapshot()


def _reason(r):
    """A reason without what the clock decides: a segment's creation ms in
    its LLC name, a freshness lag's ms."""
    r = re.sub(r"(__\d+__\d+__)\d+", r"\1<ms>", r)
    return re.sub(r"freshness lag \d+ms", "freshness lag <ms>", r)


def _view(st):
    """What must be equal across the packages: the verdict and its numbers,
    and each consuming segment's offsets and freshness time (an empty
    segment's is when it started: None here)."""
    segs = {name: (s["partition"], s["state"], s["paused"], s["currentOffset"],
                   s["latestStreamOffset"], s["offsetLag"],
                   s["freshnessTimeMs"] if s["numDocs"] else None,
                   s["rowsIndexed"], s["rowsFiltered"], s["consumeErrors"], s["numDocs"])
            for srv in st["servers"].values() for name, s in srv["segments"].items()}
    return (st["ingestionState"], [_reason(r) for r in st["reasons"]], st["paused"],
            st["numConsumingSegments"], st["maxOffsetLag"], st["unreachableServers"],
            sorted(segs.values()))


def _fresh_ok(st, t0, t1):
    """Each freshness lag is the clock at the poll less the freshness time."""
    for srv in st["servers"].values():
        for s in srv["segments"].values():
            assert t0 - s["freshnessTimeMs"] - 1 <= s["freshnessLagMs"] <= \
                t1 - s["freshnessTimeMs"] + 1, s


def both(tmp_path, scenario, **kw):
    out = {}
    for pkg in ("port", "jax"):
        out[pkg] = scenario(Side(pkg, tmp_path, **kw))
    assert out["port"] == out["jax"]
    return out["port"]


def polled(side, table=None):
    t0 = time.time() * 1000
    st = side.status(table)
    _fresh_ok(st, t0, time.time() * 1000)
    return _view(st)


# -- units -------------------------------------------------------------------

def test_consumer_lag_tracker_units():
    from pinot_tpu.ingest.realtime import ConsumerLagTracker as JTracker
    from pinot_tpu_torch.ingest.realtime import ConsumerLagTracker
    trackers = [ConsumerLagTracker("events_REALTIME", 0), JTracker("events_REALTIME", 0)]
    seen = []
    for tr in trackers:
        assert tr.rows_indexed == 0 and tr.last_consumed_ms is None
        tr.on_batch(10, 8, 1_700_000_000_000)
        got = [tr.rows_indexed, tr.rows_filtered, tr.last_event_time_ms]
        assert tr.last_consumed_ms is not None
        tr.on_batch(5, 5, 1_600_000_000_000)    # the event-time high water only rises
        got += [tr.last_event_time_ms, tr.rows_indexed, tr.rows_per_s > 0]
        before = tr.last_consumed_ms
        tr.on_batch(0, 0, None)                  # an empty fetch: no last-consumed bump
        got += [tr.last_consumed_ms == before]
        tr.on_error()
        got += [tr.errors, tr.table, tr.partition]
        seen.append(got)
    assert seen[0] == seen[1] == [8, 2, 1_700_000_000_000, 1_700_000_000_000, 13, True, True,
                                  1, "events_REALTIME", 0]


def test_execution_stats_min_merge_units():
    a = qstats.ExecutionStats()
    a.set_min(qstats.MIN_CONSUMING_FRESHNESS_TIME_MS, 2000)
    a.set_min(qstats.MIN_CONSUMING_FRESHNESS_TIME_MS, 3000)
    assert a.counters[qstats.MIN_CONSUMING_FRESHNESS_TIME_MS] == 2000
    b = qstats.ExecutionStats()
    b.set_min(qstats.MIN_CONSUMING_FRESHNESS_TIME_MS, 1500)
    b.add(qstats.NUM_CONSUMING_SEGMENTS_QUERIED, 2)
    a.add(qstats.NUM_CONSUMING_SEGMENTS_QUERIED, 1)
    a.merge(b)
    assert a.counters[qstats.MIN_CONSUMING_FRESHNESS_TIME_MS] == 1500
    assert a.counters[qstats.NUM_CONSUMING_SEGMENTS_QUERIED] == 3
    c = qstats.ExecutionStats()
    c.merge(a)
    c.merge(qstats.ExecutionStats())             # a side without the key keeps it
    assert c.counters[qstats.MIN_CONSUMING_FRESHNESS_TIME_MS] == 1500
    pub = c.to_public_dict()
    assert pub[qstats.MIN_CONSUMING_FRESHNESS_TIME_MS] == 1500
    assert isinstance(pub[qstats.MIN_CONSUMING_FRESHNESS_TIME_MS], int)
    # a record that read no consuming segment carries neither key (the
    # port zero-fills no key; the JAX package's sets the count to 0)
    empty = qstats.ExecutionStats().to_public_dict()
    assert qstats.MIN_CONSUMING_FRESHNESS_TIME_MS not in empty
    assert qstats.NUM_CONSUMING_SEGMENTS_QUERIED not in empty
    # the servers' partials reach the broker as wire dicts: the same rule
    merged = qstats.ExecutionStats()
    for wire in ({"numDocsScanned": 10, qstats.MIN_CONSUMING_FRESHNESS_TIME_MS: 5000},
                 {"numDocsScanned": 7, qstats.MIN_CONSUMING_FRESHNESS_TIME_MS: 4000},
                 {"numDocsScanned": 3}):
        merged.merge(wire)
    assert merged.to_public_dict() == {"numDocsScanned": 20,
                                       qstats.MIN_CONSUMING_FRESHNESS_TIME_MS: 4000}


def test_gauge_history_ring_bounded():
    from pinot_tpu_torch.utils.metrics import Gauge, MetricsRegistry
    reg = MetricsRegistry()
    g = reg.gauge("pinot_server_realtime_offset_lag", {"table": "t"})
    for i in range(Gauge.HISTORY_LEN + 60):
        g.set(i)
    hist = g.history()
    assert len(hist) == Gauge.HISTORY_LEN == jmetrics.Gauge.HISTORY_LEN
    assert hist[-1][1] == Gauge.HISTORY_LEN + 59 and hist[0][1] == 60
    assert all(ts > 0 for ts, _ in hist)
    reg.gauge("pinot_broker_queries_g").set(1)
    series = reg.gauge_histories("pinot_server")
    assert list(series) == ["pinot_server_realtime_offset_lag{table=t}"]
    assert len(series["pinot_server_realtime_offset_lag{table=t}"]) == Gauge.HISTORY_LEN
    assert set(reg.gauge_histories()) == {"pinot_server_realtime_offset_lag{table=t}",
                                          "pinot_broker_queries_g"}


def test_periodic_task_error_metrics():
    from pinot_tpu_torch.utils.periodic import PeriodicTask, PeriodicTaskScheduler
    reg = get_registry()
    boom = PeriodicTask("BoomTask", 60.0, lambda: (_ for _ in ()).throw(RuntimeError("nope")))
    base = reg.counter("pinot_periodic_task_errors", {"task": "BoomTask"}).value
    boom.run_once()
    boom.run_once()
    assert boom.run_count == 2 and boom.error_count == 2
    assert reg.counter("pinot_periodic_task_errors", {"task": "BoomTask"}).value == base + 2
    st = boom.stats()
    assert st["errorCount"] == 2 and st["lastError"] == "RuntimeError: nope"
    assert st["lastRunMs"] is not None
    boom.fn = lambda: None                      # a clean run clears the error
    boom.run_once()
    assert boom.stats()["lastError"] is None
    sched = PeriodicTaskScheduler()
    sched.register(boom)
    assert sched.stats()["BoomTask"]["runCount"] == 3


# -- scenarios on both packages ----------------------------------------------

def test_offset_lag_grows_and_degrades(tmp_path):
    def run(s):
        s.produce(0, 20, seed=1)
        s.produce(1, 20, seed=1)
        s.pump()
        out = [polled(s)]
        s.produce(0, 30, ts_base=TS + 100, seed=2)      # nothing pumps: the stream runs ahead
        out.append(polled(s))
        s.controller.catalog.put_property(
            "clusterConfig/controller.ingestion.offset.lag.threshold", "10")
        out.append(polled(s))
        s.pump()                                          # caught up: healthy again
        out.append(polled(s))
        s.controller.catalog.put_property(
            "clusterConfig/controller.ingestion.freshness.lag.ms.threshold", "1000")
        out.append(polled(s))                             # event times of 2023: stale
        return out
    out = both(tmp_path, run)
    assert [o[0] for o in out] == ["HEALTHY", "HEALTHY", "DEGRADED", "HEALTHY", "DEGRADED"]
    assert [o[4] for o in out] == [0, 30, 30, 0, 0]
    assert out[2][1] == ["offset lag 30 exceeds threshold 10"]
    assert out[4][1][0].startswith("freshness lag ")
    assert out[0][3] == 2
    assert sorted(seg[3] for seg in out[3][6]) == [20, 50]


def test_pause_degrades_resume_heals(tmp_path):
    def run(s):
        s.produce(1, 10, seed=3)
        s.pump()
        out = [polled(s)]
        # a paused consumer holding rows commits (no successor until the
        # resume); one holding none waits, its lag growing behind the pause
        s.controller.llc.pause_consumption(s.table)
        s.produce(0, 25, ts_base=TS + 50, seed=4)
        s.pump()
        out.append(polled(s))
        s.controller.llc.resume_consumption(s.table)
        s.pump()
        out.append(polled(s))
        return out
    out = both(tmp_path, run)
    assert [o[0] for o in out] == ["HEALTHY", "DEGRADED", "HEALTHY"]
    assert out[1][1] == ["consumption is paused"] and out[1][2] is True
    assert [o[3] for o in out] == [2, 1, 2]
    assert out[1][4] == 25 and out[1][6][0][:6] == (0, "INITIAL_CONSUMING", True, 0, 25, 25)
    assert out[2][4] == 0 and out[2][2] is False


def test_ingestion_gauges_and_stale_removal(tmp_path):
    def run(s):
        s.produce(0, 5, seed=5)
        s.pump()
        out = [s.controller.run_ingestion_status_check()]
        snap = s.snapshot()
        keys = [f"pinot_controller_ingestion_{g}{{table={s.table}}}"
                for g in ("healthy", "offset_lag", "freshness_lag_ms")]
        out.append([snap.get(k) is not None for k in keys] + [snap[keys[0]], snap[keys[1]]])
        dbg = s.controller.debug_stats()
        out.append([dbg["ingestionStatus"][s.table]["ingestionState"],
                    "servers" in dbg["ingestionStatus"][s.table],
                    "IngestionStatusChecker" in dbg["periodicTasks"],
                    any(k.startswith("pinot_controller_ingestion_healthy")
                        for k in dbg["gaugeHistories"])])
        s.controller.drop_table(s.table)
        out.append(s.controller.run_ingestion_status_check())
        snap = s.snapshot()
        out.append([k in snap for k in keys])
        return out
    out = both(tmp_path, run)
    assert out == [{"events_REALTIME": "HEALTHY"}, [True, True, True, 1.0, 0.0],
                   ["HEALTHY", False, True, True], {}, [False, False, False]]


def test_verdict_transitions_are_counted_and_journaled(tmp_path):
    s = Side("port", tmp_path)
    since = get_journal().events_since(0)["cursor"]
    s.produce(0, 5, seed=6)
    s.pump()
    assert s.controller.run_ingestion_status_check() == {s.table: "HEALTHY"}
    s.controller.llc.pause_consumption(s.table)
    for _ in range(2):   # one transition, however many ticks see it
        assert s.controller.run_ingestion_status_check() == {s.table: "DEGRADED"}
    s.controller.llc.resume_consumption(s.table)
    assert s.controller.run_ingestion_status_check() == {s.table: "HEALTHY"}
    events = [e for e in get_journal().events_since(since)["events"]
              if e["kind"] == "verdict.ingestion"]
    assert [(e["table"], e["attrs"]["fromState"], e["attrs"]["toState"], e["severity"])
            for e in events] == [(s.table, "HEALTHY", "DEGRADED", "WARN"),
                                 (s.table, "DEGRADED", "HEALTHY", "INFO")]
    assert s.snapshot()["pinot_controller_verdict_transitions{kind=ingestion}"] == 2
    # the memory plane's edge trigger is its own
    assert s.controller.run_memory_check()[s.table] == "HEALTHY"
    assert "pinot_controller_verdict_transitions{kind=memory}" not in s.snapshot()
    s.controller.drop_table(s.table)
    s.controller.run_ingestion_status_check()
    assert s.controller._verdict_prev["ingestion"] == {}


def test_server_lag_gauges_removed_on_drop(tmp_path):
    def run(s):
        s.produce(0, 5, seed=7)
        s.pump()
        s.cluster.servers[0].ingestion_snapshot()    # exports the partitions' gauges
        s.cluster.servers[1].ingestion_snapshot()
        lag = [k for k in s.snapshot() if k.startswith(LAG_GAUGES)]
        s.controller.drop_table(s.table)
        gone = wait_until(lambda: not any(k.startswith(LAG_GAUGES) for k in s.snapshot()),
                          timeout=10.0, interval=0.05, swallow=())
        return sorted(lag), gone
    lag, gone = both(tmp_path, run)
    assert gone and lag == sorted(
        f"pinot_server_realtime_{g}{{partition={p},table=events}}"
        for g in ("offset_lag", "freshness_lag_ms", "rows_per_s", "last_consumed_ts_ms")
        for p in (0, 1))


def test_server_lag_gauges_removed_on_shutdown(tmp_path):
    s = Side("port", tmp_path)
    s.produce(1, 5, seed=8)
    s.pump()
    for srv in s.cluster.servers:
        srv.ingestion_snapshot()
    assert any(k.startswith("pinot_server_realtime_offset_lag") for k in s.snapshot())
    s.cluster.shutdown()
    assert not any(k.startswith(LAG_GAUGES) for k in s.snapshot())


def test_consuming_query_stats_min_merge(tmp_path):
    def run(s):
        s.produce(0, 10, ts_base=TS + 60_000, seed=9)   # the fresher partition
        s.produce(1, 10, ts_base=TS, seed=9)            # the staler one
        s.pump()
        res = s.cluster.query("SELECT COUNT(*) FROM events LIMIT 5")
        st = s.status()
        return (res.rows[0][0], res.stats["numConsumingSegmentsQueried"],
                res.stats["minConsumingFreshnessTimeMs"],
                sorted(seg["freshnessTimeMs"] for srv in st["servers"].values()
                       for seg in srv["segments"].values()))
    assert both(tmp_path, run) == (20, 2, TS + 9, [TS + 9, TS + 60_009])


def test_ingestion_status_unknown_and_offline_tables(tmp_path):
    def run(s):
        try:
            s.status("nope_REALTIME")
            unknown = "answered"
        except ValueError:
            unknown = "ValueError"
        schema = s.S.from_json(Schema("off", [dimension("site", DataType.STRING),
                                              metric("v", DataType.DOUBLE)]).to_json())
        s.cluster.create_table(schema, s.T.from_json(TableConfig("off").to_json()))
        st = s.status("off_OFFLINE")
        s.controller.run_ingestion_status_check()
        return (unknown, st["ingestionState"], st["message"], st["numConsumingSegments"],
                "pinot_controller_ingestion_healthy{table=off_OFFLINE}" in s.snapshot())
    assert both(tmp_path, run) == ("ValueError", "HEALTHY", "offline table: batch ingestion only",
                                   0, False)


def test_unreachable_server_and_missing_consumer(tmp_path):
    def run(s):
        s.produce(0, 5, seed=10)
        s.pump()

        def down():
            raise ConnectionError("refused")
        real = s.controller.ingestion_pollers["server_1"]
        s.controller.ingestion_pollers["server_1"] = down
        out = [polled(s)]
        s.controller.ingestion_pollers = {"server_1": down}
        out.append(polled(s))
        s.controller.ingestion_pollers = {"server_1": real}   # server_0's consumer unseen
        out.append(polled(s))
        return out
    out = both(tmp_path, run)
    # each server consumes one partition: the one it polls is missing too
    assert out[0][0] == "UNHEALTHY" and out[0][5] == ["server_1"]
    assert out[0][1] == ["consuming segments with no attached consumer: "
                         "['events__1__0__<ms>']",
                         "ingestion status poll failed for: ['server_1']"]
    assert out[1][0] == "UNHEALTHY" and out[1][1][-1].startswith("no server reported")
    assert out[2][0] == "UNHEALTHY" and out[2][1] == [
        "consuming segments with no attached consumer: ['events__0__0__<ms>']"]


# -- the HTTP plane -----------------------------------------------------------

def test_health_and_ingestion_over_http(tmp_path):
    from pinot_tpu_torch.cluster.broker import Broker
    from pinot_tpu_torch.cluster.catalog import CONSUMING, Catalog
    from pinot_tpu_torch.cluster.controller import Controller
    from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
    from pinot_tpu_torch.cluster.http_service import HttpError, get_json, http_call
    from pinot_tpu_torch.cluster.server import ServerNode
    from pinot_tpu_torch.cluster.services import (BrokerService, ControllerService,
                                                  ServerService)

    catalog = Catalog()
    controller = Controller("controller_0", catalog, LocalDeepStore(str(tmp_path / "ds")),
                            str(tmp_path / "ctrl"))
    csvc = ControllerService(controller)
    services = [csvc]
    try:
        nodes = [ServerNode(f"server_{i}", catalog, LocalDeepStore(str(tmp_path / "ds")),
                            str(tmp_path / f"server_{i}"), completion=controller.llc,
                            device="cpu") for i in range(2)]
        services += [ServerService(n) for n in nodes]
        bsvc = BrokerService(Broker("broker_0", catalog, device="cpu"))
        services.append(bsvc)
        surl = services[1].url

        # liveness against readiness: a ghost assignment makes server_0 not ready
        assert get_json(f"{surl}/health")["instance"] == "server_0"
        assert get_json(f"{surl}/health/readiness")["ready"] is True
        with catalog._lock:
            catalog.ideal_state.setdefault("ghost_REALTIME", {})["ghost__0__0__x"] = {
                "server_0": CONSUMING}
        with pytest.raises(HttpError) as ei:
            http_call("GET", f"{surl}/health/readiness", timeout=5.0)
        assert ei.value.status == 503
        with catalog._lock:
            del catalog.ideal_state["ghost_REALTIME"]

        controller.add_schema(Schema.from_json(_schema_json()))
        MemoryStream.create("events_topic", 2)
        controller.add_realtime_table(TableConfig.from_json(_config_json()), num_partitions=2)
        table = "events_REALTIME"
        stream = MemoryStream.get("events_topic")
        for p, base in ((0, TS + 60_000), (1, TS)):
            for i in range(10):
                stream.produce(json.dumps({"user": f"u{i}", "value": float(i), "ts": base + i}),
                               partition=p)

        def pump():
            for n in nodes:
                mgr = n.realtime_manager(table)
                if mgr is not None:
                    mgr.pump_all()
        pump()

        def http_count():
            r = json.loads(http_call("POST", f"{bsvc.url}/query", json.dumps(
                {"sql": "SELECT COUNT(*) FROM events LIMIT 5"}).encode()).decode())
            rows = r["resultTable"]["rows"]
            return r if rows and rows[0][0] == 20 else None
        assert wait_until(lambda: http_count() is not None, timeout=20.0)
        resp = http_count()
        assert resp["numConsumingSegmentsQueried"] == 2
        assert resp["minConsumingFreshnessTimeMs"] == TS + 9

        snaps = [get_json(f"{svc.url}/debug/consuming") for svc in services[1:3]]
        assert [s["instance"] for s in snaps] == ["server_0", "server_1"]
        segs = {n: s for snap in snaps for n, s in snap["tables"].get(table, {}).get(
            "segments", {}).items()}
        assert len(segs) == 2 and all(s["currentOffset"] == 10 and s["offsetLag"] == 0
                                      for s in segs.values())

        # the controller polls the servers' own /debug/consuming routes
        st = get_json(f"{csvc.url}/tables/{table}/ingestionStatus")
        assert st["ingestionState"] == "HEALTHY" and st["numConsumingSegments"] == 2
        assert sorted(st["servers"]) == ["server_0", "server_1"]
        controller.llc.pause_consumption(table)
        for i in range(25):
            stream.produce(json.dumps({"user": "x", "value": 1.0, "ts": TS + 100 + i}),
                           partition=0)
        catalog.put_property("clusterConfig/controller.ingestion.offset.lag.threshold", "10")
        st = get_json(f"{csvc.url}/tables/{table}/ingestionStatus")
        assert st["ingestionState"] == "DEGRADED" and st["maxOffsetLag"] == 25
        assert st["reasons"] == ["consumption is paused", "offset lag 25 exceeds threshold 10"]
        controller.llc.resume_consumption(table)
        pump()
        st = get_json(f"{csvc.url}/tables/{table}/ingestionStatus")
        assert st["ingestionState"] == "HEALTHY", st["reasons"]

        assert "IngestionStatusChecker" in get_json(f"{csvc.url}/debug")["periodicTasks"]
        sdbg = get_json(f"{surl}/debug")
        assert any(k.startswith("pinot_server_realtime_offset_lag")
                   for k in sdbg["gaugeHistories"])
        with pytest.raises(HttpError) as ei:
            http_call("GET", f"{csvc.url}/tables/nope_REALTIME/ingestionStatus", timeout=5.0)
        assert ei.value.status == 404
    finally:
        for s in services:
            s.stop()
