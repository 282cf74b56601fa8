"""Realtime and hybrid tables in pinot_tpu_torch's cluster, held against the
JAX package's.

The same seeded stream goes into a `MemoryStream` topic of each package and
through the JAX package's `QuickCluster` (JAX on the CPU) and this package's
`QuickCluster(device="cpu")`, on the same pump schedule:

* the completion FSM: the scripts of `tests/test_ingest.py::
  test_completion_fsm_edges` and `tests/test_chaos.py`'s committer-crash,
  adoption, laggard-catchup and stale-takeover tests give the same responses
  and end states through both packages' `CompletionFSM`;
* a differential cluster (2 servers, replication 2, 3 partitions, a flush
  threshold that commits each partition three times, crossed at block
  granularity): after every round the catalogs agree (segments, ideal state,
  external view, offsets, statuses, time ranges) and COUNT, SUM, Q1.1 and a
  GROUP BY through both brokers agree with each other and with numpy;
* the lifecycle of `tests/test_ingest.py` and the faults of
  `tests/test_chaos.py` (a replica that diverged or never consumed downloads
  the committed copy; a dead replica's consuming segment moves; a controller
  restarted mid-commit adopts the committer), a hybrid table split at its
  time boundary, and a FULL-upsert table, each with both packages' answers;
* a GROUP BY of more than 4,096 keys on servers whose pipelines answer the
  committed segments in array form beside a consuming view's state dicts:
  one conversion of the summed array form where the two kinds meet, none
  where only array forms merge;
* `chip_smoke.py`'s `realtime_cluster` phase, rehearsed with the card's
  calls pointed at the CPU.

Tolerances: counts exact, sums at rel 1e-5 / abs 0.05 (those of
`tests/test_torch_cluster.py`).
"""

import json
import math
import os

import numpy as np
import pytest

from pinot_tpu.cluster import QuickCluster as JaxQuickCluster
from pinot_tpu.cluster import completion as jax_completion
from pinot_tpu.ingest.stream import MemoryStream as JaxMemoryStream
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu_torch import QuickCluster
from pinot_tpu_torch.cluster import Broker, Catalog, Controller, DeviceQueryPipeline, ServerNode
from pinot_tpu_torch.cluster import completion
from pinot_tpu_torch.cluster.catalog import CONSUMING, ONLINE, STATUS_DONE, STATUS_IN_PROGRESS
from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
from pinot_tpu_torch.ingest.stream import MemoryStream
from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.reduce import SegmentResult, merge_segment_results
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment.writer import SegmentBuilder, SegmentGeneratorConfig
from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY, make_columns, ssb_schema
from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType, UpsertConfig

REL, ABS = 1e-5, 0.05
SEED = 31
SQLS = {
    "count": "SELECT COUNT(*) FROM {t}",
    "sum": "SELECT SUM(lo_revenue), COUNT(*) FROM {t} WHERE lo_quantity < 25",
    "q1_1": QUERY.replace("FROM lineorder", "FROM {t}"),
    "group": GROUP_QUERY.replace("FROM lineorder", "FROM {t}"),
}


@pytest.fixture(autouse=True)
def _reset_streams():
    MemoryStream.reset_all()
    JaxMemoryStream.reset_all()
    yield
    MemoryStream.reset_all()
    JaxMemoryStream.reset_all()


def _cell_equal(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(float(a), float(b), rel_tol=REL, abs_tol=ABS)
    return a == b


def _rows_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(_cell_equal(x, y) for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def _oracle(c, qid):
    """numpy's float64 answer to SQLS[qid] over the columns `c`."""
    if qid == "count":
        return [[len(c["lo_quantity"])]]
    if qid == "sum":
        m = c["lo_quantity"] < 25
        return [[float(c["lo_revenue"][m].sum()), int(m.sum())]]
    m = (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3) & (c["lo_quantity"] < 25)
    if qid == "q1_1":
        m &= (c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19931231)
        return [[float((c["lo_extendedprice"][m] * c["lo_discount"][m]).sum())]]
    regions = np.asarray(c["lo_region"])
    return [[r, float(c["lo_revenue"][m & (regions == r)].sum()), int((m & (regions == r)).sum())]
            for r in sorted(set(regions[m].tolist()))]


def _take(cols, lo, hi):
    return {k: v[lo:hi] for k, v in cols.items()}


def _concat(parts):
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _llc_key(name: str) -> str:
    """An LLC name without its creation time, which differs between runs."""
    return "__".join(name.split("__")[:3])


def _catalog_view(catalog, table):
    with catalog._lock:
        metas = {_llc_key(n): (m.status, m.start_offset, m.end_offset, m.num_docs,
                                m.start_time_ms, m.end_time_ms, m.partition_group,
                                m.sequence_number)
                 for n, m in catalog.segments.get(table, {}).items()}
        ist = {_llc_key(s): dict(a) for s, a in catalog.ideal_state.get(table, {}).items()}
        ev = {_llc_key(s): dict(a) for s, a in catalog.external_view.get(table, {}).items()}
    return metas, ist, ev


class Pair:
    """One realtime table on the JAX package's QuickCluster (`ref`) and on
    this package's (`port`, on the CPU), fed the same messages."""

    def __init__(self, root, schema, cfg: TableConfig, num_partitions, num_servers=2):
        self.ref = JaxQuickCluster(num_servers=num_servers, work_dir=os.path.join(root, "ref"))
        self.port = QuickCluster(num_servers=num_servers, work_dir=os.path.join(root, "port"),
                                 device="cpu")
        self.cfg, self.jcfg = cfg, JaxTableConfig.from_json(cfg.to_json())
        self.table = cfg.table_name_with_type
        self.ref.create_realtime_table(JSchema.from_json(schema.to_json()), self.jcfg,
                                       num_partitions)
        self.port.create_realtime_table(schema, cfg, num_partitions)

    def produce(self, partition, payloads):
        for stream in (JaxMemoryStream.get(self.cfg.stream.topic),
                       MemoryStream.get(self.cfg.stream.topic)):
            for p in payloads:
                stream.produce(p, partition=partition)

    def pump(self, rounds=1):
        for _ in range(rounds):
            self.ref.pump_realtime(self.table)
            self.port.pump_realtime(self.table)

    def managers(self, i):
        return (self.ref.servers[i].realtime_manager(self.table),
                self.port.servers[i].realtime_manager(self.table))

    def query(self, sql):
        """Both brokers' rows, asserted equal; returns (rows, port stats)."""
        a, b = self.ref.query(sql), self.port.query(sql)
        assert _rows_equal(b.rows, a.rows), (sql, b.rows, a.rows)
        return b.rows, b.stats

    def routing_agree(self):
        """Both brokers' routing tables of the table (LLC names without their
        creation time): candidates, consuming segments, dead segments."""
        views = []
        for cluster in (self.ref, self.port):
            rt = cluster.broker.routing._tables[self.table]
            views.append(({_llc_key(s): list(v) for s, v in rt.segment_servers.items()},
                          sorted(_llc_key(s) for s in rt.consuming_segments),
                          sorted(_llc_key(s) for s in rt.dead_segments)))
        assert views[0] == views[1]
        return views[1]

    def catalogs_agree(self):
        view = _catalog_view(self.port.catalog, self.table)
        assert view == _catalog_view(self.ref.catalog, self.table)
        return view

    def shutdown(self):
        self.port.shutdown()


def _events_schema():
    return Schema("events", [dimension("user", DataType.STRING),
                             dimension("country", DataType.STRING),
                             metric("value", DataType.DOUBLE),
                             metric("clicks", DataType.INT)])


def _events_pair(tmp_path, replication=2, flush_rows=40, num_partitions=2, **cfg_kw):
    cfg = TableConfig("events", table_type=TableType.REALTIME, replication=replication,
                      stream=StreamConfig(topic="events_topic", decoder="json",
                                          flush_threshold_rows=flush_rows), **cfg_kw)
    return Pair(str(tmp_path), _events_schema(), cfg, num_partitions)


def _events(prefix, n, country="US", value=1.0, clicks=1):
    return [json.dumps({"user": f"{prefix}{i}", "country": country,
                        "value": value if value is not None else float(i), "clicks": clicks})
            for i in range(n)]


# -- the completion FSM --------------------------------------------------------------

#: (construction kwargs, script): "c" consumed(server, offset), "s" commit
#: start, "e" commit end(server, offset), "age" the decision clock pushed past
#: the timeout, "adopt" adopt_committer, "can" can_adopt
FSM_SCRIPTS = {
    "completion_fsm_edges": ({}, [
        ("c", "s1", 100), ("c", "s2", 90), ("c", "s1", 100), ("s", "s2"), ("s", "s1"),
        ("e", "s1", 100), ("c", "s2", 100), ("c", "s3", 90)]),
    "committer_crash_before_commit_start": ({"commit_timeout_s": 0.05}, [
        ("c", "s1", 50), ("c", "s2", 100), ("age",), ("c", "s1", 50), ("s", "s1"),
        ("e", "s1", 50), ("s", "s2"), ("c", "s2", 100)]),
    "committer_crash_mid_commit": ({"commit_timeout_s": 0.05}, [
        ("c", "s1", 100), ("c", "s2", 100), ("s", "s2"), ("age",), ("c", "s1", 100),
        ("s", "s1"), ("e", "s2", 100), ("e", "s1", 100), ("c", "s2", 100)]),
    "commit_start_adoption_after_controller_restart": (
        {"rebuilt": True, "replica_set": frozenset({"s1", "s2"})}, [
            ("s", "rogue"), ("s", "s1"), ("s", "s2"), ("e", "s1", 80)]),
    "no_adoption_on_fresh_fsm": ({}, [("s", "s1"), ("c", "s1", 10)]),
    "laggard_catchup_script": ({}, [
        ("c", "s1", 90), ("c", "s2", 100), ("c", "s1", 90), ("c", "s1", 100),
        ("s", "s2"), ("e", "s2", 100), ("c", "s1", 100)]),
    "can_adopt_committer_stale_takeover": (
        {"rebuilt": True, "replica_set": frozenset({"s1", "s2"})}, [
            ("can", "rogue"), ("can", "s1"), ("can", "s2"), ("adopt", "s2"), ("can", "s1"),
            ("can", "s2"), ("e", "s2", 70)]),
    "stale_committer_struck_from_reelection": ({"commit_timeout_s": 0.05}, [
        ("c", "s1", 10), ("c", "s2", 30), ("c", "s3", 20), ("age",), ("c", "s3", 20),
        ("c", "s1", 10), ("s", "s3"), ("e", "s3", 20), ("c", "s2", 30), ("c", "s1", 20)]),
}


def _run_fsm(module, kwargs, script):
    fsm = module.CompletionFSM("seg", num_replicas=kwargs.pop("num_replicas", 2), **kwargs)
    out = []
    for op, *args in script:
        if op == "c":
            out.append(fsm.on_consumed(*args))
        elif op == "s":
            out.append(fsm.on_commit_start(*args))
        elif op == "e":
            out.append(fsm.on_commit_end(*args))
        elif op == "age":
            fsm.committer_decided_at -= 1.0
        elif op == "adopt":
            fsm.adopt_committer(*args)
        else:
            out.append(fsm.can_adopt(*args))
    return out, (fsm.state, fsm.committer, fsm.final_offset, dict(fsm.offsets))


@pytest.mark.parametrize("name", sorted(FSM_SCRIPTS))
def test_completion_fsm_scripts_match_the_reference(name):
    kwargs, script = FSM_SCRIPTS[name]
    ours = _run_fsm(completion, dict(kwargs), script)
    assert ours == _run_fsm(jax_completion, dict(kwargs), script)
    assert ours[1][0] in ("COMMITTED", "HOLDING")   # every script reaches an end


def test_llc_names_parse_as_the_reference_does():
    name = completion.llc_segment_name("lineorder", 2, 5)
    assert completion.parse_llc_name(name) == jax_completion.parse_llc_name(name) == {
        "table": "lineorder", "partition": 2, "sequence": 5}
    from pinot_tpu_torch.ingest import realtime
    assert realtime.parse_llc_name is completion.parse_llc_name


# -- the differential cluster ----------------------------------------------------------

DIFF_PARTITIONS, DIFF_BLOCK_ROWS, DIFF_FLUSH_ROWS, DIFF_ROUNDS = 3, 250, 900, 6


def _ssb_pair(tmp_path, flush_rows=DIFF_FLUSH_ROWS, num_partitions=DIFF_PARTITIONS,
              replication=2, staging=True, topic="lineorder_rt"):
    cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=replication,
                      time_column="lo_orderdate",
                      stream=StreamConfig(topic=topic, decoder="columnar",
                                          flush_threshold_rows=flush_rows,
                                          properties={"realtime.ingest.device.staging":
                                                      "true" if staging else "false"}))
    return Pair(str(tmp_path), ssb_schema(), cfg, num_partitions)


def _blocks(cols, block_rows):
    schema = ssb_schema()
    n = len(cols["lo_quantity"])
    return [encode_columnar_block(schema, _take(cols, lo, lo + block_rows))
            for lo in range(0, n, block_rows)]


def test_realtime_cluster_matches_the_reference_round_by_round(tmp_path):
    pair = _ssb_pair(tmp_path)
    per_part = [make_columns(3_000, SEED + p) for p in range(DIFF_PARTITIONS)]
    blocks = [_blocks(c, DIFF_BLOCK_ROWS) for c in per_part]
    sent = [0] * DIFF_PARTITIONS
    try:
        for r in range(DIFF_ROUNDS):
            for p in range(DIFF_PARTITIONS):
                k = 1 + (r + p) % 3       # 1-3 blocks a round: thresholds cross unevenly
                pair.produce(p, blocks[p][sent[p]:sent[p] + k])
                sent[p] += k
            pair.pump()
            metas, ist, ev = pair.catalogs_agree()
            consumed = _concat([_take(per_part[p], 0, sent[p] * DIFF_BLOCK_ROWS)
                                for p in range(DIFF_PARTITIONS)])
            for qid, sql in SQLS.items():
                rows, stats = pair.query(sql.format(t="lineorder"))
                assert _rows_equal(rows, _oracle(consumed, qid)), (r, qid, rows)
                assert stats["partialResult"] is False
                assert stats["numConsumingSegmentsQueried"] == DIFF_PARTITIONS
                assert stats["minConsumingFreshnessTimeMs"] > 0
        done = [m for m in metas.values() if m[0] == STATUS_DONE]
        for p in range(DIFF_PARTITIONS):
            mine = sorted((m for m in done if m[6] == p), key=lambda m: m[7])
            assert len(mine) >= 2
            # each successor starts where its predecessor ended, and a block
            # carried each commit past the threshold
            for a, b in zip(mine, mine[1:]):
                assert a[2] == b[1]
            assert all(m[3] >= DIFF_FLUSH_ROWS and m[3] == (int(m[2]) - int(m[1]))
                       * DIFF_BLOCK_ROWS for m in mine)
        for seg, states in ev.items():
            assert set(states.values()) == ({ONLINE} if metas[seg][0] == STATUS_DONE
                                            else {CONSUMING})
        # one COMMIT a committed segment, the other replica KEEP
        handoffs = [pair.port.servers[i].realtime_manager(pair.table).handoffs
                    for i in range(2)]
        for seg in {s for h in handoffs for s in h}:
            assert sorted(h[seg] for h in handoffs) == ["COMMIT", "KEEP"]
        assert len(set().union(*handoffs)) == len(done)
    finally:
        pair.shutdown()


# -- lifecycle (tests/test_ingest.py) --------------------------------------------------

def test_realtime_consume_query_commit(tmp_path):
    pair = _events_pair(tmp_path)
    ist = pair.port.catalog.ideal_state[pair.table]
    assert len(ist) == 2 and all(set(a.values()) == {CONSUMING} for a in ist.values())
    pair.produce(0, _events("u", 30, value=None))
    pair.produce(1, _events("v", 10, country="DE", value=None))
    pair.pump()
    assert pair.query("SELECT COUNT(*) FROM events")[0] == [[40]]
    servers, consuming, _ = pair.routing_agree()
    assert len(consuming) == 2 and all(servers[s] == ["server_0", "server_1"] for s in consuming)
    pair.produce(0, _events("x", 15, clicks=2))
    pair.pump(3)
    metas, _, ev = pair.catalogs_agree()
    # across the CONSUMING -> ONLINE flip the committed segment routes as an
    # ONLINE one and its successor as a consuming one, alike in both packages
    servers, consuming, _ = pair.routing_agree()
    assert sorted(consuming) == sorted(k for k, m in metas.items() if m[0] != STATUS_DONE)
    done = [(k, m) for k, m in metas.items() if m[0] == STATUS_DONE]
    assert len(done) == 1 and done[0][1][2] == "45" and done[0][1][3] == 45
    assert set(ev[done[0][0]].values()) == {ONLINE}
    rows, stats = pair.query("SELECT COUNT(*), SUM(value), SUM(clicks) FROM events")
    assert rows == [[55, 435.0 + 45.0 + 15.0, 70]]
    pair.shutdown()


def test_realtime_data_survives_commit_plus_new_rows(tmp_path):
    pair = _events_pair(tmp_path, flush_rows=20, num_partitions=1)
    pair.produce(0, _events("u", 25))
    pair.pump(4)
    pair.produce(0, _events("z", 5, country="JP", value=2.0))
    pair.pump()
    rows, _ = pair.query("SELECT COUNT(*), SUM(value) FROM events")
    assert rows == [[30, 35.0]]
    pair.catalogs_agree()
    pair.shutdown()


def test_drop_realtime_table_stops_consumers(tmp_path):
    pair = _events_pair(tmp_path, num_partitions=1, replication=1)
    pair.produce(0, _events("a", 5))
    pair.pump()
    mgrs = [s.realtime_manager(pair.table) for s in pair.port.servers
            if s.realtime_manager(pair.table) is not None]
    consumers = [c for m in mgrs for c in m.consumers.values()]
    assert mgrs and consumers
    pair.port.controller.drop_table(pair.table)
    pair.ref.controller.drop_table(pair.table)
    for s in pair.port.servers:
        assert s.realtime_manager(pair.table) is None
    assert all(m._stop.is_set() and not m.consumers for m in mgrs)
    assert all(c.halted for c in consumers)
    assert pair.table not in pair.port.catalog.ideal_state
    pair.shutdown()


def test_repair_missing_consuming_segment(tmp_path):
    pair = _events_pair(tmp_path, flush_rows=10, num_partitions=1)
    pair.produce(0, _events("a", 12))
    pair.pump(4)
    created = []
    for cluster in (pair.ref, pair.port):
        metas = cluster.catalog.segments[pair.table]
        succ = next(m for m in metas.values() if m.sequence_number == 1)
        cluster.controller.llc.fsms.pop(succ.name, None)
        cluster.catalog.update_ideal_state(pair.table, {succ.name: None})
        cluster.catalog.drop_segment_meta(pair.table, succ.name)
        names = cluster.controller.llc.repair_missing_consuming_segments()
        assert len(names) == 1
        m = cluster.catalog.segments[pair.table][names[0]]
        created.append((m.sequence_number, m.start_offset))
    assert created[0] == created[1] == (1, "12")
    pair.catalogs_agree()
    pair.shutdown()


@pytest.mark.parametrize("held_rows", [12, 0])
def test_pause_resume_consumption(tmp_path, held_rows):
    """Pause force-commits held rows (12) with no successor; a paused empty
    consuming segment (0) idles; rows produced while paused wait; resume
    makes the successor from the committed offset (or goes on fetching)."""
    pair = _events_pair(tmp_path, replication=1, flush_rows=1000, num_partitions=1)
    pair.produce(0, _events("u", held_rows))
    pair.pump()
    for cluster in (pair.ref, pair.port):
        resp = cluster.controller.pause_consumption(pair.table)
        assert resp["paused"] and len(resp["consumingSegments"]) == 1
    pair.pump(3)
    metas, _, _ = pair.catalogs_agree()
    want = STATUS_DONE if held_rows else STATUS_IN_PROGRESS
    assert [m[0] for m in metas.values()] == [want]
    pair.produce(0, _events("p", 5, country="DE", value=2.0))
    pair.pump(3)
    assert pair.query("SELECT COUNT(*) FROM events")[0] == [[held_rows]]
    for cluster in (pair.ref, pair.port):
        resp = cluster.controller.resume_consumption(pair.table)
        assert len(resp["created"]) == (1 if held_rows else 0)
    pair.pump(3)
    rows, _ = pair.query("SELECT COUNT(*), SUM(value) FROM events")
    assert rows == [[held_rows + 5, held_rows + 10.0]]
    metas, _, _ = pair.catalogs_agree()
    assert sorted(m[1] for m in metas.values()) == (["0", "12"] if held_rows else ["0"])
    pair.shutdown()


def test_successor_consuming_segment_inherits_replica_set(tmp_path):
    pair = _events_pair(tmp_path, replication=1, flush_rows=10, num_partitions=1)
    pair.produce(0, _events("u", 12))
    pair.pump(4)
    metas, ist, _ = pair.catalogs_agree()
    by_seq = {metas[s][7]: set(a) for s, a in ist.items()}
    assert len(by_seq) >= 2 and by_seq[0] == by_seq[1]
    pair.shutdown()


def test_background_consume_loops_commit_and_answer(tmp_path):
    """`RealtimeTableManager.start_loop` on each server: its realtime
    manager pumps and completes in a thread of its own; the table commits
    past its threshold, the broker answers every row, and shutdown stops the
    loops."""
    import time

    cluster = QuickCluster(num_servers=2, work_dir=str(tmp_path), device="cpu")
    cfg = TableConfig("events", table_type=TableType.REALTIME, replication=2,
                      stream=StreamConfig(topic="events_bg", decoder="json",
                                          flush_threshold_rows=20,
                                          properties={"realtime.ingest.batch.size": 10}))
    cluster.create_realtime_table(_events_schema(), cfg, 1)
    for s in cluster.servers:
        s.realtime_manager(cfg.table_name_with_type).start_loop()
    for row in _events("u", 50, value=None):
        MemoryStream.get("events_bg").produce(row, partition=0)
    deadline, done, rows = time.time() + 30, [], None
    while time.time() < deadline:
        with cluster.catalog._lock:
            done = [m for m in cluster.catalog.segments[cfg.table_name_with_type].values()
                    if m.status == STATUS_DONE]
        rows = cluster.query("SELECT COUNT(*), SUM(value) FROM events").rows
        if len(done) >= 2 and rows == [[50, float(sum(range(50)))]]:
            break
        time.sleep(0.05)
    assert len(done) >= 2 and rows == [[50, float(sum(range(50)))]], (len(done), rows)
    managers = [s.realtime_manager(cfg.table_name_with_type) for s in cluster.servers]
    cluster.shutdown()
    assert all(m._stop.is_set() and not m.consumers for m in managers)


# -- faults (tests/test_chaos.py) --------------------------------------------------------

def test_replica_divergence_download_from_deepstore(tmp_path):
    """server_0 alone consumes and commits; server_1, which never pumped,
    downloads the committed copy; each replica alone answers every row."""
    pair = _events_pair(tmp_path, flush_rows=20, num_partitions=1)
    pair.produce(0, _events("u", 25))
    for mgr in pair.managers(0):
        mgr.pump_all()
        mgr.complete_all()    # one of two replicas reported: HOLD
        mgr.complete_all()    # a re-report elects it: COMMIT
    metas, _, ev = pair.catalogs_agree()
    seg = next(s for s, m in metas.items() if m[0] == STATUS_DONE)
    assert set(ev[seg].values()) == {ONLINE}
    full = next(n for n in pair.port.catalog.segments[pair.table] if _llc_key(n) == seg)
    assert full in pair.port.servers[1].segments_served(pair.table)
    assert pair.port.servers[1].realtime_manager(pair.table).handoffs == {full: "DISCARD"}
    assert pair.port.servers[0].realtime_manager(pair.table).handoffs == {full: "COMMIT"}
    for dead, alive in (("server_0", "server_1"), ("server_1", "server_0")):
        for cluster in (pair.ref, pair.port):
            cluster.kill_server(dead)
        assert pair.query("SELECT COUNT(*) FROM events")[0] == [[25]]
        for cluster in (pair.ref, pair.port):
            cluster.revive_server(dead)
    pair.shutdown()


def test_replica_past_the_committed_offset_discards(tmp_path):
    """server_0 reports at 25, then pumps on to 30; server_1 reports at 25
    and wins the tie: the committed end offset is 25, so server_0 (at 30)
    discards its buffer and downloads, and the successor consumes the last 5."""
    pair = _events_pair(tmp_path, flush_rows=25, num_partitions=1)
    pair.produce(0, _events("u", 25))
    (r0, p0), (r1, p1) = pair.managers(0), pair.managers(1)
    for m in (r0, p0):
        m.pump_all()
        assert set(m.complete_all().values()) == {"HOLDING"}
    pair.produce(0, _events("v", 5, value=2.0))
    for m in (r0, p0):
        m.pump_all()
    for m in (r1, p1):
        m.pump_all(max_messages=25)
        m.complete_all()
    metas, _, _ = pair.catalogs_agree()
    done = [m for m in metas.values() if m[0] == STATUS_DONE]
    assert [(m[1], m[2], m[3]) for m in done] == [("0", "25", 25)]
    full = next(n for n, m in pair.port.catalog.segments[pair.table].items()
                if m.status == STATUS_DONE)
    assert p0.handoffs == {full: "DISCARD"} and p1.handoffs == {full: "COMMIT"}
    pair.pump()
    rows, _ = pair.query("SELECT COUNT(*), SUM(value) FROM events")
    assert rows == [[30, 35.0]]
    pair.catalogs_agree()
    pair.shutdown()


def test_dead_replica_consuming_segment_reassigned(tmp_path):
    pair = _events_pair(tmp_path, flush_rows=100, replication=1, num_partitions=2)
    for p in range(2):
        pair.produce(p, _events(f"p{p}_", 5))
    pair.pump()
    moved = []
    for cluster in (pair.ref, pair.port):
        ist = cluster.catalog.ideal_state[pair.table]
        victims = sorted(s for s, a in ist.items() if "server_0" in a)
        cluster.kill_server("server_0")
        out = cluster.controller.llc.validate()
        assert sorted(out["reassigned"]) == victims and out["created"] == []
        assert all(set(cluster.catalog.ideal_state[pair.table][s]) == {"server_1"}
                   for s in victims)
        assert cluster.controller.llc.validate()["reassigned"] == []
        moved.append(sorted(_llc_key(s) for s in victims))
    assert moved[0] == moved[1] and moved[0]
    pair.pump()
    # the moved segments route to their new replica in both packages
    servers, consuming, dead = pair.routing_agree()
    assert all(servers[s] == ["server_1"] for s in moved[0]) and not dead
    assert pair.query("SELECT COUNT(*) FROM events")[0] == [[10]]
    pair.catalogs_agree()
    pair.shutdown()


def test_controller_restart_between_commit_start_and_end(tmp_path):
    pair = _events_pair(tmp_path, flush_rows=20, replication=1, num_partitions=1)
    pair.produce(0, _events("u", 25))
    for cluster in (pair.ref, pair.port):
        mgr = next(m for m in (s.realtime_manager(pair.table) for s in cluster.servers)
                   if m is not None and m.consumers)
        mgr.pump_all()
        consumer = next(iter(mgr.consumers.values()))
        build = consumer.build_immutable

        def build_during_restart(cluster=cluster, build=build):
            cluster.controller.llc.fsms.clear()   # the restart, mid-build
            return build()
        consumer.build_immutable = build_during_restart
        mgr.complete_all()   # one replica: elected at once, COMMIT, build
    metas, _, _ = pair.catalogs_agree()
    assert [(m[0], m[2]) for m in metas.values() if m[0] == STATUS_DONE] == [(STATUS_DONE, "25")]
    assert pair.query("SELECT COUNT(*) FROM events")[0] == [[25]]
    pair.shutdown()


@pytest.mark.parametrize("drop_during_upload", [False, True])
def test_commit_flips_a_copy_and_fails_once_its_table_drops_mid_upload(tmp_path,
                                                                        drop_during_upload):
    """The commit's metadata flip puts a filled-in copy: an object a reader
    took before it never shows DONE without its end offset. A table dropped
    while the committer's upload is in flight stays dropped: the commit
    fails, and leaves no ONLINE segment, no successor and no FSM."""
    import threading

    cluster = QuickCluster(num_servers=1, work_dir=str(tmp_path), device="cpu")
    cfg = TableConfig("events", table_type=TableType.REALTIME, replication=1,
                      stream=StreamConfig(topic="events_drop", decoder="json",
                                          flush_threshold_rows=10))
    table = cfg.table_name_with_type
    cluster.create_realtime_table(_events_schema(), cfg, 1)
    for row in _events("u", 12):
        MemoryStream.get("events_drop").produce(row, partition=0)
    mgr = cluster.servers[0].realtime_manager(table)
    mgr.pump_all()
    (segment, consumer), = mgr.consumers.items()
    before = cluster.catalog.segments[table][segment]
    uploading, release = threading.Event(), threading.Event()
    upload = cluster.deepstore.upload

    def slow_upload(local_path, uri):
        uploading.set()
        assert release.wait(30)
        upload(local_path, uri)
    cluster.deepstore.upload = slow_upload
    committer = threading.Thread(target=mgr.complete_all)
    committer.start()
    assert uploading.wait(30)
    assert cluster.catalog.segments[table][segment].status == STATUS_IN_PROGRESS
    if drop_during_upload:
        cluster.controller.drop_table(table)
    release.set()
    committer.join(30)
    assert not committer.is_alive()
    assert before.status == STATUS_IN_PROGRESS and before.end_offset is None
    llc = cluster.controller.llc
    if drop_during_upload:
        assert consumer.state == "ERROR"
        assert table not in cluster.catalog.table_configs
        assert table not in cluster.catalog.segments and table not in cluster.catalog.ideal_state
        assert not llc.fsms and cluster.servers[0].realtime_manager(table) is None
    else:
        metas = cluster.catalog.segments[table]
        assert (metas[segment].status, metas[segment].end_offset) == (STATUS_DONE, "12")
        assert cluster.catalog.ideal_state[table][segment] == {"server_0": ONLINE}
        successor = [n for n, m in metas.items() if m.status == STATUS_IN_PROGRESS]
        assert len(successor) == 1 and set(llc.fsms) == {segment, successor[0]}
        assert cluster.query("SELECT COUNT(*) FROM events").rows == [[12]]
    cluster.shutdown()


# -- hybrid ------------------------------------------------------------------------------

def test_hybrid_table_answers_each_row_once_across_the_time_boundary(tmp_path):
    pair = _ssb_pair(tmp_path, flush_rows=1_000, num_partitions=2)
    cols = [make_columns(2_000, SEED + 10 + p) for p in range(2)]
    for p in range(2):
        pair.produce(p, _blocks(cols[p], 500))
    pair.pump(3)
    stream = _concat(cols)
    d = int(np.median(stream["lo_orderdate"]))
    low = stream["lo_orderdate"] <= d
    offline = {k: v[low] for k, v in stream.items()}
    half = len(offline["lo_quantity"]) // 2
    cfg = TableConfig("lineorder", replication=2, time_column="lo_orderdate")
    jcfg = JaxTableConfig.from_json(cfg.to_json())
    for cluster, c in ((pair.ref, jcfg), (pair.port, cfg)):
        cluster.controller.add_table(c)
        for i, (lo, hi) in enumerate(((0, half), (half, len(offline["lo_quantity"])))):
            cluster.ingest_columns(c, _take(offline, lo, hi), segment_name=f"lineorder_off_{i}")
    boundary = int(offline["lo_orderdate"].max())
    want_cols = _concat([offline, {k: v[stream["lo_orderdate"] > boundary]
                                   for k, v in stream.items()}])
    for qid in ("count", "q1_1", "group"):
        rows, stats = pair.query(SQLS[qid].format(t="lineorder"))
        assert _rows_equal(rows, _oracle(want_cols, qid)), (qid, rows)
        assert stats["partialResult"] is False and stats["numConsumingSegmentsQueried"] == 2
    # each half alone, by its typed name
    rows, _ = pair.query(SQLS["count"].format(t="lineorder_REALTIME"))
    assert rows == [[4_000]]
    pair.shutdown()


# -- upsert ------------------------------------------------------------------------------

def test_full_upsert_realtime_table_through_the_cluster(tmp_path):
    schema = Schema("orders", [dimension("order_id", DataType.INT),
                               dimension("status", DataType.STRING),
                               metric("amount", DataType.DOUBLE)],
                    primary_key_columns=["order_id"])
    cfg = TableConfig("orders", table_type=TableType.REALTIME, replication=2,
                      upsert=UpsertConfig(mode="FULL"),
                      stream=StreamConfig(topic="orders_topic", decoder="json",
                                          flush_threshold_rows=30))
    pair = Pair(str(tmp_path), schema, cfg, 2)
    rng = np.random.default_rng(SEED)
    latest = {}
    for r in range(4):
        for p in range(2):
            keys = rng.integers(0, 20, 12) * 2 + p    # partition p holds keys of parity p
            rows = [{"order_id": int(k), "status": f"s{int(rng.integers(0, 3))}",
                     "amount": float(np.round(rng.random() * 100, 2))} for k in keys]
            pair.produce(p, [json.dumps(row) for row in rows])
            latest.update((row["order_id"], row) for row in rows)
        pair.pump()
        rows, _ = pair.query("SELECT COUNT(*), SUM(amount) FROM orders")
        want = list(latest.values())
        assert _rows_equal(rows, [[len(want), sum(x["amount"] for x in want)]]), (r, rows)
        rows, _ = pair.query("SELECT status, COUNT(*) FROM orders GROUP BY status "
                             "ORDER BY status LIMIT 10")
        by = {}
        for x in want:
            by[x["status"]] = by.get(x["status"], 0) + 1
        assert rows == [[s, n] for s, n in sorted(by.items())]
    metas, _, _ = pair.catalogs_agree()
    assert any(m[0] == STATUS_DONE for m in metas.values())
    # an upsert table never takes a pipeline: its segments answer per segment
    assert all(s.device_pipeline is None for s in pair.port.servers)
    pair.shutdown()


# -- mixed partials ------------------------------------------------------------------------

SUPPKEY_ALL = ("SELECT lo_suppkey, SUM(lo_revenue), COUNT(*) FROM lineorder "
               "GROUP BY lo_suppkey ORDER BY lo_suppkey LIMIT 100000")


def _piped_realtime_cluster(root, cfg):
    """Catalog, controller, broker and two servers on serving pipelines of
    their own, reporting to the controller's LLC manager."""
    catalog = Catalog()
    store = LocalDeepStore(os.path.join(root, "deepstore"))
    controller = Controller("controller_0", catalog, store, os.path.join(root, "controller"))
    servers = [ServerNode(f"server_{i}", catalog, store, os.path.join(root, f"server_{i}"),
                          device="cpu", completion=controller.llc,
                          device_pipeline=DeviceQueryPipeline(MeshQueryExecutor("cpu")))
               for i in range(2)]
    broker = Broker("broker_0", catalog)
    for s in servers:
        broker.register_server_handle(s.instance_id, s.execute_partial)
    controller.add_schema(ssb_schema())
    MemoryStream.create(cfg.stream.topic, 1)
    controller.add_realtime_table(cfg, 1)
    return controller, servers, broker


def _suppkey_oracle(c):
    keys, inv = np.unique(c["lo_suppkey"], return_inverse=True)
    sums = np.bincount(inv, weights=c["lo_revenue"])
    counts = np.bincount(inv)
    return [[int(k), float(s), int(n)] for k, s, n in zip(keys, sums, counts)]


def test_mixed_dense_and_consuming_partials_merge_with_one_conversion(tmp_path, monkeypatch):
    cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=2,
                      stream=StreamConfig(topic="lineorder_mixed", decoder="columnar",
                                          flush_threshold_rows=30_000,
                                          properties={"realtime.ingest.device.staging": "true"}))
    controller, servers, broker = _piped_realtime_cluster(str(tmp_path), cfg)
    # 30,000 rows keep lo_suppkey's dictionary (at most 0.7 of the rows distinct)
    cols = make_columns(40_000, SEED + 3)
    stream = MemoryStream.get("lineorder_mixed")
    for blob in _blocks(cols, 5_000):
        stream.produce(blob, partition=0)
    for _ in range(3):
        for s in servers:
            mgr = s.realtime_manager(cfg.table_name_with_type)
            mgr.pump_all(max_messages=3)
            mgr.complete_all()
    metas = controller.catalog.segments[cfg.table_name_with_type]
    assert sorted(m.status for m in metas.values()) == [STATUS_DONE, STATUS_IN_PROGRESS]

    conversions, partials = [], []
    orig = SegmentResult.materialize_dense

    def spy(self, *args, **kwargs):
        if self.dense is not None:
            conversions.append(self.dense.num_keys_real)
        return orig(self, *args, **kwargs)
    monkeypatch.setattr(SegmentResult, "materialize_dense", spy)
    for s in servers:
        pipe_call = s.device_pipeline.execute_partial

        def recorded(ctx, segments, _call=pipe_call):
            out = _call(ctx, segments)
            partials.append((out.dense, out.num_docs_scanned))   # as the pipeline gave it
            return out
        monkeypatch.setattr(s.device_pipeline, "execute_partial", recorded)
    for _ in range(2):   # the balanced selector sends the committed segment to each server
        conversions.clear()
        partials.clear()
        res = broker.handle_query(SUPPKEY_ALL)
        assert _rows_equal(res.rows, _suppkey_oracle(cols)), res.rows[:3]
        assert res.stats["numConsumingSegmentsQueried"] == 1
        assert len(partials) == 1 and partials[0][0] is not None
        assert partials[0][0].num_keys_real >= 4_096
        # the pipeline's array form meets the consuming view's state dict once
        assert conversions == [partials[0][0].num_keys_real]
    # where only array forms merge, nothing converts; with a dict partial,
    # the summed array form converts once and equals each one converted
    dense, docs = partials[0]
    aggs = [make_agg(f) for f in compile_query(SUPPKEY_ALL, ssb_schema()).aggregations]

    def copy_dense():
        return SegmentResult("groups", dense=dense, num_docs_scanned=docs)
    conversions.clear()
    both = merge_segment_results([copy_dense(), copy_dense()], aggs)
    assert both.dense is not None and not conversions
    assert np.array_equal(both.dense.counts, 2 * dense.counts)
    extra = SegmentResult("groups")   # a state-dict partial with no groups
    mixed = merge_segment_results([copy_dense(), copy_dense(), extra], aggs)
    assert len(conversions) == 1 and mixed.dense is None
    single = copy_dense()
    single.materialize_dense(aggs)
    assert set(mixed.groups) == set(single.groups)
    k = next(iter(single.groups))
    assert mixed.groups[k][1] == 2 * single.groups[k][1]
    for s in servers:
        s.shutdown()


# -- chip_smoke.py's realtime_cluster phase, rehearsed on the CPU -------------------------

def test_the_smoke_realtime_cluster_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """The phase at 81,920 rows a partition (commits of 32,768, blocks of
    8,192, two a round: the card's schedule at a sixteenth) with the card's
    calls pointed at the CPU: every round's answers match their oracles and
    their launches their dispatches, each partition commits twice at the
    JAX package's offsets with one COMMIT a segment, the hybrid table answers
    each row once, and the retired consumers hold no staging."""
    import torch

    import chip_smoke
    from pinot_tpu_torch.engine import kernels, scan
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor

    cpu = torch.device("cpu")
    for module in (executor, combine):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    counts = dict.fromkeys(("masked_sums", "masked_sums_fused", "bitmap_filter",
                            "grouped_agg"), 0)
    for module, name, key in ((scan, "masked_sums_answer", "masked_sums"),
                              (scan, "masked_sums_fused_answer", "masked_sums_fused"),
                              (kernels, "bitmap_filter", "bitmap_filter"),
                              (kernels, "grouped_agg", "grouped_agg")):
        real = getattr(module, name)

        def counted(*args, _real=real, _key=key):
            counts[_key] += 1
            return _real(*args)
        monkeypatch.setattr(module, name, counted)
    monkeypatch.setattr(chip_smoke, "reset_launch_counts",
                        lambda: counts.update(dict.fromkeys(counts, 0)))
    monkeypatch.setattr(chip_smoke, "launch_counts", lambda: dict(counts))
    monkeypatch.setattr(chip_smoke, "device_bytes", lambda: 0)
    for const, value in (("RT_CLUSTER_PARTITION_ROWS", 81_920),
                         ("RT_CLUSTER_FLUSH_ROWS", 32_768), ("RT_CLUSTER_BLOCK_ROWS", 8_192),
                         ("RT_CLUSTER_ROUND_BLOCKS", 2), ("RT_CLUSTER_WARM_RUNS", 1)):
        monkeypatch.setattr(chip_smoke, const, value)

    class Args:
        seed, trace = SEED, False
    assert chip_smoke.llc_commit_offsets(81_920, 8_192, 2, 32_768) == [(0, 4), (4, 8)]
    launches, (data, blocks) = chip_smoke.run_realtime_cluster(Args(), str(tmp_path))
    assert launches["masked_sums"] and launches["grouped_agg"] and launches["masked_sums_fused"]
    # the stream it hands the process_realtime runs: 2 partitions of PCB1 blocks
    assert [len(b) for b in blocks] == [10, 10] and len(data[0]["lo_orderdate"]) == 81_920


# -- queries racing commits ------------------------------------------------------------

RACE_BLOCK_ROWS, RACE_BLOCKS, RACE_FLUSH_BLOCKS = 2_000, 12, 4


def test_queries_racing_commits_count_each_row_once(tmp_path):
    """A reader thread queries COUNT and SUM through the broker while the
    main thread pumps one block a server a round and the replicas commit
    every fourth: each answer counts, for each partition, a prefix of its
    blocks (no segment twice, none skipped), never a partial result; the
    retired consumers hold no staged chunk or view block."""
    import threading

    cluster = QuickCluster(num_servers=2, work_dir=str(tmp_path), device="cpu")
    cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=2,
                      stream=StreamConfig(topic="lineorder_race", decoder="columnar",
                                          flush_threshold_rows=RACE_FLUSH_BLOCKS
                                          * RACE_BLOCK_ROWS,
                                          properties={"realtime.ingest.device.staging": "true"}))
    cluster.create_realtime_table(ssb_schema(), cfg, 2)
    cols = [make_columns(RACE_BLOCKS * RACE_BLOCK_ROWS, SEED + 20 + p) for p in range(2)]
    for p in range(2):
        for blob in _blocks(cols[p], RACE_BLOCK_ROWS):
            MemoryStream.get("lineorder_race").produce(blob, partition=p)
    # (count, SUM(lo_quantity)) of every pair of partition prefixes
    prefix = [np.concatenate([[0], np.cumsum([int(cols[p]["lo_quantity"][i:i + RACE_BLOCK_ROWS]
                                                      .sum()) for i in range(
        0, RACE_BLOCKS * RACE_BLOCK_ROWS, RACE_BLOCK_ROWS)])]) for p in range(2)]
    valid = {((a + b) * RACE_BLOCK_ROWS, int(prefix[0][a] + prefix[1][b]))
             for a in range(RACE_BLOCKS + 1) for b in range(RACE_BLOCKS + 1)}
    sql = "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder"
    stop, answers, errors = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            try:
                res = cluster.query(sql)
            except Exception as e:   # recorded; the test fails below
                errors.append(e)
                return
            count, total = res.rows[0]   # SUM over no rows is null
            answers.append((count, int(total or 0), res.stats["partialResult"],
                            res.stats.get("segmentsUnavailable")))

    seen = {}
    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(RACE_BLOCKS + 2):
            for s in cluster.servers:
                mgr = s.realtime_manager(cfg.table_name_with_type)
                seen.update((id(c), c) for c in mgr.consumers.values())
                mgr.pump_all(max_messages=1)
                mgr.complete_all()
    finally:
        stop.set()
        t.join(timeout=60)
    assert not errors and not t.is_alive()
    bad = [a for a in answers if a[2] or a[:2] not in valid]
    assert answers and not bad, bad[:3]
    total = 2 * RACE_BLOCKS * RACE_BLOCK_ROWS
    res = cluster.query(sql)
    assert res.rows == [[total, float(prefix[0][-1] + prefix[1][-1])]]
    live = {id(c) for s in cluster.servers
            for c in s.realtime_manager(cfg.table_name_with_type).consumers.values()}
    retired = [c for k, c in seen.items() if k not in live]
    assert len(retired) == 2 * 2 * (RACE_BLOCKS // RACE_FLUSH_BLOCKS)
    for c in retired:
        assert all(chunks is None for chunks in c.mutable._dev_chunks.values())
        assert c.mutable._view is None or not c.mutable._view._device_blocks
    cluster.shutdown()


def test_an_empty_view_taken_while_the_first_chunk_stages():
    """A query's view of a consuming segment with no published rows, taken
    after the first block's chunk of a column was staged but before the
    block is published (a query racing the first pump), is an empty view
    with a zero block, not an error."""
    from pinot_tpu_torch.ingest.vectorized import decode_columnar_block
    from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
    import torch
    store = DeviceMutableSegment("seg", ssb_schema(), device_staging=True, device="cpu")
    batch = decode_columnar_block(encode_columnar_block(ssb_schema(), make_columns(100, SEED)))
    spec = ssb_schema().field_spec("lo_quantity")
    store._append_rep(spec, batch.cols["lo_quantity"], batch.n)   # staged, not published
    view = store.query_view()
    blk = next(iter(view._device_blocks.values()))
    assert view.num_docs == 0 and not torch.count_nonzero(blk._raw["lo_quantity"])
