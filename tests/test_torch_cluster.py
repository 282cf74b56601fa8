"""The cluster roles of pinot_tpu_torch held against the JAX package's.

Segment directories are built once from a numpy seed and uploaded to the JAX
package's `QuickCluster` (JAX on the CPU) and to this package's
`QuickCluster(device="cpu")`, both with 3 servers and replication 2:

* the same SQL through both brokers gives equal rows (counts exact, sums at
  REL/ABS) and equal segment counts, through the per-segment servers and
  through servers on the serving pipeline, whose high-cardinality GROUP BY
  partials stay dense to the broker;
* the role scenarios of `tests/test_cluster.py` (upload -> assign -> load,
  failover, partial results, deletion and the reaper, retention, rebalance,
  pruned routing, the selectors, retries) behave in both alike;
* a catalog snapshot of the JAX package restores into this package's
  catalog, whose servers load the segments from the JAX package's deep store;
* no fallback: a server whose pipeline raises makes the error reach the
  query (or, with a healthy replica, the broker's retry round), never a host
  answer on that server; without CUDA the default-device roles raise.

The JAX package's scenarios that need fault injection (`utils/faults.py`:
the `server.crash` and `server.slow` points, deep-store upload and download
failures) wait for that module; a deep-store upload that fails is replaced by
hand where a test needs one (the peer download scheme).
"""

import concurrent.futures
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest

from pinot_tpu.cluster import QuickCluster as JaxQuickCluster
from pinot_tpu.cluster.server import ServerNode as JaxServerNode
from pinot_tpu.query.context import compile_query as jax_compile_query
from pinot_tpu.query.scheduler import QueryRejectedError as JaxQueryRejectedError
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu_torch import QuickCluster
from pinot_tpu_torch.cluster import Broker, Catalog, DeviceQueryPipeline, ServerNode
from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
from pinot_tpu_torch.cluster.routing import RoutingTable, partition_for_value
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.reduce import SegmentResult
from pinot_tpu_torch.query.scheduler import QueryRejectedError
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment.writer import (SegmentBuilder, SegmentGeneratorConfig,
                                            build_aligned_segments)
from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY, make_columns, ssb_schema
from pinot_tpu_torch.table import SegmentPartitionConfig, TableConfig

REL, ABS = 1e-5, 0.05       # tests/test_torch_parallel.py's tolerances
ROWS, SEGMENTS, SEED = 48_000, 4, 17
TABLE = "lineorder_OFFLINE"

SUPPKEY_GROUP = ("SELECT lo_suppkey, SUM(lo_revenue), COUNT(*) FROM lineorder "
                 "GROUP BY lo_suppkey ORDER BY lo_suppkey LIMIT 25")
QUERIES = {
    "q1_1": QUERY,
    "group_query": GROUP_QUERY,
    "count": "SELECT COUNT(*) FROM lineorder",
    "selection": ("SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
                  "ORDER BY lo_revenue DESC LIMIT 7"),
    "distinctcount": "SELECT DISTINCTCOUNT(lo_suppkey) FROM lineorder WHERE lo_quantity < 25",
    "suppkey_group": SUPPKEY_GROUP,
    "explain": "EXPLAIN PLAN FOR " + QUERY,
    "explain_analyze": "EXPLAIN ANALYZE " + GROUP_QUERY,
}


@pytest.fixture(scope="module")
def seg_dirs(tmp_path_factory):
    """Aligned segments with every column a dictionary (lo_suppkey's 20,000
    keys give a dense key space of the set's cardinality)."""
    out = tmp_path_factory.mktemp("cluster_segments")
    cols = make_columns(ROWS, SEED)
    paths = build_aligned_segments(ssb_schema(), cols, str(out), "lineorder", SEGMENTS,
                                   SegmentGeneratorConfig(raw_cardinality_fraction=1.0))
    return cols, paths


def _configs(**kw):
    cfg = TableConfig("lineorder", replication=kw.pop("replication", 2),
                      time_column="lo_orderdate", **kw)
    return cfg, JaxTableConfig.from_json(cfg.to_json())


def _piped_cluster(num_servers, work_dir, device="cpu"):
    """A QuickCluster whose servers each answer through a DeviceQueryPipeline
    of their own over a set executor on `device`, registered on the broker
    as a server process wires them."""
    cluster = QuickCluster(num_servers=0, work_dir=work_dir, device=device)
    for i in range(num_servers):
        server = ServerNode(f"server_{i}", cluster.catalog, cluster.deepstore,
                            os.path.join(work_dir, f"server_{i}"), device=device,
                            device_pipeline=DeviceQueryPipeline(MeshQueryExecutor(device)))
        cluster.servers.append(server)
        cluster.broker.register_server_handle(server.instance_id, server.execute_partial,
                                              explain_handle=server.explain_partial)
    return cluster


def _pair(root, dirs, servers=3, schema=None, cfg=None):
    """The JAX package's cluster and this package's, each with the table
    created and `dirs` uploaded: {"ref": (cluster, cfg), "port": (...)}."""
    schema = schema or ssb_schema()
    cfg, jcfg = cfg or _configs()
    ref = JaxQuickCluster(num_servers=servers, work_dir=os.path.join(root, "ref"))
    port = QuickCluster(num_servers=servers, work_dir=os.path.join(root, "port"),
                        device="cpu")
    ref.create_table(JSchema.from_json(schema.to_json()), jcfg)
    port.create_table(schema, cfg)
    for d in dirs:
        ref.controller.upload_segment(jcfg.table_name_with_type, d)
        port.controller.upload_segment(cfg.table_name_with_type, d)
    return {"ref": (ref, jcfg), "port": (port, cfg)}


@pytest.fixture()
def pair(tmp_path, seg_dirs):
    clusters = _pair(str(tmp_path), seg_dirs[1])
    yield clusters
    clusters["port"][0].shutdown()


def _cell_equal(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(float(a), float(b), rel_tol=REL, abs_tol=ABS)
    return a == b


def _rows_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(_cell_equal(x, y) for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def _compile(pkg: str, sql: str):
    """Each package's routing reads its own QueryContext."""
    return (jax_compile_query if pkg == "ref" else compile_query)(sql)


def _count(cluster) -> int:
    return cluster.query("SELECT COUNT(*) FROM lineorder").rows[0][0]


# -- the same SQL through both brokers ----------------------------------------------

@pytest.fixture(scope="module")
def read_clusters(tmp_path_factory, seg_dirs):
    root = str(tmp_path_factory.mktemp("read_clusters"))
    clusters = _pair(os.path.join(root, "plain"), seg_dirs[1])
    piped = _piped_cluster(3, os.path.join(root, "piped"))
    cfg = clusters["port"][1]
    piped.create_table(ssb_schema(), cfg)
    for d in seg_dirs[1]:
        piped.controller.upload_segment(TABLE, d)
    out = {"ref": clusters["ref"][0], "per_segment": clusters["port"][0], "pipeline": piped}
    yield out
    out["per_segment"].shutdown()
    piped.shutdown()


@pytest.mark.parametrize("route", ["per_segment", "pipeline"])
@pytest.mark.parametrize("qid", list(QUERIES))
def test_same_sql_through_both_brokers(read_clusters, route, qid):
    sql = QUERIES[qid]
    want = read_clusters["ref"].query(sql)
    got = read_clusters[route].query(sql)
    assert got.columns == want.columns
    if qid == "explain_analyze":
        # the plan and each operator's rows; the milliseconds are the runs' own
        assert [r[:4] for r in got.rows] == [r[:4] for r in want.rows]
    else:
        assert _rows_equal(got.rows, want.rows), (got.rows[:5], want.rows[:5])
    if qid != "explain":
        for key in ("numSegmentsQueried", "numSegmentsPruned"):
            assert got.stats[key] == want.stats[key], key
        assert got.stats["partialResult"] is want.stats["partialResult"] is False
        assert got.stats["numSegmentsRetried"] == 0


def test_dense_partials_merge_elementwise_at_the_broker(read_clusters, monkeypatch):
    """Through the pipeline each server answers the GROUP BY over 20,000
    keys with one array-form partial; the broker merges them elementwise and
    finalizes without building a state dict."""
    piped = read_clusters["pipeline"]
    dense = []
    for sid, handle in list(piped.broker._servers.items()):
        def spy(*args, _h=handle):
            r = _h(*args)
            dense.append(r.dense is not None)
            return r
        piped.broker._servers[sid] = spy
    materialized = []
    orig = SegmentResult.materialize_dense
    monkeypatch.setattr(SegmentResult, "materialize_dense",
                        lambda self, aggs=None: (materialized.append(1), orig(self, aggs)))
    sql = SUPPKEY_GROUP.replace("LIMIT 25", "LIMIT 100000")
    got = piped.query(sql)
    want = read_clusters["ref"].query(sql)
    assert len(got.rows) > 4096 and _rows_equal(got.rows, want.rows)
    assert dense and all(dense) and len(dense) == got.stats["numServersQueried"]
    assert not materialized


# -- the role scenarios of tests/test_cluster.py ---------------------------------------

def _both(pair, fn):
    """fn(cluster, cfg, pkg) on both clusters -> {"ref": out, "port": out}."""
    return {pkg: fn(cluster, cfg, pkg) for pkg, (cluster, cfg) in pair.items()}


def test_upload_assign_load_query(pair):
    def run(cluster, cfg, pkg):
        ist = cluster.catalog.ideal_state[TABLE]
        assert len(ist) == SEGMENTS and all(len(a) == 2 for a in ist.values())
        assert cluster.controller.table_status(TABLE)["converged"]
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        assert res.stats["numServersResponded"] == res.stats["numServersQueried"]
        return ist, res.rows, res.stats["numServersQueried"]
    out = _both(pair, run)
    assert out["ref"] == out["port"]
    assert out["port"][1] == [[ROWS]]


def test_group_by_through_broker(pair):
    sql = ("SELECT lo_region, COUNT(*) FROM lineorder GROUP BY lo_region "
           "ORDER BY lo_region LIMIT 10")
    out = _both(pair, lambda c, cfg, pkg: c.query(sql).rows)
    assert out["ref"] == out["port"] and sum(r[1] for r in out["port"]) == ROWS


def test_replica_failover(pair):
    def run(cluster, cfg, pkg):
        cluster.kill_server("server_0")
        res = cluster.query(QUERY)
        return res.rows, res.stats["partialResult"]
    out = _both(pair, run)
    assert out["port"][1] is False
    assert _rows_equal(out["port"][0], out["ref"][0])


def test_crashed_server_partial_then_routed_around(pair):
    def broken(table, ctx, segments, time_filter=None):
        raise ConnectionError("boom")

    def run(cluster, cfg, pkg):
        cluster.broker.register_server_handle("server_1", broken)
        first = cluster.query("SELECT COUNT(*) FROM lineorder")
        second = cluster.query("SELECT COUNT(*) FROM lineorder")
        return (first.rows, first.stats["partialResult"],
                "segmentsUnavailable" in first.stats,
                "server_1" in cluster.broker.routing.unhealthy_servers(),
                second.rows, second.stats["partialResult"])
    out = _both(pair, run)
    assert out["ref"] == out["port"]
    assert out["port"][0] == out["port"][4] == [[ROWS]] and out["port"][5] is False


def test_segment_deletion_parks_then_reaped(pair):
    def run(cluster, cfg, pkg):
        seg = sorted(cluster.catalog.segments[TABLE])[0]
        meta = cluster.catalog.segments[TABLE][seg]
        assert cluster.deepstore.exists(meta.download_path)
        cluster.controller.delete_segment(TABLE, seg)
        parked = f"Deleted_Segments/{TABLE}/{seg}.tar.gz"
        state = (seg in cluster.catalog.ideal_state[TABLE],
                 cluster.deepstore.exists(meta.download_path),
                 cluster.deepstore.exists(parked), _count(cluster))
        cluster.controller.run_retention()
        kept = cluster.deepstore.exists(parked)
        out = cluster.controller.run_retention(now_ms=int(meta.push_time_ms) + 8 * 86_400_000)
        return state, kept, f"reaped:{parked}" in out, cluster.deepstore.exists(parked), \
            cluster.catalog.get_property(f"deleted/{TABLE}/{seg}")
    out = _both(pair, run)
    assert out["ref"] == out["port"]
    assert out["port"] == ((False, False, True, ROWS - ROWS // SEGMENTS), True, True,
                           False, None)


def test_retention(pair):
    def run(cluster, cfg, pkg):
        cluster.catalog.table_configs[TABLE].retention_days = 1.0
        now_ms = 10_000_000
        for meta in cluster.catalog.segments[TABLE].values():
            meta.end_time_ms = now_ms - 2 * 24 * 3600 * 1000
        deleted = cluster.controller.run_retention(now_ms=now_ms)
        return sorted(deleted), _count(cluster)
    out = _both(pair, run)
    assert out["ref"] == out["port"] and len(out["port"][0]) == SEGMENTS
    assert out["port"][1] == 0


def test_rebalance_after_server_addition(pair):
    def run(cluster, cfg, pkg):
        cls = JaxServerNode if pkg == "ref" else ServerNode
        kw = {} if pkg == "ref" else {"device": "cpu"}
        new = cls("server_3", cluster.catalog, cluster.deepstore,
                  os.path.join(cluster.work_dir, "server_3"), **kw)
        cluster.broker.register_server_handle("server_3", new.execute_partial)
        final = cluster.controller.rebalance(TABLE)
        assert all(len(a) == 2 for a in final.values())
        assert "server_3" in {s for a in final.values() for s in a}
        return final, _count(cluster)
    out = _both(pair, run)
    assert out["ref"] == out["port"] and out["port"][1] == ROWS


def test_partition_pruned_routing(tmp_path):
    schema = Schema("events", [dimension("user", DataType.STRING),
                               metric("value", DataType.DOUBLE)])
    users = [f"user{i}" for i in range(40)]
    by_partition = {}
    for u in users:
        by_partition.setdefault(partition_for_value(u, "murmur", 4), []).append(u)
    dirs = [SegmentBuilder(schema).build({"user": us * 5, "value": np.ones(len(us) * 5)},
                                         str(tmp_path / "segs"), f"events_{pid}")
            for pid, us in sorted(by_partition.items())]
    cfg = TableConfig("events", replication=1,
                      partition=SegmentPartitionConfig("user", "murmur", 4))
    pair = _pair(str(tmp_path), dirs, schema=schema,
                 cfg=(cfg, JaxTableConfig.from_json(cfg.to_json())))
    sql = f"SELECT COUNT(*) FROM events WHERE user = '{users[0]}'"

    def run(cluster, c, pkg):
        res = cluster.query(sql)
        routed = cluster.broker.routing.route_query("events_OFFLINE", _compile(pkg, sql))
        return res.rows, sum(len(v) for v in routed.values()), \
            res.stats["numSegmentsPruned"], res.stats["numSegmentsPrunedByPartition"]
    out = _both(pair, run)
    assert out["ref"] == out["port"] == ([[5]], 1, len(dirs) - 1, len(dirs) - 1)


def test_time_pruned_routing(tmp_path):
    schema = ssb_schema()
    dirs = []
    for i, year in enumerate((1992, 1995)):
        cols = make_columns(500, SEED + i)
        cols["lo_orderdate"] = np.full(500, year * 10000 + 601, dtype=np.int32)
        dirs.append(SegmentBuilder(schema).build(cols, str(tmp_path / "segs"),
                                                 f"lineorder_{year}"))
    pair = _pair(str(tmp_path), dirs, cfg=_configs(replication=1))
    sql = ("SELECT COUNT(*) FROM lineorder "
           "WHERE lo_orderdate BETWEEN 19950101 AND 19951231")

    def run(cluster, cfg, pkg):
        routed = cluster.broker.routing.route_query(TABLE, _compile(pkg, sql))
        res = cluster.query(sql)
        return sum(len(v) for v in routed.values()), res.rows, \
            res.stats["numSegmentsPruned"], res.stats["numSegmentsPrunedByTime"]
    out = _both(pair, run)
    assert out["ref"] == out["port"] == (1, [[500]], 1, 1)


def test_replica_group_selector_routes_one_replica_ordinal(tmp_path, seg_dirs):
    cfg = TableConfig("lineorder", replication=2, routing_selector="replicaGroup")
    pair = _pair(str(tmp_path), seg_dirs[1], servers=2,
                 cfg=(cfg, JaxTableConfig.from_json(cfg.to_json())))

    def run(cluster, c, pkg):
        plans = [cluster.broker.routing.route_query(TABLE) for _ in range(6)]
        assert all(len(p) == 1 and sum(map(len, p.values())) == SEGMENTS for p in plans)
        return [sorted(p) for p in plans], _count(cluster)
    out = _both(pair, run)
    assert out["ref"] == out["port"]


def test_group_selector_equal_candidate_sets_always_colocate():
    rt = RoutingTable("t")
    rt.segment_servers = {"a": ["s0", "s1"], "b": ["s0", "s1"], "c": ["s0", "s1"],
                          "d": ["s1", "s2"]}
    seen = set()
    for _ in range(7):
        by_seg = {seg: srv for srv, segs in rt.route(selector="strictReplicaGroup").items()
                  for seg in segs}
        assert by_seg["a"] == by_seg["b"] == by_seg["c"]
        seen.add(by_seg["a"])
    assert len(seen) > 1
    with pytest.raises(ValueError):
        rt.route(selector="bogus")


def test_unknown_routing_selector_rejected_at_create(tmp_path):
    cluster = QuickCluster(num_servers=1, work_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="routingSelector"):
        cluster.create_table(ssb_schema(), TableConfig("lineorder", routing_selector="strict"))


def test_retry_covers_single_flaky_replica(pair):
    def run(cluster, cfg, pkg):
        victim = sorted(cluster.catalog.segments[TABLE])[0]
        orig = cluster.broker._servers["server_0"]

        def handle(t, ctx, segments, tf=None):
            return orig(t, ctx, [s for s in segments if s != victim], tf)
        cluster.broker.register_server_handle("server_0", handle)
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        return res.rows, res.stats["partialResult"], "segmentsUnavailable" in res.stats
    out = _both(pair, run)
    assert out["ref"] == out["port"] == ([[ROWS]], False, False)


def test_uncovered_segments_surface_as_partial_result(pair):
    def run(cluster, cfg, pkg):
        victim = sorted(cluster.catalog.segments[TABLE])[0]
        for sid in list(cluster.broker._servers):
            orig = cluster.broker._servers[sid]

            def handle(t, ctx, segments, tf=None, _orig=orig):
                return _orig(t, ctx, [s for s in segments if s != victim], tf)
            cluster.broker.register_server_handle(sid, handle)
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        return res.rows, res.stats["partialResult"], res.stats["segmentsUnavailable"]
    out = _both(pair, run)
    assert out["ref"] == out["port"]
    assert out["port"] == ([[ROWS - ROWS // SEGMENTS]], True, [f"{TABLE}:lineorder_0"])


def test_strict_replica_group_never_retries_per_segment(pair):
    def run(cluster, cfg, pkg):
        cluster.catalog.table_configs[TABLE].routing_selector = "strictReplicaGroup"
        return cluster.broker._retry_missing(TABLE, None, {"seg_x": {"server_0"}}, None,
                                             lambda h, s: h)
    out = _both(pair, run)
    assert out["ref"] == out["port"] == ([], 0)


def test_all_replicas_down_surfaces_unavailable(pair):
    def run(cluster, cfg, pkg):
        for sid in list(cluster.broker._servers):
            cluster.broker.routing.mark_server_unhealthy(sid)
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        return res.rows, res.stats["partialResult"], len(res.stats["segmentsUnavailable"])
    out = _both(pair, run)
    assert out["ref"] == out["port"] == ([[0]], True, SEGMENTS)


def test_all_replicas_dead_segments_surface(pair):
    def run(cluster, cfg, pkg):
        for sid in ("server_0", "server_1", "server_2"):
            cluster.kill_server(sid)
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        return res.rows, res.stats["partialResult"], len(res.stats["segmentsUnavailable"])
    out = _both(pair, run)
    assert out["ref"] == out["port"] == ([[0]], True, SEGMENTS)


def test_backpressured_server_segments_retried(pair):
    def run(cluster, cfg, pkg):
        err = JaxQueryRejectedError if pkg == "ref" else QueryRejectedError

        def throttled(table, ctx, segments, time_filter=None):
            raise err("admission queue full")
        cluster.broker.register_server_handle("server_2", throttled)
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        return res.rows, "segmentsUnavailable" in res.stats, \
            "server_2" in cluster.broker.routing.unhealthy_servers()
    out = _both(pair, run)
    assert out["ref"] == out["port"] == ([[ROWS]], False, False)


def test_replica_local_error_fails_over(pair):
    def run(cluster, cfg, pkg):
        def corrupt(table, ctx, segments, time_filter=None):
            raise ValueError("segment file corrupt on this replica")
        cluster.broker.register_server_handle("server_0", corrupt)
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        return res.rows, "server_0" in cluster.broker.routing.unhealthy_servers()
    out = _both(pair, run)
    assert out["ref"] == out["port"] == ([[ROWS]], False)


def test_query_error_raises_and_keeps_servers_routable(pair):
    def run(cluster, cfg, pkg):
        with pytest.raises(Exception):
            cluster.query("SELECT COUNT(*) FROM lineorder "
                          "WHERE IN_ID_SET(lo_custkey, 'not-a-valid-idset')")
        res = cluster.query("SELECT COUNT(*) FROM lineorder")
        return cluster.broker.routing.unhealthy_servers(), res.rows, res.stats["partialResult"]
    out = _both(pair, run)
    assert out["ref"] == out["port"] == (set(), [[ROWS]], False)


def test_stream_query_replica_local_error_fails_over(pair):
    def run(cluster, cfg, pkg):
        def corrupt(table, ctx, segments, time_filter=None):
            raise ValueError("segment file corrupt on this replica")
        cluster.broker.register_server_handle("server_1", corrupt)
        rows = []
        for kind, payload in cluster.broker.stream_query(
                "SELECT lo_custkey FROM lineorder LIMIT 100000"):
            if kind == "rows":
                rows.extend(payload)
        return sorted(r[0] for r in rows)
    out = _both(pair, run)
    assert out["ref"] == out["port"] and len(out["port"]) == ROWS


def test_disabled_table_and_quota(pair):
    port, _ = pair["port"]
    port.controller.set_table_state(TABLE, False)
    with pytest.raises(ValueError, match="disabled"):
        port.query("SELECT COUNT(*) FROM lineorder")
    port.controller.set_table_state(TABLE, True)
    assert _count(port) == ROWS


def test_catalog_snapshot_carries_across_packages(pair):
    """A snapshot of the JAX package's catalog restores into this package's;
    its servers load every segment from the JAX package's deep store and its
    broker answers as the JAX package's does."""
    ref, _ = pair["ref"]
    catalog = Catalog()
    catalog.restore(ref.catalog.snapshot())
    assert catalog.ideal_state[TABLE] == ref.catalog.ideal_state[TABLE]
    assert catalog.table_configs[TABLE].replication == 2
    store = LocalDeepStore(ref.deepstore.root)
    servers = [ServerNode(f"server_{i}", catalog, store,
                          os.path.join(ref.work_dir, "torch_server", str(i)), device="cpu")
               for i in range(3)]
    broker = Broker("broker_torch", catalog)
    for s in servers:
        broker.register_server_handle(s.instance_id, s.execute_partial,
                                      explain_handle=s.explain_partial)
    for sql in (QUERY, GROUP_QUERY, "SELECT COUNT(*) FROM lineorder"):
        got, want = broker.handle_query(sql), ref.query(sql)
        assert _rows_equal(got.rows, want.rows), sql
        assert got.stats["numSegmentsQueried"] == want.stats["numSegmentsQueried"] == SEGMENTS
    assert ref.catalog.snapshot() is not None and catalog.snapshot()   # both directions load
    back = type(ref.catalog)()
    back.restore(catalog.snapshot())
    assert back.ideal_state[TABLE] == ref.catalog.ideal_state[TABLE]


# -- no fallback ----------------------------------------------------------------------

class _FaultyPipeline:
    """A serving pipeline whose every partial fails, as a device fault would."""

    def __init__(self, device="cpu"):
        import torch
        self.mesh_exec = type("M", (), {"device": torch.device(device)})()
        self.calls = 0

    def execute_partial(self, ctx, segments):
        self.calls += 1
        raise RuntimeError("device fault: launch failed")

    def stop(self):
        pass


def _faulty_cluster(root, dirs, faulty_ids):
    catalog = Catalog()
    from pinot_tpu_torch.cluster import Controller
    store = LocalDeepStore(os.path.join(root, "store"))
    ctl = Controller("controller_0", catalog, store, os.path.join(root, "ctl"))
    servers = {}
    for i in range(2):
        sid = f"server_{i}"
        servers[sid] = ServerNode(sid, catalog, store, os.path.join(root, sid),
                                  device_pipeline=_FaultyPipeline() if sid in faulty_ids
                                  else None, device="cpu")
    broker = Broker("broker_0", catalog)
    for s in servers.values():
        broker.register_server_handle(s.instance_id, s.execute_partial)
    ctl.add_schema(ssb_schema())
    ctl.add_table(TableConfig("lineorder", replication=2))
    for d in dirs:
        ctl.upload_segment(TABLE, d)
    return broker, servers


def test_a_pipeline_error_reaches_the_query(tmp_path, seg_dirs):
    broker, servers = _faulty_cluster(str(tmp_path), seg_dirs[1], {"server_0", "server_1"})
    with pytest.raises(RuntimeError, match="device fault"):
        broker.handle_query(QUERY)
    assert all(s.device_pipeline.calls for s in servers.values())


def test_a_pipeline_error_is_retried_on_a_healthy_replica_not_answered_on_the_host(
        tmp_path, seg_dirs, monkeypatch):
    broker, servers = _faulty_cluster(str(tmp_path), seg_dirs[1], {"server_0"})
    host_calls = []
    orig = servers["server_0"].executor.execute_segment
    monkeypatch.setattr(servers["server_0"].executor, "execute_segment",
                        lambda *a, **k: (host_calls.append(1), orig(*a, **k))[1])
    cols = seg_dirs[0]
    res = broker.handle_query(QUERY)
    m = ((cols["lo_orderdate"] >= 19930101) & (cols["lo_orderdate"] <= 19931231)
         & (cols["lo_discount"] >= 1) & (cols["lo_discount"] <= 3) & (cols["lo_quantity"] < 25))
    assert math.isclose(res.rows[0][0], float((cols["lo_extendedprice"][m]
                                               * cols["lo_discount"][m]).sum()),
                        rel_tol=REL, abs_tol=ABS)
    assert servers["server_0"].device_pipeline.calls == 1 and not host_calls
    # the failed server marks the answer partial, as the JAX package's broker
    # does, though the retry round covered every segment
    assert res.stats["numSegmentsRetried"] > 0 and "segmentsUnavailable" not in res.stats
    assert res.stats["numServersResponded"] < res.stats["numServersQueried"]


def test_roles_raise_without_cuda_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        QuickCluster(num_servers=1, work_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServerNode("s", Catalog(), LocalDeepStore(str(tmp_path / "ds")), str(tmp_path / "s"))


def test_unported_server_knobs_raise(tmp_path):
    catalog = Catalog()
    catalog.put_property("clusterConfig/server.index.bitmap.enabled", "false")
    with pytest.raises(NotImplementedError, match="server.index.bitmap.enabled"):
        ServerNode("s", catalog, LocalDeepStore(str(tmp_path / "ds")), str(tmp_path / "s"),
                   device="cpu")


def test_joins_and_realtime_raise_with_their_queue_item(tmp_path):
    """A join answers through QuickCluster's broker (the funnel path: leaf
    scans scattered to the servers, partitions joined on the broker's
    device), with any OPTION(numPartitions), as the JAX package's
    QuickCluster answers it (`tests/test_multistage.py::test_cluster_join_query`,
    `::test_num_partitions_query_option`); the minion still raises with its
    queue item. A realtime commit whose deep-store upload runs out of retries
    commits under the peer download scheme: `peer://` and quarantined, the
    committer's build serving, its successor consuming."""
    cluster = QuickCluster(num_servers=2, work_dir=str(tmp_path), device="cpu")
    jax = JaxQuickCluster(num_servers=2, work_dir=str(tmp_path / "jax"))
    dim_schema = Schema("dim", [dimension("k", DataType.INT),
                                dimension("label", DataType.STRING)])
    fact_schema = Schema("fact", [dimension("k", DataType.INT), metric("v", DataType.DOUBLE)])
    rng = np.random.default_rng(1)
    ks = rng.integers(0, 5, 200).astype(np.int32)
    vs = np.round(rng.uniform(0, 10, 200), 2)
    for qc, schema_of, config in ((cluster, lambda s: s, TableConfig),
                                  (jax, lambda s: JSchema.from_json(s.to_json()),
                                   JaxTableConfig)):
        qc.create_table(schema_of(dim_schema), config("dim"))
        qc.create_table(schema_of(fact_schema), config("fact"))
        qc.ingest_columns(config("dim"), {"k": np.arange(5, dtype=np.int32),
                                          "label": [f"L{i}" for i in range(5)]})
        qc.ingest_columns(config("fact"), {"k": ks[:100], "v": vs[:100]})
        qc.ingest_columns(config("fact"), {"k": ks[100:], "v": vs[100:]})
    sql = ("SELECT d.label, SUM(f.v), COUNT(*) FROM fact f JOIN dim d ON f.k = d.k "
           "GROUP BY d.label ORDER BY d.label LIMIT 100")
    for opt in ("", " OPTION(numPartitions=1)", " OPTION(numPartitions=3)",
                " OPTION(numPartitions=16)"):
        res = cluster.query(sql + opt)
        assert res.stats.get("multistage") is True and "mailboxShuffle" not in res.stats
        want = jax.query(sql + opt).rows
        assert [r[0] for r in res.rows] == [r[0] for r in want] == [f"L{i}" for i in range(5)]
        assert [r[2] for r in res.rows] == [r[2] for r in want]
        assert all(math.isclose(a[1], b[1], rel_tol=1e-9) for a, b in zip(res.rows, want)), opt
    cluster.create_table(ssb_schema(), TableConfig("lineorder"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cluster.run_minion_round()
    # a realtime commit whose deep-store upload runs out of retries takes
    # the peer download scheme
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.table import StreamConfig, TableType

    def failing_upload(local_path, uri):
        raise OSError("deep store down")
    cluster.deepstore.upload = failing_upload
    cluster.catalog.put_property("clusterConfig/deepstore.retry.max", 2)
    cluster.catalog.put_property("clusterConfig/deepstore.retry.backoff.ms", 0)
    MemoryStream.reset_all()
    cluster.create_realtime_table(ssb_schema(), TableConfig(
        "lineorder", table_type=TableType.REALTIME, stream=StreamConfig(
            topic="lineorder_peer", decoder="dict", flush_threshold_rows=4)), 1)
    row = {c: np.asarray(v)[:1].tolist()[0] for c, v in make_columns(1, SEED).items()}
    for _ in range(4):
        MemoryStream.get("lineorder_peer").produce(row, partition=0)
    cluster.pump_realtime("lineorder_REALTIME")
    metas = cluster.catalog.segments["lineorder_REALTIME"]
    done = [m for m in metas.values() if m.status == "DONE"]
    assert len(done) == 1 and done[0].download_path == \
        f"peer://lineorder_REALTIME/{done[0].name}"
    assert cluster.controller.llc.quarantined == {done[0].name: 2}
    assert [m.start_offset for m in metas.values() if m.status == "IN_PROGRESS"] == ["4"]
    server = next(s for s in cluster.servers if s.local_segment_dir("lineorder_REALTIME",
                                                                     done[0].name))
    assert server.realtime_manager("lineorder_REALTIME").handoffs[done[0].name] == "COMMIT"
    assert cluster.query("SELECT COUNT(*) FROM lineorder_REALTIME").rows == [[4]]


def test_the_smoke_cluster_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `cluster` phase at 160,000 rows with the card's calls
    pointed at the CPU: the roles wire, the table converges, every broker
    answer matches its oracle, every run's launches match its route, the e2e
    mix and the failover pass, and the per-segment servers launch once a
    segment."""
    import torch

    import chip_smoke
    from pinot_tpu_torch.engine import kernels, scan
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.segment import load_segment

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
    monkeypatch.setattr(chip_smoke, "SERVE_CLIENTS", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_QUERIES_PER_CLIENT", 3)
    monkeypatch.setattr(chip_smoke, "CLUSTER_RUNS", 1)
    rows = 160_000
    cols = make_columns(rows, SEED)
    table = [load_segment(p) for p in build_aligned_segments(
        ssb_schema(), cols, str(tmp_path / "main"), "lineorder", 8,
        SegmentGeneratorConfig(raw_cardinality_fraction=1.0))]
    for_table = [load_segment(p) for p in build_aligned_segments(
        ssb_schema(), {k: v[:40_000] for k, v in cols.items()}, str(tmp_path / "for"),
        "lineorder", 2, SegmentGeneratorConfig(no_dictionary_columns=["lo_quantity"]))]

    class Args:
        seed, trace = SEED, False
    launches = chip_smoke.run_cluster(Args(), table, cols, for_table, str(tmp_path))
    # per query: one launch a server (2 servers, each 4 segments) for each of
    # 1 + CLUSTER_RUNS runs; EXPLAIN ANALYZE's Q1.1; the mix's scans; the
    # failover's one; the per-segment Q1.1's 8 and the FOR sum's 2
    assert launches["masked_sums_fused"] == 2
    assert launches["masked_sums"] >= 2 * 2 + 2 * 2 + 2 + 1 + 8
    assert launches["grouped_agg"] == 2 * 2 + 2 * 2 + 1


def test_concurrent_uploads_converge(tmp_path, seg_dirs):
    """More uploads at once than cores, threads switching often: every
    segment ends loaded on both replicas and reported ONLINE; none is
    unloaded by a reconcile that began before its assignment, and no
    reconcile waits on another's load."""
    cluster = QuickCluster(num_servers=2, work_dir=str(tmp_path), device="cpu")
    cluster.create_table(ssb_schema(), TableConfig("lineorder", replication=2))
    copies = max(4, 2 * (os.cpu_count() or 1) // SEGMENTS)
    dirs = seg_dirs[1] * copies
    names = []
    for i, d in enumerate(dirs):   # distinct segments from the four directories
        out = tmp_path / "copies" / f"lineorder_{i}"
        shutil.copytree(d, out)
        meta = out / "metadata.json"
        m = json.loads(meta.read_text())
        m["segmentName"] = f"lineorder_{i}"
        meta.write_text(json.dumps(m))
        names.append(str(out))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            futures = [pool.submit(cluster.controller.upload_segment, TABLE, d)
                       for d in names]
            done, pending = concurrent.futures.wait(futures, timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not pending and all(f.result() for f in done)
    status = cluster.controller.table_status(TABLE)
    assert status["segments"] == len(names)
    assert status["converged"] and set(status["replicas_online"].values()) == {2}
    assert _count(cluster) == copies * ROWS


# -- the roles' other planes ------------------------------------------------------

def _port_cluster(tmp_path, dirs, servers=2, **cfg_kw):
    cluster = QuickCluster(num_servers=servers, work_dir=str(tmp_path), device="cpu")
    cluster.create_table(ssb_schema(), TableConfig("lineorder", replication=2, **cfg_kw))
    for d in dirs:
        cluster.controller.upload_segment(TABLE, d)
    return cluster


def test_a_server_scheduler_admits_and_its_rejection_is_backpressure(tmp_path, seg_dirs):
    """A server behind a QueryScheduler answers through it; one whose queue
    is full rejects, and the broker retries the segments on the replica
    without taking the server out of routing."""
    from pinot_tpu_torch.query.scheduler import QueryScheduler
    cluster = _port_cluster(tmp_path, seg_dirs[1])
    s0, s1 = cluster.servers
    s0.scheduler = QueryScheduler(max_concurrent=2, max_pending=8)
    assert _count(cluster) == ROWS and s0.scheduler.stats.completed == 1
    s1.scheduler = QueryScheduler(max_concurrent=1, max_pending=0)
    res = cluster.query("SELECT COUNT(*) FROM lineorder")
    assert res.rows == [[ROWS]] and res.stats["numSegmentsRetried"] > 0
    assert s1.scheduler.stats.rejected == 1
    assert "server_1" not in cluster.broker.routing.unhealthy_servers()
    for s in (s0, s1):
        s.scheduler.stop()


def test_admission_sheds_a_saturated_broker(tmp_path, seg_dirs):
    cluster = _port_cluster(tmp_path, seg_dirs[1])
    for key, value in (("enabled", "true"), ("queue.max", "0")):
        cluster.catalog.put_property(f"clusterConfig/broker.admission.{key}", value)
    with pytest.raises(QueryRejectedError, match="saturated"):
        cluster.query("SELECT COUNT(*) FROM lineorder")
    snap = cluster.broker.admission.snapshot()
    assert snap["sheds"] == 1 and snap["shedByReason"] == {"saturated": 1}
    cluster.catalog.put_property("clusterConfig/broker.admission.enabled", "false")
    assert _count(cluster) == ROWS


def test_a_straggler_is_hedged_to_the_other_replica(tmp_path, seg_dirs):
    """With `broker.hedge.enabled`, a dispatch that outlives the hedge delay
    is duplicated to a replica serving all its segments; the first answer
    wins and no stat counts the unit twice."""
    import time
    cluster = _port_cluster(tmp_path, seg_dirs[1])
    cluster.catalog.put_property("clusterConfig/broker.hedge.enabled", "true")
    cluster.catalog.put_property("clusterConfig/broker.hedge.delay.ms", "5")
    slow = cluster.broker._servers["server_0"]

    def straggler(*args):
        time.sleep(1.0)
        return slow(*args)
    cluster.broker.register_server_handle("server_0", straggler)
    t0 = time.perf_counter()
    res = cluster.query("SELECT COUNT(*) FROM lineorder")
    assert res.rows == [[ROWS]] and res.stats["hedgedRequests"] == 1
    assert res.stats["numSegmentsQueried"] == SEGMENTS and not res.stats["partialResult"]
    assert time.perf_counter() - t0 < 1.0


def test_the_failure_detector_probes_a_failed_server_back(tmp_path, seg_dirs):
    import time
    from pinot_tpu_torch.utils.events import get_journal
    cluster = _port_cluster(tmp_path, seg_dirs[1])
    healthy = cluster.broker._servers["server_1"]

    def broken(*args):
        raise ConnectionError("boom")
    cursor = get_journal().events_since()["cursor"]
    cluster.broker.register_server_handle("server_1", broken, probe=lambda: True)
    cluster.query("SELECT COUNT(*) FROM lineorder")
    assert "server_1" in cluster.broker.routing.unhealthy_servers()
    assert cluster.broker.failure_detector.snapshot()["server_1"]["state"] == "probing"
    cluster.broker._servers["server_1"] = healthy
    cluster.broker.failure_detector.tick(now=time.time() + 10)
    assert "server_1" not in cluster.broker.routing.unhealthy_servers()
    kinds = [e["kind"] for e in get_journal().events_since(cursor)["events"]
             if e["attrs"].get("server") == "server_1"]
    assert kinds == ["server.registered", "server.down", "server.up"]
    res = cluster.query("SELECT COUNT(*) FROM lineorder")
    assert res.rows == [[ROWS]] and res.stats["numServersQueried"] == 2


def test_trace_spans_and_the_slow_query_ring(tmp_path, seg_dirs):
    cluster = _port_cluster(tmp_path, seg_dirs[1])
    cluster.catalog.put_property("clusterConfig/broker.slow.query.ms", "0")
    res = cluster.query("SELECT COUNT(*) FROM lineorder OPTION(trace=true)")
    names = {s["name"] for s in res.stats["traceInfo"]}
    assert {"compile", "route", "reduce"} <= names
    assert {"server:server_0", "server:server_1"} & names
    debug = cluster.broker.debug_stats()
    assert debug["queryStats"]["numSlowQueries"] == 1 and debug["recentSlowQueries"]
    assert cluster.broker.trace_ring.get(res.stats["traceId"]) is not None
    assert debug["tableStats"]["lineorder"]["numQueries"] == 1


def test_controller_operations_match_the_reference(pair, tmp_path):
    """replace_segments behind lineage, the segment status check, tenants and
    re-tagging: both packages end in the same catalog state and answers."""
    cols = make_columns(3_000, SEED + 3)
    new_dir = SegmentBuilder(ssb_schema()).build(cols, str(tmp_path / "new"), "lineorder_r0")

    def run(cluster, cfg, pkg):
        old = sorted(cluster.catalog.segments[TABLE])[:2]
        names = cluster.controller.replace_segments(TABLE, old, [new_dir])
        status = cluster.controller.run_segment_status_check()
        cluster.controller.update_instance_tags("server_2", ["other"])
        return (names, sorted(cluster.catalog.ideal_state[TABLE]),
                cluster.catalog.get_property(f"lineage/{TABLE}"), status,
                cluster.controller.list_tenants(), _count(cluster))
    out = _both(pair, run)
    assert out["ref"] == out["port"]
    assert out["port"][5] == ROWS - 2 * (ROWS // SEGMENTS) + 3_000


def test_reload_after_update_table_adds_the_index(tmp_path, seg_dirs):
    from pinot_tpu_torch.table import IndexingConfig
    cluster = _port_cluster(tmp_path, seg_dirs[1])
    cfg = TableConfig("lineorder", replication=2,
                      indexing=IndexingConfig(inverted_index_columns=["lo_region"]))
    cluster.controller.update_table(cfg)
    for s in cluster.servers:
        for name in s.segments_served(TABLE):
            seg = s.tables[TABLE].get(name)
            assert "inverted" in seg.column("lo_region").index_types
    res = cluster.query(GROUP_QUERY)
    assert len(res.rows) == 5 and not res.stats["partialResult"]
