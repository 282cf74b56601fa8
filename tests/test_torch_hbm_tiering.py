"""pinot_tpu_torch's tiers held against the JAX package's: the admission gate,
pressure eviction, the host tier, the cold tier and the deferred release.

Segment directories are built once a test from a numpy seed and uploaded to
the JAX package's `QuickCluster` (JAX on the CPU) and to this package's
`QuickCluster(device="cpu")`, one server each. Each package's ledger capacity
is pinned as a multiple of that package's own `predicted_block_bytes`, as the
JAX package's tests pin it (its layout and this package's differ), and both
packages' ledgers and registries are reset around each test.

* Answers under a pinned capacity equal the JAX cluster's and numpy's
  (rel 1e-5, counts exactly), the hot tier's equal the host tier's, and the
  ledger stays at or under capacity after every query of a table four times
  the capacity, on the per-segment route and on the serving pipeline's.
* The gate rejects past its target (`segmentsServedHostTier`), reserves the
  blocks a query admitted, and the pressure sweep evicts only what no query
  holds; a segment unloaded under a running query keeps its block until the
  query releases it.
* The cold tier: demotion unloads, the next query loads the segment again,
  a spent deadline raises before the load, retention demotes instead of
  deleting; the controller's memoryStatus carries the tiering counters.
* No fallback: a device failure reaches the query, and the join's budget is
  the ledger's.
"""

import math
import os
import threading
import time

import numpy as np
import pytest

from pinot_tpu.cluster import QuickCluster as JaxQuickCluster
from pinot_tpu.engine.datablock import predicted_block_bytes as jax_predicted_block_bytes
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu.utils.memledger import get_ledger as jax_get_ledger
from pinot_tpu.utils.memledger import reset_ledger as jax_reset_ledger
from pinot_tpu.utils.metrics import get_registry as jax_registry
from pinot_tpu_torch import QuickCluster
from pinot_tpu_torch.cluster import DeviceQueryPipeline, ServerNode
from pinot_tpu_torch.cluster.catalog import COLD, Catalog
from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
from pinot_tpu_torch.engine.datablock import (block_for, has_block, predicted_block_bytes,
                                              release_block)
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.scheduler import QueryTimeoutError
from pinot_tpu_torch.schema import Schema
from pinot_tpu_torch.segment.writer import SegmentBuilder, SegmentGeneratorConfig
from pinot_tpu_torch.table import TableConfig
from pinot_tpu_torch.utils.memledger import get_ledger, reset_ledger
from pinot_tpu_torch.utils.metrics import get_registry

from conftest import make_ssb_columns

ROWS_PER_SEGMENT = 2000
REL = 1e-5
TABLE = "lineorder_OFFLINE"
SUITE = {
    "count": "SELECT COUNT(*) FROM lineorder",
    "sum": "SELECT SUM(lo_revenue) FROM lineorder",
    "region_count": ("SELECT lo_region, COUNT(*) FROM lineorder GROUP BY lo_region "
                     "ORDER BY lo_region LIMIT 10"),
    "discount_count": "SELECT COUNT(*) FROM lineorder WHERE lo_discount >= 5",
}


@pytest.fixture()
def fresh():
    """Both packages' ledgers and registries reset around the test: the
    capacities pinned here must not leak into other tests."""
    reset_ledger()
    get_registry().reset()
    jax_reset_ledger()
    jax_registry().reset()
    yield get_ledger()
    reset_ledger()
    get_registry().reset()
    jax_reset_ledger()
    jax_registry().reset()


def _counter_value(name, **labels):
    for key, v in get_registry().snapshot().items():
        if key == name:
            return v
        if key.startswith(name + "{") and all(f"{lk}={lv}" in key for lk, lv in labels.items()):
            return v
    return None


def _build(tmp_path, ssb_schema, num_segments, seed=11):
    """The segment directories and their columns (numpy seed), built by this
    package's writer (byte-compatible with the JAX package's)."""
    rng = np.random.default_rng(seed)
    schema = Schema.from_json(ssb_schema.to_json())
    builder = SegmentBuilder(schema, SegmentGeneratorConfig())
    cols, dirs = [], []
    for i in range(num_segments):
        c = make_ssb_columns(rng, ROWS_PER_SEGMENT)
        cols.append(c)
        dirs.append(builder.build(c, str(tmp_path / "build"), f"lineorder_{i}"))
    merged = {k: np.concatenate([np.asarray(c[k]) for c in cols]) for k in cols[0]}
    return schema, dirs, merged


def _port_cluster(root, schema, dirs, servers=None):
    cluster = QuickCluster(num_servers=0 if servers is not None else 1, work_dir=str(root),
                           device="cpu")
    for server in servers or ():
        server = server(cluster)
        cluster.servers.append(server)
        cluster.broker.register_server_handle(server.instance_id, server.execute_partial)
        cluster.controller.memory_pollers[server.instance_id] = server.memory_snapshot
    cfg = TableConfig("lineorder", replication=1, time_column="lo_orderdate")
    cluster.create_table(schema, cfg)
    for d in dirs:
        cluster.controller.upload_segment(TABLE, d)
    return cluster


def _ref_cluster(root, ssb_schema, dirs):
    cluster = JaxQuickCluster(num_servers=1, work_dir=str(root))
    cluster.create_table(ssb_schema, JaxTableConfig("lineorder", replication=1,
                                                    time_column="lo_orderdate"))
    for d in dirs:
        cluster.controller.upload_segment(TABLE, d)
    return cluster


def _names(cluster):
    return sorted(cluster.servers[0].tables[TABLE].segment_names)


def _oracle(cols, qid):
    if qid == "count":
        return [[len(cols["lo_revenue"])]]
    if qid == "sum":
        return [[float(cols["lo_revenue"].sum())]]
    if qid == "discount_count":
        return [[int((cols["lo_discount"] >= 5).sum())]]
    regions, counts = np.unique(np.asarray(cols["lo_region"], dtype=object),
                                return_counts=True)
    return [[r, int(n)] for r, n in zip(regions, counts)]


def _rows_equal(got, want) -> bool:
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                if not math.isclose(float(x), float(y), rel_tol=REL):
                    return False
            elif x != y:
                return False
    return True


def _pin(cluster, ledger, predict, blocks):
    """Pin a package's capacity at `blocks` of its own predicted block bytes."""
    mgr = cluster.servers[0].tables[TABLE]
    capacity = int(predict(mgr.get(_names(cluster)[0])) * blocks)
    ledger.set_capacity(capacity)
    return capacity


# -- deferred release: an unload never races a running query ------------------

def test_remove_segment_defers_block_drop_until_refcount_drains(tmp_path, ssb_schema, fresh):
    schema, dirs, _ = _build(tmp_path, ssb_schema, 1)
    cluster = _port_cluster(tmp_path / "port", schema, dirs)
    server = cluster.servers[0]
    mgr = server.tables[TABLE]
    name = _names(cluster)[0]
    ctx = compile_query("SELECT COUNT(*), SUM(lo_quantity) FROM lineorder WHERE lo_discount < 5",
                        schema)
    held = mgr.acquire([name])
    assert len(held) == 1 and mgr.refcount(name) == 1
    seg = held[0]
    blk = block_for(seg, server.executor.device)
    blk.valid
    blk.ids("lo_region")
    assert get_ledger().resident_bytes(segment=name) > 0
    want = server.executor.execute_segment(ctx, seg, None).scalar
    removed = threading.Event()
    answers = []

    def query_loop():
        for i in range(40):
            if i == 10:
                removed.wait(timeout=10.0)   # the unload lands mid-stream
            answers.append(server.executor.execute_segment(ctx, seg, None).scalar)

    t = threading.Thread(target=query_loop)
    t.start()
    mgr.remove_segment(name)
    removed.set()
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert name not in mgr.segment_names and mgr.acquire([name]) == []
    # the holder kept its block the whole time
    assert has_block(seg) and get_ledger().resident_bytes(segment=name) > 0
    assert answers == [want] * 40, "a query saw its block dropped"
    mgr.release(held)                # the refcount drains: the drop fires
    assert not has_block(seg) and get_ledger().resident_bytes(segment=name) == 0


# -- the admission gate and the host tier --------------------------------------

def test_admission_gate_rejects_past_target_and_host_tier_answers(tmp_path, ssb_schema, fresh):
    """A capacity of about one block out of three: the answers are whole and
    equal the JAX cluster's (pinned alike) and numpy's, the rejected segments
    answer on the host tier, and residency stays under capacity."""
    schema, dirs, cols = _build(tmp_path, ssb_schema, 3)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    ref = _ref_cluster(tmp_path / "ref", ssb_schema, dirs)
    capacity = _pin(port, get_ledger(), predicted_block_bytes, 1.5)
    _pin(ref, jax_get_ledger(), jax_predicted_block_bytes, 1.5)
    res = port.query(SUITE["count"])
    jres = ref.query(SUITE["count"])
    assert res.rows == jres.rows == _oracle(cols, "count")
    assert not res.stats["partialResult"]
    assert res.stats["segmentsServedHostTier"] >= 1
    assert jres.stats["segmentsServedHostTier"] >= 1
    assert get_ledger().snapshot()["totalBytes"] <= capacity
    tiering = port.servers[0].tiering.snapshot()
    assert tiering["rejections"] >= 1 and tiering["targetBytes"] == int(capacity * 0.9)
    assert _counter_value("pinot_server_hbm_admission_rejects", table=TABLE) >= 1
    res = port.query(SUITE["sum"])
    assert _rows_equal(res.rows, ref.query(SUITE["sum"]).rows)
    assert _rows_equal(res.rows, _oracle(cols, "sum"))
    assert get_ledger().snapshot()["totalBytes"] <= capacity


def test_admission_reservations_prevent_same_query_overcommit(tmp_path, ssb_schema, fresh):
    """A query admits all its segments before any block stages; without
    reservations the gate would admit all three against an empty ledger."""
    schema, dirs, cols = _build(tmp_path, ssb_schema, 3)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    capacity = _pin(port, get_ledger(), predicted_block_bytes, 1.5)
    res = port.query(SUITE["sum"])
    assert _rows_equal(res.rows, _oracle(cols, "sum"))
    assert get_ledger().snapshot()["totalBytes"] <= capacity
    mgr = port.servers[0].tables[TABLE]
    assert sum(1 for n in _names(port) if has_block(mgr.get(n))) <= 1, \
        "reservations failed: several blocks staged"


def test_pressure_sweep_evicts_cold_blocks_but_never_inflight(tmp_path, ssb_schema, fresh):
    schema, dirs, _ = _build(tmp_path, ssb_schema, 2)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    server = port.servers[0]
    mgr = server.tables[TABLE]
    names = _names(port)
    port.query(SUITE["sum"])           # the probed capacity: both stage
    assert all(has_block(mgr.get(n)) for n in names)
    resident = get_ledger().resident_bytes()
    assert resident > 0
    held = mgr.acquire([names[0]])     # a running query holds segment 0
    get_ledger().set_capacity(max(1, resident // 4))
    assert server.tiering.run_pressure_sweep() >= 1
    assert has_block(mgr.get(names[0])), "evicted a block under a running query"
    assert not has_block(mgr.get(names[1]))
    assert _counter_value("pinot_server_hbm_evictions") >= 1
    mgr.release(held)
    assert server.tiering.run_pressure_sweep() >= 1
    assert not has_block(mgr.get(names[0]))
    assert get_ledger().resident_bytes() <= server.tiering.target_bytes()


HOT_HOST_SUITE = [
    "SELECT COUNT(*) FROM lineorder",
    "SELECT SUM(lo_revenue), MIN(lo_quantity), MAX(lo_discount) FROM lineorder",
    "SELECT lo_region, SUM(lo_revenue) FROM lineorder GROUP BY lo_region ORDER BY lo_region "
    "LIMIT 20",
    "SELECT COUNT(*) FROM lineorder WHERE lo_quantity > 25",
    "SELECT lo_category, COUNT(*) FROM lineorder WHERE lo_region = 'ASIA' "
    "GROUP BY lo_category ORDER BY lo_category LIMIT 20",
    "SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
    "ORDER BY lo_revenue DESC LIMIT 5",
]


def test_hot_and_host_tier_answers_are_identical(tmp_path, ssb_schema, fresh):
    """The same queries over the same data answer alike with every segment
    on the device and with the gate sending most of them to the host, and
    alike with the JAX cluster pinned the same way."""
    schema, dirs, _ = _build(tmp_path, ssb_schema, 3, seed=23)

    def run(root, capacity_blocks):
        reset_ledger()
        jax_reset_ledger()
        port = _port_cluster(root / "port", schema, dirs)
        ref = _ref_cluster(root / "ref", ssb_schema, dirs)
        _pin(port, get_ledger(), predicted_block_bytes, capacity_blocks)
        _pin(ref, jax_get_ledger(), jax_predicted_block_bytes, capacity_blocks)
        rows, host_served = [], 0
        for _ in range(2):             # two passes: eviction and promotion churn
            for sql in HOT_HOST_SUITE:
                res = port.query(sql)
                assert not res.stats["partialResult"]
                assert _rows_equal(res.rows, ref.query(sql).rows), sql
                rows.append(res.rows)
                host_served += res.stats["segmentsServedHostTier"]
        return rows, host_served

    hot_rows, hot_host = run(tmp_path / "hot", 100.0)
    tiered_rows, tiered_host = run(tmp_path / "tiered", 1.5)
    assert hot_host == 0
    assert tiered_host > 0, "the pinned run never reached the host tier"
    assert len(hot_rows) == len(tiered_rows)
    for hot, tiered in zip(hot_rows, tiered_rows):
        assert _rows_equal(tiered, hot)


def _piped_server(root):
    def make(cluster):
        return ServerNode("server_0", cluster.catalog, cluster.deepstore,
                          os.path.join(str(root), "server_0"), device="cpu",
                          device_pipeline=DeviceQueryPipeline(MeshQueryExecutor("cpu")))
    return make


@pytest.mark.parametrize("route", ["per_segment", "pipeline"])
def test_4x_capacity_table_serves_full_suite_without_oom(tmp_path, ssb_schema, fresh, route):
    """A table four times the pinned capacity serves the suite twice with the
    ledger at or under capacity after every query, on the per-segment route
    and on the pipeline's (whose stacked set block registers each member's
    share); every answer equals the JAX cluster's (pinned alike) and numpy's."""
    schema, dirs, cols = _build(tmp_path, ssb_schema, 5)
    port = _port_cluster(tmp_path / "port", schema, dirs,
                         servers=[_piped_server(tmp_path / "port")]
                         if route == "pipeline" else None)
    ref = _ref_cluster(tmp_path / "ref", ssb_schema, dirs)
    capacity = _pin(port, get_ledger(), predicted_block_bytes, 1.25)
    _pin(ref, jax_get_ledger(), jax_predicted_block_bytes, 1.25)
    try:
        for _ in range(2):
            for qid, sql in SUITE.items():
                res = port.query(sql)
                assert not res.stats["partialResult"], sql
                assert _rows_equal(res.rows, _oracle(cols, qid)), (qid, res.rows)
                assert _rows_equal(res.rows, ref.query(sql).rows), qid
                total = get_ledger().snapshot()["totalBytes"]
                assert total <= capacity, f"resident {total} > capacity {capacity}: {sql}"
        snap = get_ledger().snapshot()
        assert snap["watermarkBytes"] <= capacity + snap["transientPeakBytes"]
        for _, footprint in snap["watermarkHistory"]:
            assert footprint <= capacity + snap["transientPeakBytes"]
        tiering = port.servers[0].tiering.snapshot()
        assert tiering["rejections"] + tiering["evictions"] > 0
        assert snap["tables"] == {TABLE: snap["totalBytes"]}
    finally:
        port.shutdown()


def test_one_segment_name_in_two_tables_is_accounted_apart(tmp_path, ssb_schema, fresh):
    """Segment names are unique only within a table: two tables whose
    segments share names keep apart in the ledger (each its own bytes) and
    in the gate (evicting one leaves the other resident)."""
    schema, dirs, cols = _build(tmp_path, ssb_schema, 2)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    twin = Schema("twin", list(schema.fields))
    port.create_table(twin, TableConfig("twin"))
    for d in dirs:
        port.controller.upload_segment("twin_OFFLINE", d)
    server = port.servers[0]
    res = port.query(SUITE["sum"])
    twin_res = port.query(SUITE["sum"].replace("lineorder", "twin"))
    assert _rows_equal(res.rows, twin_res.rows) and _rows_equal(res.rows, _oracle(cols, "sum"))
    ledger = get_ledger()
    name = _names(port)[0]
    mine = ledger.resident_bytes(table=TABLE, segment=name)
    theirs = ledger.resident_bytes(table="twin_OFFLINE", segment=name)
    assert mine == theirs > 0 and ledger.resident_bytes(segment=name) == 2 * mine
    assert ledger.snapshot()["tables"] == {TABLE: ledger.resident_bytes() // 2,
                                           "twin_OFFLINE": ledger.resident_bytes() // 2}
    # pressure to one table's worth: the twin's blocks (touched last) stay
    ledger.set_capacity(int(ledger.resident_bytes() / 2 / 0.9) + 2)
    assert server.tiering.run_pressure_sweep() == 2
    assert ledger.resident_bytes(table=TABLE) == 0
    assert ledger.resident_bytes(table="twin_OFFLINE", segment=name) == theirs
    assert server.tiering.snapshot()["admittedSegments"] == 2


# -- the capacity knob --------------------------------------------------------

def test_capacity_knob_overrides_probe_on_server_start(tmp_path, fresh):
    catalog = Catalog()
    catalog.put_property("clusterConfig/server.hbm.capacity.bytes", "123456")
    server = ServerNode("server_knob", catalog, LocalDeepStore(str(tmp_path / "ds")),
                        str(tmp_path / "data"), device="cpu")
    try:
        assert get_ledger().capacity_bytes() == (123456, False)
        assert get_ledger().snapshot()["capacityBytes"] == 123456
    finally:
        server.shutdown()


def test_malformed_capacity_knob_keeps_probed_value(tmp_path, fresh):
    before = get_ledger().capacity_bytes()
    catalog = Catalog()
    catalog.put_property("clusterConfig/server.hbm.capacity.bytes", "not-a-number")
    server = ServerNode("server_knob2", catalog, LocalDeepStore(str(tmp_path / "ds")),
                        str(tmp_path / "data"), device="cpu")
    try:
        assert get_ledger().capacity_bytes() == before == (16 << 30, True)
    finally:
        server.shutdown()


# -- the cold tier ------------------------------------------------------------

def test_cold_demotion_unloads_and_first_query_lazily_reloads(tmp_path, ssb_schema, fresh):
    schema, dirs, cols = _build(tmp_path, ssb_schema, 2)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    ref = _ref_cluster(tmp_path / "ref", ssb_schema, dirs)
    server = port.servers[0]
    mgr = server.tables[TABLE]
    name = _names(port)[0]
    assert port.query(SUITE["count"]).rows == [[2 * ROWS_PER_SEGMENT]]
    for c in (port, ref):
        assert c.controller.demote_segment_to_cold(TABLE, name)
    assert port.catalog.external_view[TABLE][name] == {"server_0": COLD}
    assert name not in mgr.segment_names and server.local_segment_dir(TABLE, name) is None
    assert get_ledger().resident_bytes(segment=name) == 0
    assert _counter_value("pinot_controller_cold_demotions", table=TABLE) == 1
    assert not port.controller.demote_segment_to_cold(TABLE, name)   # already cold
    res, jres = port.query(SUITE["sum"]), ref.query(SUITE["sum"])
    assert _rows_equal(res.rows, jres.rows) and _rows_equal(res.rows, _oracle(cols, "sum"))
    assert not res.stats["partialResult"]
    assert res.stats["segmentsColdLoaded"] == jres.stats["segmentsColdLoaded"] == 1
    assert res.stats["coldLoadMs"] > 0
    assert server.tiering.snapshot()["coldLoads"] == 1
    assert _counter_value("pinot_server_hbm_cold_loads") == 1
    # the loaded copy stays: eviction is the tiering's call, not reconcile's
    server.reconcile(TABLE)
    assert name in mgr.segment_names
    res = port.query(SUITE["count"])
    assert res.stats["segmentsColdLoaded"] == 0 and res.rows == [[2 * ROWS_PER_SEGMENT]]
    assert server.tiering.snapshot()["coldLoads"] == 1


def test_cold_load_past_deadline_fails_typed(tmp_path, ssb_schema, fresh):
    """A spent budget raises QueryTimeoutError naming the cold-tier load it
    refused, before any download, and leaves nothing half loaded."""
    schema, dirs, _ = _build(tmp_path, ssb_schema, 1)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    server = port.servers[0]
    name = _names(port)[0]
    assert port.controller.demote_segment_to_cold(TABLE, name)
    assert name not in server.tables[TABLE].segment_names
    ctx = compile_query("SELECT COUNT(*) FROM lineorder", schema)
    ctx.options["deadlineEpochMs"] = time.time() * 1000 - 1000
    with pytest.raises(QueryTimeoutError) as exc:
        server._execute_partial(TABLE, ctx, [name])
    assert "cold-tier load" in str(exc.value)
    assert name not in server.tables[TABLE].segment_names
    assert server.tables[TABLE].refcount(name) == 0


def test_retention_demotes_to_cold_instead_of_deleting(tmp_path, ssb_schema, fresh):
    schema, dirs, cols = _build(tmp_path, ssb_schema, 2)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    ref = _ref_cluster(tmp_path / "ref", ssb_schema, dirs)
    names = _names(port)
    for c in (port, ref):
        cfg = c.catalog.table_configs[TABLE]
        cfg.retention_days = 1.0
        c.catalog.put_table_config(cfg)
        c.catalog.put_property("clusterConfig/controller.retention.cold.demote", "true")
    metas = port.catalog.segments[TABLE]
    future = max(m.end_time_ms for m in metas.values()) + 2 * 24 * 3600 * 1000
    acted = port.controller.run_retention(now_ms=future)
    assert sorted(acted) == sorted(ref.controller.run_retention(now_ms=future)) \
        == sorted(f"cold:{TABLE}/{n}" for n in names)
    assert set(port.catalog.segments[TABLE]) == set(names)   # demoted, not deleted
    res = port.query(SUITE["region_count"])
    assert res.rows == ref.query(SUITE["region_count"]).rows == _oracle(cols, "region_count")
    assert res.stats["segmentsColdLoaded"] == 2
    assert port.controller.run_retention(now_ms=future) == []


def test_memory_status_carries_tiering_rollup(tmp_path, ssb_schema, fresh):
    schema, dirs, _ = _build(tmp_path, ssb_schema, 3)
    port = _port_cluster(tmp_path / "port", schema, dirs)
    ref = _ref_cluster(tmp_path / "ref", ssb_schema, dirs)
    _pin(port, get_ledger(), predicted_block_bytes, 1.5)
    _pin(ref, jax_get_ledger(), jax_predicted_block_bytes, 1.5)
    for c in (port, ref):
        c.query(SUITE["sum"])
    verdicts = port.controller.run_memory_check()
    assert set(verdicts) == set(ref.controller.run_memory_check()) == {TABLE}
    tiering = port.controller.memory_status(TABLE)["tiering"]
    want = ref.controller.memory_status(TABLE)["tiering"]
    assert set(tiering) == set(want)
    assert tiering["admissions"] >= 1 and tiering["rejections"] >= 1


# -- no fallback ----------------------------------------------------------------

class _FaultyPipeline:
    """A serving pipeline whose every partial fails, as a device fault would."""

    def __init__(self):
        import torch
        self.mesh_exec = type("M", (), {"device": torch.device("cpu")})()
        self.calls = 0

    def execute_partial(self, ctx, segments):
        self.calls += 1
        raise RuntimeError("device fault: out of memory")

    def stop(self):
        pass


def test_a_device_failure_propagates_instead_of_answering_on_the_host(tmp_path, ssb_schema,
                                                                      fresh):
    """The host tier is the gate's decision only: an admitted segment whose
    device route raises fails the partial, and the host-tier executor never
    runs."""
    schema, dirs, _ = _build(tmp_path, ssb_schema, 2)
    pipeline = _FaultyPipeline()

    def make(cluster):
        return ServerNode("server_0", cluster.catalog, cluster.deepstore,
                          os.path.join(str(tmp_path / "port"), "server_0"), device="cpu",
                          device_pipeline=pipeline)
    port = _port_cluster(tmp_path / "port", schema, dirs, servers=[make])
    server = port.servers[0]
    host_calls = []
    orig = server.host_executor.execute_segment
    server.host_executor.execute_segment = \
        lambda *a, **k: (host_calls.append(1), orig(*a, **k))[1]
    ctx = compile_query(SUITE["sum"], schema)
    with pytest.raises(RuntimeError, match="device fault"):
        server._execute_partial(TABLE, ctx, None)
    assert pipeline.calls == 1 and not host_calls
    assert all(server.tables[TABLE].refcount(n) == 0 for n in _names(port))


def test_the_join_budget_is_the_ledgers(fresh):
    from pinot_tpu_torch.cluster.tiering import join_device_budget_bytes
    get_ledger().set_capacity(10_000)
    get_ledger().register("t", "s", "raw", "c", 1_000)
    assert join_device_budget_bytes() == 9_000 - 1_000
    get_ledger().register("t", "s", "raw", "d", 9_000)
    assert join_device_budget_bytes() == 0


# -- the smoke's memory phase, rehearsed -----------------------------------------

def test_the_smoke_memory_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, fresh):
    """chip_smoke.py's `memory` phase at 160,000 rows with the card's calls
    pointed at the CPU (the kernels' calls counted as launches): both routes
    of the capped server answer on the oracles within the capacity with the
    launches exact, the lifted run admits every segment, retention demotes
    one segment that the next query loads, and the unload leaves a ledger
    of 0."""
    import torch

    import chip_smoke
    from pinot_tpu_torch import load_segment, ssb
    from pinot_tpu_torch.engine import kernels, scan
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.segment.writer import build_aligned_segments

    cpu = torch.device("cpu")
    for module in (executor, combine):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: cpu)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setenv("PINOT_TPU_HBM_CAPACITY_BYTES", str(1 << 34))
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
    monkeypatch.setattr(chip_smoke, "log", lambda phase, **fields: None)

    rows = 160_000
    cols = ssb.make_columns(rows, 31)
    table = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), cols, str(tmp_path / "main"), "lineorder", 8)]
    for_cols = {k: v[:rows // 4] for k, v in cols.items()}
    for_table = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), for_cols, str(tmp_path / "for"), "lineorder", 2,
        SegmentGeneratorConfig(no_dictionary_columns=["lo_quantity"]))]
    # phase 17's state: a cluster of two servers that held both tables
    root = str(tmp_path / "cluster")
    qc = QuickCluster(num_servers=2, work_dir=root, device="cpu")
    qc.create_table(ssb.ssb_schema(), TableConfig("lineorder", replication=2))
    qc.create_table(Schema("lineorder_for", list(ssb.ssb_schema().fields)),
                    TableConfig("lineorder_for"))
    for segs, name in ((table, TABLE), (for_table, "lineorder_for_OFFLINE")):
        for s in segs:
            qc.controller.upload_segment(name, s.path)
    monkeypatch.setitem(chip_smoke.CLUSTER_STATE, "root", root)
    monkeypatch.setitem(chip_smoke.CLUSTER_STATE, "snapshot", qc.catalog.snapshot())
    qc.shutdown()

    class Args:
        seed, trace = 31, False
    launches, numbers = chip_smoke.run_memory(Args(), table, cols, for_table)
    assert all(launches[k] for k in ("masked_sums", "masked_sums_fused", "grouped_agg"))
    for route in ("per_segment", "pipeline"):
        n = numbers[route]
        assert n["rejections"] + n["evictions"] > 0 and n["segments_served_host_tier"] > 0
        assert n["ledger_watermark_bytes"] <= n["capacity_bytes"] \
            + get_ledger().snapshot()["transientPeakBytes"]
    assert numbers["lifted"]["capacity_estimated"] is False
    assert numbers["cold"]["cold_loads"] == 1 and numbers["unload"]["ledger_bytes"] == 0
