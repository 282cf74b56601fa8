"""pinot_tpu_torch's memory ledger and memory verdicts, held against the JAX package's.

* The ledger's arithmetic (register and release by filter, re-registration,
  table attribution, the snapshot, the transient peak, reconcile's drift,
  concurrent registration, the gauges and their stale series, the `staged`
  wrapper) as `tests/test_memory.py` pins the JAX package's, on this package's
  `MemoryLedger` over tensors.
* The controller's memory verdicts: the same polled snapshots fed to the JAX
  package's `Controller.run_memory_check` and to this package's give equal
  verdicts and equal `memory_status` bodies.
* End to end on the CPU: a query's staging lands in the ledger under its
  table; `release_block`, a segment's unload and a consuming segment's retire
  return the ledger exactly to its baseline; a stacked set block registers
  its share of each member and goes with a member's eviction; the predicted
  block bytes bound a fully staged block; the memory plane over HTTP, in
  process and on a `ProcessCluster` of OS processes.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from pinot_tpu.cluster import QuickCluster as JaxQuickCluster
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu.utils.memledger import reset_ledger as jax_reset_ledger
from pinot_tpu.utils.metrics import get_registry as jax_registry
from pinot_tpu_torch import QuickCluster
from pinot_tpu_torch.engine import datablock
from pinot_tpu_torch.engine.datablock import (block_for, has_block, predicted_block_bytes,
                                              release_block)
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.utils import memledger
from pinot_tpu_torch.utils.memledger import MemoryLedger, get_ledger, reset_ledger, staged
from pinot_tpu_torch.utils.metrics import get_registry
from pinot_tpu_torch.schema import Schema
from pinot_tpu_torch.segment.writer import SegmentBuilder, SegmentGeneratorConfig
from pinot_tpu_torch.table import TableConfig

from conftest import make_ssb_columns, wait_until

CPU = torch.device("cpu")


@pytest.fixture()
def ledger(monkeypatch):
    """A MemoryLedger with a 1,000-byte capacity (exact headroom) publishing
    into a freshly reset registry."""
    monkeypatch.setenv("PINOT_TPU_HBM_CAPACITY_BYTES", "1000")
    get_registry().reset()
    led = MemoryLedger()
    yield led
    get_registry().reset()


@pytest.fixture()
def fresh():
    """Both packages' process ledgers and registries reset around the test:
    a pinned capacity must not leak into another test."""
    reset_ledger()
    get_registry().reset()
    jax_reset_ledger()
    jax_registry().reset()
    yield get_ledger()
    reset_ledger()
    get_registry().reset()
    jax_reset_ledger()
    jax_registry().reset()


def _gauge_value(name, **labels):
    for key, v in get_registry().snapshot().items():
        if key == name:
            return v
        if key.startswith(name + "{") and all(f"{lk}={lv}" in key for lk, lv in labels.items()):
            return v
    return None


# -- the ledger's arithmetic ---------------------------------------------------

def test_register_release_and_filters(ledger):
    ledger.register("t1", "seg_a", "raw", "col_x", 100)
    ledger.register("t1", "seg_a", "dict", "col_x", 40)
    ledger.register("t1", "seg_b", "raw", "col_x", 60)
    ledger.register("t2", "seg_c", "raw", "col_y", 9)
    assert ledger.resident_bytes() == 209
    assert ledger.resident_bytes(table="t1") == 200
    assert ledger.resident_bytes(segment="seg_a") == 140
    assert ledger.resident_bytes(kind="raw") == 169
    assert ledger.resident_bytes(table="t1", kind="raw") == 160
    assert ledger.release(segment="seg_a") == 140
    assert ledger.resident_bytes() == 69
    assert ledger.release(table="t1") == 60
    assert ledger.resident_bytes() == 9
    assert ledger.release() == 9
    assert ledger.resident_bytes() == 0


def test_reregistration_replaces_not_accumulates(ledger):
    ledger.register("t1", "seg_a", "raw", "col_x", 100)
    ledger.register("t1", "seg_a", "raw", "col_x", 100)
    assert ledger.resident_bytes() == 100
    ledger.register("t1", "seg_a", "raw", "col_x", 250)
    assert ledger.resident_bytes() == 250
    assert ledger.release(segment="seg_a") == 250


def test_table_attribution_binding_and_llc_fallback(ledger):
    ledger.bind_segment("trips_OFFLINE", "trips_0")
    ledger.register(None, "trips_0", "raw", "fare", 10)
    assert ledger.resident_bytes(table="trips_OFFLINE") == 10
    ledger.register(None, "lineorder__0__3__20240101", "consuming", "rows", 7)
    assert ledger.resident_bytes(table="lineorder") == 7
    ledger.register(None, "orphan_seg", "raw", "c", 5)
    assert ledger.resident_bytes(table="-") == 5
    assert ledger.resident_bytes() == 22
    # a star-tree view's block belongs to its segment's table
    ledger.register(None, "trips_0!st", "ids", "c", 3)
    assert ledger.resident_bytes(table="trips_OFFLINE") == 13
    # releasing a segment drops its binding; an eviction keeps it
    ledger.release(segment="trips_0", keep_binding=True)
    ledger.register(None, "trips_0", "raw", "fare", 10)
    assert ledger.resident_bytes(table="trips_OFFLINE") == 13
    ledger.release(segment="trips_0")
    ledger.release(segment="trips_0!st")
    ledger.register(None, "trips_0", "raw", "fare", 10)
    assert ledger.resident_bytes(table="trips_OFFLINE") == 0
    assert ledger.resident_bytes(table="-") == 15


def test_snapshot_shape_and_headroom(ledger):
    ledger.register("t1", "seg_a", "raw", "col_x", 300)
    ledger.register("t1", "seg_b", "dict", "col_x", 100)
    ledger.register("t2", "seg_c", "raw", "col_y", 200)
    ledger.note_transient(50)
    snap = ledger.snapshot()
    assert snap["totalBytes"] == 600
    assert snap["entries"] == 3
    assert snap["capacityBytes"] == 1000
    assert snap["capacityEstimated"] is False
    assert snap["headroomPct"] == 40.0
    assert snap["transientPeakBytes"] == 50
    assert snap["watermarkBytes"] == 650
    ts, bytes_ = snap["watermarkHistory"][-1]
    assert bytes_ == 650 and ts > 0
    assert snap["kinds"] == {"raw": 500, "dict": 100}
    assert snap["tables"] == {"t1": 400, "t2": 200}
    top = snap["topSegments"]
    assert [e["segment"] for e in top] == ["seg_a", "seg_c", "seg_b"]
    assert top[0] == {"table": "t1", "segment": "seg_a", "bytes": 300}
    json.dumps(snap)


def test_note_transient_tracks_peak_only(ledger):
    ledger.note_transient(100)
    ledger.note_transient(40)
    ledger.note_transient(120)
    assert ledger.snapshot()["transientPeakBytes"] == 120
    assert _gauge_value("pinot_server_hbm_transient_peak_bytes") == 120


def test_reconcile_drift_math(ledger, monkeypatch):
    ledger.register("t1", "seg_a", "raw", "c", 800)
    monkeypatch.setattr(memledger, "live_device_bytes", lambda device=None: 1000)
    rec = ledger.reconcile(baseline_bytes=200)
    assert rec["ledgerBytes"] == 800 and rec["deviceBytes"] == 1000
    assert rec["driftBytes"] == 0 and rec["driftPct"] == 0.0
    monkeypatch.setattr(memledger, "live_device_bytes", lambda device=None: 1200)
    rec = ledger.reconcile(baseline_bytes=200)
    assert rec["driftBytes"] == 200
    assert rec["driftPct"] == pytest.approx(20.0)
    # off CUDA the allocator reports nothing: drift is None, not a fake zero
    monkeypatch.undo()
    rec = ledger.reconcile()
    assert rec["driftBytes"] is None and rec["driftPct"] is None


def test_capacity_comes_from_the_environment_else_the_cpu_estimate(monkeypatch):
    monkeypatch.delenv("PINOT_TPU_HBM_CAPACITY_BYTES", raising=False)
    assert memledger.device_capacity_bytes("cpu") == (16 << 30, True)
    led = MemoryLedger()
    led.bind_device("cpu")
    assert led.capacity_bytes() == (16 << 30, True)
    monkeypatch.setenv("PINOT_TPU_HBM_CAPACITY_BYTES", "4096")
    assert memledger.device_capacity_bytes("cpu") == (4096, False)
    # a pinned capacity survives binding a device
    led.set_capacity(777)
    led.bind_device("cpu")
    assert led.capacity_bytes() == (777, False)


def test_a_failed_cuda_probe_raises(monkeypatch):
    """No fallback to the estimate: a CUDA device whose probe fails raises."""
    monkeypatch.delenv("PINOT_TPU_HBM_CAPACITY_BYTES", raising=False)

    def broken(device=None):
        raise RuntimeError("CUDA driver initialization failed")
    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    with pytest.raises(RuntimeError):
        memledger.device_capacity_bytes("cuda")
    with pytest.raises(RuntimeError):
        MemoryLedger().bind_device("cuda")


def test_concurrent_registration_is_exact(ledger):
    threads_n, per_thread, nbytes = 8, 200, 10

    def work(tid):
        for i in range(per_thread):
            ledger.register("t", f"seg_{tid}", "raw", f"col_{i}", nbytes)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(threads_n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ledger.resident_bytes() == threads_n * per_thread * nbytes
    freed = sum(ledger.release(segment=f"seg_{t}") for t in range(threads_n))
    assert freed == threads_n * per_thread * nbytes
    assert ledger.resident_bytes() == 0


def test_gauges_flush_after_register_burst(ledger):
    ledger.register("t1", "seg_a", "raw", "c1", 100)
    ledger.register("t1", "seg_a", "dict", "c1", 40)
    assert ledger.resident_bytes() == 140
    ledger.flush()
    assert _gauge_value("pinot_server_hbm_resident_bytes", table="t1", kind="raw") == 100
    assert _gauge_value("pinot_server_hbm_resident_bytes", table="t1", kind="dict") == 40
    assert _gauge_value("pinot_server_hbm_resident_total_bytes") == 140
    assert _gauge_value("pinot_server_hbm_capacity_bytes") == 1000
    assert _gauge_value("pinot_server_hbm_headroom_pct") == 86.0


def test_stale_series_removed_on_release(ledger):
    ledger.register("t1", "seg_a", "raw", "c1", 100)
    ledger.flush()
    assert _gauge_value("pinot_server_hbm_resident_bytes", table="t1", kind="raw") == 100
    ledger.release(table="t1")
    assert _gauge_value("pinot_server_hbm_resident_bytes", table="t1", kind="raw") is None
    assert _gauge_value("pinot_server_hbm_resident_total_bytes") == 0


def test_staged_wrapper_registers_and_passes_through(fresh):
    t = torch.zeros(256, dtype=torch.float64)
    out = staged(t, "seg_w", "raw", name="col", table="tw")
    assert out is t
    assert get_ledger().resident_bytes(table="tw", kind="raw") == t.nbytes == 2048
    arr = np.zeros(16, dtype=np.int32)
    assert staged(arr, "seg_w", "ids", table="tw") is arr
    assert staged(object(), "seg_w", "dict", table="tw") is not None   # 0 bytes
    assert get_ledger().resident_bytes(table="tw") == 2048 + 64


# -- the controller's memory verdicts, held against the JAX package's ---------

@pytest.fixture()
def verdict_clusters(tmp_path, ssb_schema, fresh):
    """The JAX package's in-process cluster and this package's, each with the
    lineorder table and one server."""
    ref = JaxQuickCluster(num_servers=1, work_dir=str(tmp_path / "ref"))
    port = QuickCluster(num_servers=1, work_dir=str(tmp_path / "port"), device="cpu")
    jcfg = JaxTableConfig(ssb_schema.name, replication=1, time_column="lo_orderdate")
    ref.create_table(ssb_schema, jcfg)
    cfg = TableConfig.from_json(jcfg.to_json())
    port.create_table(Schema.from_json(ssb_schema.to_json()), cfg)
    return ref, port, cfg.table_name_with_type


def _poller(headroom, tables=None, total=None):
    snap = {"headroomPct": headroom, "tables": tables or {},
            "totalBytes": total if total is not None else sum((tables or {}).values())}
    return lambda: snap


def _raising_poller():
    def poll():
        raise ConnectionError("server down")
    return poll


def _check_both(clusters, pollers, table):
    """Feed the same pollers to both controllers: equal verdicts and equal
    memoryStatus bodies; returns the port's."""
    ref, port, _ = clusters
    ref.controller.memory_pollers = dict(pollers)
    port.controller.memory_pollers = dict(pollers)
    got, want = port.controller.run_memory_check(), ref.controller.run_memory_check()
    assert got == want
    st, jst = port.controller.memory_status(table), ref.controller.memory_status(table)
    assert st == jst
    return got, st


def _set_config(clusters, key, value):
    for c in clusters[:2]:
        c.catalog.put_property(f"clusterConfig/{key}", value)


def test_memory_verdict_matrix(verdict_clusters):
    table = verdict_clusters[2]
    got, st = _check_both(verdict_clusters, {"server_0": _poller(80.0, {table: 4096})}, table)
    assert got == {table: "HEALTHY"}
    assert st["memoryState"] == "HEALTHY" and st["reasons"] == []
    assert st["residentBytes"] == 4096 and st["servers"] == {"server_0": 4096}
    assert st["minServerHeadroomPct"] == 80.0
    got, st = _check_both(verdict_clusters, {"server_0": _poller(10.0, {table: 4096})}, table)
    assert got == {table: "DEGRADED"}
    assert any("server_0" in r and "20" in r for r in st["reasons"])
    got, st = _check_both(verdict_clusters, {"server_0": _poller(4.0, {table: 4096})}, table)
    assert got == {table: "UNHEALTHY"} and any("critically" in r for r in st["reasons"])
    _set_config(verdict_clusters, "controller.memory.headroom.pct", "1")
    got, _ = _check_both(verdict_clusters, {"server_0": _poller(0.0, {table: 4096})}, table)
    assert got == {table: "UNHEALTHY"}
    _set_config(verdict_clusters, "controller.memory.headroom.pct", "50")
    got, st = _check_both(verdict_clusters, {"server_0": _poller(40.0, {table: 4096})}, table)
    assert got == {table: "DEGRADED"} and st["headroomThresholdPct"] == 50.0


def test_memory_verdict_unreachable_servers(verdict_clusters):
    table = verdict_clusters[2]
    got, st = _check_both(verdict_clusters, {"server_0": _raising_poller()}, table)
    assert got == {table: "UNHEALTHY"}
    assert any("no server reported" in r for r in st["reasons"])
    assert st["unreachableServers"] == ["server_0"]
    got, st = _check_both(verdict_clusters, {"server_0": _poller(90.0, {table: 1024}),
                                             "server_1": _raising_poller()}, table)
    assert got == {table: "DEGRADED"} and st["residentBytes"] == 1024
    assert any("poll failed" in r for r in st["reasons"])
    got, st = _check_both(verdict_clusters, {"server_0": _poller(90.0, {table: 1024}),
                                             "server_1": _poller(70.0, {table: 512})}, table)
    assert got == {table: "HEALTHY"}
    assert st["residentBytes"] == 1536 and st["minServerHeadroomPct"] == 70.0


def test_memory_status_unknown_and_prejudgment(verdict_clusters):
    ref, port, table = verdict_clusters
    for ctl in (ref.controller, port.controller):
        st = ctl.memory_status(table)
        assert st["memoryState"] == "UNKNOWN"
    _check_both(verdict_clusters, {"server_0": _poller(80.0, {table: 10})}, table)
    assert port.controller.memory_status(table)["memoryState"] == "HEALTHY"
    assert port.controller.memory_status("lineorder")["memoryState"] == \
        ref.controller.memory_status("lineorder")["memoryState"]
    for ctl in (ref.controller, port.controller):
        with pytest.raises(ValueError):
            ctl.memory_status("no_such_table")


def test_memory_check_publishes_and_removes_gauges(verdict_clusters):
    table = verdict_clusters[2]
    _check_both(verdict_clusters, {"server_0": _poller(35.5, {table: 2048})}, table)
    assert _gauge_value("pinot_controller_hbm_headroom_pct", instance="server_0") == 35.5
    assert _gauge_value("pinot_controller_hbm_healthy", table=table) == 1
    assert _gauge_value("pinot_controller_hbm_resident_bytes", table=table) == 2048
    _check_both(verdict_clusters, {"server_1": _poller(60.0, {table: 2048})}, table)
    assert _gauge_value("pinot_controller_hbm_headroom_pct", instance="server_0") is None
    assert _gauge_value("pinot_controller_hbm_headroom_pct", instance="server_1") == 60.0


def test_a_verdict_change_is_journaled_once(verdict_clusters):
    from pinot_tpu_torch.utils.events import get_journal
    table = verdict_clusters[2]
    start = get_journal().events_since(0)["cursor"]
    for _ in range(2):
        _check_both(verdict_clusters, {"server_0": _poller(10.0, {table: 1})}, table)
    memory = [e for e in get_journal().events_since(start)["events"]
              if e["kind"] == "verdict.memory"]
    assert len(memory) == 1 and memory[0]["attrs"]["toState"] == "DEGRADED"


# -- the ledger end to end, in process -----------------------------------------

@pytest.fixture()
def lineorder_cluster(tmp_path, ssb_schema, fresh):
    rng = np.random.default_rng(11)
    cluster = QuickCluster(num_servers=1, work_dir=str(tmp_path), device="cpu")
    cfg = TableConfig(ssb_schema.name, replication=1, time_column="lo_orderdate")
    cluster.create_table(Schema.from_json(ssb_schema.to_json()), cfg)
    for _ in range(2):
        cluster.ingest_columns(cfg, make_ssb_columns(rng, 2000))
    return cluster, cfg


def test_query_staging_lands_in_ledger_and_verdict(lineorder_cluster):
    cluster, cfg = lineorder_cluster
    table = cfg.table_name_with_type
    ledger = get_ledger()
    before = ledger.resident_bytes(table=table)
    cluster.query("SELECT SUM(lo_extendedprice) FROM lineorder WHERE lo_discount < 5")
    assert ledger.resident_bytes(table=table) > before
    snap = cluster.servers[0].memory_snapshot()
    assert snap["instanceId"] == "server_0" and snap["tables"].get(table, 0) > 0
    assert snap["tiering"]["admissions"] == 2 and snap["capacityEstimated"] is True
    assert cluster.controller.run_memory_check()[table] == "HEALTHY"
    st = cluster.controller.memory_status(table)
    assert st["residentBytes"] >= snap["tables"][table]


def test_segment_unload_returns_ledger_to_baseline(lineorder_cluster):
    cluster, cfg = lineorder_cluster
    mgr = cluster.servers[0].tables[cfg.table_name_with_type]
    segments = mgr.acquire()
    seg = segments[0]
    try:
        ledger = get_ledger()
        release_block(seg)
        baseline = ledger.resident_bytes(segment=seg.name)
        staged_bytes = None
        for _ in range(5):
            blk = block_for(seg, CPU)
            blk.valid
            blk.ids("lo_region")
            blk.values("lo_quantity")
            blk.raw("lo_revenue")
            blk.for_form("lo_custkey")
            now = ledger.resident_bytes(segment=seg.name)
            assert now > baseline and now == blk.staged_bytes()
            staged_bytes = staged_bytes or now
            assert now == staged_bytes            # re-staging never grows it
            release_block(seg)
            assert ledger.resident_bytes(segment=seg.name) == baseline
            assert not has_block(seg)
        # unload while this test holds the segment: deferred to the last release
        block_for(seg, CPU).ids("lo_region")
        mgr.remove_segment(seg.name)
        assert ledger.resident_bytes(segment=seg.name) > baseline and has_block(seg)
    finally:
        mgr.release(segments)
    assert ledger.resident_bytes(segment=seg.name) == 0 and not has_block(seg)


def test_predicted_block_bytes_bound_a_fully_staged_block(lineorder_cluster):
    """Every lazy cache of the block built: its bytes stay within the
    metadata-only price, which prices this package's layout (narrowed raw
    columns, FOR deltas, bitmap words, 1-byte masks)."""
    cluster, cfg = lineorder_cluster
    mgr = cluster.servers[0].tables[cfg.table_name_with_type]
    seg = mgr.get(mgr.segment_names[0])
    blk = block_for(seg, CPU)
    blk.valid
    blk.valid_words
    for name in seg.column_names:
        reader = seg.column(name)
        blk.null_mask(name)
        if reader.has_dictionary:
            blk.ids(name)
            blk.bitmap_words(name)
            if reader.data_type.is_numeric:
                blk.dict_values(name)
        else:
            blk.raw(name)
            blk.for_form(name)
    staged_bytes = get_ledger().resident_bytes(segment=seg.name)
    assert staged_bytes == blk.staged_bytes()
    predicted = predicted_block_bytes(seg)
    assert staged_bytes <= predicted <= 2 * staged_bytes
    release_block(seg)


@pytest.mark.parametrize("sql", [
    "SELECT SUM(lo_extendedprice * lo_discount) FROM lineorder WHERE lo_discount BETWEEN 1 AND 3",
    "SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder WHERE lo_quantity < 25 "
    "GROUP BY lo_region",
    "SELECT DISTINCTCOUNT(lo_quantity) FROM lineorder WHERE lo_region = 'ASIA' "
    "OR lo_discount > 8",
])
def test_a_released_block_frees_its_tensors_without_a_collection(lineorder_cluster, sql):
    """What the ledger releases, the allocator gets back at once: no reference
    cycle of the query path (a recursive closure over the kernel inputs) may
    keep a released block's tensors alive until the next garbage collection."""
    import gc
    import weakref
    cluster, cfg = lineorder_cluster
    server = cluster.servers[0]
    mgr = server.tables[cfg.table_name_with_type]
    seg = mgr.get(mgr.segment_names[0])
    ctx = compile_query(sql, seg.schema)
    gc.collect()
    gc.disable()
    try:
        server.executor.execute_segment(ctx, seg)
        blk = seg.__dict__["_device_blocks"][datablock.device_key(CPU)]
        refs = [weakref.ref(t) for d in (blk._ids, blk._raw, blk._dict_vals, blk._bitmaps)
                for t in d.values() if t is not None]
        del blk
        assert refs
        release_block(seg)
        assert not [r for r in refs if r() is not None]
    finally:
        gc.enable()


def test_stacked_set_block_registers_each_member_and_goes_with_an_eviction(
        lineorder_cluster):
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    cluster, cfg = lineorder_cluster
    mgr = cluster.servers[0].tables[cfg.table_name_with_type]
    segs = [mgr.get(n) for n in mgr.segment_names]
    for s in segs:
        release_block(s)
    ledger = get_ledger()
    mx = MeshQueryExecutor(device="cpu")
    mx.execute(segs, "SELECT SUM(lo_revenue) FROM lineorder WHERE lo_quantity < 25")
    shares = [ledger.resident_bytes(segment=s.name) for s in segs]
    assert all(shares) and all(has_block(s) for s in segs)
    assert ledger.resident_bytes(table=cfg.table_name_with_type) == sum(shares)
    (block,) = [b for _, b in mx._set_blocks.values()]
    assert sum(shares) == sum(int(t.nbytes) for t in block._cache.values())
    release_block(segs[0])                  # one member evicted: the set goes
    assert ledger.resident_bytes() == 0 and not any(has_block(s) for s in segs)
    # a later query stacks it again; a superset of the members supersedes it
    mx.execute(segs[:1], "SELECT SUM(lo_revenue) FROM lineorder")
    mx.execute(segs, "SELECT SUM(lo_revenue) FROM lineorder")
    assert len(mx._set_blocks) == 1
    assert ledger.resident_bytes() == sum(int(t.nbytes) for _, b in mx._set_blocks.values()
                                          for t in b._cache.values())


def test_a_consumers_retire_returns_the_ledger_to_baseline(tmp_path, fresh):
    from pinot_tpu_torch import execute_query, ssb
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    schema, rows = ssb.ssb_schema(), ssb.make_columns(8192, 2)
    stream = MemoryStream.create("mem_retire", 1)
    for lo in range(0, 8192, 2048):
        stream.produce(encode_columnar_block(schema, {c: v[lo:lo + 2048]
                                                      for c, v in rows.items()}), partition=0)
    cfg = TableConfig("lineorder", stream=ssb_stream_config("mem_retire"))
    name = "lineorder__0__0__20261018T0000Z"
    consumer = RealtimePartitionConsumer(name, cfg, schema, 0, str(tmp_path), device="cpu")
    ledger = get_ledger()
    assert ledger.resident_bytes() == 0
    consumer.pump()
    staged_chunks = ledger.resident_bytes(segment=name, kind="consuming")
    assert staged_chunks > 0 and ledger.resident_bytes(table="lineorder") == staged_chunks
    execute_query([consumer.query_segment()], ssb.GROUP_QUERY, device="cpu")
    assert ledger.resident_bytes(segment=name) > staged_chunks   # the view's block
    assert ledger.resident_bytes(segment=name) == ledger.resident_bytes(kind="consuming")
    consumer.mutable.release_device()
    assert ledger.resident_bytes() == 0
    MemoryStream.reset_all()


def ssb_stream_config(topic):
    from pinot_tpu_torch.table import StreamConfig
    return StreamConfig(topic=topic, decoder="columnar",
                        properties={"realtime.ingest.device.staging": "true"})


# -- the memory plane over HTTP ----------------------------------------------

TRIPS = (["nyc", "sf", "nyc", "la"], [10.0, 20.0, 30.0, 7.5], [1, 2, 3, 4]), \
    (["sf", "la", "nyc"], [5.0, 7.0, 2.5], [5, 6, 7])


def _trips_segments(root):
    from pinot_tpu_torch.schema import DataType, FieldSpec
    schema = Schema("trips", [FieldSpec("city", DataType.STRING),
                              FieldSpec("fare", DataType.DOUBLE),
                              FieldSpec("n", DataType.INT)])
    builder = SegmentBuilder(schema, SegmentGeneratorConfig())
    dirs = [builder.build({"city": np.array(c, dtype=object),
                           "fare": np.array(f, dtype=np.float64),
                           "n": np.array(n, dtype=np.int32)},
                          os.path.join(root, f"b{i}"), f"trips_{i}")
            for i, (c, f, n) in enumerate(TRIPS)]
    return schema, dirs


def _check_plane(server_url, controller_memory_status, table, run_check):
    from pinot_tpu_torch.cluster.http_service import get_json
    snap = get_json(f"{server_url}/debug/memory")
    assert snap["instanceId"] == "server_0" and snap["totalBytes"] > 0
    assert snap["tables"].get(table, 0) > 0 and 0.0 <= snap["headroomPct"] <= 100.0
    assert snap["capacityBytes"] > 0 and snap["tiering"]["admissions"] >= 1
    verdicts = run_check()
    assert verdicts[table] == "HEALTHY"
    st = controller_memory_status(table)
    assert st["memoryState"] == "HEALTHY" and "server_0" in st["servers"]
    assert st["residentBytes"] >= snap["tables"][table]


def test_memory_plane_over_http(tmp_path, fresh):
    """Controller, server and broker services in this process over real
    sockets: the server's /debug/memory, the controller's poller over HTTP
    and its /tables/{t}/memoryStatus."""
    from pinot_tpu_torch.cluster.broker import Broker
    from pinot_tpu_torch.cluster.catalog import Catalog
    from pinot_tpu_torch.cluster.controller import Controller
    from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
    from pinot_tpu_torch.cluster.http_service import get_json
    from pinot_tpu_torch.cluster.process import BrokerClient, ControllerClient
    from pinot_tpu_torch.cluster.remote import ControllerDeepStore, RemoteCatalog
    from pinot_tpu_torch.cluster.server import ServerNode
    from pinot_tpu_torch.cluster.services import (BrokerService, ControllerService,
                                                  ServerService)
    schema, dirs = _trips_segments(str(tmp_path))
    controller = Controller("controller_0", Catalog(),
                            LocalDeepStore(str(tmp_path / "deepstore")), str(tmp_path / "ctrl"))
    csvc = ControllerService(controller)
    services, catalogs = [csvc], []
    node = None
    try:
        src = RemoteCatalog(csvc.url, poll_timeout_s=1.0)
        catalogs.append(src)
        node = ServerNode("server_0", src, ControllerDeepStore(csvc.url),
                          str(tmp_path / "server_0"), device="cpu")
        ssvc = ServerService(node)
        services.append(ssvc)
        brc = RemoteCatalog(csvc.url, poll_timeout_s=1.0)
        catalogs.append(brc)
        bsvc = BrokerService(Broker("broker_0", brc, device="cpu"))
        services.append(bsvc)
        c = ControllerClient(csvc.url)
        c.add_schema(schema)
        cfg = TableConfig("trips", replication=1)
        c.add_table(cfg)
        for d in dirs:
            c.upload_segment(cfg.table_name_with_type, d)
        table = cfg.table_name_with_type
        assert wait_until(lambda: len(node.segments_served(table)) == 2, timeout=15.0,
                          interval=0.05, swallow=())
        bc = BrokerClient(bsvc.url)
        assert wait_until(lambda: bc.query("SELECT COUNT(*) FROM trips")
                          ["resultTable"]["rows"][0][0] == 7, timeout=15.0, interval=0.1)
        assert bc.query("SELECT SUM(fare) FROM trips WHERE n > 1")["resultTable"]["rows"] \
            == [[72.0]]
        assert node._pressure_scheduler is not None    # the service started the sweep
        # no in-process poller registered: the controller reads the server's route
        _check_plane(ssvc.url, lambda t: get_json(f"{csvc.url}/tables/{t}/memoryStatus"),
                     table, controller.run_memory_check)
        assert c.run_memory_check() == {table: "HEALTHY"}
    finally:
        if node is not None:
            node.shutdown()
        for rc in catalogs:
            rc.close()
        for s in services:
            s.stop()


def test_memory_plane_on_a_process_cluster(tmp_path):
    """The same plane between OS processes: a server process's own ledger
    behind its /debug/memory, the controller process's poller and verdict."""
    from pinot_tpu_torch.cluster.process import ProcessCluster
    schema, dirs = _trips_segments(str(tmp_path))
    cfg = TableConfig("trips", replication=1)
    table = cfg.table_name_with_type
    with ProcessCluster(num_servers=1, device="cpu", work_dir=str(tmp_path / "proc"),
                        startup_timeout_s=90.0) as pc:
        pc.controller.add_schema(schema)
        pc.controller.add_table(cfg)
        for d in dirs:
            pc.controller.upload_segment(table, d)
        assert wait_until(lambda: pc.query("SELECT COUNT(*) FROM trips")
                          ["resultTable"]["rows"] == [[7]], timeout=30.0, interval=0.1)
        assert pc.query("SELECT SUM(fare) FROM trips WHERE n > 1")["resultTable"]["rows"] \
            == [[72.0]]
        _check_plane(pc.server_url("server_0"), pc.controller.memory_status, table,
                     pc.controller.run_memory_check)
