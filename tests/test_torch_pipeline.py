"""pinot_tpu_torch's DeviceQueryPipeline: scheduling with a fake executor, then
the real set executor on the CPU against the JAX package.

The fake (ported from tests/test_device_pipeline.py) records every call, so
the scheduling contract shows without racing on real kernel times:
concurrent submissions coalesce into one fetch, a cancelled item is never
dispatched or fetched, N same-shape queries launch as one stacked group,
identical queries share one pass, and a shape the executor does not run
raises through the caller's future (the port has no host path to fall back
to). The last tests serve four concurrent SSB queries through the real
`MeshQueryExecutor(device="cpu")`: they must batch (meanBatch > 1) and each
partial, merged and reduced, must match the JAX package's answer.
"""

import math
import threading
import time
from types import SimpleNamespace

import pytest

from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.writer import build_aligned_segments as jax_build
from pinot_tpu_torch.cluster import DeviceQueryPipeline, device_server
from pinot_tpu_torch.cluster.device_server import _Item
from pinot_tpu_torch.engine import scan
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.ssb import make_columns, ssb_schema

REL, ABS = 1e-5, 0.05


class FakePrepared:
    """Duck-typed PreparedDispatch: only the fields the pipeline reads."""

    def __init__(self, shape, literal):
        self.kind = "agg"
        self.route = None
        self.stackable = True
        self.stack_key = ("shape", shape)
        self.dedupe_key = ("shape", shape, literal)
        self.decode = lambda outs: SimpleNamespace(answer=("res", shape, literal, outs),
                                                   stats={})


class FakeMeshExec:
    """Prepared-API fake: ctx is a dict {shape, literal, unported?}."""

    def __init__(self, fetch_latency: float = 0.0):
        self.fetch_latency = fetch_latency
        self.prepared = []        # ctxs that reached prepare_partial
        self.launched_keys = []   # one stack_key per launch group
        self.fetch_calls = []     # number of launches per fetch() call
        self.fetch_started = threading.Event()

    def prepare_partial(self, ctx, segments):
        self.prepared.append(ctx)
        if ctx.get("unported"):
            raise NotImplementedError("unported shape")
        return FakePrepared(ctx["shape"], ctx["literal"])

    def dispatch_prepared(self, reps):
        groups = {}
        for i, p in enumerate(reps):
            groups.setdefault(p.stack_key if p.stackable else ("solo", i), []).append(i)
        launches = []
        for key, idxs in groups.items():
            self.launched_keys.append(key)
            packed = {"launch": len(self.launched_keys), "n": len(idxs)}
            launches.append((packed, lambda host, n=len(idxs): [host] * n, idxs))
        return launches

    def fetch(self, trees):
        self.fetch_started.set()
        if self.fetch_latency:
            time.sleep(self.fetch_latency)
        self.fetch_calls.append(len(trees))
        return trees


def _submit_concurrently(pipeline, ctxs):
    """Queue every ctx from its own thread against a pipeline not yet started,
    wait until all are queued, then start: one deterministic drain. Returns
    each caller's answer, or the exception it raised."""
    results = [None] * len(ctxs)

    def run(i):
        try:
            results[i] = pipeline.execute_partial(ctxs[i], []).answer
        except Exception as e:   # the test inspects what the caller saw
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(ctxs))]
    for t in threads:
        t.start()
    deadline = time.time() + 5
    while pipeline._q.qsize() < len(ctxs) and time.time() < deadline:
        time.sleep(0.005)
    assert pipeline._q.qsize() == len(ctxs)
    pipeline.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    return results


def _coalesce(fake, pipeline):
    results = _submit_concurrently(pipeline, [{"shape": "A", "literal": i} for i in range(6)])
    assert results == [("res", "A", i, {"launch": 1, "n": 6}) for i in range(6)]
    # six queries, one drain, one fetch for the whole batch
    assert fake.fetch_calls == [1]
    assert pipeline.batches == 1
    assert pipeline.stats()["meanBatch"] == 6.0


def _cancelled(fake, pipeline):
    stale = _Item({"shape": "A", "literal": 0}, [])
    stale.future.cancel()  # the caller timed out while still queued
    live = _Item({"shape": "A", "literal": 1}, [])
    pipeline._q.put(stale)
    pipeline._q.put(live)
    pipeline.start()
    assert live.future.result(timeout=10).answer[:3] == ("res", "A", 1)
    # the cancelled item never reached the executor, nor the fetch
    assert fake.prepared == [{"shape": "A", "literal": 1}]
    assert pipeline.dispatched == 1
    assert fake.fetch_calls == [1]


def _stacked(fake, pipeline):
    results = _submit_concurrently(
        pipeline, [{"shape": "A", "literal": i} for i in range(5)]
        + [{"shape": "B", "literal": 99}])
    assert [r[:3] for r in results] == ([("res", "A", i) for i in range(5)]
                                        + [("res", "B", 99)])
    # 6 queries -> 2 launch groups: A stacked (5 passes), B alone
    assert fake.launched_keys == [("shape", "A"), ("shape", "B")]
    s = pipeline.stats()
    assert (s["dispatched"], s["launches"], s["stackedLaunches"]) == (6, 2, 1)


def _dedupe(fake, pipeline):
    results = _submit_concurrently(pipeline, [{"shape": "A", "literal": 0},
                                              {"shape": "A", "literal": 1},
                                              {"shape": "A", "literal": 0}])
    # the duplicate decoded from the same pass as the original
    assert results[2] == results[0]
    s = pipeline.stats()
    assert (s["dispatched"], s["dedupeHits"], s["launches"]) == (3, 1, 1)


def _unported(fake, pipeline):
    results = _submit_concurrently(pipeline, [{"shape": "A", "literal": 1},
                                              {"shape": "A", "literal": 2, "unported": True}])
    assert results[0][:3] == ("res", "A", 1)
    assert isinstance(results[1], NotImplementedError)
    s = pipeline.stats()
    assert (s["errors"], s["dispatched"]) == (1, 1)
    for stage in ("queue_wait", "dispatch", "fetch", "decode"):
        assert s["stageMs"][stage]["count"] >= 1, stage


@pytest.mark.parametrize("case", [_coalesce, _cancelled, _stacked, _dedupe, _unported],
                         ids=["coalesce_one_fetch", "cancelled_never_dispatched",
                              "same_shape_one_stacked_group", "identical_dedupe",
                              "unported_raises_through_future"])
def test_pipeline_scheduling(case):
    fake = FakeMeshExec()
    pipeline = DeviceQueryPipeline(mesh_exec=fake, start=False)
    try:
        case(fake, pipeline)
    finally:
        pipeline.stop()


def test_timeout_mid_fetch_skips_decode():
    fake = FakeMeshExec(fetch_latency=0.5)
    pipeline = DeviceQueryPipeline(mesh_exec=fake, start=False)
    try:
        a = _Item({"shape": "A", "literal": 0}, [])
        b = _Item({"shape": "B", "literal": 1}, [])
        pipeline._q.put(a)
        pipeline._q.put(b)
        pipeline.start()
        assert fake.fetch_started.wait(timeout=5)
        a.future.cancel()  # gives up while the batched fetch is in flight
        assert b.future.result(timeout=10).answer[:3] == ("res", "B", 1)
        assert a.future.cancelled()
    finally:
        pipeline.stop()


def test_all_cancelled_launches_never_fetched():
    fake = FakeMeshExec()
    pipeline = DeviceQueryPipeline(mesh_exec=fake, start=False)
    try:
        a = _Item({"shape": "A", "literal": 0}, [])
        b = _Item({"shape": "A", "literal": 1}, [])
        # dispatch on this thread (the pipeline's threads are not running),
        # then cancel both callers before the fetcher sees the entry
        entry, n = pipeline._dispatch_grouped([a, b], time.perf_counter())
        assert n == 2 and entry
        a.future.cancel()
        b.future.cancel()
        pipeline._fetchq.put((entry, None))
        pipeline.start()
        time.sleep(0.3)
        assert fake.fetch_calls == []
    finally:
        pipeline.stop()


def test_caller_timeout_raises_timeout_error(monkeypatch):
    """No sentinel and no host answer: a caller that waits too long gets a
    TimeoutError, and its item is skipped once the pipeline runs."""
    monkeypatch.setattr(device_server, "SUBMIT_TIMEOUT_S", 0.05)
    fake = FakeMeshExec()
    pipeline = DeviceQueryPipeline(mesh_exec=fake, start=False)
    try:
        with pytest.raises(TimeoutError):
            pipeline.execute_partial({"shape": "A", "literal": 0}, [])
        assert pipeline.stats()["timeouts"] == 1
        pipeline.start()
        time.sleep(0.3)
        assert fake.prepared == []
    finally:
        pipeline.stop()


def test_many_concurrent_clients_each_get_their_own_answer():
    """More client threads than cores, with a short switch interval: every
    caller gets the answer to its own query, and the counters the three kinds
    of thread share add up."""
    import sys
    fake = FakeMeshExec(fetch_latency=0.002)
    pipeline = DeviceQueryPipeline(mesh_exec=fake)
    n_clients, per_client = 48, 10
    wrong = []
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def client(ci):
        for qi in range(per_client):
            shape, literal = "AB"[ci % 2], (ci * per_client + qi) % 7
            got = pipeline.execute_partial({"shape": shape, "literal": literal}, []).answer
            if got[:3] != ("res", shape, literal):
                wrong.append((ci, qi, got))

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(n_clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        s = pipeline.stats()
    finally:
        sys.setswitchinterval(old_interval)
        pipeline.stop()
    assert not wrong
    assert s["dispatched"] == n_clients * per_client
    assert (s["errors"], s["timeouts"]) == (0, 0)
    assert s["stageMs"]["queue_wait"]["count"] == min(512, n_clients * per_client)
    assert len(fake.prepared) == n_clients * per_client
    assert s["launches"] == len(fake.launched_keys)
    assert sum(fake.fetch_calls) == s["launches"]


def test_stop_fails_queued_items():
    pipeline = DeviceQueryPipeline(mesh_exec=FakeMeshExec(), start=False)
    item = _Item({"shape": "A", "literal": 0}, [])
    pipeline._q.put(item)
    pipeline.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        item.future.result(timeout=1)


# -- the real set executor on the CPU -------------------------------------------

SERVE_SQLS = [f"SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_quantity >= {q}"
              for q in (5, 15, 25, 35)]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_pipeline")
    schema = JSchema.from_json(ssb_schema().to_json())
    paths = jax_build(schema, make_columns(6000, seed=11), str(out), "lineorder", 4)
    return [jax_load(p) for p in paths], [load_segment(p) for p in paths]


def _serve(pipeline, segs, sqls):
    """Each SQL from its own thread, queued before the pipeline starts; returns
    each caller's partial merged and reduced to rows."""
    ctxs = [compile_query(sql, segs[0].schema) for sql in sqls]
    rows = [None] * len(sqls)

    def run(i):
        aggs = [make_agg(f) for f in ctxs[i].aggregations]
        partial = pipeline.execute_partial(ctxs[i], segs)
        merged = merge_segment_results([partial], aggs)
        rows[i] = reduce_to_result(ctxs[i], merged, aggs, list(ctxs[i].group_by)).rows

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sqls))]
    for t in threads:
        t.start()
    deadline = time.time() + 10
    while pipeline._q.qsize() < len(sqls) and time.time() < deadline:
        time.sleep(0.01)
    pipeline.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return rows


def test_real_executor_batches_and_matches_reference(table, monkeypatch):
    jax_segs, segs = table
    launches = []
    real = scan.masked_sums_answer

    def spy(*args):
        launches.append(args[1])
        return real(*args)
    monkeypatch.setattr(scan, "masked_sums_answer", spy)
    pipeline = DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(device="cpu"), start=False)
    try:
        rows = _serve(pipeline, segs, SERVE_SQLS)
        s = pipeline.stats()
    finally:
        pipeline.stop()
    assert s["dispatched"] == len(SERVE_SQLS)
    assert s["meanBatch"] > 1, s
    # four literals of one shape: one stacked group of four scan launches
    assert (s["launches"], s["stackedLaunches"], s["scanLaunches"]) == (1, 1, 4)
    assert len(launches) == 4
    reference = JaxMeshExecutor(default_mesh(1))
    for sql, got in zip(SERVE_SQLS, rows):
        want = reference.execute(jax_segs, sql).rows
        assert len(got) == len(want) == 1
        assert got[0][0] == want[0][0]
        assert math.isclose(got[0][1], want[0][1], rel_tol=REL, abs_tol=ABS), (sql, got, want)


def test_real_executor_serves_group_by_and_metadata_answers(table):
    jax_segs, segs = table
    sqls = ["SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
            "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY lo_region ORDER BY lo_region",
            "SELECT COUNT(*) FROM lineorder",
            "SELECT SUM(lo_revenue) FROM lineorder"]
    pipeline = DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(device="cpu"), start=False)
    try:
        rows = _serve(pipeline, segs, sqls)
    finally:
        pipeline.stop()
    reference = JaxMeshExecutor(default_mesh(1))
    for sql, got in zip(sqls, rows):
        want = reference.execute(jax_segs, sql).rows
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                if isinstance(y, float):
                    assert math.isclose(x, y, rel_tol=REL, abs_tol=ABS), (sql, got, want)
                else:
                    assert x == y, (sql, got, want)


def test_direct_execute_beside_the_pipeline_on_one_executor(table, monkeypatch):
    """One executor serves a running pipeline and direct `execute` callers at
    once: every answer matches the reference, and the scan calls the two paths
    made add up to the pipeline's `scanLaunches` plus one per direct query."""
    jax_segs, segs = table
    calls = []
    real = scan.masked_sums_answer

    def spy(*args):
        calls.append(args[1])
        return real(*args)
    monkeypatch.setattr(scan, "masked_sums_answer", spy)
    mx = MeshQueryExecutor(device="cpu")
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    rounds = 6
    served, direct, errors = [], [], []

    def serve(i):
        try:
            for r in range(rounds):
                sql = SERVE_SQLS[(i + r) % len(SERVE_SQLS)]
                ctx = compile_query(sql, segs[0].schema)
                aggs = [make_agg(f) for f in ctx.aggregations]
                merged = merge_segment_results([pipeline.execute_partial(ctx, segs)], aggs)
                served.append((sql, reduce_to_result(ctx, merged, aggs, []).rows))
        except Exception as e:   # the test reports what a thread saw
            errors.append(e)

    def execute(i):
        try:
            for r in range(rounds):
                sql = SERVE_SQLS[(i + r) % len(SERVE_SQLS)]
                direct.append((sql, mx.execute(segs, sql).rows))
        except Exception as e:
            errors.append(e)

    threads = ([threading.Thread(target=serve, args=(i,)) for i in range(4)]
               + [threading.Thread(target=execute, args=(i,)) for i in range(2)])
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        s = pipeline.stats()
    finally:
        pipeline.stop()
    assert not errors, errors
    assert len(served) == 4 * rounds and len(direct) == 2 * rounds
    assert s["dispatched"] == 4 * rounds and s["errors"] == 0
    # deduped queries share a launch: the pipeline counts the ones it issued
    assert len(calls) == s["scanLaunches"] + len(direct)
    reference = JaxMeshExecutor(default_mesh(1))
    want = {sql: reference.execute(jax_segs, sql).rows for sql in SERVE_SQLS}
    for sql, got in served + direct:
        assert got[0][0] == want[sql][0][0], sql
        assert math.isclose(got[0][1], want[sql][0][1], rel_tol=REL, abs_tol=ABS), sql
