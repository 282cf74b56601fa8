"""Differential test: pinot_tpu_torch's realtime consuming segments against pinot_tpu's.

The same rows, made from a seed with numpy, go through both packages on the
CPU: the JAX package's `DeviceMutableSegment(device_staging=True)` (staged on
the CPU jax device, as tests/test_device_ingest.py drives it) and the port's
(`device="cpu"`). Held equal:

* the reader surface: dictionaries, forward indexes, null bitmaps, min/max
  and `snapshot_arrays()` of views frozen at several row counts, over uneven
  batches (331, 129) with a dictionary that grows across batches and a
  null-heavy column;
* the PCB1 block codec: the same bytes from both encoders, and each decoder
  reads the other's;
* queries over a staged view: the reference device ingest test's shapes plus
  the two scan-route queries (SUM of a raw f32 row through `masked_sums`, SUM
  of a raw integer column through `masked_sums_fused`), against the
  reference's view and numpy: integer aggregates exactly, doubles at rel 1e-5;
* segment sets: a mixed set (two immutable segments built apart plus a view)
  and an unaligned immutable set, through `MeshQueryExecutor` and the
  pipeline, against the reference's set executor and numpy;
* the consumer: a `MemoryStream` pumped through both lanes (PCB1 blocks and
  JSON rows), its offsets and decode path, and a `build_immutable()` segment
  equal to the reference's;
* staging: an epoch-ms LONG column stays on the host and still answers; a
  device copy that fails raises; the staged block equals the host-built one;
* concurrency: queries taken while a thread pumps see whole batches only.
"""

import json
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pinot_tpu.ingest import realtime as jax_realtime
from pinot_tpu.ingest.stream import MemoryStream as JaxMemoryStream
from pinot_tpu.ingest.vectorized import decode_columnar_block as jax_decode
from pinot_tpu.ingest.vectorized import encode_columnar_block as jax_encode
from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.mutable_device import DeviceMutableSegment as JaxDeviceMutable
from pinot_tpu.table import StreamConfig as JaxStreamConfig
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu.table import TableType as JaxTableType
from pinot_tpu_torch import execute_query
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import datablock, scan
from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
from pinot_tpu_torch.ingest.stream import MemoryStream
from pinot_tpu_torch.ingest.vectorized import (decode_columnar_block, decode_columnar_blocks,
                                               encode_columnar_block)
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.schema import DataType, Schema, date_time, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
from pinot_tpu_torch.table import StreamConfig, TableConfig

REL = 1e-5
CPU = "cpu"
BATCHES = (331, 129)          # uneven batch sizes, alternating
SEG_NAME = "events__0__0__20261017T0000Z"


def _schema():
    return Schema("events", [dimension("site", DataType.STRING),
                             metric("clicks", DataType.LONG),
                             metric("cost", DataType.DOUBLE),
                             metric("score", DataType.INT),
                             date_time("ts", DataType.LONG)])


def _jax_schema():
    return JSchema.from_json(_schema().to_json())


def _columns(n, seed=7, null_every=0, site_shift=0):
    """Seeded columns; `site_shift` moves the site values of later rows, so
    the dictionary grows (and re-sorts) across batches; `null_every` makes
    the site, cost and score columns null-heavy."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    site = np.array([f"s{int(k)}.com" for k in rng.integers(0, 23, n) + (i // 500) * site_shift],
                    dtype=object)
    cols = {"site": site, "clicks": rng.integers(-500, 5000, n).astype(np.int64),
            "cost": np.round(rng.random(n) * 90, 4), "score": rng.integers(-100, 100, n),
            "ts": 1700000000000 + i}
    lists = {k: v.tolist() for k, v in cols.items()}
    if null_every:
        for j in range(n):
            if j % null_every == 0:
                lists["site"][j] = None
            if j % (null_every + 4) == 1:
                lists["cost"][j] = None
            if j % (null_every + 7) == 2:
                lists["score"][j] = None
    return lists


def _slices(n):
    lo, k = 0, 0
    while lo < n:
        hi = min(n, lo + BATCHES[k % len(BATCHES)])
        yield lo, hi
        lo, k = hi, k + 1


def _blocks(cols, n):
    schema = _schema()
    return [encode_columnar_block(schema, {c: v[lo:hi] for c, v in cols.items()})
            for lo, hi in _slices(n)]


def _both(cols, n, staging=True):
    """The same blocks appended to the port's and the reference's stores;
    returns (port store, reference store, [(port view, reference view)] after
    every third batch)."""
    ours = DeviceMutableSegment("seg0", _schema(), device_staging=staging,
                                device=CPU if staging else None)
    ref = JaxDeviceMutable("seg0", _jax_schema(), device_staging=staging)
    views = []
    for b, blob in enumerate(_blocks(cols, n)):
        ours.index_arrays(decode_columnar_block(blob))
        ref.index_arrays(jax_decode(blob))
        if b % 3 == 2:
            views.append((ours.query_view(), ref.query_view()))
    views.append((ours.query_view(), ref.query_view()))
    return ours, ref, views


def _assert_readers_equal(a, b, names):
    assert a.num_docs == b.num_docs
    for name in names:
        ra, rb = a.column(name), b.column(name)
        assert ra.has_dictionary == rb.has_dictionary, name
        assert ra.cardinality == rb.cardinality, name
        fa, fb = np.asarray(ra.fwd), np.asarray(rb.fwd)
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb), name
        if rb.dictionary is not None:
            assert list(ra.dictionary.values) == list(rb.dictionary.values), name
        na, nb = ra.null_bitmap, rb.null_bitmap
        assert (na is None) == (nb is None), name
        if nb is not None:
            assert np.array_equal(na, nb), name
        assert ra.min_value == rb.min_value and ra.max_value == rb.max_value, name
        assert ra.meta == {k: v for k, v in rb.meta.items() if k in ra.meta}, name


def _assert_arrays_equal(a, b):
    assert list(a) == list(b)
    for c in b:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype and x.tolist() == y.tolist(), c


# -- reader surface and codec --------------------------------------------------------

@pytest.mark.parametrize("null_every", [0, 3], ids=["dense", "null_heavy"])
def test_reader_surface_matches_the_reference_at_frozen_row_counts(null_every):
    n = 2400
    cols = _columns(n, null_every=null_every, site_shift=7)
    ours, ref, views = _both(cols, n)
    assert len(views) >= 4
    names = _schema().column_names
    for vo, vr in views:     # earlier views stay frozen while the store grows
        assert not vo.is_mutable and not vr.is_mutable
        _assert_readers_equal(vo, vr, names)
    _assert_readers_equal(ours, ref, names)
    assert len(ours.column("site").dictionary) > len(views[0][0].column("site").dictionary)
    if null_every:
        assert ours.column("site").null_bitmap.sum() == n // null_every
    _assert_arrays_equal(ours.snapshot_arrays(), ref.snapshot_arrays())


def test_pcb1_codec_gives_equal_bytes_both_ways():
    n = 700
    cols = _columns(n, null_every=5)
    ours = encode_columnar_block(_schema(), cols)
    theirs = jax_encode(_jax_schema(), cols)
    assert ours == theirs
    joined = b"\n".join([ours, theirs])
    for got, want in ((decode_columnar_blocks(joined, 2)[1], jax_decode(ours)),
                      (decode_columnar_block(theirs), jax_decode(ours))):
        assert got.n == want.n == n and list(got.cols) == list(want.cols)
        for c, rep in want.cols.items():
            mine = got.cols[c]
            assert mine[0] == rep[0], c
            for x, y in zip(mine[1:], rep[1:]):
                if isinstance(y, np.ndarray):
                    assert x.dtype == y.dtype and np.array_equal(x, y), c
                else:
                    assert x == y, c
    with pytest.raises(ValueError):
        encode_columnar_block(Schema("t", [dimension("tags", DataType.STRING,
                                                     single_value=False)]), {"tags": [None]})


# -- queries over a staged view --------------------------------------------------------

# the reference device ingest test's shapes, then the two scan-route queries
SQLS = (
    "SELECT COUNT(*), SUM(clicks), SUM(score) FROM events",
    "SELECT site, COUNT(*), SUM(clicks) FROM events GROUP BY site ORDER BY site LIMIT 100",
    "SELECT MIN(clicks), MAX(clicks), MIN(ts), MAX(ts) FROM events",
    "SELECT COUNT(*) FROM events WHERE clicks > 1000",
    "SELECT site, SUM(clicks) FROM events WHERE score >= 0 GROUP BY site ORDER BY site "
    "LIMIT 100",
    "SELECT SUM(cost), COUNT(*) FROM events WHERE site = 's3.com'",
    "SELECT SUM(score), COUNT(*) FROM events WHERE site = 's3.com'",
)
# the scan each query takes on a view (the first one is a band-free scan: its
# two integer columns' FOR widths differ); the others run the plain body
SCAN_ROUTE = {SQLS[0]: "masked_sums_answer", SQLS[5]: "masked_sums_answer",
              SQLS[6]: "masked_sums_fused_answer"}


def _oracle(cols, sql):
    """numpy float64 over the rows (null cells read as the spec's null fill)."""
    schema = _schema()
    c = {}
    for f in schema.fields:
        vals = [f.null_value if v is None else v for v in cols[f.name]]
        c[f.name] = np.array(vals, dtype=object if f.name == "site" else np.float64)
    every = np.ones(len(c["clicks"]), dtype=bool)
    s3 = c["site"] == "s3.com"
    if sql == SQLS[0]:
        return [[int(every.sum()), c["clicks"].sum(), c["score"].sum()]]
    if sql in (SQLS[1], SQLS[4]):
        m = every if sql == SQLS[1] else c["score"] >= 0
        rows = []
        for site in sorted(set(c["site"][m].tolist()))[:100]:
            g = m & (c["site"] == site)
            rows.append([site, int(g.sum()), c["clicks"][g].sum()] if sql == SQLS[1]
                        else [site, c["clicks"][g].sum()])
        return rows
    if sql == SQLS[2]:
        return [[c["clicks"].min(), c["clicks"].max(), c["ts"].min(), c["ts"].max()]]
    if sql == SQLS[3]:
        return [[int((c["clicks"] > 1000).sum())]]
    col = "cost" if sql == SQLS[5] else "score"
    return [[c[col][s3].sum(), int(s3.sum())]]


def _match(got, want) -> bool:
    """Integers exactly (an integral float sum is held exactly too), other
    floats at rel 1e-5."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for x, y in zip(rg, rw):
            if isinstance(y, str) or isinstance(x, str):
                if x != y:
                    return False
            elif float(y).is_integer() and float(x).is_integer():
                if float(x) != float(y):
                    return False
            elif not math.isclose(float(x), float(y), rel_tol=REL):
                return False
    return True


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.fixture(scope="module")
def staged():
    n = 2500
    cols = _columns(n, null_every=9)
    ours, ref, _ = _both(cols, n)
    return cols, ours.query_view(), ref.query_view()


@pytest.mark.parametrize("sql", SQLS, ids=[f"q{i}" for i in range(len(SQLS))])
def test_queries_over_a_staged_view_match_the_reference_and_numpy(staged, monkeypatch, sql):
    cols, view, ref_view = staged
    want = _oracle(cols, sql)
    ref = JaxExecutor(use_device=True).execute([ref_view], jax_compile(sql, _jax_schema())).rows
    assert _match(ref, want), (sql, ref, want)
    calls = {name: _spy(monkeypatch, scan, name)
             for name in ("masked_sums_answer", "masked_sums_fused_answer")}
    got = execute_query([view], sql, device=CPU).rows
    assert _match(got, want), (sql, got, want)
    for name, seen in calls.items():
        assert len(seen) == (1 if SCAN_ROUTE.get(sql) == name else 0), (sql, name)


def test_a_store_without_staging_raises_naming_the_host_path():
    """A store without staging (and its view) is mutable: the per-segment
    executor plans it on the host, the set executor on the merged view, and
    both answer as numpy and the reference do. A store with a multi-value
    column answers an any-value filter as the reference's does."""
    n = 800
    cols = _columns(n, null_every=7)
    ours, ref, _ = _both(cols, n, staging=False)
    view = ours.query_view()
    assert view.is_mutable
    for sql in SQLS:
        want = _oracle(cols, sql)
        assert _match(JaxExecutor().execute([ref.query_view()],
                                            jax_compile(sql, _jax_schema())).rows, want)
        for segs in ([view], [ours]):
            assert _match(execute_query(segs, sql, device=CPU).rows, want), sql
            assert _match(MeshQueryExecutor(device=CPU).execute(segs, sql).rows, want), sql
    mv_schema = Schema("t", [dimension("tags", DataType.STRING, single_value=False),
                             metric("v", DataType.DOUBLE)])
    tags = [["a", "b"], None, ["b"], [], ["c", "a", "a"]]
    store = DeviceMutableSegment("mv", mv_schema)
    store.index_batch({"tags": tags, "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    ref_store = JaxDeviceMutable("mv", JSchema.from_json(mv_schema.to_json()))
    ref_store.index_batch({"tags": tags, "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    sql = "SELECT COUNT(*), SUM(v) FROM t WHERE tags = 'a'"
    want = JaxExecutor().execute([ref_store.query_view()],
                                 jax_compile(sql, ref_store.schema)).rows
    assert want == [[2, 6.0]]
    assert execute_query([store.query_view()], sql, device=CPU).rows == want


# -- staging ---------------------------------------------------------------------------

def test_epoch_ms_column_stays_on_the_host_and_the_block_equals_the_host_built_one(staged):
    cols, view, _ = staged
    store = view._store
    assert store._dev_chunks["ts"] is None          # beyond int32: never staged
    assert all(store._dev_chunks[c] for c in ("clicks", "cost", "score"))
    blk = datablock.block_for(view, torch.device(CPU))
    assert blk is view._device_blocks[CPU]
    assert set(blk._raw) == {"clicks", "cost", "score"}
    host = datablock.SegmentBlock(view, torch.device(CPU))
    for col in ("clicks", "cost", "score"):
        assert torch.equal(blk.raw(col), host.raw(col)), col
        assert blk.raw(col).dtype == host.raw(col).dtype
    assert execute_query([view], "SELECT MIN(ts), MAX(ts) FROM events",
                         device=CPU).rows == [[1700000000000.0, 1700000002499.0]]


def test_a_failing_device_copy_raises(monkeypatch):
    store = DeviceMutableSegment("seg0", _schema(), device_staging=True, device=CPU)
    blob = encode_columnar_block(_schema(), _columns(50))

    def broken(self, *args, **kwargs):
        raise RuntimeError("device copy failed")
    monkeypatch.setattr(torch.Tensor, "to", broken)
    with pytest.raises(RuntimeError, match="device copy failed"):
        store.index_arrays(decode_columnar_block(blob))


@pytest.mark.parametrize("sizes", [(400, 400, 400), (331, 129, 331)], ids=["equal", "uneven"])
def test_rows_indexed_after_a_release_answer_right(sizes):
    """`release_device`, then more batches: the released columns stage no
    more, and every later view builds them from the host, in row order."""
    n = sum(sizes)
    cols = _columns(n, seed=19)
    schema = _schema()
    store = DeviceMutableSegment("seg0", schema, device_staging=True, device=CPU)
    lo = 0
    for k, m in enumerate(sizes):
        store.index_arrays(decode_columnar_block(
            encode_columnar_block(schema, {c: v[lo:lo + m] for c, v in cols.items()})))
        lo += m
        if k == 0:
            assert execute_query([store.query_view()], SQLS[0], device=CPU).rows
            store.release_device()
            assert all(chunks is None for chunks in store._dev_chunks.values())
        view = store.query_view()
        for sql in (SQLS[0], SQLS[5], SQLS[6]):
            got = execute_query([view], sql, device=CPU).rows
            assert _match(got, _oracle({c: v[:lo] for c, v in cols.items()}, sql)), (k, sql)
    blk = datablock.block_for(view, torch.device(CPU))
    host = datablock.SegmentBlock(view, torch.device(CPU))
    for col in ("clicks", "cost", "score"):
        assert torch.equal(blk.raw(col), host.raw(col)), col


def test_device_key_names_a_bare_cuda_by_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert datablock.device_key("cuda") == datablock.device_key(torch.device("cuda:1")) \
        == "cuda:1"
    assert datablock.device_key("cuda:0") == "cuda:0"
    assert datablock.device_key(torch.device(CPU)) == CPU


# -- segment sets ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def set_env(tmp_path_factory):
    """Two immutable segments built apart (dictionaries of their own) and a
    staged consuming segment, over one seeded row set."""
    out = tmp_path_factory.mktemp("torch_realtime_sets")
    cols = _columns(4100, seed=11, null_every=0, site_shift=3)
    parts = [(0, 1500), (1500, 2700), (2700, 4100)]
    segs, jax_segs = [], []
    for i, (lo, hi) in enumerate(parts[:2]):
        path = SegmentBuilder(_schema()).build({c: v[lo:hi] for c, v in cols.items()},
                                               str(out), f"events_{i}")
        segs.append(load_segment(path))
        jax_segs.append(jax_load(path))
    lo, hi = parts[2]
    tail = {c: v[lo:hi] for c, v in cols.items()}
    ours, ref, _ = _both(tail, hi - lo)
    return cols, segs, jax_segs, ours.query_view(), ref.query_view()


SET_SQLS = SQLS[:2] + SQLS[3:]   # the set executor hands metadata plans to the per-segment path


def _reduce(ctx, partial):
    aggs = [make_agg(f) for f in ctx.aggregations]
    merged = merge_segment_results([partial], aggs)
    group_exprs = [e for e, _ in ctx.select_items] if ctx.distinct else list(ctx.group_by)
    return reduce_to_result(ctx, merged, aggs, group_exprs)


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "unaligned_immutable"])
def test_sets_match_the_reference_set_executor_and_numpy(set_env, monkeypatch, mixed):
    cols, segs, jax_segs, view, ref_view = set_env
    scans = _spy(monkeypatch, scan, "masked_sums_answer")
    members, jax_members = (segs + [view], jax_segs + [ref_view]) if mixed else (segs, jax_segs)
    n = sum(s.num_docs for s in members)
    rows = {c: v[:n] for c, v in cols.items()}
    mx = MeshQueryExecutor(device=CPU)
    jax_mx = JaxMeshExecutor(default_mesh(1))
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        for sql in SET_SQLS:
            want = _oracle(rows, sql)
            ref = jax_mx.execute(jax_members, sql).rows
            assert _match(ref, want), (sql, ref, want)
            got = mx.execute(members, sql).rows
            assert _match(got, want), (sql, got, want)
            ctx = compile_query(sql, members[0].schema)
            served = _reduce(ctx, pipeline.execute_partial(ctx, members)).rows
            assert _match(served, want), (sql, served, want)
        plan, merged = mx._plan_for_set(compile_query(SQLS[5], members[0].schema), members)
        assert merged is not None and merged.seg_docs == tuple(s.num_docs for s in members)
        # the scan-route query: one launch over the whole stacked set (2,048
        # padded rows a member), in global-id space
        del scans[:]
        mx.execute(members, SQLS[5])
        assert len(scans) == 1 and scans[0][0][0].shape[0] == len(members) * 2048
    finally:
        pipeline.stop()


def test_a_grown_consuming_member_replaces_its_view_and_block(tmp_path):
    """The set's merged view and block are cached by the members' identity,
    with their row counts as the subkey: a consuming segment that grew (a new
    view) replaces both, and the set answers over exactly its new rows."""
    cols = _columns(2000, seed=5)
    path = SegmentBuilder(_schema()).build({c: v[:1000] for c, v in cols.items()},
                                           str(tmp_path), "events_0")
    seg = load_segment(path)
    store = DeviceMutableSegment("seg1", _schema(), device_staging=True, device=CPU)
    blobs = _blocks({c: v[1000:] for c, v in cols.items()}, 1000)
    mx = MeshQueryExecutor(device=CPU)
    sql = SQLS[5]
    seen_views, seen_blocks = set(), set()
    for k, blob in enumerate(blobs):
        store.index_arrays(decode_columnar_block(blob))
        members = [seg, store.query_view()]
        n = sum(s.num_docs for s in members)
        got = mx.execute(members, sql).rows
        assert _match(got, _oracle({c: v[:n] for c, v in cols.items()}, sql)), (k, got)
        seen_views.add(id(mx._merged_view(members)))
        seen_blocks.add(id(mx._block_for(members, mx._merged_view(members))))
        assert len(mx._views) == 1 and len(mx._set_blocks) == 1
    assert len(seen_views) == len(seen_blocks) == len(blobs)


# -- the consumer --------------------------------------------------------------------------

PUMP_MESSAGES = 3   # messages per pump on both sides


def _consumers(tmp_path, decoder, topic, staging=True):
    props = {"realtime.ingest.device.staging": "true" if staging else "false"}
    ours = RealtimePartitionConsumer(
        SEG_NAME, TableConfig("events", stream=StreamConfig(
            topic=topic, decoder=decoder, properties=props, flush_threshold_rows=2000)),
        _schema(), 0, str(tmp_path / "ours"), device=CPU)
    ref = jax_realtime.RealtimePartitionConsumer(
        SEG_NAME, JaxTableConfig("events", table_type=JaxTableType.REALTIME,
                                 stream=JaxStreamConfig(
                                     topic=topic, decoder=decoder,
                                     properties={**props,
                                                 "realtime.ingest.batch.size": PUMP_MESSAGES},
                                     flush_threshold_rows=2000)),
        _jax_schema(), 0, "server_0", None, str(tmp_path / "ref"))
    return ours, ref


@pytest.mark.parametrize("lane", ["blocks", "batch"])
def test_pump_both_lanes_and_build_immutable_match_the_reference(tmp_path, lane):
    n = 2000
    cols = _columns(n, seed=13, null_every=10)
    topic = f"ev_{lane}"
    MemoryStream.reset_all()
    JaxMemoryStream.reset_all()
    streams = (MemoryStream.create(topic, 1), JaxMemoryStream.create(topic, 1))
    if lane == "blocks":
        payloads = _blocks(cols, n)
    else:
        payloads = [json.dumps({c: cols[c][i] for c in cols}) for i in range(n)]
    for p in payloads:
        for s in streams:
            s.produce(p, partition=0)
    ours, ref = _consumers(tmp_path, "columnar" if lane == "blocks" else "json", topic)
    steps = 0
    while ours.offset < len(payloads):
        got, want = ours.pump(max_messages=PUMP_MESSAGES), ref.pump()
        assert got == want and ours.offset == ref.offset
        assert ours.mutable.num_docs == ref.mutable.num_docs
        steps += 1
    assert ours.last_decode_path == ref.last_decode_path == lane
    assert ours.mutable.num_docs == n and ours.end_criteria_reached()
    assert ours.pump(max_messages=PUMP_MESSAGES) == 0 and ours.offset == len(payloads)
    # past the threshold both report their offset to the completion
    # protocol; a controller that answers HOLD parks both
    reports = []

    class HoldingController:
        def segment_consumed(self, segment, server, offset):
            reports.append((segment, offset))
            return {"status": "HOLD", "offset": offset}
    ours.completion = ref.completion = HoldingController()
    assert ours.maybe_complete() == ref.maybe_complete() == "HOLDING"
    assert reports == [(SEG_NAME, len(payloads))] * 2
    view = ours.query_segment()
    assert view is ours.query_segment() and not view.is_mutable
    assert _match(execute_query([view], SQLS[0], device=CPU).rows, _oracle(cols, SQLS[0]))
    a, b = load_segment(ours.build_immutable()), jax_load(ref.build_immutable())
    assert a.num_docs == b.num_docs == n
    for name in _schema().column_names:
        ca, cb = a.column(name), b.column(name)
        assert np.array_equal(np.asarray(ca.fwd), np.asarray(cb.fwd)), name
        if cb.dictionary is not None:
            assert list(ca.dictionary.values) == list(cb.dictionary.values), name
        # the reference's writer adds a bloom filter the port does not write
        assert ca.meta == {k: cb.meta[k] for k in ca.meta}, name


def test_queries_during_a_pump_see_whole_batches_only(tmp_path):
    """A writer thread pumps one block at a time while the main thread
    queries: each answer's COUNT is a row count the pump published, and its
    SUM covers exactly those rows."""
    n = 6000
    cols = _columns(n, seed=17)
    MemoryStream.reset_all()
    stream = MemoryStream.create("ev_race", 1)
    blobs = _blocks(cols, n)
    for blob in blobs:
        stream.produce(blob, partition=0)
    ours = RealtimePartitionConsumer(
        SEG_NAME, TableConfig("events", stream=StreamConfig(
            topic="ev_race", decoder="columnar",
            properties={"realtime.ingest.device.staging": "true"})),
        _schema(), 0, str(tmp_path), device=CPU)
    published = {0} | set(np.cumsum([hi - lo for lo, hi in _slices(n)]).tolist())
    prefix = np.concatenate([[0], np.cumsum(cols["clicks"])])
    sql = "SELECT COUNT(*), SUM(clicks) FROM events WHERE site <> 'nowhere'"
    done = threading.Event()

    def pump():
        try:
            while ours.pump(max_messages=1):
                time.sleep(0.002)   # let queries land between batches too
        finally:
            done.set()
    writer = threading.Thread(target=pump)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    seen = []
    try:
        writer.start()
        while not done.is_set() or not seen:
            view = ours.query_segment()
            if view.num_docs == 0:
                continue
            count, total = execute_query([view], sql, device=CPU).rows[0]
            seen.append(count)
            assert count == view.num_docs and count in published, count
            assert total == prefix[count], (count, total)
    finally:
        sys.setswitchinterval(old)
        writer.join(timeout=60)
    assert not writer.is_alive() and ours.mutable.num_docs == n
    assert len(set(seen)) > 1


@pytest.mark.parametrize("sql", [
    # no id band: the stacked top-k over the whole mixed block
    "SELECT site, cost FROM events ORDER BY cost DESC LIMIT 6",
    # an id band on a column whose dictionaries disagree: the per-segment
    # executor answers (each segment's own top-k), as in the reference
    "SELECT site, cost FROM events WHERE site = 's3.com' ORDER BY cost LIMIT 6",
], ids=["stacked_topk", "per_segment_topk"])
def test_selections_over_a_mixed_set_match_numpy(set_env, sql):
    cols, segs, _, view, _ = set_env
    members = segs + [view]
    n = sum(s.num_docs for s in members)
    site = np.array(cols["site"][:n], dtype=object)
    cost = np.array(cols["cost"][:n], dtype=np.float64)
    m = site == "s3.com" if "WHERE" in sql else np.ones(n, dtype=bool)
    idx = np.nonzero(m)[0]
    desc = "DESC" in sql
    idx = idx[np.argsort(-cost[idx] if desc else cost[idx], kind="stable")][:6]
    want = [[site[i], cost[i]] for i in idx]
    mx = MeshQueryExecutor(device=CPU)
    assert _match(mx.execute(members, sql).rows, want)
    ctx = compile_query(sql, members[0].schema)
    p = mx.prepare_partial(ctx, members)
    assert p.kind == ("topk" if "WHERE" not in sql else "exact")
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        assert _match(_reduce(ctx, pipeline.execute_partial(ctx, members)).rows, want)
    finally:
        pipeline.stop()
