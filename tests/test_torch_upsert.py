"""Differential test: pinot_tpu_torch's upsert and dedup against pinot_tpu's.

The same inputs, made from a seed with numpy, go through both packages on the
CPU. Held equal:

* the metadata managers after the same `add_record` sequences (return values,
  valid-doc masks, versions, `num_primary_keys`; ties, late events,
  `rename_segment`, `remove_segment`), also under threads, and dedup;
* `merge_partial` for all seven strategies;
* the row-append `MutableSegment`'s reader surface (single- and multi-value
  snapshots, nulls, min/max, the realtime inverted index's postings and the
  realtime text index's masks), before and after growth;
* the consumer end to end for FULL, PARTIAL and dedup tables: both packages'
  consumers pump the same JSON messages (the per-row lane) over commits;
  every segment's valid-doc mask equals the reference's and numpy's live
  rows, and every query through the port's `execute_query(..., upsert=)`
  equals the reference's `execute_segment(ctx, seg, valid)` per segment
  (integers exactly, doubles at rel 1e-5), before and after an update;
* the class choice and the block-stream refusal;
* the scan with the valid band: its plain version against the plain body
  under the same mask, and the band's device copy following the segment's
  version;
* the reference's `tests/test_upsert.py` cases, on the port.
"""

import json
import math
import sys
import threading

import numpy as np
import pytest

from chip_smoke import live_events
from pinot_tpu import upsert as jax_upsert
from pinot_tpu.ingest import realtime as jax_realtime
from pinot_tpu.ingest.stream import MemoryStream as JaxMemoryStream
from pinot_tpu.query.aggregates import make_agg as jax_make_agg
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.reduce import merge_segment_results as jax_merge
from pinot_tpu.query.reduce import reduce_to_result as jax_reduce
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutable
from pinot_tpu.table import IndexingConfig as JaxIndexingConfig
from pinot_tpu.table import StreamConfig as JaxStreamConfig
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu.table import TableType as JaxTableType
from pinot_tpu.table import UpsertConfig as JaxUpsertConfig
from pinot_tpu_torch import execute_query, ssb, upsert
from pinot_tpu_torch.engine import scan
from pinot_tpu_torch.engine.datablock import block_for
from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
from pinot_tpu_torch.ingest.stream import MemoryStream
from pinot_tpu_torch.ingest.transform import TransformPipeline
from pinot_tpu_torch.query import executor as executor_mod
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.executor import ServerQueryExecutor, scan_route
from pinot_tpu_torch.query.planner import plan_segment
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import load_segment, segments_from_columns
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
from pinot_tpu_torch.table import IndexingConfig, StreamConfig, TableConfig, UpsertConfig

REL = 1e-5
CPU = "cpu"
SEED = 20261017
PUMP = 97                       # messages a pump, on both sides


@pytest.fixture(autouse=True)
def _reset_streams():
    MemoryStream.reset_all()
    JaxMemoryStream.reset_all()
    yield
    MemoryStream.reset_all()
    JaxMemoryStream.reset_all()


def _match(got, want) -> bool:
    """Integers exactly (an integral float too), other floats at rel 1e-5,
    strings and None equal."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for x, y in zip(rg, rw):
            if x is None or y is None or isinstance(x, (str, list)) or isinstance(y, (str, list)):
                if x != y:
                    return False
            elif float(y).is_integer() and float(x).is_integer():
                if float(x) != float(y):
                    return False
            elif not math.isclose(float(x), float(y), rel_tol=REL):
                return False
    return True


# -- the metadata managers --------------------------------------------------------------

def _ops(seed, n=600, keys=40, segs=("s0", "s1", "s2")):
    """A seeded add_record sequence: (segment, doc, pk, comparison value),
    doc ids appended per segment; ties and late values included."""
    rng = np.random.default_rng(seed)
    next_doc = {s: 0 for s in segs}
    out = []
    for _ in range(n):
        s = segs[int(rng.integers(0, len(segs)))]
        cmp_val = int(rng.integers(0, 50)) if rng.random() < 0.9 else None
        out.append((s, next_doc[s], (int(rng.integers(0, keys)),), cmp_val))
        next_doc[s] += 1
    return out, next_doc


def _same_state(ours, ref, segs, sizes):
    assert ours.num_primary_keys == ref.num_primary_keys
    for s in segs:
        assert ours.version(s) == ref.version(s), s
        a, b = ours.valid_mask(s, sizes.get(s, 0)), ref.valid_mask(s, sizes.get(s, 0))
        assert (a is None) == (b is None), s
        if a is not None:
            np.testing.assert_array_equal(a, b)
            assert a.key[2:] == (s, ref.version(s), sizes.get(s, 0))


@pytest.mark.parametrize("comparison", [True, False])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_partition_manager_matches_the_reference(seed, comparison):
    ops, sizes = _ops(seed)
    ours = upsert.PartitionUpsertMetadataManager(comparison)
    ref = jax_upsert.PartitionUpsertMetadataManager(comparison)
    segs = ("s0", "s1", "s2", "s3")
    for i, (s, doc, pk, cmp_val) in enumerate(ops):
        assert ours.add_record(s, doc, pk, cmp_val) == ref.add_record(s, doc, pk, cmp_val)
        if i % 97 == 0:
            _same_state(ours, ref, segs, sizes)
    _same_state(ours, ref, segs, sizes)
    # a commit under another name keeps the doc ids; a dropped segment loses its keys
    for m in (ours, ref):
        m.rename_segment("s1", "s3")
        m.remove_segment("s2")
    sizes["s3"] = sizes.pop("s1")
    _same_state(ours, ref, segs, sizes)
    for m in (ours, ref):
        assert m.add_record("s3", 0, (7,), 100) is True
    _same_state(ours, ref, segs, sizes)


def test_ties_late_events_and_the_mask_key():
    m = upsert.PartitionUpsertMetadataManager()
    assert m.add_record("a", 0, ("k",), 10)
    assert m.add_record("a", 1, ("k",), 10)          # a tie replaces
    assert not m.add_record("a", 2, ("k",), 9)       # late: rejected, stays invisible
    np.testing.assert_array_equal(m.valid_mask("a", 3), [False, True, False])
    key = m.valid_mask("a", 3).key
    assert m.valid_mask("a", 3).key == key           # no change, same key
    m.add_record("a", 3, ("j",), 1)
    assert m.valid_mask("a", 4).key != key
    # derived arrays carry no key; a remove then re-add never repeats one
    assert (m.valid_mask("a", 4) & np.ones(4, dtype=bool)).key is None
    before = m.valid_mask("a", 4).key
    m.remove_segment("a")
    assert m.valid_mask("a", 4) is None
    m.add_record("a", 0, ("k",), 1)
    m.add_record("a", 1, ("j",), 1)
    m.add_record("a", 2, ("x",), 1)
    m.add_record("a", 3, ("y",), 1)
    assert m.version("a") == before[3] and m.valid_mask("a", 4).key != before


def test_table_manager_routes_to_its_partitions():
    ours, ref = upsert.TableUpsertMetadataManager(), jax_upsert.TableUpsertMetadataManager()
    for m in (ours, ref):
        m.partition(0).add_record("p0", 0, ("a",), 1)
        m.partition(1).add_record("p1", 0, ("b",), 1)
        m.partition(1).add_record("p1", 1, ("b",), 2)
    for s, n in (("p0", 1), ("p1", 2), ("none", 3)):
        a, b = ours.valid_mask(s, n), ref.valid_mask(s, n)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (ours.version("p0"), ours.version("p1"), ours.version("none")) == (1, 3, 0)


def test_concurrent_add_record_stays_consistent():
    """tests/test_analysis.py's threaded regression, on the port: one live
    row per key, carrying the largest comparison value."""
    mgr = upsert.PartitionUpsertMetadataManager(comparison_enabled=True)
    nkeys, nthreads, niter = 32, 8, 25
    ndocs = niter * nkeys
    barrier = threading.Barrier(nthreads)

    def worker(tid):
        barrier.wait()
        for i in range(niter):
            for k in range(nkeys):
                mgr.add_record(f"seg{tid}", i * nkeys + k, (k,), comparison_value=tid * niter + i)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(nthreads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert mgr.num_primary_keys == nkeys
    live = sum(int(m.sum()) for m in (mgr.valid_mask(f"seg{t}", ndocs) for t in range(nthreads))
               if m is not None)
    assert live == nkeys
    best = (nthreads - 1) * niter + (niter - 1)
    with mgr._lock:
        assert all(mgr._primary_keys[(k,)][2] == best for k in range(nkeys))


PAIRS = [(1, 2), (5, 5), (2.5, -1.0), (None, 3), (3, None), (None, None), ("a", "b"),
         (["a"], "b"), (["a", "b"], ["b", "c"]), ("x", ["x", "y"]), ([1, 2], [2, 3])]


@pytest.mark.parametrize("strategy", ["OVERWRITE", "IGNORE", "INCREMENT", "APPEND", "UNION",
                                      "MAX", "MIN", "max"])
def test_merge_partial_matches_the_reference(strategy):
    for old, new in PAIRS:
        numeric = all(isinstance(v, (int, float)) or v is None for v in (old, new))
        if strategy.upper() in ("INCREMENT", "MAX", "MIN") and not numeric \
                and not (old is None or new is None):
            continue
        got = upsert.merge_partial(strategy, _copy(old), _copy(new))
        want = jax_upsert.merge_partial(strategy, _copy(old), _copy(new))
        assert got == want, (strategy, old, new)
    with pytest.raises(ValueError, match="strategy"):
        upsert.merge_partial("SUMMON", 1, 2)


def _copy(v):
    return list(v) if isinstance(v, list) else v


def test_dedup_manager_matches_the_reference():
    rng = np.random.default_rng(SEED)
    ours, ref = upsert.PartitionDedupMetadataManager(), jax_upsert.PartitionDedupMetadataManager()
    for k in rng.integers(0, 50, 400).tolist():
        assert ours.check_and_add((k,)) == ref.check_and_add((k,))
    for m in (ours, ref):
        m.remove_segment_keys([(k,) for k in range(10)])
    for k in range(20):
        assert ours.check_and_add((k,)) == ref.check_and_add((k,))


# -- the row-append MutableSegment ---------------------------------------------------

def _mutable_schema():
    return Schema("t", [dimension("site", DataType.STRING),
                        dimension("tags", DataType.STRING, single_value=False),
                        dimension("codes", DataType.INT, single_value=False),
                        metric("clicks", DataType.LONG),
                        metric("cost", DataType.DOUBLE),
                        dimension("note", DataType.STRING)])


def _mutable_rows(n, seed, shift=0):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "gamut", "betas"]
    rows = []
    for i in range(n):
        k = int(rng.integers(0, 12)) + shift
        rows.append({
            "site": None if i % 11 == 0 else f"s{k}",
            "tags": [f"t{int(t)}" for t in rng.integers(0, 6, int(rng.integers(0, 4)))] or None,
            "codes": [int(c) for c in rng.integers(0, 30, int(rng.integers(1, 4)))],
            "clicks": None if i % 13 == 1 else int(rng.integers(-50, 500)),
            "cost": float(np.round(rng.random() * 10, 3)),
            "note": " ".join(words[int(w)] for w in rng.integers(0, 6, int(rng.integers(1, 5))))})
    return rows


TEXT_QUERIES = ("beta", "beta AND gamma", "NOT alpha", '"alpha beta"', "gam*", "/be.a/",
                "betas~1", "(alpha OR delta) AND NOT gamut")


def _same_readers(ours, ref):
    assert ours.num_docs == ref.num_docs
    for name in ours.schema.column_names:
        a, b = ours.column(name), ref.column(name)
        sa, sb = a.dict_snapshot(), b.dict_snapshot()
        assert len(sa) == len(sb) and sa[0] == sb[0], name
        if sb[1] is None:
            assert sa[1] is None
        else:
            assert list(sa[1].values) == list(sb[1].values), name
            for x, y in zip(sa[2:], sb[2:]):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(np.asarray(a.fwd), np.asarray(b.fwd))
        va, vb = a.values(), b.values()
        assert [list(v) if isinstance(v, np.ndarray) else v for v in va] == \
            [list(v) if isinstance(v, np.ndarray) else v for v in vb], name
        na, nb = a.null_bitmap, b.null_bitmap
        assert (na is None) == (nb is None), name
        if nb is not None:
            np.testing.assert_array_equal(na, nb)
        assert (a.min_value, a.max_value) == (b.min_value, b.max_value), name
        assert (a.cardinality, a.has_dictionary, a.is_multi_value, a.max_num_values) == \
            (b.cardinality, b.has_dictionary, b.is_multi_value, b.max_num_values), name
        if a.is_multi_value:
            np.testing.assert_array_equal(a.mv_offsets, b.mv_offsets)
        ia, ib = a.inverted_index, b.inverted_index
        assert (ia is None) == (ib is None), name
        if ib is not None:
            assert ia.cardinality == ib.cardinality
            for d in range(ib.cardinality):
                np.testing.assert_array_equal(ia.doc_ids_for(d), ib.doc_ids_for(d))
            ids = list(range(0, ib.cardinality, 2))
            np.testing.assert_array_equal(ia.doc_ids_for_ids(ids), ib.doc_ids_for_ids(ids))
            assert ia.match_count_for_ids(ids) == ib.match_count_for_ids(ids)
        ta, tb = a.text_index, b.text_index
        assert (ta is None) == (tb is None), name
        if tb is not None:
            for q in TEXT_QUERIES:
                np.testing.assert_array_equal(ta.match(q), tb.match(q), err_msg=q)
    assert ours.snapshot_columns() == ref.snapshot_columns()


@pytest.mark.parametrize("lane", ["index", "index_batch"])
def test_mutable_segment_reader_surface_matches_the_reference(lane):
    schema = _mutable_schema()
    kw = dict(text_index_columns=["note"], inverted_index_columns=["site", "tags", "codes",
                                                                  "clicks"])
    ours = MutableSegment("m", schema, **kw)
    ref = JaxMutable("m", JSchema.from_json(schema.to_json()), **kw)
    assert ours.is_mutable and set(ours.inverted_indexes) == set(ref.inverted_indexes)
    for step, (n, shift) in enumerate(((150, 0), (90, 7), (1, 3), (210, 20))):
        rows = _mutable_rows(n, SEED + step, shift)
        if lane == "index":
            for r in rows:
                ours.index(r)
                ref.index(r)
        else:
            cols = {c: [r.get(c) for r in rows] for c in schema.column_names}
            assert ours.index_batch(cols) == ref.index_batch(cols) == n
        _same_readers(ours, ref)


def test_mutable_snapshot_is_bound_to_its_row_count():
    """A reader's snapshot and the inverted view bound to it stay in one id
    space while the segment grows."""
    seg = MutableSegment("m", _mutable_schema(), inverted_index_columns=["site"])
    for r in _mutable_rows(100, 3):
        seg.index(r)
    reader = seg.column("site")
    snap = reader.dict_snapshot()
    for r in _mutable_rows(50, 4, shift=-5):    # new values sort before the old ones
        seg.index(r)
    view = reader.inverted_view(snap)
    d, ids = snap[1], np.asarray(snap[2])
    for i in range(len(d)):
        np.testing.assert_array_equal(view.doc_ids_for(i), np.flatnonzero(ids == i))
    assert reader.dict_snapshot()[0] == 150 and snap[0] == 100


# -- the consumer ------------------------------------------------------------------

FULL_EVENTS, FULL_KEYS, FULL_FLUSH = 3300, 500, 1000
PARTIAL_EVENTS, PARTIAL_KEYS, PARTIAL_FLUSH = 1600, 200, 700
DEDUP_EVENTS, DEDUP_FLUSH = 1600, 600
STRATEGIES = {"lo_quantity": "INCREMENT", "lo_revenue": "MAX", "lo_discount": "OVERWRITE",
              "lo_orderdate": "IGNORE"}
# Q1.1's shape without its lo_orderdate band: at these sizes the writer keeps
# lo_orderdate raw (more distinct dates than its dictionary fraction of the
# rows), and a raw compare takes no band
BAND_QUERY = ("SELECT SUM(lo_extendedprice * lo_discount), COUNT(*) FROM lineorder "
              "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25")
KIND_QUERIES = {
    "full": ("count", "q1_1", "group", "for_sum", "bitmap_group", "region_asia", "top_revenue"),
    "partial": ("count", "partial_sums", "group", "q1_1"),
    "dedup": ("count", "q1_1", "text", "region_asia"),
}


def _table(kind, topic):
    """(port schema, port config, reference config, events)."""
    schema = ssb.upsert_schema(comment=kind == "dedup")
    idx = dict(inverted_index_columns=["lo_region", "lo_discount"],
               no_dictionary_columns=["lo_tax"],
               text_index_columns=["lo_comment"] if kind == "dedup" else [])
    if kind == "full":
        up, flush = dict(mode="FULL", comparison_column="lo_ts"), FULL_FLUSH
        events = ssb.make_upsert_events(FULL_EVENTS, FULL_KEYS, SEED)
    elif kind == "partial":
        up, flush = dict(mode="PARTIAL", partial_strategies=STRATEGIES), PARTIAL_FLUSH
        events = ssb.make_partial_events(PARTIAL_EVENTS, PARTIAL_KEYS, SEED)
    else:
        up, flush = None, DEDUP_FLUSH
        events = ssb.make_dedup_events(DEDUP_EVENTS, SEED)
    cfg = TableConfig("lineorder", stream=StreamConfig(topic=topic, flush_threshold_rows=flush),
                      indexing=IndexingConfig(**idx),
                      upsert=UpsertConfig(**up) if up else None, dedup_enabled=up is None)
    jcfg = JaxTableConfig("lineorder", table_type=JaxTableType.REALTIME,
                          stream=JaxStreamConfig(topic=topic, flush_threshold_rows=flush),
                          indexing=JaxIndexingConfig(**idx),
                          upsert=JaxUpsertConfig(**up) if up else None,
                          dedup_enabled=up is None)
    return schema, cfg, jcfg, events


class _Both:
    """One table consumed by both packages: each side's committed segments,
    its current consumer and its metadata managers."""

    def __init__(self, kind, tmp_path):
        self.kind, self.tmp = kind, tmp_path
        topic = f"up_{kind}"
        self.schema, self.cfg, self.jcfg, self.events = _table(kind, topic)
        self.jschema = JSchema.from_json(self.schema.to_json())
        self.streams = (MemoryStream.create(topic, 1), JaxMemoryStream.create(topic, 1))
        self.up = upsert.TableUpsertMetadataManager() if kind != "dedup" else None
        self.jup = jax_upsert.TableUpsertMetadataManager() if kind != "dedup" else None
        self.dedup = upsert.PartitionDedupMetadataManager() if kind == "dedup" else None
        self.jdedup = jax_upsert.PartitionDedupMetadataManager() if kind == "dedup" else None
        self.partial, self.jpartial = {}, {}
        self.ours, self.refs = [], []
        self.seq = 0
        self.produce(self.events)
        self._start(0)

    def produce(self, cols):
        for m in ssb.json_messages(cols, self.schema):
            for s in self.streams:
                s.produce(m, partition=0)

    def _start(self, offset):
        name = f"lineorder__0__{self.seq}__20261017T0000Z"
        self.c = RealtimePartitionConsumer(name, self.cfg, self.schema, offset,
                                           str(self.tmp / "ours"), device=CPU, upsert=self.up,
                                           dedup=self.dedup, partial_rows=self.partial)
        self.j = jax_realtime.RealtimePartitionConsumer(
            name, self.jcfg, self.jschema, offset, "server_0", None, str(self.tmp / "ref"),
            upsert=self.jup, dedup=self.jdedup, partial_rows=self.jpartial)

    def pump_all(self, commit=True):
        flush = self.cfg.stream.flush_threshold_rows
        end = len(self.streams[0].partitions[0])
        while self.c.offset < end:
            k = min(PUMP, flush - self.c.mutable.num_docs) if commit else PUMP
            assert self.c.pump(max_messages=k) == self.j.pump(max_messages=k)
            assert self.c.offset == self.j.offset and self.c.last_decode_path == "row"
            assert self.c.mutable.num_docs == self.j.mutable.num_docs
            if commit and self.c.end_criteria_reached():
                self.ours.append(load_segment(self.c.build_immutable()))
                self.refs.append(jax_load(self.j.build_immutable()))
                self.seq += 1
                self._start(self.c.offset)

    def segments(self):
        """Both sides' segments; the consuming one where it holds rows (the
        reference's server skips an empty one)."""
        if not self.c.mutable.num_docs:
            return list(self.ours), list(self.refs)
        return self.ours + [self.c.query_segment()], self.refs + [self.j.mutable]

    def ref_answer(self, sql):
        segs = self.segments()[1]
        ctx = jax_compile(sql, self.jschema)
        ex = JaxExecutor()
        parts = [ex.execute_segment(ctx, s, self.jup.valid_mask(s.name, s.num_docs)
                                    if self.jup else None) for s in segs]
        aggs = [jax_make_agg(f) for f in ctx.aggregations]
        return jax_reduce(ctx, jax_merge(parts, aggs), aggs, list(ctx.group_by)).rows

    def port_answer(self, sql):
        return execute_query(self.segments()[0], sql, device=CPU, upsert=self.up).rows


@pytest.mark.parametrize("kind", ["full", "partial", "dedup"])
def test_consumer_matches_the_reference_over_commits(kind, tmp_path):
    both = _Both(kind, tmp_path)
    both.pump_all()
    assert len(both.ours) >= 1 and isinstance(both.c.mutable, MutableSegment)
    ours, refs = both.segments()
    # every segment's rows and valid-doc mask as the reference's
    for a, b in zip(ours, refs):
        assert a.name == b.name and a.num_docs == b.num_docs
        for c in ("lo_orderkey", "lo_ts", "lo_quantity", "lo_revenue", "lo_region"):
            np.testing.assert_array_equal(np.asarray(a.column(c).values()),
                                          np.asarray(b.column(c).values()), err_msg=c)
        if both.up is not None:
            np.testing.assert_array_equal(both.up.valid_mask(a.name, a.num_docs),
                                          both.jup.valid_mask(b.name, b.num_docs))
    # ... and numpy's live rows
    keys_in_order = np.concatenate([np.asarray(s.column("lo_orderkey").values()) for s in ours])
    live = live_events(kind, both.events)
    if kind == "dedup":
        np.testing.assert_array_equal(keys_in_order, both.events["lo_orderkey"][live])
    else:
        visible = np.concatenate([both.up.valid_mask(s.name, s.num_docs) for s in ours])
        np.testing.assert_array_equal(np.flatnonzero(visible), live)
        assert both.up.partition(0).num_primary_keys == len(np.unique(both.events["lo_orderkey"]))
    for qid in KIND_QUERIES[kind]:
        sql = ssb.UPSERT_QUERIES[qid]
        got, want = both.port_answer(sql), both.ref_answer(sql)
        assert _match(got, want), (qid, got, want)


def test_full_upsert_requery_after_an_update_follows_the_version(tmp_path):
    """Updates to keys living in committed segments change Q1.1's answer; the
    band's device copy of each touched segment is staged again (a new key),
    and the answers equal the reference's and numpy's."""
    both = _Both("full", tmp_path)
    both.pump_all()
    seg0 = both.ours[0]
    sql = BAND_QUERY
    ctx = compile_query(sql, both.schema)
    first = both.port_answer(sql)
    assert _match(first, both.ref_answer(sql))
    plan = plan_segment(ctx, seg0, valid_docs=both.up.valid_mask(seg0.name, seg0.num_docs))
    assert scan_route(plan) == "masked_sums"
    key_before = block_for(seg0, executor_mod.resolve_device(CPU))._valid_band[0]
    assert key_before == plan.valid_docs.key
    # one more pump of updates to keys whose live row is in a committed segment
    committed_keys = np.unique(np.concatenate([
        np.asarray(s.column("lo_orderkey").values())[both.up.valid_mask(s.name, s.num_docs)]
        for s in both.ours]))
    rng = np.random.default_rng(SEED + 9)
    n_up = 300
    upd = ssb.make_update_events(rng.choice(committed_keys, n_up), int(both.events["lo_ts"].max()),
                                 SEED + 9)
    upd["lo_discount"] = np.full(n_up, 2, dtype=np.int32)     # inside Q1.1's band
    upd["lo_quantity"] = np.full(n_up, 3, dtype=np.int32)
    upd["lo_orderdate"] = np.full(n_up, 19930615, dtype=np.int32)
    both.produce(upd)
    both.pump_all(commit=False)
    second = both.port_answer(sql)
    assert not _match(second, first)
    assert _match(second, both.ref_answer(sql))
    key_after = block_for(seg0, executor_mod.resolve_device(CPU))._valid_band[0]
    assert key_after != key_before and key_after[3] == both.up.version(seg0.name)
    # numpy over the live events of the whole stream
    events = {c: np.concatenate([both.events[c], upd[c]]) for c in both.events}
    live = live_events("full", events)
    ours = both.segments()[0]
    visible = np.concatenate([both.up.valid_mask(s.name, s.num_docs) for s in ours])
    np.testing.assert_array_equal(np.flatnonzero(visible), live)
    m = np.zeros(len(events["lo_ts"]), dtype=bool)
    m[live] = True
    m &= ((events["lo_discount"] >= 1) & (events["lo_discount"] <= 3)
          & (events["lo_quantity"] < 25))
    want = float((events["lo_extendedprice"][m] * events["lo_discount"][m]).sum())
    assert math.isclose(second[0][0], want, rel_tol=REL) and second[0][1] == int(m.sum())


def test_partial_rows_merge_before_the_comparison(tmp_path):
    """A PARTIAL table stores each key's merged row; the live row of a key
    carries INCREMENT, MAX, OVERWRITE and IGNORE over all its events."""
    both = _Both("partial", tmp_path)
    both.pump_all()
    ev = both.events
    key = ev["lo_orderkey"]
    for k in np.unique(key)[:25].tolist():
        idx = np.flatnonzero(key == k)
        row = both.partial[(k,)]
        assert row == both.jpartial[(k,)]
        assert row["lo_quantity"] == int(ev["lo_quantity"][idx].sum())
        assert row["lo_revenue"] == float(ev["lo_revenue"][idx].max())
        assert row["lo_discount"] == int(ev["lo_discount"][idx[-1]])
        assert row["lo_orderdate"] == int(ev["lo_orderdate"][idx[0]])
        assert row["lo_region"] == ev["lo_region"][idx[-1]]


def test_late_events_are_indexed_and_stay_invisible(tmp_path):
    both = _Both("full", tmp_path)
    both.pump_all()
    ours = both.segments()[0]
    assert sum(s.num_docs for s in ours) == FULL_EVENTS     # every event indexed
    ts = np.concatenate([np.asarray(s.column("lo_ts").values()) for s in ours])
    visible = np.concatenate([both.up.valid_mask(s.name, s.num_docs) for s in ours])
    key = both.events["lo_orderkey"]
    late = np.zeros(FULL_EVENTS, dtype=bool)
    for k in np.unique(key).tolist():
        idx = np.flatnonzero(key == k)
        late[idx[1:]] = ts[idx[1:]] < np.maximum.accumulate(ts[idx])[:-1]
    assert late.sum() > 0 and not (visible & late).any()


def test_dedup_drops_resends_after_a_commit(tmp_path):
    both = _Both("dedup", tmp_path)
    both.pump_all()
    keys = np.concatenate([np.asarray(s.column("lo_orderkey").values())
                           for s in both.segments()[0]])
    assert len(keys) == len(np.unique(keys)) == len(np.unique(both.events["lo_orderkey"]))
    committed = set(np.asarray(both.ours[0].column("lo_orderkey").values()).tolist())
    ev = both.events["lo_orderkey"]
    resent_after = [i for i in range(DEDUP_FLUSH, DEDUP_EVENTS) if int(ev[i]) in committed]
    assert resent_after    # re-sends of committed keys came after the commit, and were dropped


# -- the class choice and the block-stream refusal -------------------------------------

@pytest.mark.parametrize("case", ["plain", "upsert", "dedup", "text", "inverted", "unvectorized",
                                  "absent_columns"])
def test_consumer_class_choice_matches_the_reference(case, tmp_path):
    schema = ssb.upsert_schema(comment=True)
    idx = {"text": dict(text_index_columns=["lo_comment"]),
           "inverted": dict(inverted_index_columns=["lo_region"]),
           "absent_columns": dict(text_index_columns=["nope"],
                                  inverted_index_columns=["nope"])}.get(case, {})
    props = {"realtime.ingest.vectorized": "false"} if case == "unvectorized" else {}
    MemoryStream.create("choice", 1)
    JaxMemoryStream.create("choice", 1)
    up = {"upsert": (upsert.TableUpsertMetadataManager(), jax_upsert.TableUpsertMetadataManager()),
          "dedup": (upsert.PartitionDedupMetadataManager(),
                    jax_upsert.PartitionDedupMetadataManager())}.get(case)
    kw = {case: up[0]} if up else {}
    jkw = {case: up[1]} if up else {}
    ours = RealtimePartitionConsumer(
        "lineorder__0__0__x", TableConfig("lineorder", stream=StreamConfig(
            topic="choice", properties=props), indexing=IndexingConfig(**idx)),
        schema, 0, str(tmp_path), device=CPU, **kw)
    ref = jax_realtime.RealtimePartitionConsumer(
        "lineorder__0__0__x", JaxTableConfig("lineorder", table_type=JaxTableType.REALTIME,
                                             stream=JaxStreamConfig(topic="choice",
                                                                    properties=props),
                                             indexing=JaxIndexingConfig(**idx)),
        JSchema.from_json(schema.to_json()), 0, "server_0", None, str(tmp_path), **jkw)
    assert type(ours.mutable).__name__ == type(ref.mutable).__name__
    assert isinstance(ours.mutable, DeviceMutableSegment if case in ("plain", "absent_columns")
                      else MutableSegment)
    assert ours.query_segment() is (ours.mutable if isinstance(ours.mutable, MutableSegment)
                                    else ours.mutable.query_view())


@pytest.mark.parametrize("hook", ["upsert", "dedup"])
def test_block_stream_with_upsert_or_dedup_raises(hook, tmp_path):
    MemoryStream.create("blocks", 1)
    mgr = upsert.TableUpsertMetadataManager() if hook == "upsert" \
        else upsert.PartitionDedupMetadataManager()
    with pytest.raises(ValueError, match="columnar block stream"):
        RealtimePartitionConsumer("lineorder__0__0__x", TableConfig(
            "lineorder", stream=StreamConfig(topic="blocks", decoder="columnar")),
            ssb.upsert_schema(), 0, str(tmp_path), device=CPU, **{hook: mgr})


def test_block_stream_into_a_row_append_segment(tmp_path):
    """A block stream of a table with a realtime index indexes its blocks as
    column lists into the MutableSegment, as the reference does."""
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    schema = ssb.ssb_schema()
    cols = ssb.make_columns(700, SEED)
    stream = MemoryStream.create("rows_blocks", 1)
    for lo in range(0, 700, 300):
        stream.produce(encode_columnar_block(schema, {c: v[lo:lo + 300].tolist()
                                                      for c, v in cols.items()}), partition=0)
    c = RealtimePartitionConsumer("lineorder__0__0__x", TableConfig(
        "lineorder", stream=StreamConfig(topic="rows_blocks", decoder="columnar"),
        indexing=IndexingConfig(inverted_index_columns=["lo_region"])),
        schema, 0, str(tmp_path), device=CPU)
    assert c.pump() == 700 and c.last_decode_path == "blocks"
    got = execute_query([c.query_segment()], "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder "
                        "WHERE lo_region = 'ASIA'", device=CPU).rows
    m = cols["lo_region"] == "ASIA"
    assert got == [[int(m.sum()), float(cols["lo_quantity"][m].sum())]]


def test_table_config_json_keys_match_the_reference():
    j = JaxTableConfig("t", table_type=JaxTableType.REALTIME,
                       stream=JaxStreamConfig(topic="x", flush_threshold_rows=5,
                                              properties={"a": "b"}),
                       upsert=JaxUpsertConfig("PARTIAL", "ts", {"q": "MAX"}),
                       dedup_enabled=True,
                       indexing=JaxIndexingConfig(inverted_index_columns=["q"],
                                                  text_index_columns=["s"],
                                                  raw_compression="zlib"))
    ours = TableConfig.from_json(j.to_json())
    assert ours.upsert == UpsertConfig("PARTIAL", "ts", {"q": "MAX"}) and ours.dedup_enabled
    assert (ours.stream.topic, ours.stream.flush_threshold_rows) == ("x", 5)
    assert ours.indexing.text_index_columns == ["s"] and ours.indexing.raw_compression == "zlib"
    back = JaxTableConfig.from_json(ours.to_json())
    assert (back.upsert, back.dedup_enabled, back.indexing) == (j.upsert, True, j.indexing)


def test_apply_rows_is_apply_row_one_at_a_time():
    schema = ssb.upsert_schema(comment=True)
    pipe = TransformPipeline(schema, filter_expr="lo_quantity > 40",
                             column_transforms={"lo_tax": "lo_quantity % 9"})
    ev = ssb.make_dedup_events(300, SEED)
    rows = [json.loads(m) for m in ssb.json_messages(ev, schema)]
    rows[3]["lo_revenue"] = None
    rows[4]["lo_quantity"] = "12"
    assert pipe.apply_rows(rows) == [pipe.apply_row(r) for r in rows]
    assert any(r is None for r in pipe.apply_rows(rows))


# -- the scan with the valid band ---------------------------------------------------

@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    schema = ssb.upsert_schema()
    cols = ssb.make_upsert_events(6000, 900, SEED + 4)
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig
    segs = segments_from_columns(schema, cols, str(tmp_path_factory.mktemp("band")), 2,
                                 SegmentGeneratorConfig(no_dictionary_columns=["lo_tax"],
                                                        inverted_index_columns=["lo_discount"]))
    return schema, cols, segs


def _plain_body(ex, plan):
    """The plan's answer through the plain body, the scan route skipped."""
    saved = executor_mod.scan_route
    executor_mod.scan_route = lambda p: None
    try:
        return ex._device_aggregate(plan)
    finally:
        executor_mod.scan_route = saved


@pytest.mark.parametrize("qid,route", [("band", "masked_sums"), ("count", "masked_sums"),
                                       ("for_sum", "masked_sums_fused")])
def test_banded_scan_matches_the_plain_body_under_the_mask(committed, qid, route):
    schema, cols, segs = committed
    rng = np.random.default_rng(SEED)
    mgr = upsert.PartitionUpsertMetadataManager()
    for s in segs:
        for d in range(s.num_docs):
            mgr.add_record(s.name, d, (int(rng.integers(0, 2000)),), None)
    ex = ServerQueryExecutor(CPU)
    ctx = compile_query(BAND_QUERY if qid == "band" else ssb.UPSERT_QUERIES[qid], schema)
    for s in segs:
        mask = mgr.valid_mask(s.name, s.num_docs)
        plan = plan_segment(ctx, s, valid_docs=mask)
        assert scan_route(plan) == route
        got = ex._device_aggregate(plan).scalar
        want = _plain_body(ex, plan_segment(ctx, s, valid_docs=mask)).scalar
        assert _match([got], [want]), (got, want)
        # the star-tree's record mask (a plain array) keeps the plain body
        assert scan_route(plan_segment(ctx, s, valid_docs=np.asarray(mask))) is None


def test_banded_scan_plain_versions(committed):
    """The band is one more int32 mask column with the band (1, 1), for both
    scans' plain versions."""
    import torch
    _, cols, segs = committed
    n = segs[0].num_docs
    rng = np.random.default_rng(SEED + 1)
    live = rng.random(n) < 0.3
    band = torch.from_numpy(live.astype(np.int32))
    disc = torch.from_numpy(cols["lo_discount"][:n].astype(np.int32))
    rev = torch.from_numpy(cols["lo_revenue"][:n].astype(np.float32))
    sums, count = scan.masked_sums([disc, band], [(1, 3), (1, 1)], [rev])
    m = live & (cols["lo_discount"][:n] >= 1) & (cols["lo_discount"][:n] <= 3)
    assert int(count) == int(m.sum())
    assert math.isclose(float(sums[0]), float(cols["lo_revenue"][:n][m].sum()), rel_tol=REL)
    deltas = torch.from_numpy(cols["lo_tax"][:n].astype(np.uint8))
    fsums, fcount = scan.masked_sums_fused([disc, band], [(1, 3), (1, 1)], [(0.0, deltas)])
    assert int(fcount) == int(m.sum()) and float(fsums[0]) == float(cols["lo_tax"][:n][m].sum())


def test_band_limit_falls_back_to_the_plain_body(tmp_path):
    """A plan with MAX_MASK_COLS id bands has no band free for the mask: the
    plain body answers it, ANDing the mask into `valid`."""
    k = scan.MAX_MASK_COLS
    schema = Schema("t", [metric(f"c{i}", DataType.INT) for i in range(k)]
                    + [metric("v", DataType.DOUBLE)])
    rng = np.random.default_rng(SEED + 5)
    n = 2000
    cols = {f"c{i}": rng.integers(0, 10, n).astype(np.int32) for i in range(k)}
    cols["v"] = np.round(rng.random(n) * 100, 2)
    seg = segments_from_columns(schema, cols, str(tmp_path), 1)[0]
    where = " AND ".join(f"c{i} BETWEEN 1 AND 8" for i in range(k))
    ctx = compile_query(f"SELECT COUNT(*), SUM(v) FROM t WHERE {where}", schema)
    mgr = upsert.PartitionUpsertMetadataManager()
    for d in range(0, n, 3):
        mgr.add_record(seg.name, d, (d,), None)
    mask = mgr.valid_mask(seg.name, n)
    plan = plan_segment(ctx, seg, valid_docs=mask)
    assert len(executor_mod._band_leaf_indices(plan)) == k
    assert scan_route(plan) is None and scan_route(plan_segment(ctx, seg)) == "masked_sums"
    got = ServerQueryExecutor(CPU).execute_segment(ctx, seg, mask).scalar
    m = mask.copy()
    for i in range(k):
        m &= (cols[f"c{i}"] >= 1) & (cols[f"c{i}"] <= 8)
    assert got[0] == int(m.sum()) and math.isclose(got[1], float(cols["v"][m].sum()),
                                                   rel_tol=REL)


# -- the reference's tests/test_upsert.py cases, on the port ---------------------------

def _orders_schema():
    return Schema("orders", [dimension("order_id", DataType.STRING),
                             dimension("status", DataType.STRING),
                             metric("amount", DataType.DOUBLE)],
                  primary_key_columns=["order_id"])


class _Orders:
    """The reference tests' `orders` table on the port: one partition, the
    consumer's commits done by hand (build, load, next consumer)."""

    def __init__(self, tmp_path, upsert_cfg=None, dedup=False, flush=1000):
        self.tmp = tmp_path
        self.stream = MemoryStream.create("orders_topic", 1)
        self.cfg = TableConfig("orders", stream=StreamConfig(topic="orders_topic",
                                                             flush_threshold_rows=flush),
                               upsert=upsert_cfg, dedup_enabled=dedup)
        self.up = upsert.TableUpsertMetadataManager() if upsert_cfg else None
        self.dedup = upsert.PartitionDedupMetadataManager() if dedup else None
        self.partial = {}
        self.committed = []
        self.seq = 0
        self._start(0)

    def _start(self, offset):
        self.c = RealtimePartitionConsumer(
            f"orders__0__{self.seq}__20261017T0000Z", self.cfg, _orders_schema(), offset,
            str(self.tmp), device=CPU, upsert=self.up, dedup=self.dedup,
            partial_rows=self.partial)

    def produce(self, rows):
        for r in rows:
            self.stream.produce(json.dumps(r), partition=0)

    def pump(self):
        """One pump; a segment that reached its threshold commits."""
        self.c.pump()
        if self.c.end_criteria_reached():
            self.committed.append(load_segment(self.c.build_immutable()))
            self.seq += 1
            self._start(self.c.offset)

    def query(self, sql):
        return execute_query(self.committed + [self.c.query_segment()], sql, device=CPU,
                             upsert=self.up)


def _case_partition_manager_basics(tmp_path):
    m = upsert.PartitionUpsertMetadataManager()
    assert m.add_record("s1", 0, ("k1",), 10)
    assert m.add_record("s1", 1, ("k2",), 10)
    assert m.add_record("s2", 0, ("k1",), 20)
    np.testing.assert_array_equal(m.valid_mask("s1", 2), [False, True])
    np.testing.assert_array_equal(m.valid_mask("s2", 1), [True])
    assert not m.add_record("s2", 1, ("k1",), 5)
    np.testing.assert_array_equal(m.valid_mask("s2", 2), [True, False])
    assert m.num_primary_keys == 2


def _case_dedup_manager(tmp_path):
    d = upsert.PartitionDedupMetadataManager()
    assert d.check_and_add(("a",))
    assert not d.check_and_add(("a",))
    assert d.check_and_add(("b",))


def _case_merge_partial_strategies(tmp_path):
    mp = upsert.merge_partial
    assert mp("OVERWRITE", 1, 2) == 2 and mp("IGNORE", 1, 2) == 1
    assert mp("INCREMENT", 1, 2) == 3 and mp("MAX", 1, 2) == 2 and mp("MIN", 1, 2) == 1
    assert mp("APPEND", ["a"], "b") == ["a", "b"]
    assert mp("UNION", ["a"], ["a", "b"]) == ["a", "b"]
    assert mp("OVERWRITE", None, 5) == 5 and mp("OVERWRITE", 5, None) == 5


def _case_full_upsert_end_to_end(tmp_path):
    t = _Orders(tmp_path, UpsertConfig(mode="FULL"))
    t.produce([{"order_id": "o1", "status": "NEW", "amount": 10.0},
               {"order_id": "o2", "status": "NEW", "amount": 20.0},
               {"order_id": "o1", "status": "SHIPPED", "amount": 10.0},
               {"order_id": "o1", "status": "DELIVERED", "amount": 10.0}])
    t.pump()
    res = t.query("SELECT COUNT(*), SUM(amount) FROM orders")
    assert res.rows[0][0] == 2 and res.rows[0][1] == pytest.approx(30.0)
    res2 = t.query("SELECT status, COUNT(*) FROM orders GROUP BY status LIMIT 10")
    assert dict((r[0], r[1]) for r in res2.rows) == {"DELIVERED": 1, "NEW": 1}


def _case_partial_upsert_increment(tmp_path):
    t = _Orders(tmp_path, UpsertConfig(mode="PARTIAL", partial_strategies={
        "amount": "INCREMENT", "status": "OVERWRITE"}))
    t.produce([{"order_id": "o1", "status": "NEW", "amount": 10.0},
               {"order_id": "o1", "status": "PAID", "amount": 5.0},
               {"order_id": "o1", "status": "PAID", "amount": 2.0}])
    t.pump()
    res = t.query("SELECT status, SUM(amount) FROM orders GROUP BY status LIMIT 5")
    assert res.rows == [["PAID", 17.0]]


def _case_dedup_end_to_end(tmp_path):
    t = _Orders(tmp_path, dedup=True)
    t.produce([{"order_id": "o1", "status": "NEW", "amount": 10.0},
               {"order_id": "o1", "status": "DUPLICATE", "amount": 99.0},
               {"order_id": "o2", "status": "NEW", "amount": 20.0}])
    t.pump()
    res = t.query("SELECT COUNT(*), SUM(amount) FROM orders")
    assert res.rows[0][0] == 2 and res.rows[0][1] == pytest.approx(30.0)


def _case_upsert_survives_commit(tmp_path):
    t = _Orders(tmp_path, UpsertConfig(mode="FULL"), flush=4)
    t.produce([{"order_id": "o1", "status": "NEW", "amount": 1.0},
               {"order_id": "o2", "status": "NEW", "amount": 2.0},
               {"order_id": "o1", "status": "PAID", "amount": 1.0},
               {"order_id": "o3", "status": "NEW", "amount": 3.0}])
    for _ in range(4):
        t.pump()
    assert len(t.committed) == 1
    t.produce([{"order_id": "o2", "status": "CANCELLED", "amount": 2.0}])
    t.pump()
    assert t.query("SELECT COUNT(*) FROM orders").rows[0][0] == 3
    res2 = t.query("SELECT status, COUNT(*) FROM orders GROUP BY status LIMIT 10")
    assert dict((r[0], r[1]) for r in res2.rows) == {"PAID": 1, "NEW": 1, "CANCELLED": 1}


REFERENCE_CASES = {
    "partition_upsert_manager_basics": _case_partition_manager_basics,
    "dedup_manager": _case_dedup_manager,
    "merge_partial_strategies": _case_merge_partial_strategies,
    "full_upsert_end_to_end": _case_full_upsert_end_to_end,
    "partial_upsert_increment": _case_partial_upsert_increment,
    "dedup_end_to_end": _case_dedup_end_to_end,
    "upsert_survives_commit": _case_upsert_survives_commit,
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_upsert_cases_on_the_port(case, tmp_path):
    REFERENCE_CASES[case](tmp_path)


# -- the smoke's phase, rehearsed ------------------------------------------------------

def test_the_smoke_upsert_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `upsert` phase at 1/128 of its size (segments of 4,096
    rows, enough for lo_orderdate's dictionary) with the card's calls pointed
    at the CPU, its streams made by `start_upsert_builds`'s jobs: every
    answer, mask and launch check of the phase passes (the kernels' calls
    counted as launches), and the banded cases run."""
    import concurrent.futures

    import torch

    import chip_smoke
    from pinot_tpu_torch.engine import kernels

    cpu = torch.device(CPU)
    monkeypatch.setattr(executor_mod, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    counts = {"masked_sums": 0, "masked_sums_fused": 0, "bitmap_filter": 0,
              "grouped_agg": 0}
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
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, flush: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, flush: (fn(), 1.0)[1])
    for name, value in (("UPSERT_EVENTS", 16_384), ("UPSERT_KEYS", 4_096),
                        ("UPSERT_FLUSH", 4_096), ("UPSERT_PARTIAL", (8_192, 2_048, 4_096)),
                        ("UPSERT_DEDUP", (8_192, 4_096)), ("UPSERT_UPDATES", 1_024),
                        ("UPSERT_RUNS", 1), ("L2_FLUSH_BYTES", 8)):
        monkeypatch.setattr(chip_smoke, name, value)

    class Args:
        seed, trace = SEED, False
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = chip_smoke.start_upsert_builds(pool, Args())
        launches, cases = chip_smoke.run_upsert(Args(), str(tmp_path), jobs)
    # masked_sums: COUNT(*), Q1.1, lo_region = 'ASIA' and Q1.1 after the update
    # on 3 committed segments, COUNT(*) and Q1.1 on PARTIAL's one, Q1.1 on dedup's
    # grouped_agg: the FULL table's two GROUP BYs, one a committed segment
    assert launches == {"masked_sums": 15, "masked_sums_fused": 3, "bitmap_filter": 3,
                        "grouped_agg": 6}
    assert sorted(cases) == ["for_sum, banded", "for_sum, unbanded", "q1_1, banded",
                             "q1_1, unbanded"]
    assert cases["q1_1, banded"]["bytes_per_row"] == 20
    assert cases["for_sum, banded"]["bytes_per_row"] == 9
    assert cases["q1_1, banded"]["count"] <= cases["q1_1, unbanded"]["count"]
