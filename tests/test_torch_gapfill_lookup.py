"""pinot_tpu_torch's GAPFILL/FILL and LOOKUP against the JAX package's.

The JAX package's own cases (`tests/test_gapfill_lookup.py`) run through
both packages over segments each package loads from the same directory, on
the CPU, and answer alike (host answers exactly, device sums rel 1e-5):

* GAPFILL with FILL_PREVIOUS_VALUE, FILL_DEFAULT_VALUE and no FILL, the
  validation errors, the ORDER BY re-sort after the fill, OFFSET and LIMIT
  over the filled rows, several series keys, and GAPFILL over SSB segments
  per segment and over a stacked set (the inner GROUP BY is a device plan
  whose `lo_discount = 2` leaf takes the bitmap filter);
* LOOKUP with hits, misses (None, an object column), hits only (the value
  column's dtype), composite keys, a dimension table of zero segments (every
  key misses), LOOKUP inside SUM and in GROUP BY, and
  `register_dim_table_from_segments` (per segment and through the set
  executor); every plan that holds it is a host plan.
"""

import math

import numpy as np
import pytest

from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.query.context import QueryValidationError as JaxValidationError
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import execute_query as jax_execute
from pinot_tpu.query.lookup import REGISTRY as JAX_REGISTRY
from pinot_tpu.query.lookup import DimensionTable as JaxDimensionTable
from pinot_tpu.query.lookup import register_dim_table_from_segments as jax_register
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu_torch import ssb
from pinot_tpu_torch.engine import bitmap
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.context import QueryValidationError, compile_query
from pinot_tpu_torch.query.executor import execute_query
from pinot_tpu_torch.query.lookup import REGISTRY, DimensionTable, register_dim_table_from_segments
from pinot_tpu_torch.query.planner import plan_segment
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.segment.writer import build_aligned_segments

CPU = "cpu"
SEED = 20261114
REL = 1e-5


def _close(a, b, rel=REL) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        return math.isclose(a, b, rel_tol=rel, abs_tol=1e-6)
    return a == b


def _rows_match(got, want, rel=REL) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_close(x, y, rel) for x, y in zip(g, w))
        for g, w in zip(got, want))


def _both(path):
    return [load_segment(path)], [jax_load(path)]


# -- GAPFILL -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tseg(tmp_path_factory):
    schema = Schema("events", [dimension("ts", DataType.LONG),
                               dimension("host", DataType.STRING),
                               dimension("dc", DataType.STRING),
                               metric("v", DataType.DOUBLE)])
    # buckets of 10; host a has data at 0, 10, 30, host b at 10, 20
    cols = {"ts": np.array([0, 10, 30, 10, 20, 30], dtype=np.int64),
            "host": ["a", "a", "a", "b", "b", "b"],
            "dc": ["x", "x", "x", "y", "y", "x"],
            "v": np.array([1.0, 2.0, 3.0, 5.0, 6.0, 7.0])}
    out = tmp_path_factory.mktemp("gap")
    return _both(SegmentBuilder(schema).build(cols, str(out), "ev_0"))


GAPFILL_QUERIES = [
    ("previous", "SELECT GAPFILL(ts, 0, 40, 10), host, FILL(SUM(v), 'FILL_PREVIOUS_VALUE') "
     "FROM events WHERE dc <> 'x' OR host = 'a' GROUP BY ts, host LIMIT 100"),
    ("default", "SELECT GAPFILL(ts, 0, 40, 10), host, FILL(SUM(v), 'FILL_DEFAULT_VALUE', 0) "
     "FROM events GROUP BY ts, host LIMIT 100"),
    ("unfilled", "SELECT GAPFILL(ts, 0, 40, 10), host, SUM(v), COUNT(*) "
     "FROM events GROUP BY ts, host LIMIT 100"),
    ("both_modes", "SELECT GAPFILL(ts, -10, 50, 10), host, FILL(SUM(v), 'FILL_PREVIOUS_VALUE'), "
     "FILL(COUNT(*), 'FILL_DEFAULT_VALUE', 0) FROM events GROUP BY ts, host LIMIT 100"),
    ("order_by", "SELECT GAPFILL(ts, 0, 40, 10), host, FILL(SUM(v), 'FILL_DEFAULT_VALUE', -1) "
     "FROM events GROUP BY ts, host ORDER BY ts DESC, host LIMIT 100"),
    ("order_by_value", "SELECT GAPFILL(ts, 0, 40, 10), host, "
     "FILL(SUM(v), 'FILL_PREVIOUS_VALUE') FROM events GROUP BY ts, host "
     "ORDER BY SUM(v) DESC LIMIT 100"),
    ("offset_limit", "SELECT GAPFILL(ts, 0, 40, 10), host, FILL(MAX(v), 'FILL_PREVIOUS_VALUE') "
     "FROM events GROUP BY ts, host ORDER BY host, ts LIMIT 3 OFFSET 2"),
    ("two_keys", "SELECT GAPFILL(ts, 0, 40, 10), host, dc, FILL(SUM(v), 'FILL_DEFAULT_VALUE', 0) "
     "FROM events GROUP BY ts, host, dc LIMIT 100"),
    ("coarse_bucket", "SELECT GAPFILL(ts, 0, 60, 20), host, FILL(COUNT(*), "
     "'FILL_DEFAULT_VALUE', 0) FROM events GROUP BY ts, host LIMIT 100"),
]


@pytest.mark.parametrize("qid, sql", GAPFILL_QUERIES, ids=[q for q, _ in GAPFILL_QUERIES])
def test_gapfill_matches_the_reference(tseg, qid, sql):
    segs, jsegs = tseg
    got = execute_query(segs, sql, device=CPU)
    want = jax_execute(jsegs, sql)
    assert got.columns == want.columns
    assert got.rows == want.rows
    assert got.stats["gapfilled"] is True


def test_gapfill_fills_as_the_reference_cases_say(tseg):
    """The JAX package's assertions, on the port's answer."""
    segs, _ = tseg
    r = execute_query(segs, "SELECT GAPFILL(ts, 0, 40, 10), host, "
                            "FILL(SUM(v), 'FILL_PREVIOUS_VALUE') FROM events "
                            "WHERE dc <> 'x' OR host = 'a' GROUP BY ts, host LIMIT 100",
                      device=CPU)
    rows = {(row[1], row[0]): row[2] for row in r.rows}
    assert rows == {("a", 0): 1.0, ("a", 10): 2.0, ("a", 20): 2.0, ("a", 30): 3.0,
                    ("b", 0): None, ("b", 10): 5.0, ("b", 20): 6.0, ("b", 30): 6.0}
    r = execute_query(segs, GAPFILL_QUERIES[1][1], device=CPU)
    rows = {(row[1], row[0]): row[2] for row in r.rows}
    assert rows[("a", 20)] == 0 and rows[("b", 0)] == 0
    r = execute_query(segs, GAPFILL_QUERIES[2][1], device=CPU)
    rows = {(row[1], row[0]): (row[2], row[3]) for row in r.rows}
    assert rows[("a", 20)] == (None, None)


@pytest.mark.parametrize("sql, match", [
    ("SELECT GAPFILL(ts, 0, 40) FROM events GROUP BY ts", "GAPFILL"),
    ("SELECT ts, FILL(SUM(v), 'FILL_DEFAULT_VALUE') FROM events GROUP BY ts", "FILL requires"),
    ("SELECT GAPFILL(ts, 0, 40, 10), GAPFILL(ts, 0, 40, 10), COUNT(*) FROM events "
     "GROUP BY ts", "only one GAPFILL"),
    ("SELECT GAPFILL(ts, 0, 40, 0), COUNT(*) FROM events GROUP BY ts", "bucket must be positive"),
    ("SELECT GAPFILL(ts, 0, host, 10), COUNT(*) FROM events GROUP BY ts", "literal bounds"),
    ("SELECT GAPFILL(ts, 0, 40, 10), FILL(COUNT(*), 'FILL_LINEAR') FROM events GROUP BY ts",
     "unknown FILL mode"),
    ("SELECT GAPFILL(ts, 0, 40, 10), FILL(COUNT(*)) FROM events GROUP BY ts", "FILL\\(expr"),
], ids=["arity", "fill_without_gapfill", "two_gapfills", "bucket", "bounds", "mode",
        "fill_arity"])
def test_gapfill_validation_errors_are_the_reference_errors(sql, match):
    with pytest.raises(QueryValidationError, match=match) as got:
        compile_query(sql)
    with pytest.raises(JaxValidationError) as want:
        jax_compile(sql)
    assert str(got.value) == str(want.value)


SSB_GAPFILL = ("SELECT GAPFILL(lo_orderdate, 19920202, 19920230, 1), lo_region, "
               "FILL(SUM(lo_revenue), 'FILL_PREVIOUS_VALUE'), "
               "FILL(COUNT(*), 'FILL_DEFAULT_VALUE', 0) FROM lineorder "
               "WHERE lo_orderdate BETWEEN 19920202 AND 19920229 AND lo_discount = 2 "
               "AND lo_quantity < 12 GROUP BY lo_orderdate, lo_region LIMIT 1000")


def gapfill_oracle(cols, lo: int, hi: int, quantity_below: int):
    """The reference's fill rules over a numpy filter of the generated rows:
    each region seen, each day of [lo, hi), FILL_PREVIOUS_VALUE for the sum
    and 0 for the count; series in first-seen order of the grouped rows is
    not asserted here (the rows are compared as a set)."""
    m = ((cols["lo_orderdate"] >= lo) & (cols["lo_orderdate"] < hi)
         & (cols["lo_discount"] == 2) & (cols["lo_quantity"] < quantity_below))
    cells = {}
    for d, r, v in zip(cols["lo_orderdate"][m], cols["lo_region"][m], cols["lo_revenue"][m]):
        s, c = cells.get((int(d), r), (0.0, 0))
        cells[(int(d), r)] = (s + float(v), c + 1)
    out = {}
    for region in {r for _, r in cells}:
        prev = None
        for day in range(lo, hi):
            if (day, region) in cells:
                prev, count = cells[(day, region)]
                out[(day, region)] = (prev, count)
            else:
                out[(day, region)] = (prev, 0)
    return out, len(cells)


@pytest.fixture(scope="module")
def ssb_env(tmp_path_factory):
    cols = ssb.make_columns(60_000, SEED)
    paths = build_aligned_segments(ssb.ssb_schema(), cols,
                                   str(tmp_path_factory.mktemp("ssbgap")), "lineorder", 3)
    return cols, [load_segment(p) for p in paths], [jax_load(p) for p in paths]


def test_gapfill_over_ssb_per_segment_and_over_the_set(ssb_env, monkeypatch):
    cols, segs, jsegs = ssb_env
    plan = plan_segment(compile_query(SSB_GAPFILL, segs[0].schema), segs[0])
    assert plan.kind == "device"
    launches = []
    real = bitmap.bitmap_filter_plain

    def counted(*a, **k):
        launches.append(1)
        return real(*a, **k)
    monkeypatch.setattr(bitmap, "bitmap_filter_plain", counted)
    want = jax_execute(jsegs, SSB_GAPFILL).rows
    per_segment = execute_query(segs, SSB_GAPFILL, device=CPU).rows
    # the lo_discount and lo_quantity leaves are selective dictionary leaves
    # of a mixed tree: one bitmap mask each, per segment and over the set
    assert len(launches) == 2 * len(segs)
    stacked = MeshQueryExecutor(device=CPU).execute(segs, SSB_GAPFILL).rows
    assert len(launches) == 2 * len(segs) + 2
    # the series come in first-seen order of the merged groups, which is the
    # set path's dense order over a stacked set: each path is held to the
    # JAX package's same path
    want_stacked = JaxMeshExecutor(default_mesh(1)).execute(jsegs, SSB_GAPFILL).rows
    oracle, filled = gapfill_oracle(cols, 19920202, 19920230, 12)
    assert 0 < filled < len(oracle)    # gap rows exist
    for got, ref in ((per_segment, want), (stacked, want_stacked)):
        assert _rows_match(got, ref)
        assert len(got) == len(oracle)
        for day, region, s, c in got:
            ws, wc = oracle[(day, region)]
            assert c == wc
            assert (s is None) == (ws is None)
            assert s is None or math.isclose(s, ws, rel_tol=REL)


# -- LOOKUP ------------------------------------------------------------------------

DIM_HOSTS = {"hostname": np.array(["a", "b", "c"], dtype=object),
             "dc": np.array(["us-east", "eu-west", "us-east"], dtype=object),
             "cores": np.array([8, 16, 32], dtype=np.int64)}
DIM_PAIRS = {"host": np.array(["a", "a", "b"], dtype=object),
             "rack": np.array([1, 2, 1], dtype=np.int64),
             "owner": np.array(["ann", "bob", "cy"], dtype=object)}


@pytest.fixture(scope="module")
def lookup_env(tmp_path_factory):
    for reg, table in ((REGISTRY, DimensionTable), (JAX_REGISTRY, JaxDimensionTable)):
        reg.register(table("dim_hosts", ["hostname"], DIM_HOSTS))
        reg.register(table("dim_pairs", ["host", "rack"], DIM_PAIRS))
        reg.register(table("dim_empty", ["hostname"], {}))
    schema = Schema("metrics", [dimension("host", DataType.STRING),
                                dimension("rack", DataType.INT),
                                metric("load", DataType.DOUBLE)])
    cols = {"host": ["a", "b", "a", "x", "b"],
            "rack": np.array([1, 1, 2, 1, 3], dtype=np.int32),
            "load": np.array([0.5, 0.6, 0.7, 0.9, 0.25])}
    out = tmp_path_factory.mktemp("lkp")
    yield _both(SegmentBuilder(schema).build(cols, str(out), "m_0"))
    for name in ("dim_hosts", "dim_pairs", "dim_empty"):
        REGISTRY.unregister(name)
        JAX_REGISTRY.unregister(name)


LOOKUP_QUERIES = [
    ("selection", "SELECT host, LOOKUP('dim_hosts', 'dc', 'hostname', host), load "
     "FROM metrics LIMIT 10"),
    ("group_by", "SELECT LOOKUP('dim_hosts', 'dc', 'hostname', host), SUM(load) "
     "FROM metrics GROUP BY LOOKUP('dim_hosts', 'dc', 'hostname', host) LIMIT 10"),
    ("numeric_sum", "SELECT SUM(LOOKUP('dim_hosts', 'cores', 'hostname', host)) "
     "FROM metrics WHERE host <> 'x' LIMIT 10"),
    ("hits_only", "SELECT host, LOOKUP('dim_hosts', 'cores', 'hostname', host) FROM metrics "
     "WHERE host IN ('a', 'b') LIMIT 10"),
    ("composite", "SELECT host, rack, LOOKUP('dim_pairs', 'owner', 'host', host, 'rack', rack) "
     "FROM metrics LIMIT 10"),
    ("composite_group", "SELECT LOOKUP('dim_pairs', 'owner', 'host', host, 'rack', rack), "
     "COUNT(*), MAX(load) FROM metrics "
     "GROUP BY LOOKUP('dim_pairs', 'owner', 'host', host, 'rack', rack) LIMIT 10"),
    ("empty_table", "SELECT host, LOOKUP('dim_empty', 'dc', 'hostname', host) FROM metrics "
     "LIMIT 10"),
    ("order_by", "SELECT LOOKUP('dim_hosts', 'cores', 'hostname', host), SUM(load) "
     "FROM metrics WHERE host <> 'x' "
     "GROUP BY LOOKUP('dim_hosts', 'cores', 'hostname', host) ORDER BY 1 DESC LIMIT 10"),
]


@pytest.mark.parametrize("qid, sql", LOOKUP_QUERIES, ids=[q for q, _ in LOOKUP_QUERIES])
def test_lookup_matches_the_reference(lookup_env, qid, sql):
    segs, jsegs = lookup_env
    plan = plan_segment(compile_query(sql, segs[0].schema), segs[0])
    assert plan.kind in ("host", "selection")
    got = execute_query(segs, sql, device=CPU)
    want = jax_execute(jsegs, sql)
    assert got.columns == want.columns
    assert sorted(map(repr, got.rows)) == sorted(map(repr, want.rows))
    if qid == "group_by":
        rows = {row[0]: row[1] for row in got.rows}
        assert rows["us-east"] == pytest.approx(1.2) and rows["eu-west"] == pytest.approx(0.85)
        assert rows[None] == pytest.approx(0.9)   # the miss forms its own group
    if qid == "numeric_sum":
        assert got.rows[0][0] == pytest.approx(8 + 16 + 8 + 16)


def test_lookup_routes_a_numeric_key_to_the_host(tmp_path):
    """A LOOKUP over a numeric key column is a host plan for the function
    alone, as FROMDATETIME is."""
    paths = build_aligned_segments(ssb.ssb_schema(), ssb.make_columns(2000, SEED),
                                   str(tmp_path), "lineorder", 1)
    sql = ("SELECT SUM(LOOKUP('customer', 'c_custkey', 'c_custkey', lo_custkey)) "
           "FROM lineorder WHERE lo_discount = 2")
    plan = plan_segment(compile_query(sql, ssb.ssb_schema()), load_segment(paths[0]))
    assert plan.kind == "host" and plan.fallback_reason == "function lookup not device-supported"


def test_lookup_keeps_the_value_dtype_where_every_key_hits():
    from pinot_tpu_torch.engine.expr import _FUNCTIONS
    REGISTRY.register(DimensionTable("dim_dtype", ["hostname"], DIM_HOSTS))
    try:
        fn = _FUNCTIONS["lookup"]
        hit = fn(np, "dim_dtype", "cores", "hostname", np.array(["a", "c"], dtype=object))
        assert hit.dtype == np.int64 and hit.tolist() == [8, 32]
        miss = fn(np, "dim_dtype", "cores", "hostname", np.array(["a", "z"], dtype=object))
        assert miss.dtype == object and miss.tolist() == [8, None]
        with pytest.raises(ValueError, match="host-side only"):
            fn(object(), "dim_dtype", "cores", "hostname", np.array(["a"], dtype=object))
        with pytest.raises(ValueError, match="pk columns"):
            fn(np, "dim_dtype", "cores", "host", np.array(["a"], dtype=object))
        with pytest.raises(ValueError, match="not loaded"):
            fn(np, "dim_nowhere", "cores", "hostname", np.array(["a"], dtype=object))
    finally:
        REGISTRY.unregister("dim_dtype")


def test_dimension_table_from_segments_matches_the_reference(tmp_path):
    """`register_dim_table_from_segments` over SSB customer segments (and
    over none), then a LOOKUP GROUP BY over lineorder whose keys half miss."""
    customer = ssb.make_customer(4000, SEED)
    half = {c: v[:2000] for c, v in customer.items()}
    dim_paths = build_aligned_segments(ssb.customer_schema(), half, str(tmp_path / "c"),
                                       "customer", 2)
    lo = ssb.make_columns(6000, SEED + 1)
    lo["lo_custkey"] = (lo["lo_custkey"] % 4000).astype(np.int32)
    paths = build_aligned_segments(ssb.ssb_schema(), lo, str(tmp_path / "lo"), "lineorder", 2)
    segs, jsegs = [load_segment(p) for p in paths], [jax_load(p) for p in paths]
    sql = ("SELECT LOOKUP('customer', 'c_nation', 'c_custkey', lo_custkey), SUM(lo_revenue) "
           "FROM lineorder WHERE lo_discount = 2 AND lo_quantity < 10 "
           "GROUP BY LOOKUP('customer', 'c_nation', 'c_custkey', lo_custkey) LIMIT 100")
    try:
        for cut in (dim_paths, []):
            ours = register_dim_table_from_segments(
                "customer", ["c_custkey"], [load_segment(p) for p in cut])
            jax_register("customer", ["c_custkey"], [jax_load(p) for p in cut])
            assert set(ours.columns) == (set(customer) if cut else set())
            got, want = execute_query(segs, sql, device=CPU).rows, jax_execute(jsegs, sql).rows
            key = lambda r: (r[0] is None, r[0] or "")   # noqa: E731
            got, want = sorted(got, key=key), sorted(want, key=key)
            assert _rows_match(got, want, rel=1e-9)
            # the set executor hands the host plan to the per-segment executor
            assert sorted(MeshQueryExecutor(device=CPU).execute(segs, sql).rows, key=key) == got
            assert got[-1][0] is None                    # the misses' group
            assert (len(got) == 1) == (not cut)
    finally:
        REGISTRY.unregister("customer")
        JAX_REGISTRY.unregister("customer")
