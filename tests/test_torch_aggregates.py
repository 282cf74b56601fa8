"""Differential test: pinot_tpu_torch's aggregation library against the JAX package's.

The same segment directories (4 segments of a seeded SSB lineorder table,
written by the port's writer with every column dictionary-encoded, loaded by
both packages) go through both, on the CPU:

* route parity: for every query, the port's plan kind and `fallback_reason`
  on every segment equal the JAX planner's, and the kind is the one the
  family should take: a dictionary-column argument on the device (the
  `distinct` output, or the power sums within the f32 budget), an
  expression argument and the host-only families on the host;
* answers through `execute_query` against the reference's `execute_query`,
  and through `MeshQueryExecutor` and the serving pipeline against the
  reference's `MeshQueryExecutor` on a one-device mesh (the set path builds
  one t-digest from the whole set's counts, so its centroids are not the
  per-segment path's): counts, distinct counts, HLL and theta estimates,
  t-digest quantiles, modes, id sets and serialized sketches exactly, the
  moments at rel 1e-5 (abs 1e-4 near 0: skewness), host float answers at
  rel 1e-9;
* an unaligned set (segments built apart) through the merged-dictionary view;
* `IDSET` feeding an `IN_ID_SET` filter, which is a device LUT leaf over a
  dictionary column and raises over a raw one;
* a join with DISTINCTCOUNT and KURTOSIS in its final aggregation, through
  `execute_multistage`;
* a staged consuming view, alone and beside committed segments;
* the routing constants: `_power_sum_f32_safe` and
  `MAX_GROUPED_DISTINCT_CELLS` send the same queries to the host in both;
* `make_agg` takes every single-value name of the reference's registry and
  raises NotImplementedError for the multi-value ones.
"""

import math

import numpy as np
import pytest

from pinot_tpu.ingest.vectorized import decode_columnar_block as jax_decode
from pinot_tpu.multistage import execute_multistage as jax_multistage
from pinot_tpu.multistage import make_segment_scan as jax_scan
from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.query import aggregates as jax_aggregates
from pinot_tpu.query import planner as jax_planner
from pinot_tpu.query.context import QueryValidationError as JaxValidationError
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.planner import plan_segment as jax_plan
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.mutable_device import DeviceMutableSegment as JaxDeviceMutable
from pinot_tpu.sql.ast import Function as JaxFunction
from pinot_tpu_torch import execute_query, ssb
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.ingest.vectorized import decode_columnar_block, encode_columnar_block
from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query import planner
from pinot_tpu_torch.query.aggregates import MV_AGGREGATIONS, make_agg
from pinot_tpu_torch.query.context import QueryValidationError, compile_query
from pinot_tpu_torch.query.planner import plan_segment
from pinot_tpu_torch.query.predicate import LutLeaf
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
from pinot_tpu_torch.sql.ast import Function, Identifier

CPU = "cpu"
SEED = 20261017
ROWS, SEGMENTS = 4 * 2900 + 11, 4
HOST_REL = 1e-9
MOMENT_REL, MOMENT_ABS = 1e-5, 1e-4
ALL_DICT = SegmentGeneratorConfig(raw_cardinality_fraction=1.0)

# (id, sql, plan kind on every segment, floats held as moments)
QUERIES = [
    # -- device: the `distinct` output --------------------------------------
    ("distinctcount", "SELECT DISTINCTCOUNT(lo_suppkey), COUNT(DISTINCT lo_discount) "
     "FROM lineorder WHERE lo_quantity < 25", "device", False),
    ("distinctcount_string", "SELECT DISTINCTCOUNTBITMAP(lo_region), DISTINCTCOUNT(lo_custkey) "
     "FROM lineorder WHERE lo_discount BETWEEN 1 AND 3", "device", False),
    ("hll", "SELECT DISTINCTCOUNTHLL(lo_custkey), FASTHLL(lo_suppkey), "
     "DISTINCTCOUNTHLL(lo_region, 8) FROM lineorder", "device", False),
    ("raw_hll", "SELECT DISTINCTCOUNTRAWHLL(lo_suppkey) FROM lineorder "
     "WHERE lo_quantity < 10", "device", False),
    ("theta", "SELECT DISTINCTCOUNTTHETASKETCH(lo_suppkey), "
     "DISTINCTCOUNTTHETASKETCH(lo_custkey, 'nominalEntries=1024') FROM lineorder "
     "WHERE lo_orderdate < 19950101", "device", False),
    ("raw_theta", "SELECT DISTINCTCOUNTRAWTHETASKETCH(lo_region) FROM lineorder "
     "WHERE lo_discount = 4", "device", False),
    ("tdigest", "SELECT PERCENTILETDIGEST(lo_discount, 95), PERCENTILETDIGEST50(lo_quantity), "
     "PERCENTILEEST(lo_revenue, 90) FROM lineorder WHERE lo_region <> 'ASIA'", "device", False),
    ("distinct_sum_avg", "SELECT DISTINCTSUM(lo_discount), DISTINCTAVG(lo_quantity) "
     "FROM lineorder WHERE lo_region = 'ASIA'", "device", False),
    # -- device: power sums and min/max --------------------------------------
    ("moments", "SELECT VAR_POP(lo_discount), VAR_SAMP(lo_discount), STDDEV_POP(lo_discount), "
     "STDDEV_SAMP(lo_quantity), SKEWNESS(lo_discount), KURTOSIS(lo_discount) FROM lineorder "
     "WHERE lo_orderdate BETWEEN 19930101 AND 19961231", "device", True),
    ("minmaxrange", "SELECT MINMAXRANGE(lo_quantity), MINMAXRANGE(lo_revenue) FROM lineorder "
     "WHERE lo_discount = 3", "device", False),
    ("group_distinct", "SELECT lo_region, DISTINCTCOUNT(lo_suppkey), DISTINCTCOUNTHLL(lo_custkey), "
     "DISTINCTCOUNTTHETASKETCH(lo_suppkey), PERCENTILETDIGEST(lo_discount, 90), "
     "MINMAXRANGE(lo_quantity) FROM lineorder GROUP BY lo_region ORDER BY lo_region",
     "device", False),
    ("group_moments", "SELECT lo_region, lo_discount, VAR_SAMP(lo_quantity), "
     "SKEWNESS(lo_quantity), DISTINCTCOUNT(lo_suppkey) FROM lineorder WHERE lo_quantity < 40 "
     "GROUP BY lo_region, lo_discount ORDER BY lo_region, lo_discount LIMIT 100", "device", True),
    ("group_kurtosis", "SELECT lo_discount, KURTOSIS(lo_discount), STDDEV_POP(lo_discount) "
     "FROM lineorder GROUP BY lo_discount ORDER BY lo_discount", "device", True),
    # -- metadata -------------------------------------------------------------
    ("metadata_range", "SELECT MINMAXRANGE(lo_revenue), COUNT(*) FROM lineorder", "metadata",
     False),
    # -- host: expression arguments and the f32 power-sum budget --------------
    ("expr_args", "SELECT DISTINCTCOUNT(lo_suppkey + 0), DISTINCTCOUNTHLL(lo_suppkey * 2), "
     "PERCENTILETDIGEST(lo_discount + 1, 95), DISTINCTCOUNTTHETASKETCH(lo_custkey - 1) "
     "FROM lineorder WHERE lo_quantity > 20", "host", False),
    ("expr_moments", "SELECT VAR_POP(lo_discount + 0), KURTOSIS(lo_discount * 1) "
     "FROM lineorder", "host", True),
    ("kurtosis_budget", "SELECT KURTOSIS(lo_quantity), SKEWNESS(lo_revenue) FROM lineorder",
     "host", True),
    ("percentile", "SELECT PERCENTILE(lo_revenue, 99), PERCENTILE90(lo_quantity) "
     "FROM lineorder WHERE lo_discount < 5", "host", False),
    ("mode", "SELECT MODE(lo_quantity), MODE(lo_extendedprice) FROM lineorder "
     "WHERE lo_region = 'EUROPE'", "host", False),
    ("covar_corr", "SELECT COVAR_POP(lo_revenue, lo_extendedprice), "
     "COVAR_SAMP(lo_quantity, lo_discount), CORR(lo_revenue, lo_quantity) FROM lineorder",
     "host", False),
    ("with_time", "SELECT FIRSTWITHTIME(lo_revenue, lo_orderdate, 'DOUBLE'), "
     "LASTWITHTIME(lo_quantity, lo_orderdate, 'INT') FROM lineorder WHERE lo_discount = 7",
     "host", False),
    ("histogram_precision", "SELECT HISTOGRAM(lo_discount, 0, 11, 11), SUMPRECISION(lo_revenue) "
     "FROM lineorder WHERE lo_quantity < 5", "host", False),
    ("raw_and_smart_digests", "SELECT PERCENTILERAWTDIGEST(lo_discount, 50), "
     "PERCENTILESMARTTDIGEST(lo_revenue, 90), PERCENTILERAWEST(lo_quantity, 50) "
     "FROM lineorder WHERE lo_discount = 2", "host", False),
    ("smart_hll_partitioned", "SELECT DISTINCTCOUNTSMARTHLL(lo_custkey, 1000), "
     "DISTINCTCOUNTSMARTHLL(lo_suppkey), SEGMENTPARTITIONEDDISTINCTCOUNT(lo_region) "
     "FROM lineorder", "host", False),
    ("theta_setop", "SELECT DISTINCTCOUNTTHETASKETCH(lo_suppkey, 'nominalEntries=1024', "
     "'lo_region = ''ASIA''', 'lo_discount > 5', 'SET_INTERSECT($1, $2)') FROM lineorder",
     "host", False),
    ("stunion", "SELECT STUNION(stpoint(lo_discount, lo_quantity)) FROM lineorder "
     "WHERE lo_quantity < 3", "host", False),
    ("idset", "SELECT IDSET(lo_suppkey), IDSET(lo_region) FROM lineorder "
     "WHERE lo_quantity = 7 AND lo_discount = 3", "host", False),
    ("group_expr", "SELECT lo_discount / 5, MODE(lo_quantity), DISTINCTCOUNT(lo_suppkey), "
     "VAR_SAMP(lo_revenue) FROM lineorder GROUP BY lo_discount / 5 ORDER BY 1", "host", True),
]
IDS = [q[0] for q in QUERIES]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_aggregates")
    cols = ssb.make_columns(ROWS, SEED)
    paths = build_aligned_segments(ssb.ssb_schema(), cols, str(out / "lo"), "lineorder",
                                   SEGMENTS, ALL_DICT)
    # the same rows built apart: each segment has dictionaries of its own
    bounds = np.linspace(0, ROWS, SEGMENTS + 1).astype(int)
    apart = [SegmentBuilder(ssb.ssb_schema(), ALL_DICT).build(
        {c: v[lo:hi] for c, v in cols.items()}, str(out / "apart"), f"lineorder_{i}")
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]
    return {"cols": cols, "segs": [load_segment(p) for p in paths],
            "jax": [jax_load(p) for p in paths],
            "apart": [load_segment(p) for p in apart], "jax_apart": [jax_load(p) for p in apart],
            "jax_mesh": JaxMeshExecutor(default_mesh(1))}


def _cell_match(x, y, moment: bool, host: bool) -> bool:
    if isinstance(x, float) or isinstance(y, float):
        if x is None or y is None:
            return False
        if moment:
            return math.isclose(x, y, rel_tol=MOMENT_REL, abs_tol=MOMENT_ABS)
        return x == y or (host and math.isclose(x, y, rel_tol=HOST_REL))
    return x == y


def _rows_match(got, want, moment=False, host=False) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_cell_match(x, y, moment, host) for x, y in zip(g, w))
        for g, w in zip(got, want))


def _reduce(ctx, partial):
    aggs = [make_agg(f) for f in ctx.aggregations]
    group_exprs = [e for e, _ in ctx.select_items] if ctx.distinct else list(ctx.group_by)
    return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs, group_exprs)


@pytest.mark.parametrize("qid, sql, kind, moment", QUERIES, ids=IDS)
def test_route_parity_with_the_reference(env, qid, sql, kind, moment):
    ctx = compile_query(sql, env["segs"][0].schema)
    jctx = jax_compile(sql, env["jax"][0].schema)
    for seg, jseg in zip(env["segs"], env["jax"]):
        plan, jplan = plan_segment(ctx, seg), jax_plan(jctx, jseg)
        assert (plan.kind, plan.fallback_reason) == (jplan.kind, jplan.fallback_reason), qid
        assert plan.kind == kind, (qid, plan.fallback_reason)


@pytest.mark.parametrize("qid, sql, kind, moment", QUERIES, ids=IDS)
def test_answers_per_segment_match_the_reference(env, qid, sql, kind, moment):
    want = JaxExecutor().execute(env["jax"], sql).rows
    got = execute_query(env["segs"], sql, device=CPU).rows
    assert _rows_match(got, want, moment, kind == "host"), (qid, got, want)


@pytest.mark.parametrize("qid, sql, kind, moment", QUERIES, ids=IDS)
def test_answers_over_the_set_and_the_pipeline_match_the_reference(env, qid, sql, kind,
                                                                   moment):
    want = env["jax_mesh"].execute(env["jax"], sql).rows
    mx = MeshQueryExecutor(device=CPU)
    got = mx.execute(env["segs"], sql).rows
    assert _rows_match(got, want, moment, kind == "host"), (qid, got, want)
    ctx = compile_query(sql, env["segs"][0].schema)
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        served = _reduce(ctx, pipeline.execute_partial(ctx, env["segs"])).rows
        stats = pipeline.stats()
    finally:
        pipeline.stop()
    assert _rows_match(served, want, moment, kind == "host"), (qid, served, want)
    # a device plan is one pass over the stacked block; none of these is a scan
    assert (stats["launches"], stats["scanLaunches"]) == ((1 if kind == "device" else 0), 0)


UNALIGNED = [q for q in QUERIES if q[0] in ("distinctcount", "hll", "theta", "tdigest",
                                             "group_distinct", "moments")]


@pytest.mark.parametrize("qid, sql, kind, moment", UNALIGNED, ids=[q[0] for q in UNALIGNED])
def test_an_unaligned_set_takes_the_merged_view_as_the_reference_does(env, qid, sql, kind,
                                                                       moment):
    """Segments built apart disagree on dict ids: the distinct output counts
    global ids of the merged view, decoded through its dictionary."""
    mx = MeshQueryExecutor(device=CPU)
    plan, view = mx._plan_for_set(compile_query(sql, env["apart"][0].schema), env["apart"])
    assert plan.kind == "device" and view is not None
    want = env["jax_mesh"].execute(env["jax_apart"], sql).rows
    got = mx.execute(env["apart"], sql).rows
    assert _rows_match(got, want, moment), (qid, got, want)
    exact = JaxExecutor().execute(env["jax_apart"], sql).rows
    assert _rows_match(execute_query(env["apart"], sql, device=CPU).rows, exact, moment)


def test_exact_answers_equal_numpy(env):
    """The exact families against numpy float64 over the same rows."""
    c = env["cols"]
    m = c["lo_quantity"] < 25
    got = execute_query(env["segs"], QUERIES[0][1], device=CPU).rows
    assert got == [[len(np.unique(c["lo_suppkey"][m])), len(np.unique(c["lo_discount"][m]))]]
    m = (c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19961231)
    d, q = c["lo_discount"][m].astype(np.float64), c["lo_quantity"][m].astype(np.float64)
    z = (d - d.mean()) / d.std()
    want = [d.var(), d.var(ddof=1), d.std(), q.std(ddof=1), (z ** 3).mean(),
            (z ** 4).mean() - 3.0]
    for path in (execute_query(env["segs"], QUERIES[8][1], device=CPU),
                 MeshQueryExecutor(device=CPU).execute(env["segs"], QUERIES[8][1])):
        assert _rows_match(path.rows, [want], moment=True), (path.rows, want)


def _idset_literal(segs, sql):
    return execute_query(segs, sql, device=CPU).rows[0][0]


@pytest.mark.parametrize("col, form", [("lo_suppkey", "= 1"), ("lo_region", ""),
                                       ("lo_custkey", "= 0")],
                         ids=["numeric", "string", "negated"])
def test_idset_feeds_an_in_id_set_filter_on_the_device(env, col, form):
    segs, jsegs = env["segs"], env["jax"]
    literal = _idset_literal(segs, f"SELECT IDSET({col}) FROM lineorder "
                                   "WHERE lo_quantity = 7 AND lo_discount < 4")
    ref_literal = JaxExecutor().execute(jsegs, f"SELECT IDSET({col}) FROM lineorder "
                                               "WHERE lo_quantity = 7 AND lo_discount < 4"
                                        ).rows[0][0]
    assert literal == ref_literal
    sql = (f"SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder "
           f"WHERE IN_ID_SET({col}, '{literal}') {form} AND lo_quantity > 3 "
           "GROUP BY lo_region ORDER BY lo_region")
    plan = plan_segment(compile_query(sql, segs[0].schema), segs[0])
    assert plan.kind == "device"
    assert any(isinstance(leaf, LutLeaf) and leaf.op == "idset"
               for leaf in plan.filter_prog.leaves)
    want = JaxExecutor().execute(jsegs, sql).rows
    assert _rows_match(execute_query(segs, sql, device=CPU).rows, want, moment=True)
    mx = MeshQueryExecutor(device=CPU)
    assert _rows_match(mx.execute(segs, sql).rows, env["jax_mesh"].execute(jsegs, sql).rows,
                       moment=True)
    ctx = compile_query(sql, segs[0].schema)
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        served = _reduce(ctx, pipeline.execute_partial(ctx, segs)).rows
    finally:
        pipeline.stop()
    assert _rows_match(served, want, moment=True)
    c = env["cols"]
    members = np.isin(c[col], np.unique(c[col][(c["lo_quantity"] == 7)
                                               & (c["lo_discount"] < 4)]))
    keep = (members if form != "= 0" else ~members) & (c["lo_quantity"] > 3)
    assert sum(r[1] for r in want) == int(keep.sum())


def test_in_id_set_over_a_raw_column_raises(tmp_path):
    """IN_ID_SET over a raw column (a doc-set leaf: the serialized set
    resolved on the host into a row mask) answers as the JAX package does, per
    segment and over the set, bare and compared to 1 or 0."""
    cols = ssb.make_columns(3000, SEED)
    paths = build_aligned_segments(ssb.ssb_schema(), cols, str(tmp_path), "lineorder", 2)
    segs = [load_segment(p) for p in paths]
    assert not segs[0].column("lo_custkey").has_dictionary
    literal = _idset_literal(segs, "SELECT IDSET(lo_custkey) FROM lineorder "
                                   "WHERE lo_quantity = 7")
    keys = np.unique(cols["lo_custkey"][cols["lo_quantity"] == 7])
    jax_segs = [jax_load(p) for p in paths]
    mx = MeshQueryExecutor(device=CPU)
    for form, keep in (("", True), (" = 1", True), (" = 0", False)):
        sql = (f"SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
               f"WHERE IN_ID_SET(lo_custkey, '{literal}'){form} AND lo_quantity > 3")
        m = (np.isin(cols["lo_custkey"], keys) == keep) & (cols["lo_quantity"] > 3)
        want = JaxExecutor().execute(jax_segs, sql).rows
        assert want[0][0] == int(m.sum())
        for got in (execute_query(segs, sql, device=CPU).rows, mx.execute(segs, sql).rows):
            assert got[0][0] == want[0][0]
            assert math.isclose(got[0][1], want[0][1], rel_tol=1e-6)


JOIN_SQL = ("SELECT s.s_nation, DISTINCTCOUNT(l.lo_custkey), COUNT(DISTINCT l.lo_discount), "
            "KURTOSIS(l.lo_quantity), PERCENTILE(l.lo_revenue, 90) FROM lineorder l "
            "JOIN supplier s ON l.lo_suppkey = s.s_suppkey WHERE s.s_region = 'AMERICA' "
            "GROUP BY s.s_nation ORDER BY s.s_nation LIMIT 25")


def test_a_join_with_distinctcount_matches_the_reference_and_numpy(env, tmp_path):
    sup = ssb.make_supplier(ssb.HIGH_CARD_SUPPKEYS, SEED)
    sup_path = SegmentBuilder(ssb.supplier_schema()).build(sup, str(tmp_path), "supplier_0")
    tables = {"lineorder": env["segs"], "supplier": [load_segment(sup_path)]}
    jax_tables = {"lineorder": env["jax"], "supplier": [jax_load(sup_path)]}
    schemas = {"lineorder": ssb.ssb_schema(), "supplier": ssb.supplier_schema()}
    jax_schemas = {t: JSchema.from_json(s.to_json()) for t, s in schemas.items()}
    got = execute_multistage(JOIN_SQL, make_segment_scan(tables, device=CPU), schemas.get)
    want = jax_multistage(JOIN_SQL, jax_scan(jax_tables), jax_schemas.get)
    assert _rows_match(got.rows, want.rows, moment=True), (got.rows, want.rows)
    c = env["cols"]
    nation = np.asarray(sup["s_nation"])[c["lo_suppkey"]]
    region = np.asarray(sup["s_region"])[c["lo_suppkey"]]
    assert [r[:3] for r in got.rows] == [
        [n, len(np.unique(c["lo_custkey"][(region == "AMERICA") & (nation == n)])),
         len(np.unique(c["lo_discount"][(region == "AMERICA") & (nation == n)]))]
        for n in sorted(set(nation[region == "AMERICA"]))]


CONSUMING = [
    ("string_distinct", "SELECT DISTINCTCOUNT(lo_region), DISTINCTCOUNTHLL(lo_region), "
     "DISTINCTCOUNTTHETASKETCH(lo_region) FROM lineorder WHERE lo_quantity < 30", "device"),
    ("moments", "SELECT VAR_POP(lo_discount), KURTOSIS(lo_discount), MINMAXRANGE(lo_quantity) "
     "FROM lineorder WHERE lo_region = 'ASIA'", "device"),
    ("group", "SELECT lo_region, DISTINCTCOUNT(lo_region), SKEWNESS(lo_discount) "
     "FROM lineorder GROUP BY lo_region ORDER BY lo_region", "device"),
    ("numeric_distinct", "SELECT DISTINCTCOUNT(lo_suppkey), PERCENTILE(lo_discount, 90) "
     "FROM lineorder WHERE lo_discount > 2", "host"),
]


@pytest.mark.parametrize("qid, sql, kind", CONSUMING, ids=[q[0] for q in CONSUMING])
def test_a_staged_consuming_view_alone_and_in_a_mixed_set(env, qid, sql, kind):
    """A staged view is planned as an immutable segment: its string columns
    carry a sorted snapshot dictionary (the `distinct` output over their
    ids), its numeric columns are raw (a distinct over them is a host plan).
    Beside the committed segments the set executor plans on the merged view."""
    cols, segs, jsegs = env["cols"], env["segs"], env["jax"]
    n = segs[-1].num_docs
    tail = {c: v[ROWS - n:] for c, v in cols.items()}
    ours = DeviceMutableSegment("lineorder__0__0__20261017T0000Z", ssb.ssb_schema(),
                                device_staging=True, device=CPU)
    ref = JaxDeviceMutable("lineorder__0__0__20261017T0000Z",
                           JSchema.from_json(ssb.ssb_schema().to_json()), device_staging=True)
    for lo in range(0, n, 700):
        blob = encode_columnar_block(ssb.ssb_schema(), {c: v[lo:lo + 700]
                                                        for c, v in tail.items()})
        ours.index_arrays(decode_columnar_block(blob))
        ref.index_arrays(jax_decode(blob))
    view, ref_view = ours.query_view(), ref.query_view()
    ctx = compile_query(sql, view.schema)
    assert plan_segment(ctx, view).kind == kind
    want = JaxExecutor(use_device=True).execute([ref_view], jax_compile(sql, ref_view.schema)).rows
    assert _rows_match(execute_query([view], sql, device=CPU).rows, want, moment=True), qid
    # the same rows committed answer the same
    assert _rows_match(execute_query(segs[-1:], sql, device=CPU).rows, want, moment=True), qid
    members, jax_members = segs[:-1] + [view], jsegs[:-1] + [ref_view]
    mx = MeshQueryExecutor(device=CPU)
    got = mx.execute(members, sql).rows
    set_want = env["jax_mesh"].execute(jax_members, sql).rows
    assert _rows_match(got, set_want, moment=True), (qid, got, set_want)
    if kind == "device":
        assert mx._plan_for_set(ctx, members)[1] is not None


def test_power_sum_budget_routes_as_the_reference(env):
    """|x|^p within 2^20 keeps the device (lo_discount <= 10); past it the f64
    host path (lo_quantity <= 50: 50^3 fits, 50^4 does not)."""
    seg, jseg = env["segs"][0], env["jax"][0]
    for agg_sql, err in (("KURTOSIS(lo_discount)", ""), ("SKEWNESS(lo_quantity)", ""),
                         ("KURTOSIS(lo_quantity)", "|lo_quantity|^4"),
                         ("VAR_POP(lo_revenue)", "|lo_revenue|^2"),
                         ("VAR_POP(lo_discount * 2)", "over an expression")):
        sql = f"SELECT {agg_sql} FROM lineorder"
        agg = make_agg(compile_query(sql, seg.schema).aggregations[0])
        jagg = jax_aggregates.make_agg(jax_compile(sql, jseg.schema).aggregations[0])
        reason = planner._power_sum_f32_safe(agg, seg)
        assert reason == jax_planner._power_sum_f32_safe(jagg, jseg)
        assert (err in reason) if err else reason == ""
    assert planner.POWER_SUM_F32_LIMIT == jax_planner.POWER_SUM_F32_LIMIT


def test_grouped_distinct_cell_cap_routes_as_the_reference(env, monkeypatch):
    """2 x keys x lut_size(card) past MAX_GROUPED_DISTINCT_CELLS goes to the
    host in both packages: here custkey's 16,384-id LUT over 5 regions is
    163,840 cells, quantity's 64-id LUT 640; a cap between the two splits
    them as 2^22 splits custkey from suppkey at the smoke's 16M rows."""
    assert planner.MAX_GROUPED_DISTINCT_CELLS == jax_planner.MAX_GROUPED_DISTINCT_CELLS
    sqls = {col: f"SELECT lo_region, DISTINCTCOUNT({col}) FROM lineorder GROUP BY lo_region "
                 "ORDER BY lo_region" for col in ("lo_custkey", "lo_quantity")}
    seg, jseg = env["segs"][0], env["jax"][0]
    for cap, kinds in ((planner.MAX_GROUPED_DISTINCT_CELLS, ("device", "device")),
                       (100_000, ("host", "device"))):
        monkeypatch.setattr(planner, "MAX_GROUPED_DISTINCT_CELLS", cap)
        monkeypatch.setattr(jax_planner, "MAX_GROUPED_DISTINCT_CELLS", cap)
        for (col, sql), want_kind in zip(sqls.items(), kinds):
            plan = plan_segment(compile_query(sql, seg.schema), seg)
            jplan = jax_plan(jax_compile(sql, jseg.schema), jseg)
            assert (plan.kind, plan.fallback_reason) == (jplan.kind, jplan.fallback_reason)
            assert plan.kind == want_kind, (cap, col, plan.fallback_reason)
        got = execute_query(env["segs"], sqls["lo_custkey"], device=CPU).rows
        assert got == JaxExecutor().execute(env["jax"], sqls["lo_custkey"]).rows


def _registry_names():
    return sorted(jax_aggregates._REGISTRY)


@pytest.mark.parametrize("name", _registry_names())
def test_make_agg_takes_every_single_value_name_of_the_reference(name):
    args = {"histogram": (Identifier("x"), *[_lit(v) for v in (0, 10, 5)]),
            "covarpop": (Identifier("x"), Identifier("y")),
            "covar_pop": (Identifier("x"), Identifier("y")),
            "covarsamp": (Identifier("x"), Identifier("y")),
            "covar_samp": (Identifier("x"), Identifier("y")),
            "corr": (Identifier("x"), Identifier("y")),
            "firstwithtime": (Identifier("x"), Identifier("t")),
            "lastwithtime": (Identifier("x"), Identifier("t")),
            "percentile": (Identifier("x"), _lit(50)),
            "percentileest": (Identifier("x"), _lit(50)),
            "percentiletdigest": (Identifier("x"), _lit(50)),
            "percentilerawtdigest": (Identifier("x"), _lit(50)),
            "percentilerawest": (Identifier("x"), _lit(50)),
            "percentilesmarttdigest": (Identifier("x"), _lit(50))}.get(name, (Identifier("x"),))
    agg = make_agg(Function(name, args))
    ref = jax_aggregates.make_agg(JaxFunction(name, tuple(_jax(a) for a in args)))
    assert type(agg).__name__ == type(ref).__name__
    assert (agg.name, agg.device_outputs, agg.wants_id_counts) == \
        (ref.name, ref.device_outputs, getattr(ref, "wants_id_counts", False))
    if name in MV_AGGREGATIONS:
        _assert_mv_outputs_equal(agg, ref)


def _mv_cells():
    """Seeded multi-value cells: 40 rows of 1-4 INT values."""
    rng = np.random.default_rng(11)
    cells = np.empty(40, dtype=object)
    for i in range(len(cells)):
        cells[i] = rng.integers(0, 30, rng.integers(1, 5)).astype(np.int32)
    return cells


def _assert_mv_outputs_equal(agg, ref):
    """A multi-value aggregation's finalized state over two merged partials
    of the same cells equals the JAX package's."""
    cells = _mv_cells()
    ours = agg.finalize(agg.merge(agg.host_state(cells[:25]), agg.host_state(cells[25:])))
    theirs = ref.finalize(ref.merge(ref.host_state(cells[:25]), ref.host_state(cells[25:])))
    assert ours == theirs


def _lit(v):
    from pinot_tpu_torch.sql.ast import Literal
    return Literal(v)


def _jax(e):
    from pinot_tpu.sql.ast import Identifier as JaxIdentifier
    from pinot_tpu.sql.ast import Literal as JaxLiteral
    return JaxIdentifier(e.name) if isinstance(e, Identifier) else JaxLiteral(e.value)


@pytest.mark.parametrize("name", ["percentile90mv", "percentiletdigestmv", "percentileest50mv",
                                  "percentilerawtdigestmv", "percentilerawestmv"])
def test_the_multi_value_percentiles_raise(name):
    """The PERCENTILE*MV names (digit-suffix forms too) build the JAX
    package's classes, whose answers over multi-value cells they equal."""
    agg = make_agg(Function(name, (Identifier("x"), _lit(50))))
    ref = jax_aggregates.make_agg(JaxFunction(name, (_jax(Identifier("x")), _jax(_lit(50)))))
    assert type(agg).__name__ == type(ref).__name__ and agg.name == ref.name
    _assert_mv_outputs_equal(agg, ref)


def test_count_distinct_is_distinctcount_and_unknown_names_are_invalid():
    agg = make_agg(Function("count", (Identifier("x"),), distinct=True))
    assert type(agg).__name__ == "DistinctCountAgg" and agg.name == "distinctcount"
    with pytest.raises(QueryValidationError):
        make_agg(Function("nosuchagg", (Identifier("x"),)))


@pytest.mark.parametrize("sql", [
    "SELECT VAR_POP(lo_region) FROM lineorder",
    "SELECT BOOL_AND(lo_discount) FROM lineorder",
    "SELECT COVAR_POP(lo_revenue, lo_region) FROM lineorder",
    "SELECT DISTINCTSUM(lo_region) FROM lineorder",
    "SELECT DISTINCTCOUNTTHETASKETCH(lo_suppkey, 'k=16', 'lo_discount > 1') FROM lineorder",
], ids=["moment_of_string", "bool_and_of_int", "covar_of_string", "distinctsum_of_string",
        "theta_lone_predicate"])
def test_argument_validation_raises_as_the_reference(env, sql):
    with pytest.raises(JaxValidationError):
        JaxExecutor().execute(env["jax"], sql)
    with pytest.raises(QueryValidationError):
        execute_query(env["segs"], sql, device=CPU)


def test_bool_and_or_over_a_boolean_column(tmp_path):
    """BOOL_AND / BOOL_OR ride the device min / max outputs."""
    schema = Schema("flags", [dimension("flag", DataType.BOOLEAN), metric("v", DataType.INT),
                              dimension("g", DataType.STRING)])
    rng = np.random.default_rng(SEED)
    n = 3000
    cols = {"flag": rng.integers(0, 2, n).astype(bool), "v": rng.integers(0, 10, n),
            "g": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]}
    cols["flag"][cols["v"] == 9] = True
    path = SegmentBuilder(schema).build(cols, str(tmp_path), "flags_0")
    segs, jsegs = [load_segment(path)], [jax_load(path)]
    for sql in ("SELECT BOOL_AND(flag), BOOL_OR(flag) FROM flags WHERE v = 9",
                "SELECT BOOL_AND(flag), BOOL_OR(flag) FROM flags WHERE v < 5",
                "SELECT g, BOOL_AND(flag), BOOL_OR(flag) FROM flags GROUP BY g ORDER BY g"):
        plan = plan_segment(compile_query(sql, schema), segs[0])
        assert plan.kind == "device"
        want = JaxExecutor().execute(jsegs, sql).rows
        assert execute_query(segs, sql, device=CPU).rows == want
        assert MeshQueryExecutor(device=CPU).execute(segs, sql).rows == want
    assert execute_query(segs, "SELECT BOOL_AND(flag) FROM flags WHERE v = 9",
                         device=CPU).rows == [[True]]


@pytest.mark.parametrize("grouped", [False, True], ids=["scalar", "grouped"])
def test_run_kernel_distinct_and_power_sum_outputs_equal_numpy(env, grouped):
    """The body's `distinct` outputs (0/1 presence or per-id counts, scalar;
    per-id counts per group) equal numpy's counts of the filtered rows' dict
    ids, and its power sums equal float64 numpy's, narrowed to float32."""
    from pinot_tpu_torch.engine.datablock import block_for
    from pinot_tpu_torch.engine.kernels import run_kernel
    from pinot_tpu_torch.query.executor import ServerQueryExecutor, kernel_spec
    from pinot_tpu_torch.query.planner import build_device_geometry
    import torch
    seg, cols = env["segs"][1], env["cols"]
    lo = env["segs"][0].num_docs
    rows = {c: v[lo:lo + seg.num_docs] for c, v in cols.items()}
    group = "lo_region, " if grouped else ""
    sql = (f"SELECT {group}DISTINCTCOUNT(lo_suppkey), PERCENTILETDIGEST(lo_custkey, 50), "
           "KURTOSIS(lo_discount) FROM lineorder WHERE lo_quantity < 25"
           + (" GROUP BY lo_region" if grouped else ""))
    plan = plan_segment(compile_query(sql, seg.schema), seg)
    build_device_geometry(plan)
    spec = kernel_spec(plan)
    ex = ServerQueryExecutor(CPU)
    outs = run_kernel(spec, ex._kernel_inputs(plan, spec, block_for(seg, ex.device)))
    m = rows["lo_quantity"] < 25
    ids = {c: np.searchsorted(np.asarray(seg.column(c).dictionary.values), rows[c])
           for c in ("lo_suppkey", "lo_custkey", "lo_region")}
    keys = ids["lo_region"] if grouped else np.zeros(seg.num_docs, dtype=np.int64)
    d = rows["lo_discount"].astype(np.float64)
    for k in range(5 if grouped else 1):
        g = m & (keys == k)
        for ai, col, counts in ((0, "lo_suppkey", False), (1, "lo_custkey", True)):
            size = spec.distinct_lut_sizes[ai]
            want = np.bincount(ids[col][g], minlength=size)
            got = outs[f"{ai}.distinct"][k] if grouped else outs[f"{ai}.distinct"]
            assert got.dtype == torch.int32 and got.shape == (size,)
            # a grouped output is counts; the scalar one presence unless the
            # aggregation wants the counts (the t-digest)
            assert np.array_equal(got.numpy(), want if counts or grouped
                                  else (want > 0).astype(np.int32))
        for p in (2, 3, 4):
            got = outs[f"2.sum{p}"][k] if grouped else outs[f"2.sum{p}"]
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(np.float32((d[g] ** p).sum())), rel=1e-7)


def test_the_smoke_aggs_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `aggs` phase at 60,000 rows with the card's calls
    pointed at the CPU: every route, answer, sketch-equals-the-CPU and
    launch check of the phase passes, and no scan kernel is launched. The
    grouped presence cap is lowered so that it splits lo_custkey from
    lo_suppkey at this size as 2^22 does at the smoke's 16M rows."""
    import torch

    import chip_smoke
    from pinot_tpu_torch.engine import grouped, join_kernels, kernels, scan
    from pinot_tpu_torch.multistage import runtime
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.segment import mutable_device

    cpu = torch.device(CPU)
    for module in (executor, combine, mutable_device, runtime, join_kernels):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
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
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, flush: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, flush: (fn(), 1.0)[1])
    monkeypatch.setattr(grouped, "device_caps", lambda device: (132, 232_448, 233_472))
    for name, value in (("L2_FLUSH_BYTES", 8), ("AGGS_CONSUMING_ROWS", 32_768),
                        ("AGGS_DEVICE_RUNS", 1), ("SERVE_CLIENTS", 4),
                        ("SERVE_QUERIES_PER_CLIENT", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(planner, "MAX_GROUPED_DISTINCT_CELLS", 1 << 19)
    cols = ssb.make_columns(60_000, SEED)
    table = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), cols, str(tmp_path / "main"), "lineorder", 8, ALL_DICT)]

    class Args:
        seed, trace = SEED, False
    launches, cases = chip_smoke.run_aggs(Args(), table, cols, str(tmp_path))
    # the IN_ID_SET query's lo_quantity > 40 leaf (one mask per segment, one
    # over the set) and the join's supplier leaf read the bitmap index
    # grouped_agg: one a distinct output and a plan's power sums a pass (per
    # segment and over the set: 72), the IN_ID_SET GROUP BY (9), the consuming
    # view's distinct alone (1), on the merged view (1), and the host set
    # plan's 8 device segments with 2 distinct outputs each (16)
    assert launches == {"masked_sums": 0, "masked_sums_fused": 0, "bitmap_filter": 10,
                        "grouped_agg": 99}
    assert {k.rsplit(", ", 1)[1] for k in cases} == {"one segment", "stacked set"}
    assert all(c["bound_by"] == "bytes" and c["bound_ms"] > 0 for c in cases.values())
