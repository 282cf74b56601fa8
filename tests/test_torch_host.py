"""Differential test: pinot_tpu_torch's host aggregation path and device
expressions against the JAX package's, on the CPU.

The same segment directories (written by the port's writer, loaded by both
packages) go through both:

* route parity: for each query, the port's plan kind and `fallback_reason`
  on every segment equal the JAX planner's (a selection's host-mask reason
  against the JAX executor's `_expr_device_ok` rule);
* answers through `execute_query`, `MeshQueryExecutor` and
  `DeviceQueryPipeline` against the reference's `execute_query`: host plans
  at rel 1e-9 (both sum in float64 on the host), device plans at the device
  tolerance (rel 1e-5, abs 0.05: f32 partials), counts exactly; the
  expression SUM under a band filter reaches the masked-sum scan. A CASE
  answer is held against numpy instead: the reference's CASE fold misreads
  its WHENs (tests/test_torch_expr.py);
* a join whose leaf filters need the host mask, through `execute_multistage`;
* a consuming segment without staging (a mutable view), alone and beside
  committed segments;
* `TransformPipeline` filters and column transforms, directly and on both
  realtime lanes, against the reference's pipeline.
"""

import math

import numpy as np
import pytest

from pinot_tpu.ingest.transform import TransformPipeline as JaxPipeline
from pinot_tpu.multistage import execute_multistage as jax_multistage
from pinot_tpu.multistage import make_segment_scan as jax_scan
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.planner import _expr_device_ok as jax_expr_device_ok
from pinot_tpu.query.planner import plan_segment as jax_plan
from pinot_tpu.query.predicate import CmpLeaf as JaxCmpLeaf
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu_torch import ServerQueryExecutor, execute_query, segments_from_columns, ssb
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import scan
from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
from pinot_tpu_torch.ingest.stream import MemoryStream
from pinot_tpu_torch.ingest.transform import TransformPipeline
from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.planner import plan_segment
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
from pinot_tpu_torch.table import StreamConfig, TableConfig

CPU = "cpu"
HOST_REL = 1e-9
DEV_REL, DEV_ABS = 1e-5, 0.05
ROWS, SEGMENTS = 3 * 6000 + 7, 3
SEED = 20260729
POLYGON = "POLYGON ((-110 30, -80 30, -80 45, -110 45, -110 30))"

CASE_SUM = ("SELECT SUM(CASE WHEN lo_discount BETWEEN 1 AND 3 THEN lo_extendedprice * "
            "lo_discount ELSE 0 END), COUNT(*) FROM lineorder WHERE lo_quantity < 25")
# (id, table, sql, plan kind on every segment)
ROUTES = [
    ("case_sum", "lo", CASE_SUM, "device"),
    ("math_filter", "lo", "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE "
     "floor(lo_extendedprice / 100) > 50 AND mod(lo_orderdate, 100) = 15", "device"),
    ("group_math", "lo", "SELECT lo_region, AVG(power(lo_discount, 2)), "
     "MAX(abs(lo_revenue - lo_extendedprice)) FROM lineorder GROUP BY lo_region "
     "ORDER BY lo_region", "device"),
    ("datetime_filter", "lo", "SELECT COUNT(*), MIN(lo_revenue) FROM lineorder "
     "WHERE second(lo_orderdate) < 30 AND millisecond(lo_orderdate) > 500", "device"),
    ("sum_of_compare", "lo", "SELECT SUM(lo_discount > 5), MAX(lo_quantity < 10) "
     "FROM lineorder WHERE lo_region = 'ASIA'", "device"),
    ("group_expr", "lo", "SELECT lo_orderdate / 10000, COUNT(*), SUM(lo_revenue) "
     "FROM lineorder GROUP BY lo_orderdate / 10000 ORDER BY 1 LIMIT 20", "host"),
    ("string_group", "lo", "SELECT substr(lo_region, 0, 2), COUNT(*), SUM(lo_quantity) "
     "FROM lineorder WHERE startswith(lo_region, 'A') = 1 GROUP BY substr(lo_region, 0, 2) "
     "ORDER BY 1", "host"),
    ("upper_group", "lo", "SELECT upper(lo_region), MIN(lo_revenue), AVG(lo_discount) "
     "FROM lineorder WHERE length(lo_region) > 4 GROUP BY upper(lo_region) ORDER BY 1",
     "host"),
    ("string_filter", "lo", "SELECT SUM(lo_revenue), COUNT(*) FROM lineorder "
     "WHERE strpos(lo_region, 'I') = 2 OR lo_quantity > 45", "host"),
    ("raw_group", "lo", "SELECT lo_custkey, COUNT(*), SUM(lo_revenue) FROM lineorder "
     "GROUP BY lo_custkey ORDER BY COUNT(*) DESC, lo_custkey LIMIT 5", "host"),
    ("host_having", "lo", "SELECT lo_discount, SUM(lo_revenue) / COUNT(*) FROM lineorder "
     "WHERE length(lo_region) = 4 GROUP BY lo_discount HAVING COUNT(*) > 10 "
     "ORDER BY 1 LIMIT 20", "host"),
    ("host_mask_selection", "lo", "SELECT lo_region, lo_revenue FROM lineorder "
     "WHERE strpos(lo_region, 'I') = 2 ORDER BY lo_revenue DESC LIMIT 7", "selection"),
    ("device_selection", "lo", "SELECT lo_custkey, lo_revenue FROM lineorder "
     "WHERE sqrt(lo_revenue) > 200 ORDER BY lo_revenue LIMIT 5", "selection"),
    ("metadata", "lo", "SELECT COUNT(*), MAX(lo_quantity) FROM lineorder", "metadata"),
    ("geo_distance", "geo", "SELECT COUNT(*), SUM(v) FROM geo WHERE "
     "stdistance(stpoint(lng, lat), stpoint(-100.0, 40.0)) < RADIUS", "device"),
    ("geo_within", "geo", "SELECT COUNT(*), SUM(v) FROM geo WHERE "
     f"stwithin(stpoint(lng, lat), stgeogfromtext('{POLYGON}'))", "host"),
    ("epoch_ms_guard", "geo", "SELECT COUNT(*) FROM geo WHERE month(ts) = 3", "host"),
    ("epoch_ms_group", "geo", "SELECT month(ts), COUNT(*), SUM(v) FROM geo "
     "GROUP BY month(ts) ORDER BY 1", "host"),
]
IDS = [r[0] for r in ROUTES]


def _geo_columns(n, seed=SEED):
    rng = np.random.default_rng(seed)
    return {"city": np.array([f"c{k}" for k in rng.integers(0, 40, n)], dtype=object),
            "lng": rng.uniform(-130.0, -60.0, n), "lat": rng.uniform(20.0, 55.0, n),
            "ts": 1_672_531_200_000 + rng.integers(0, 365 * 86_400_000, n),
            "v": rng.integers(-50, 500, n).astype(np.int32)}


def _geo_schema():
    return Schema("geo", [dimension("city", DataType.STRING), metric("lng", DataType.DOUBLE),
                          metric("lat", DataType.DOUBLE), metric("ts", DataType.LONG),
                          metric("v", DataType.INT)])


def _radius(cols) -> float:
    """A distance from (-100, 40) with the widest gap between two rows' f64
    distances around it, so that f32 rounding in either package decides no
    row."""
    lam, phi = np.radians(cols["lng"]), np.radians(cols["lat"])
    lam0, phi0 = math.radians(-100.0), math.radians(40.0)
    a = np.sin((phi0 - phi) / 2) ** 2 + np.cos(phi) * math.cos(phi0) * \
        np.sin((lam0 - lam) / 2) ** 2
    d = np.sort(2 * 6371008.8 * np.arcsin(np.sqrt(np.minimum(a, 1.0))))
    mid = slice(len(d) // 4, 3 * len(d) // 4)
    gaps = np.diff(d[mid])
    j = int(np.argmax(gaps))
    return float((d[mid][j] + d[mid][j + 1]) / 2)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_host"))
    cols = ssb.make_columns(ROWS, SEED)
    geo = _geo_columns(4000)
    lo = segments_from_columns(ssb.ssb_schema(), cols, out + "/lo", SEGMENTS)
    geo_paths = [SegmentBuilder(_geo_schema()).build(
        {c: v[k::2] for c, v in geo.items()}, out + "/geo", f"geo_{k}") for k in range(2)]
    tables = {"lo": lo, "geo": [load_segment(p) for p in geo_paths]}
    jax_tables = {t: [jax_load(s.path) for s in segs] for t, segs in tables.items()}
    return {"cols": cols, "geo": geo, "tables": tables, "jax": jax_tables,
            "radius": _radius(geo)}


def _case_sum_oracle(c):
    m = c["lo_quantity"] < 25
    d = c["lo_discount"]
    return [[float(np.where((d >= 1) & (d <= 3), c["lo_extendedprice"] * d, 0)[m].sum()),
             int(m.sum())]]


ORACLES = {"case_sum": _case_sum_oracle}


def _sql(env, table, sql):
    return sql.replace("RADIUS", repr(env["radius"])) if table == "geo" else sql


def _rows_match(a, b, rel, abs_tol=0.0) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None or not math.isclose(
                        float(x), float(y), rel_tol=rel, abs_tol=abs_tol):
                    return False
            elif x != y:
                return False
    return True


def _tolerance(kind):
    return (DEV_REL, DEV_ABS) if kind == "device" else (HOST_REL, 0.0)


def _jax_route(ctx, seg):
    plan = jax_plan(ctx, seg)
    if plan.kind != "selection":
        return plan.kind, plan.fallback_reason
    reasons = [jax_expr_device_ok(leaf.expr, seg) for leaf in plan.filter_prog.leaves
               if isinstance(leaf, JaxCmpLeaf)]
    return plan.kind, next(filter(None, reasons), "")


@pytest.mark.parametrize("qid, table, sql, kind", ROUTES, ids=IDS)
def test_route_parity_with_the_reference(env, qid, table, sql, kind):
    sql = _sql(env, table, sql)
    segs, jax_segs = env["tables"][table], env["jax"][table]
    ctx, jctx = compile_query(sql, segs[0].schema), jax_compile(sql, jax_segs[0].schema)
    for seg, jseg in zip(segs, jax_segs):
        plan = plan_segment(ctx, seg)
        assert (plan.kind, plan.fallback_reason) == _jax_route(jctx, jseg), qid
        assert plan.kind == kind, (qid, plan.fallback_reason)
    if qid == "host_mask_selection":
        assert plan.fallback_reason == "non-numeric column lo_region in expression"


@pytest.mark.parametrize("qid, table, sql, kind", ROUTES, ids=IDS)
def test_answers_match_the_reference(env, qid, table, sql, kind):
    sql = _sql(env, table, sql)
    segs, jax_segs = env["tables"][table], env["jax"][table]
    want = (ORACLES[qid](env["cols"]) if qid in ORACLES
            else JaxExecutor().execute(jax_segs, sql).rows)
    rel, abs_tol = _tolerance(kind)
    got = execute_query(segs, sql, device=CPU).rows
    assert _rows_match(got, want, rel, abs_tol), (qid, got, want)
    assert _rows_match(MeshQueryExecutor(device=CPU).execute(segs, sql).rows, want,
                       rel, abs_tol), qid


@pytest.mark.parametrize("qid, table, sql, kind",
                         [r for r in ROUTES if r[3] == "host"],
                         ids=[r[0] for r in ROUTES if r[3] == "host"])
def test_host_plans_through_the_pipeline_are_the_per_segment_partial(env, qid, table, sql,
                                                                     kind):
    """The serving pipeline answers a host plan without a pass over the
    block: its partial is the per-segment executor's, reduced as the
    reference's answer."""
    sql = _sql(env, table, sql)
    segs, jax_segs = env["tables"][table], env["jax"][table]
    ctx = compile_query(sql, segs[0].schema)
    mx = MeshQueryExecutor(device=CPU)
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        partial = pipeline.execute_partial(ctx, segs)
        stats = pipeline.stats()
    finally:
        pipeline.stop()
    assert mx.prepare_partial(ctx, segs).kind == "metadata"   # answered without a pass
    assert stats["launches"] == 0 and stats["scanLaunches"] == 0
    aggs = [make_agg(f) for f in ctx.aggregations]
    per_segment = merge_segment_results(
        [ServerQueryExecutor(device=CPU).execute_segment(ctx, s) for s in segs], aggs)
    assert (partial.kind, partial.groups, partial.scalar) == \
        (per_segment.kind, per_segment.groups, per_segment.scalar)
    got = reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                           list(ctx.group_by)).rows
    want = JaxExecutor().execute(jax_segs, sql).rows
    assert _rows_match(got, want, HOST_REL), (qid, got, want)


def test_the_case_sum_runs_through_the_masked_sum_scan(env, monkeypatch):
    """SUM(CASE ...) under an id band is a `masked_sums` operand row: once
    per segment, once for the aligned set."""
    calls = []
    real = scan.masked_sums_plain

    def spy(*args):
        calls.append(len(args[0]))
        return real(*args)
    monkeypatch.setattr(scan, "masked_sums_plain", spy)
    segs = env["tables"]["lo"]
    execute_query(segs, CASE_SUM, device=CPU)
    assert len(calls) == SEGMENTS
    MeshQueryExecutor(device=CPU).execute(segs, CASE_SUM)
    assert len(calls) == SEGMENTS + 1


def test_a_join_whose_leaf_filters_need_the_host_mask(env, tmp_path):
    cols = env["cols"]
    sup = ssb.make_supplier(ssb.HIGH_CARD_SUPPKEYS, SEED)
    tables = {"lineorder": env["tables"]["lo"],
              "supplier": segments_from_columns(ssb.supplier_schema(), sup,
                                                str(tmp_path / "sup"), 1)}
    schemas = {"lineorder": ssb.ssb_schema(), "supplier": ssb.supplier_schema()}
    sql = ("SELECT s.s_nation, SUM(l.lo_revenue), COUNT(*) FROM lineorder l "
           "JOIN supplier s ON l.lo_suppkey = s.s_suppkey "
           "WHERE length(s.s_nation) > 5 AND strpos(l.lo_region, 'A') = 0 "
           "GROUP BY s.s_nation ORDER BY s.s_nation LIMIT 25")
    got = execute_multistage(sql, make_segment_scan(tables, device=CPU), schemas.get)
    jax_tables = {t: [jax_load(s.path) for s in segs] for t, segs in tables.items()}
    jax_schemas = {t: JSchema.from_json(s.to_json()) for t, s in schemas.items()}
    want = jax_multistage(sql, jax_scan(jax_tables), jax_schemas.get)
    assert _rows_match(got.rows, want.rows, HOST_REL)
    nation = np.asarray(sup["s_nation"])[cols["lo_suppkey"]]
    keep = (np.array([len(x) > 5 for x in nation])
            & np.array([r.find("A") == 0 for r in cols["lo_region"]]))
    oracle = [[n, float(cols["lo_revenue"][keep & (nation == n)].sum()),
               int((keep & (nation == n)).sum())] for n in sorted(set(nation[keep]))]
    assert _rows_match(got.rows, oracle, HOST_REL)


def _consuming(cols, lo, hi):
    store = DeviceMutableSegment("lineorder__0__0__20261017T0000Z", ssb.ssb_schema())
    step = 1500
    for a in range(lo, hi, step):
        store.index_batch({c: v[a:min(a + step, hi)].tolist() for c, v in cols.items()})
    return store


@pytest.mark.parametrize("sql", [ssb.QUERY, ssb.GROUP_QUERY, ROUTES[1][2],
                                 "SELECT lo_orderdate / 10000, COUNT(*) FROM lineorder "
                                 "GROUP BY lo_orderdate / 10000 ORDER BY 1 LIMIT 20",
                                 "SELECT lo_region, lo_revenue FROM lineorder WHERE "
                                 "lo_quantity < 3 ORDER BY lo_revenue DESC LIMIT 4"],
                         ids=["q1_1", "group", "math_filter", "group_expr", "selection"])
def test_a_consuming_segment_without_staging_alone_and_in_a_mixed_set(env, sql):
    """A view of a store without staging is planned on the host (rel 1e-9
    against the reference's host answer over the same rows, committed); with
    committed segments, the set executor plans the set on the merged view."""
    cols, segs, jax_segs = env["cols"], env["tables"]["lo"], env["jax"]["lo"]
    bounds = [0] + list(np.cumsum([s.num_docs for s in segs]))
    store = _consuming(cols, bounds[2], bounds[3])
    view = store.query_view()
    assert view.is_mutable
    assert plan_segment(compile_query(sql, view.schema), view).kind in ("host", "selection")
    want_view = JaxExecutor(use_device=False).execute(jax_segs[2:], sql).rows
    assert _rows_match(execute_query([view], sql, device=CPU).rows, want_view, HOST_REL)
    want = JaxExecutor(use_device=False).execute(jax_segs, sql).rows
    got = MeshQueryExecutor(device=CPU).execute(segs[:2] + [view], sql).rows
    assert _rows_match(got, want, DEV_REL, DEV_ABS), (got, want)
    assert _rows_match(execute_query(segs[:2] + [view], sql, device=CPU).rows, want,
                       DEV_REL, DEV_ABS)


EVENTS = Schema("events", [dimension("user", DataType.STRING),
                           dimension("country", DataType.STRING),
                           metric("value", DataType.DOUBLE), metric("clicks", DataType.INT)])
TRANSFORMS = {"clicks": "clicks * 2 + length(country)", "country": "upper(country)"}
FILTER = "value < 0 OR startswith(user, 'x') = 1"


def _events(n, seed=3):
    rng = np.random.default_rng(seed)
    return {"user": [f"{'xu'[k % 2]}{k}" for k in rng.integers(0, 50, n)],
            "country": [["us", "de", "fr", None][k] for k in rng.integers(0, 4, n)],
            "value": [float(k) - 20.0 for k in rng.integers(0, 60, n)],
            "clicks": rng.integers(0, 9, n).tolist(), "extra": ["e"] * n}


def test_transform_pipeline_filters_and_transforms_as_the_reference():
    rows = _events(300)
    for flt, tr in ((FILTER, TRANSFORMS), (None, TRANSFORMS), (FILTER, None), (None, None)):
        got = TransformPipeline(EVENTS, flt, tr).apply(rows)
        want = JaxPipeline(JSchema.from_json(EVENTS.to_json()), flt, tr).apply(rows)
        assert got == want, (flt, tr)
    assert 0 < len(got["user"]) == 300
    with pytest.raises(ValueError, match="trailing"):
        TransformPipeline(EVENTS, "value < 0 value")


@pytest.mark.parametrize("decoder", ["json", "columnar"])
def test_realtime_lanes_apply_the_ingestion_filter_and_transforms(tmp_path, decoder):
    import json as _json
    MemoryStream.reset_all()
    rows = _events(400, seed=9)
    stream = MemoryStream.create(f"ev_{decoder}", 1)
    n = len(rows["user"])
    if decoder == "json":
        for i in range(n):
            stream.produce(_json.dumps({c: v[i] for c, v in rows.items()}).encode(),
                           partition=0)
    else:
        cols = TransformPipeline(EVENTS).apply(rows)
        for lo in range(0, n, 128):
            stream.produce(encode_columnar_block(EVENTS, {c: v[lo:lo + 128]
                                                          for c, v in cols.items()}),
                           partition=0)
    cfg = TableConfig("events", stream=StreamConfig(
        topic=f"ev_{decoder}", decoder=decoder,
        properties={"filterExpr": FILTER, "columnTransforms": TRANSFORMS}))
    consumer = RealtimePartitionConsumer("events__0__0__20261017T0000Z", cfg, EVENTS, 0,
                                         str(tmp_path), device=CPU)
    consumer.pump()
    want = TransformPipeline(EVENTS, FILTER, TRANSFORMS).apply(
        TransformPipeline(EVENTS).apply(rows) if decoder == "columnar" else rows)
    got = consumer.mutable.snapshot_arrays()
    assert consumer.mutable.num_docs == len(want["user"]) < n
    for c in ("user", "country", "clicks"):
        assert [None if v is None else v for v in np.asarray(got[c]).tolist()] == want[c], c
    view = consumer.query_segment()
    res = execute_query([view], "SELECT country, SUM(clicks) FROM events "
                        "GROUP BY country ORDER BY country", device=CPU).rows
    assert all(k is None or k == k.upper() for k, _ in res)


@pytest.mark.parametrize("kind", ["strings_with_none", "floats_with_nan", "ints", "empty"])
def test_factorize_keys_matches_the_reference(kind):
    """The port factorizes object keys through a dict (the reference sorts
    every row with np.unique): the same codes and the same sorted values."""
    from pinot_tpu.query.executor import _factorize_keys as jax_factorize
    from pinot_tpu_torch.query.executor import _factorize_keys
    rng = np.random.default_rng(11)
    words = np.array(["ASIA", "EUROPE", None, "AFRICA", "asia", ""], dtype=object)
    arr = {"strings_with_none": words[rng.integers(0, len(words), 500)],
           "floats_with_nan": np.where(rng.random(500) < 0.1, np.nan,
                                       rng.integers(0, 9, 500) / 4),
           "ints": rng.integers(-5, 5, 500),
           "empty": np.empty(0, dtype=object)}[kind]
    codes, values = _factorize_keys(arr)
    want_codes, want_values = jax_factorize(arr)
    np.testing.assert_array_equal(codes, want_codes)
    assert [None if v is None else v for v in values] == \
        [None if v is None else v for v in want_values]


def test_the_smoke_expr_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `expr` phase at 100,000 rows with the card's calls
    pointed at the CPU: every family, route, launch count and answer check
    of the phase passes; the host queries launch nothing."""
    import torch

    import chip_smoke
    from pinot_tpu_torch.engine import join_kernels, kernels
    from pinot_tpu_torch.multistage import runtime
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.segment import mutable_device
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments

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
    monkeypatch.setattr(chip_smoke, "EXPR_CONSUMING_ROWS", 32_768)
    # the expr_case timing (CUDA graphs and events, a 256 MiB L2 flush)
    for timer in ("graph_ms", "time_ms"):
        monkeypatch.setattr(chip_smoke, timer, lambda fn, flush: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "L2_FLUSH_BYTES", 8)
    rows = 100_000
    cols = ssb.make_columns(rows, SEED)
    table = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), cols, str(tmp_path / "main"), "lineorder", 8,
        SegmentGeneratorConfig(raw_cardinality_fraction=1.0))]

    class Args:
        seed, trace = SEED, False
    launches, case = chip_smoke.run_expr(Args(), table, cols, str(tmp_path))
    # grouped_agg: group_math's GROUP BY per segment (8) and over the set (1),
    # the GROUP BY over the table beside the consuming segment (1)
    assert launches == {"expr": {"masked_sums": 9, "masked_sums_fused": 0, "bitmap_filter": 0,
                                 "grouped_agg": 10},
                        "host": {"masked_sums": 0, "masked_sums_fused": 0, "bitmap_filter": 0,
                                 "grouped_agg": 0}}
    m = cols["lo_quantity"][:table[0].num_docs] < 25
    assert case["rows"] == table[0].num_docs and case["count"] == int(m.sum())
