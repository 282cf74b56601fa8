"""pinot_tpu_torch's star-trees against the JAX package's, on the CPU.

The same numpy-seeded SSB rows, built with star-trees by the port's writer:

* `try_star_tree` fits exactly the queries the JAX function fits, with the
  same slot aggregations, and the traversal masks are equal;
* per segment, over the set (the stacked device star path) and through the
  pipeline, star
  answers equal the JAX package's, numpy's and the same rows' without trees
  (counts exactly, sums rel 1e-6), on fixed queries and a randomized
  differential on the model of `tests/test_startree.py`;
* a whole-segment SUM(lo_revenue) through the star node, past 2^31, and its
  COUNT(*) (a SUM of `$count`, an exact integer sum) over the stacked path.
"""

import math

import numpy as np
import pytest

from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.startree_exec import try_star_tree as jax_try_star_tree
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu_torch import ssb
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.parallel import MeshQueryExecutor, combine
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.executor import execute_query
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.query.startree_exec import try_star_tree
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments

CPU = "cpu"
SEED = 20261019
ROWS, SEGMENTS = 3 * 9000 + 7, 3
REL = 1e-6
STAR_TREES = [
    {"dimensionsSplitOrder": ["lo_region", "lo_discount"],
     "functionColumnPairs": ["SUM__lo_revenue", "AVG__lo_quantity", "MIN__lo_extendedprice",
                             "MAX__lo_extendedprice", "MINMAXRANGE__lo_extendedprice"],
     "maxLeafRecords": 10},
    {"dimensionsSplitOrder": ["lo_orderdate", "lo_discount"],
     "functionColumnPairs": ["SUM__lo_revenue"]},
]

QUERIES = [
    ("star_query", ssb.STAR_QUERY),
    ("hc_orderdate", "SELECT lo_orderdate, SUM(lo_revenue), COUNT(*), AVG(lo_revenue) "
     "FROM lineorder WHERE lo_discount BETWEEN 1 AND 3 GROUP BY lo_orderdate "
     "ORDER BY lo_orderdate LIMIT 10"),
    ("scalar", "SELECT SUM(lo_revenue), COUNT(*), AVG(lo_quantity) FROM lineorder "
     "WHERE lo_region = 'ASIA'"),
    ("two_dims", "SELECT lo_region, lo_discount, COUNT(*), MIN(lo_extendedprice), "
     "MAX(lo_extendedprice) FROM lineorder WHERE lo_discount <> 4 "
     "GROUP BY lo_region, lo_discount ORDER BY lo_region, lo_discount LIMIT 100"),
    ("or_filter", "SELECT COUNT(*), MINMAXRANGE(lo_extendedprice) FROM lineorder "
     "WHERE lo_region = 'ASIA' OR lo_discount = 9"),
    ("order_by_agg", "SELECT lo_discount, SUM(lo_revenue) FROM lineorder "
     "WHERE lo_region IN ('AFRICA', 'EUROPE') GROUP BY lo_discount "
     "ORDER BY SUM(lo_revenue) DESC LIMIT 3"),
]
IDS = [q[0] for q in QUERIES]
NOT_FITTING = [
    "SELECT SUM(lo_revenue) FROM lineorder",                           # metadata is better
    "SELECT lo_suppkey, SUM(lo_revenue) FROM lineorder GROUP BY lo_suppkey",
    "SELECT SUM(lo_extendedprice) FROM lineorder WHERE lo_region = 'ASIA'",
    "SELECT COUNT(*) FROM lineorder WHERE lo_quantity < 10",
    "SELECT DISTINCTCOUNT(lo_region) FROM lineorder WHERE lo_discount = 1",
    "SELECT lo_region, lo_revenue FROM lineorder WHERE lo_discount = 1 LIMIT 5",
    "SELECT SUM(lo_revenue + 1) FROM lineorder WHERE lo_discount = 1",
]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_startree")
    cols = ssb.make_columns(ROWS, SEED)
    star = build_aligned_segments(ssb.ssb_schema(), cols, str(out / "star"), "lineorder",
                                  SEGMENTS, SegmentGeneratorConfig(star_tree_configs=STAR_TREES))
    plain = build_aligned_segments(ssb.ssb_schema(), cols, str(out / "plain"), "lineorder",
                                   SEGMENTS)
    return {"cols": cols, "segs": [load_segment(p) for p in star],
            "jax": [jax_load(p) for p in star], "plain": [load_segment(p) for p in plain]}


def _rows_match(got, want) -> bool:
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None or not math.isclose(x, y, rel_tol=REL):
                    return False
            elif x != y:
                return False
    return True


def _served(segs, sql, mx):
    ctx = compile_query(sql, segs[0].schema)
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        partial = pipeline.execute_partial(ctx, segs)
    finally:
        pipeline.stop()
    aggs = [make_agg(f) for f in ctx.aggregations]
    return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                            list(ctx.group_by)).rows


@pytest.mark.parametrize("sql", [q[1] for q in QUERIES] + NOT_FITTING,
                         ids=IDS + [f"not_fitting_{i}" for i in range(len(NOT_FITTING))])
def test_try_star_tree_fits_as_the_jax_function(env, sql):
    for seg, jseg in zip(env["segs"], env["jax"]):
        ours = try_star_tree(compile_query(sql, seg.schema), seg)
        theirs = jax_try_star_tree(jax_compile(sql, jseg.schema), jseg)
        assert (ours is None) == (theirs is None)
        if ours is None:
            continue
        assert ours.tree.path == theirs.tree.path
        assert [repr(f) for f in ours.ctx2.aggregations] == \
            [repr(f) for f in theirs.ctx2.aggregations]
        assert ours.slots_per_agg == theirs.slots_per_agg
        np.testing.assert_array_equal(ours.record_mask, theirs.record_mask)


def test_star_tree_files_match_the_jax_builder(env, tmp_path):
    """The JAX writer builds the same trees from the same rows: node arrays
    and record tables equal, so either package loads the other's."""
    from pinot_tpu.schema import Schema as JSchema
    from pinot_tpu.segment.startree import StarTreeIndexConfig as JaxStarConfig
    from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
    from pinot_tpu.segment.writer import build_aligned_segments as jax_build
    paths = jax_build(JSchema.from_json(ssb.ssb_schema().to_json()), env["cols"],
                      str(tmp_path), "lineorder", SEGMENTS, config=JaxConfig(
                          star_tree_configs=[JaxStarConfig.from_json(d) for d in STAR_TREES]))
    for ours, path in zip(env["segs"], paths):
        theirs = load_segment(path)
        for a, b in zip(ours.star_trees, theirs.star_trees):
            assert a.dims == b.dims and a.num_records == b.num_records and a.cards == b.cards
            for f in ("node_value", "node_start", "node_end", "node_child_start",
                      "node_child_end"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            for d in a.dims:
                np.testing.assert_array_equal(a.dim_ids[d], b.dim_ids[d])
            assert sorted(a.metric_arrays) == sorted(b.metric_arrays)
            for k in a.metric_arrays:
                np.testing.assert_array_equal(a.metric_arrays[k], b.metric_arrays[k])


@pytest.mark.parametrize("route", ["per_segment", "set", "pipeline"])
@pytest.mark.parametrize("qid, sql", QUERIES, ids=IDS)
def test_star_answers_match_the_reference_and_the_plain_rows(env, qid, sql, route):
    """Per segment (each segment's tree), over the set (the stacked device star
    path) and through the pipeline: the JAX answer and the same rows' without
    trees."""
    segs = env["segs"]
    want = execute_query(env["plain"], sql, device=CPU).rows
    jax_rows = JaxExecutor().execute(env["jax"], sql).rows
    assert _rows_match(jax_rows, want), (jax_rows, want)
    mx = MeshQueryExecutor(device=CPU)
    plan, _ = mx._plan_for_set(compile_query(sql, segs[0].schema), segs)
    assert isinstance(plan, combine.StarSetPlan)
    got = {"per_segment": lambda: execute_query(segs, sql, device=CPU).rows,
           "set": lambda: mx.execute(segs, sql).rows,
           "pipeline": lambda: _served(segs, sql, mx)}[route]()
    assert _rows_match(got, want), (got, want)


def test_star_answers_match_numpy(env):
    c = env["cols"]
    m = (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3)
    want = [[r, c["lo_revenue"][m & (c["lo_region"] == r)].sum()] for r in ssb.REGIONS]
    assert _rows_match(execute_query(env["segs"], ssb.STAR_QUERY, device=CPU).rows, want)
    dates = np.unique(c["lo_orderdate"][m])[:10]
    want = [[int(d), c["lo_revenue"][m & (c["lo_orderdate"] == d)].sum(),
             int((m & (c["lo_orderdate"] == d)).sum()),
             c["lo_revenue"][m & (c["lo_orderdate"] == d)].mean()] for d in dates]
    assert _rows_match(MeshQueryExecutor(device=CPU).execute(env["segs"], QUERIES[1][1]).rows,
                       want)


def test_the_stacked_star_path_matches_the_jax_mesh(env, monkeypatch):
    """The JAX set executor's stacked star path (its 65,536-record floor
    lowered) and the port's give one answer."""
    from pinot_tpu.parallel import combine as jax_combine
    monkeypatch.setattr(jax_combine, "STAR_DEVICE_MIN_RECORDS", 1)
    jmx = JaxMeshExecutor(default_mesh(1))
    for _, sql in QUERIES[:3]:
        assert isinstance(jmx._plan_for_set(jax_compile(sql, env["jax"][0].schema),
                                            env["jax"])[0], jax_combine.StarSetPlan)
        assert _rows_match(MeshQueryExecutor(device=CPU).execute(env["segs"], sql).rows,
                           jmx.execute(env["jax"], sql).rows)


@pytest.mark.parametrize("route", ["set", "execute_many", "pipeline"])
def test_a_set_whose_slot_plans_do_not_stack_traverses_each_tree_once(env, monkeypatch,
                                                                      route):
    """When the slot plans do not stack, the set plans a StarLoopPlan and the
    per-segment executor answers from its fits: each tree is traversed once
    per query, and the answer is the stacked path's."""
    from pinot_tpu_torch.query import executor
    segs, sql = env["segs"], ssb.STAR_QUERY
    mx = MeshQueryExecutor(device=CPU)
    want = mx.execute(segs, sql).rows
    calls = []

    def counted(module):
        real = module.try_star_tree

        def fit(ctx, segment):
            calls.append(segment)
            return real(ctx, segment)
        monkeypatch.setattr(module, "try_star_tree", fit)
    counted(combine)
    counted(executor)
    monkeypatch.setattr(MeshQueryExecutor, "_plan_star_device", lambda self, plans: None)
    assert isinstance(mx._plan_for_set(compile_query(sql, segs[0].schema), segs)[0],
                      combine.StarLoopPlan)
    calls.clear()
    got = {"set": lambda: mx.execute(segs, sql).rows,
           "execute_many": lambda: mx.execute_many(segs, [sql])[0].rows,
           "pipeline": lambda: _served(segs, sql, mx)}[route]()
    assert _rows_match(got, want), (got, want)
    assert len(calls) == len(segs) and {id(s) for s in calls} == {id(s) for s in segs}


def test_star_randomized_differential(env):
    """Random queries over the trees' dimensions and stored aggregations: the
    star answers (per segment and stacked) equal the plain rows'."""
    rng = np.random.default_rng(SEED)
    aggs = ["SUM(lo_revenue)", "AVG(lo_quantity)", "MIN(lo_extendedprice)",
            "MAX(lo_extendedprice)", "COUNT(*)", "MINMAXRANGE(lo_extendedprice)"]
    mx = MeshQueryExecutor(device=CPU)
    used = 0
    for _ in range(24):
        keys = [d for d in ("lo_region", "lo_discount") if rng.random() < 0.5]
        chosen = list(dict.fromkeys(aggs[int(rng.integers(0, len(aggs)))]
                                    for _ in range(int(rng.integers(1, 4)))))
        preds = []
        if rng.random() < 0.6:
            picks = sorted(set(rng.integers(0, 5, int(rng.integers(1, 3))).tolist()))
            preds.append("lo_region IN (" + ", ".join(f"'{ssb.REGIONS[i]}'" for i in picks)
                         + ")")
        if rng.random() < 0.5 or not (preds or keys):
            preds.append(f"lo_discount BETWEEN {int(rng.integers(0, 5))} "
                         f"AND {int(rng.integers(5, 11))}")
        where = " WHERE " + " AND ".join(preds) if preds else ""
        group = f" GROUP BY {', '.join(keys)} ORDER BY {', '.join(keys)}" if keys else ""
        sql = f"SELECT {', '.join(keys + chosen)} FROM lineorder{where}{group} LIMIT 1000"
        ctx = compile_query(sql, env["segs"][0].schema)
        used += try_star_tree(ctx, env["segs"][0]) is not None
        want = execute_query(env["plain"], sql, device=CPU).rows
        for got in (execute_query(env["segs"], sql, device=CPU).rows,
                    mx.execute(env["segs"], sql).rows):
            assert _rows_match(got, want), (sql, got, want)
    assert used >= 20


def test_a_whole_segment_sum_through_the_star_node_past_2_31(tmp_path):
    """Two segments of 60,000 rows: SUM(lo_revenue) over every row (the
    region star node's records) is ~3.6e9, past 2^31; its COUNT(*) is a SUM of
    `$count`, held exactly on every path, the stacked one included."""
    cols = ssb.make_columns(120_000, SEED + 1)
    paths = build_aligned_segments(ssb.ssb_schema(), cols, str(tmp_path), "lineorder", 2,
                                   SegmentGeneratorConfig(star_tree_configs=STAR_TREES[:1]))
    segs = [load_segment(p) for p in paths]
    sql = ("SELECT SUM(lo_revenue), COUNT(*), AVG(lo_revenue) FROM lineorder "
           "WHERE lo_discount BETWEEN 0 AND 10")
    stp = try_star_tree(compile_query(sql, segs[0].schema), segs[0])
    assert stp is not None and int(stp.record_mask.sum()) <= 11
    total = cols["lo_revenue"].sum()
    assert total > 2 ** 31
    want = [[total, len(cols["lo_revenue"]), total / len(cols["lo_revenue"])]]
    jax_rows = JaxExecutor().execute([jax_load(p) for p in paths], sql).rows
    mx = MeshQueryExecutor(device=CPU)
    assert isinstance(mx._plan_for_set(compile_query(sql, segs[0].schema), segs)[0],
                      combine.StarSetPlan)
    for got in (execute_query(segs, sql, device=CPU).rows, mx.execute(segs, sql).rows,
                _served(segs, sql, mx)):
        assert got[0][1] == want[0][1]
        assert _rows_match(got, want), (got, want)
    assert jax_rows[0][1] == want[0][1]
    assert math.isclose(jax_rows[0][0], total, rel_tol=REL)
