"""Differential test: pinot_tpu_torch's selections and ORDER BY ... LIMIT top-k.

The same SQL over the same SSB segments (3 segments, seeded) runs through
the port's three entry points on the CPU: `execute_query(device="cpu")`,
`MeshQueryExecutor(device="cpu").execute` and `DeviceQueryPipeline.
execute_partial` followed by the port's reduce. Each answer is held against
`pinot_tpu`'s `ServerQueryExecutor()` (its per-segment device top-k, on the
CPU), `ServerQueryExecutor(use_device=False)` (its host path) and a numpy
oracle that orders ties by global row index. Floats at the reference's device
tolerance (rel 1e-5, abs 0.05); row order exactly.

Two tables: "raw" is built as the writer decides at this size (lo_custkey,
lo_extendedprice and lo_revenue raw), "dict" with every column
dictionary-encoded, as the writer encodes them at 16,777,216 rows; GROUP BY
lo_custkey needs its dictionary.

Also the traps: ties beyond k + TOPK_SLACK, NaN keys (the pipeline answers by
the exact path and counts it), the set's fold guard (a raw range that holds
for the first segment's rows only), and the exact group trim.
"""

import math

import numpy as np
import pytest

from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
from pinot_tpu.segment.writer import build_aligned_segments as jax_build
from pinot_tpu_torch import ServerQueryExecutor, execute_query
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import kernels
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.executor import TOPK_SLACK
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.ssb import make_columns, ssb_schema

REL, ABS = 1e-5, 0.05
SEED = 20260729
ROWS = 3 * 30011

TOPK_DESC = ("SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
             "ORDER BY lo_revenue DESC LIMIT 7")
TOPK_ALL = ("SELECT lo_suppkey, lo_extendedprice FROM lineorder "
            "ORDER BY lo_extendedprice LIMIT 12")
TOPK_TIES = ("SELECT lo_custkey, lo_orderdate, lo_revenue FROM lineorder "
             "WHERE lo_quantity >= 10 ORDER BY lo_suppkey LIMIT 9")
SELECT_LIMIT = ("SELECT lo_region, lo_revenue FROM lineorder WHERE lo_quantity < 3 "
                "LIMIT 10")
ORDER_EXACT = ("SELECT lo_custkey, lo_orderdate FROM lineorder WHERE lo_quantity = 1 "
               "AND lo_discount = 0 ORDER BY lo_orderdate DESC LIMIT 5")
GROUP_TRIM = ("SELECT lo_custkey, SUM(lo_revenue) FROM lineorder GROUP BY lo_custkey "
              "ORDER BY SUM(lo_revenue) DESC LIMIT 10")


def _ordered(c, mask, select, key, desc, limit):
    """numpy: the matching rows by `key` (ties by row index), first `limit`."""
    idx = np.nonzero(mask)[0]
    if key is not None:
        v = c[key][idx].astype(np.float64)
        idx = idx[np.argsort(-v if desc else v, kind="stable")]
    return [[c[s][i].item() if hasattr(c[s][i], "item") else c[s][i] for s in select]
            for i in idx[:limit]]


def _group_trim_oracle(c):
    sums = np.bincount(c["lo_custkey"], weights=c["lo_revenue"])
    keys = np.nonzero(np.bincount(c["lo_custkey"]))[0]
    top = keys[np.argsort(-sums[keys], kind="stable")][:10]
    return [[int(k), float(sums[k])] for k in top]


# (id, sql, numpy oracle over the columns, device top-k per segment?)
QUERIES = {
    "topk_desc": (TOPK_DESC, lambda c: _ordered(
        c, c["lo_quantity"] >= 10, ["lo_custkey", "lo_revenue"], "lo_revenue", True, 7),
        True),
    "topk_all": (TOPK_ALL, lambda c: _ordered(
        c, np.ones(len(c["lo_quantity"]), bool), ["lo_suppkey", "lo_extendedprice"],
        "lo_extendedprice", False, 12), True),
    "topk_ties": (TOPK_TIES, lambda c: _ordered(
        c, c["lo_quantity"] >= 10, ["lo_custkey", "lo_orderdate", "lo_revenue"],
        "lo_suppkey", False, 9), True),
    "select_limit": (SELECT_LIMIT, lambda c: _ordered(
        c, c["lo_quantity"] < 3, ["lo_region", "lo_revenue"], None, False, 10), False),
    "order_exact": (ORDER_EXACT, lambda c: _ordered(
        c, (c["lo_quantity"] == 1) & (c["lo_discount"] == 0),
        ["lo_custkey", "lo_orderdate"], "lo_orderdate", True, 5), False),
    "group_trim": (GROUP_TRIM, _group_trim_oracle, False),
}
CASES = [(q, t) for q in QUERIES for t in ("dict", "raw") if (q, t) != ("group_trim", "raw")]


@pytest.fixture(scope="module")
def cols():
    return make_columns(ROWS, seed=SEED)


@pytest.fixture(scope="module")
def tables(tmp_path_factory, cols):
    out = tmp_path_factory.mktemp("torch_selection")
    schema = JSchema.from_json(ssb_schema().to_json())
    built = {}
    for name, config in (("raw", None), ("dict", JaxConfig(raw_cardinality_fraction=1.0))):
        paths = jax_build(schema, cols, str(out / name), "lineorder", 3, config=config)
        built[name] = ([jax_load(p) for p in paths], [load_segment(p) for p in paths])
    assert built["raw"][1][0].column("lo_revenue").has_dictionary is False
    assert built["dict"][1][0].column("lo_custkey").has_dictionary
    return built


def _same(x, y) -> bool:
    if isinstance(x, float) or isinstance(y, float):
        if math.isnan(float(x)) or math.isnan(float(y)):
            return math.isnan(float(x)) and math.isnan(float(y))
        return math.isclose(float(x), float(y), rel_tol=REL, abs_tol=ABS)
    return x == y


def _rows_match(a, b) -> bool:
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(_same(x, y) for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def _spy(monkeypatch, name):
    calls = []
    real = getattr(kernels, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(kernels, name, spy)
    return calls


def _reduce(ctx, partial):
    aggs = [make_agg(f) for f in ctx.aggregations]
    merged = merge_segment_results([partial], aggs)
    return reduce_to_result(ctx, merged, aggs, list(ctx.group_by))


def _pipeline_rows(segs, sql):
    mx = MeshQueryExecutor(device="cpu")
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        ctx = compile_query(sql, segs[0].schema)
        rows = _reduce(ctx, pipeline.execute_partial(ctx, segs)).rows
        return rows, pipeline.stats()
    finally:
        pipeline.stop()


@pytest.mark.parametrize("qid, table", CASES, ids=[f"{q}-{t}" for q, t in CASES])
def test_three_entry_points_match_reference_and_numpy(tables, cols, monkeypatch, qid, table):
    sql, oracle, per_segment_topk = QUERIES[qid]
    jax_segs, segs = tables[table]
    want = oracle(cols)
    dev = JaxExecutor().execute(jax_segs, sql).rows
    host = JaxExecutor(use_device=False).execute(jax_segs, sql).rows
    assert _rows_match(dev, want), (qid, dev, want)
    assert _rows_match(host, want), (qid, host, want)

    host_topk = _spy(monkeypatch, "compute_topk")
    launches = _spy(monkeypatch, "topk")
    got = execute_query(segs, sql, device="cpu")
    assert _rows_match(got.rows, want), (qid, got.rows, want)
    assert len(host_topk) == (len(segs) if per_segment_topk else 0)
    if got.stats.get("topkExact") is not None:
        assert got.stats["topkExact"] == (qid == "order_exact")

    del host_topk[:], launches[:]
    by_set = MeshQueryExecutor(device="cpu").execute(segs, sql).rows
    assert _rows_match(by_set, want), (qid, by_set, want)
    assert len(host_topk) == (len(segs) if per_segment_topk else 0)

    del host_topk[:], launches[:]
    served, stats = _pipeline_rows(segs, sql)
    assert _rows_match(served, want), (qid, served, want)
    assert not host_topk
    assert len(launches) == stats["topkLaunches"] == (1 if per_segment_topk else 0)
    assert stats["topkExact"] == (qid in ("select_limit", "order_exact"))


def test_order_exact_never_reaches_the_top_k(tables, monkeypatch):
    _, segs = tables["dict"]
    calls = _spy(monkeypatch, "topk")
    res = ServerQueryExecutor(device="cpu").execute(segs, ORDER_EXACT)
    assert res.stats["topkExact"] is True and not calls
    # lo_orderdate's values reach 2^24: f32 would misorder them
    assert segs[0].column("lo_orderdate").max_value >= 1 << 24


def _tie_table(tmp_path, n, keys):
    """SSB rows whose lo_suppkey takes `keys` values: every key ties far more
    rows than k + TOPK_SLACK."""
    c = make_columns(n, seed=SEED)
    c["lo_suppkey"] = (c["lo_suppkey"] % keys).astype(np.int32)
    schema = JSchema.from_json(ssb_schema().to_json())
    paths = jax_build(schema, c, str(tmp_path), "lineorder", 3)
    return c, [jax_load(p) for p in paths], [load_segment(p) for p in paths]


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_ties_beyond_the_slack_keep_the_host_order(tmp_path, monkeypatch, desc):
    c, jax_segs, segs = _tie_table(tmp_path, 9000, 4)
    direction = "DESC" if desc else ""
    sql = ("SELECT lo_custkey, lo_suppkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
           f"ORDER BY lo_suppkey {direction} LIMIT 9 OFFSET 3")
    m = c["lo_quantity"] >= 10
    key = c["lo_suppkey"][m].max() if desc else c["lo_suppkey"][m].min()
    assert ((c["lo_suppkey"] == key) & m).sum() > 12 + TOPK_SLACK
    want = _ordered(c, m, ["lo_custkey", "lo_suppkey", "lo_revenue"], "lo_suppkey", desc,
                    12)[3:]
    host = JaxExecutor(use_device=False).execute(jax_segs, sql).rows
    assert _rows_match(host, want)
    calls = _spy(monkeypatch, "topk")
    assert _rows_match(execute_query(segs, sql, device="cpu").rows, want)
    assert _rows_match(MeshQueryExecutor(device="cpu").execute(segs, sql).rows, want)
    served, stats = _pipeline_rows(segs, sql)
    assert _rows_match(served, want), (served, want)
    assert len(calls) == 2 * len(segs) + 1 and stats["topkExact"] == 0


def test_tie_key_orders_by_score_then_lower_row():
    import torch
    score = torch.tensor([1.0, 2.0, 2.0, float("-inf"), -0.0, 0.0, -2.0, 2.0])
    key = kernels._tie_broken_key(score)
    order = torch.topk(key, 8).indices.tolist()
    assert order == [1, 2, 7, 0, 4, 5, 6, 3]


def test_nan_keys_send_the_pipeline_to_the_exact_path(tmp_path, monkeypatch):
    c = make_columns(6000, seed=SEED)
    # a matching row of each segment gets a NaN key
    nan_rows = [lo + int(np.nonzero(c["lo_quantity"][lo:] >= 10)[0][0])
                for lo in (5, 2100, 4500)]
    c["lo_revenue"] = c["lo_revenue"].copy()
    c["lo_revenue"][nan_rows] = np.nan
    schema = JSchema.from_json(ssb_schema().to_json())
    paths = jax_build(schema, c, str(tmp_path), "lineorder", 3)
    jax_segs, segs = [jax_load(p) for p in paths], [load_segment(p) for p in paths]
    for sql in (TOPK_DESC, TOPK_DESC.replace(" DESC", "")):
        host = JaxExecutor(use_device=False).execute(jax_segs, sql).rows
        calls = _spy(monkeypatch, "topk")
        served, stats = _pipeline_rows(segs, sql)
        assert _rows_match(served, host), (sql, served, host)
        assert stats["topkLaunches"] == len(calls) == 1 and stats["topkExact"] == 1
        res = execute_query(segs, sql, device="cpu")
        assert _rows_match(res.rows, host) and res.stats["topkExact"] is True
        monkeypatch.undo()


def test_fold_guard_on_the_pipeline_route(tmp_path, monkeypatch):
    """8,000 rows sorted by lo_extendedprice descending, in 4 aligned segments:
    `lo_extendedprice >= <segment 0's min>` holds for segment 0's rows only.
    Planned by the first segment alone it would fold to match-all."""
    from pinot_tpu_torch.segment.writer import build_aligned_segments
    c = make_columns(8000, seed=3)
    order = np.argsort(-c["lo_extendedprice"], kind="stable")
    c = {k: v[order] for k, v in c.items()}
    segs = [load_segment(p) for p in build_aligned_segments(
        ssb_schema(), c, str(tmp_path), "lineorder", 4)]
    assert not segs[0].column("lo_extendedprice").has_dictionary
    low = float(segs[0].column("lo_extendedprice").min_value)
    sql = ("SELECT lo_custkey, lo_revenue FROM lineorder "
           f"WHERE lo_extendedprice >= {low} ORDER BY lo_revenue DESC LIMIT 5")
    m = c["lo_extendedprice"] >= low
    assert m.sum() == 2000
    want = _ordered(c, m, ["lo_custkey", "lo_revenue"], "lo_revenue", True, 5)
    calls = _spy(monkeypatch, "topk")
    served, stats = _pipeline_rows(segs, sql)
    assert _rows_match(served, want), (served, want)
    assert len(calls) == stats["topkLaunches"] == 1 and stats["topkExact"] == 0


@pytest.mark.parametrize("sql, k, ties", [
    # the dense decode declines post-aggregation arithmetic: the classic
    # decode with the exact trim
    ("SELECT lo_custkey, SUM(lo_revenue), SUM(lo_revenue) / COUNT(*) FROM lineorder "
     "GROUP BY lo_custkey ORDER BY SUM(lo_revenue) DESC LIMIT 10", 10, False),
    # COUNT(*) ties at the k-th group: the trim keeps the lower keys, as the
    # untrimmed sort does. (The per-segment path orders tied groups as its
    # merge first saw them, so it is not compared here.)
    ("SELECT lo_custkey, COUNT(*) * 2 FROM lineorder WHERE lo_quantity < 40 "
     "GROUP BY lo_custkey ORDER BY COUNT(*) DESC LIMIT 25 OFFSET 5", 30, True),
    ("SELECT lo_custkey, AVG(lo_revenue) + 0 FROM lineorder GROUP BY lo_custkey "
     "ORDER BY AVG(lo_revenue) LIMIT 10", 10, False),
], ids=["sum", "count_ties", "avg"])
def test_group_trim_decodes_k_groups_and_keeps_the_untrimmed_order(tables, monkeypatch,
                                                                   sql, k, ties):
    _, segs = tables["dict"]
    mx = MeshQueryExecutor(device="cpu")
    decoded = []
    real = mx._fallback._decode_group_partials

    def spy(plan, outs, trim_global=False):
        r = real(plan, outs, trim_global=trim_global)
        decoded.append((trim_global, len(r.groups)))
        return r
    monkeypatch.setattr(mx._fallback, "_decode_group_partials", spy)
    got = mx.execute(segs, sql).rows
    assert decoded == [(True, k)]
    limit = sql.index("LIMIT")
    untrimmed_sql = sql[:limit] + "LIMIT 1000000"
    untrimmed = mx.execute(segs, untrimmed_sql).rows
    assert decoded[1] == (True, len(untrimmed)) and len(untrimmed) > 1000
    offset = k - int(sql[limit:].split()[1])
    assert got == untrimmed[offset:k]
    if not ties:
        assert _rows_match(got, execute_query(segs, sql, device="cpu").rows)


def test_group_trim_on_the_dense_decode_returns_the_untrimmed_first_k(tables, cols):
    _, segs = tables["dict"]
    mx = MeshQueryExecutor(device="cpu")
    res = mx.execute(segs, GROUP_TRIM)
    assert res.stats.get("denseReduce") and len(res.rows) == 10
    untrimmed = mx.execute(segs, GROUP_TRIM.replace("LIMIT 10", "LIMIT 1000000")).rows
    assert res.rows == untrimmed[:10]
    assert _rows_match(res.rows, _group_trim_oracle(cols))


def test_selection_whose_filter_needs_the_host_mask_raises(tables, cols, monkeypatch):
    """A filter the device cannot evaluate (a string function) takes the host
    filter mask on every path, as in the JAX package: no device top-k, the
    exact path, and numpy's rows and the reference's."""
    from pinot_tpu.query.context import compile_query as jax_compile
    from pinot_tpu.query.planner import plan_segment as jax_plan
    from pinot_tpu_torch.query.planner import plan_segment

    jax_segs, segs = tables["raw"]
    sql = ("SELECT lo_revenue FROM lineorder WHERE LENGTH(lo_region) > 4 "
           "ORDER BY lo_revenue LIMIT 3")
    ctx = compile_query(sql, segs[0].schema)
    assert {plan_segment(ctx, s).fallback_reason for s in segs} == {
        "non-numeric column lo_region in expression"}
    assert {jax_plan(jax_compile(sql, jax_segs[0].schema), s).kind
            for s in jax_segs} == {"selection"}
    topk = _spy(monkeypatch, "topk")
    keep = np.array([len(r) > 4 for r in cols["lo_region"]])
    want = [[v] for v in sorted(cols["lo_revenue"][keep].tolist())[:3]]
    got = execute_query(segs, sql, device="cpu")
    assert _rows_match(got.rows, want) and got.stats["topkExact"]
    assert _rows_match(JaxExecutor().execute(jax_segs, sql).rows, want)
    assert MeshQueryExecutor(device="cpu").prepare_partial(ctx, segs).kind == "exact"
    assert topk == []


def test_execute_many_answers_selections_beside_aggregations(tables):
    from pinot_tpu_torch.ssb import QUERY
    _, segs = tables["raw"]
    queries = [TOPK_DESC, QUERY, ORDER_EXACT, SELECT_LIMIT, TOPK_DESC]
    mx = MeshQueryExecutor(device="cpu")
    one_by_one = [mx.execute(segs, q).rows for q in queries]
    assert [r.rows for r in mx.execute_many(segs, queries)] == one_by_one
    assert one_by_one[0] == execute_query(segs, TOPK_DESC, device="cpu").rows


def test_one_drain_serves_top_k_exact_and_aggregation_items(tables, monkeypatch):
    """Items queued together form one drain with one fetch: identical top-k
    queries share one launch, distinct ones launch once each, never stacked; a
    selection without ORDER BY is answered when prepared; an aggregation rides
    the same fetch."""
    from pinot_tpu_torch.cluster.device_server import _Item
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY
    _, segs = tables["dict"]
    sqls = [TOPK_DESC, TOPK_DESC.replace("LIMIT 7", "LIMIT 7 OFFSET 0"), TOPK_ALL,
            SELECT_LIMIT, QUERY, GROUP_QUERY, TOPK_DESC]
    mx = MeshQueryExecutor(device="cpu")
    fetches = []
    real_fetch = mx.fetch

    def spy(launches):
        fetches.append(len(launches))
        return real_fetch(launches)
    monkeypatch.setattr(mx, "fetch", spy)
    pipeline = DeviceQueryPipeline(mesh_exec=mx, start=False)
    ctxs = [compile_query(sql, segs[0].schema) for sql in sqls]
    items = [_Item(ctx, segs) for ctx in ctxs]
    for item in items:
        pipeline._q.put(item)
    try:
        pipeline.start()
        rows = [_reduce(ctx, item.future.result(timeout=60)).rows
                for ctx, item in zip(ctxs, items)]
        stats = pipeline.stats()
    finally:
        pipeline.stop()
    for sql, got in zip(sqls, rows):
        assert _rows_match(got, execute_query(segs, sql, device="cpu").rows), sql
    assert fetches == [4]   # TOPK_DESC, TOPK_ALL, QUERY, GROUP_QUERY
    assert (stats["batches"], stats["topkLaunches"], stats["topkExact"]) == (1, 2, 1)
    assert stats["dedupeHits"] == 2 and stats["stackedLaunches"] == 0


@pytest.mark.parametrize("raw, n_segments", [(True, 1), (True, 3), (False, 1), (False, 3)],
                         ids=["raw-1", "raw-3", "dict-1", "dict-3"])
def test_double_keys_that_tie_in_f32_take_the_exact_path(tmp_path, monkeypatch, raw,
                                                         n_segments):
    """700 DOUBLE keys 1.0 + i * 1e-12 all round to the f32 score 1.0: more than
    k + TOPK_SLACK of them tie in f32, and the largest doubles sit at the
    highest rows, which the candidate pass (lower rows first among ties) never
    keeps. Every entry point answers rows 699, 698, 697, as numpy and the
    reference's host path do: where the candidates were cut, by the exact path."""
    from pinot_tpu.schema import DataType as JType
    from pinot_tpu.schema import dimension as jdim
    from pinot_tpu.schema import metric as jmetric
    n = 700
    cols = {"id": np.arange(n, dtype=np.int32), "d": 1.0 + np.arange(n) * 1e-12}
    assert len(np.unique(cols["d"].astype(np.float32))) == 1 and n > 3 + TOPK_SLACK
    schema = JSchema("t", [jdim("id", JType.INT), jmetric("d", JType.DOUBLE)])
    config = JaxConfig(raw_cardinality_fraction=0.7 if raw else 1.0)
    paths = jax_build(schema, cols, str(tmp_path), "t", n_segments, config=config)
    jax_segs, segs = [jax_load(p) for p in paths], [load_segment(p) for p in paths]
    assert segs[0].column("d").has_dictionary is not raw
    sql = "SELECT id, d FROM t ORDER BY d DESC LIMIT 3"
    want = [[i, float(cols["d"][i])] for i in (699, 698, 697)]
    host = JaxExecutor(use_device=False).execute(jax_segs, sql).rows
    assert [[r[0], r[1]] for r in host] == want

    def exact(rows):
        return [[r[0], r[1]] for r in rows] == want

    # per segment, the candidates are cut only where a segment holds more
    # than k + TOPK_SLACK rows (one segment of 700; not three of ~233)
    cut = n_segments == 1
    calls = _spy(monkeypatch, "topk")
    res = execute_query(segs, sql, device="cpu")
    assert exact(res.rows), res.rows
    assert res.stats["topkExact"] is cut and len(calls) == n_segments
    res = MeshQueryExecutor(device="cpu").execute(segs, sql)
    assert exact(res.rows), res.rows
    assert res.stats["topkExact"] is cut
    served, stats = _pipeline_rows(segs, sql)
    assert exact(served), served
    assert stats["topkLaunches"] == 1 and stats["topkExact"] == 1
