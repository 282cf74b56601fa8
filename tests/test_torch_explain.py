"""pinot_tpu_torch's EXPLAIN PLAN FOR and EXPLAIN ANALYZE against the JAX package's.

The same numpy-seeded SSB rows are written by both packages' writers into
dictionary-aligned segments (an inverted index on lo_region, a bloom filter
on lo_custkey and a star-tree over [lo_region, lo_discount]), and each
package queries the segments it loads, on the CPU:

* EXPLAIN rows equal the JAX package's, row for row, for device, host (with
  its fallback reason), selection, ORDER BY, HAVING, metadata-only, pruned
  (a constant-false filter and a bloom filter), null-leaf, expression-leaf,
  doc-set and star-tree plans, over the segments of either writer;
* EXPLAIN ANALYZE has the same labels, ids and `Rows`, a `Ms` wherever it
  has `Rows`, and carries the plain query's answer (row count and docs
  scanned);
* EXPLAIN launches nothing and EXPLAIN ANALYZE of Q1.1 one scan a segment;
* the set executor and the serving pipeline treat an EXPLAIN context as the
  JAX set executor does: a plan the set path runs on the device answers the
  query itself (the flag is not read there), and a set the path hands to
  the per-segment executor answers the EXPLAIN;
* under `upsert=` (each segment under its valid-doc mask) EXPLAIN shows
  the plan that runs: no metadata answer and no star-tree rewrite, and
  EXPLAIN ANALYZE gives each of its operators but the filters `Rows` and
  `Ms`.
"""

import math

import numpy as np
import pytest

from pinot_tpu.cluster.device_server import DeviceQueryPipeline as JaxPipeline
from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import execute_query as jax_execute
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.startree import StarTreeIndexConfig as JaxStarConfig
from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
from pinot_tpu.segment.writer import build_aligned_segments as jax_build
from pinot_tpu_torch import ssb
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import scan
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.executor import ServerQueryExecutor, execute_query
from pinot_tpu_torch.query.explain import ANALYZE_COLUMNS
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments

CPU = "cpu"
SEED = 20261113
ROWS, SEGMENTS = 3 * 4000 + 7, 3
REL = 1e-5
CONFIG = dict(inverted_index_columns=["lo_region"], bloom_filter_columns=["lo_custkey"],
              star_tree_configs=[{"dimensionsSplitOrder": ["lo_region", "lo_discount"],
                                  "functionColumnPairs": ["SUM__lo_revenue"]}])

# (id, sql): one query per plan kind EXPLAIN labels; "idset" takes its
# literal from the data (`_sql`)
QUERIES = [
    ("device_scan", ssb.QUERY),
    ("device_group", ssb.GROUP_QUERY),
    ("star_tree", ssb.STAR_QUERY),
    ("host_fallback", "SELECT substr(lo_region, 0, 2), COUNT(*) FROM lineorder "
     "WHERE length(lo_region) > 4 GROUP BY substr(lo_region, 0, 2)"),
    ("host_scalar", "SELECT PERCENTILE(lo_revenue, 90), MODE(lo_quantity) FROM lineorder "
     "WHERE lo_discount BETWEEN 2 AND 4"),
    ("selection", "SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity < 5 LIMIT 7"),
    ("order_by", "SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_revenue > 30000 "
     "ORDER BY lo_revenue DESC, lo_custkey LIMIT 5"),
    ("having", "SELECT lo_region, SUM(lo_revenue) FROM lineorder WHERE lo_quantity < 40 "
     "GROUP BY lo_region HAVING SUM(lo_revenue) > 1000 ORDER BY lo_region"),
    ("metadata", "SELECT COUNT(*), MIN(lo_quantity), MAX(lo_quantity) FROM lineorder"),
    ("pruned", "SELECT COUNT(*) FROM lineorder WHERE lo_quantity > 1000"),
    ("bloom_pruned", "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_custkey = 500123"),
    ("null_not", "SELECT COUNT(*) FROM lineorder WHERE lo_region IS NULL OR NOT lo_discount = 3"),
    ("expr_leaf", "SELECT lo_discount, MAX(lo_revenue) FROM lineorder "
     "WHERE lo_extendedprice * lo_discount > 500 GROUP BY lo_discount ORDER BY lo_discount"),
    ("idset", None),
]
IDS = [q for q, _ in QUERIES]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("explain")
    cols = ssb.make_columns(ROWS, SEED)
    schema = ssb.ssb_schema()
    ours = build_aligned_segments(schema, cols, str(root / "ours"), "lineorder", SEGMENTS,
                                  SegmentGeneratorConfig(**CONFIG))
    theirs = jax_build(JSchema.from_json(schema.to_json()), cols, str(root / "theirs"),
                       "lineorder", SEGMENTS, JaxConfig(**{
                           **CONFIG, "star_tree_configs": [JaxStarConfig.from_json(c)
                                                           for c in CONFIG["star_tree_configs"]]}))
    out = {"cols": cols}
    for writer, paths in (("torch", ours), ("jax", theirs)):
        out[writer] = ([load_segment(p) for p in paths], [jax_load(p) for p in paths])
    segs = out["torch"][0]
    assert not segs[0].column("lo_custkey").has_dictionary   # the idset leaf is a doc set
    literal = execute_query(segs, "SELECT IDSET(lo_custkey) FROM lineorder "
                                  "WHERE lo_quantity = 7", device=CPU).rows[0][0]
    out["idset"] = (f"SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                    f"WHERE IN_ID_SET(lo_custkey, '{literal}') AND lo_quantity > 3")
    return out


def _sql(env, qid: str) -> str:
    return dict(QUERIES)[qid] or env[qid]


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        return math.isclose(a, b, rel_tol=REL, abs_tol=1e-6)
    return a == b


def _rows_match(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_close(x, y) for x, y in zip(g, w))
        for g, w in zip(got, want))


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("qid", IDS)
def test_explain_rows_equal_the_reference(env, writer, qid):
    segs, jsegs = env[writer]
    sql = "EXPLAIN PLAN FOR " + _sql(env, qid)
    got = execute_query(segs, sql, device=CPU)
    want = jax_execute(jsegs, sql)
    assert got.columns == want.columns == ["Operator", "Operator_Id", "Parent_Id"]
    assert got.rows == want.rows
    assert got.stats["explain"] is True
    labels = [r[0] for r in got.rows]
    expected = {"device_scan": "DEVICE_FUSED_AGGREGATE(aggregations:sum)",
                "star_tree": "STAR_TREE_REWRITE(records:",
                "host_fallback": "HOST_GROUP_BY(keys:substr(lo_region, 0, 2); "
                                 "aggregations:count; fallback:",
                "order_by": "SELECT_ORDERBY(columns:lo_custkey, lo_revenue)",
                "metadata": "METADATA_ONLY_AGGREGATE(aggregations:count, min, max)",
                "pruned": "PRUNED(filter folds to constant false)",
                "bloom_pruned": "PRUNED(filter folds to constant false)",
                "null_not": "FILTER_NOT",
                "expr_leaf": "FILTER_EXPR(",
                "idset": "FILTER_DOCSET(column=lo_custkey; idset["}.get(qid)
    if expected is not None:
        assert any(label.startswith(expected) for label in labels), labels
    parents = {r[1]: r[2] for r in got.rows}
    assert [r[1] for r in got.rows] == list(range(len(got.rows)))
    assert all(p < i for i, p in parents.items())


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("qid", IDS)
def test_explain_analyze_matches_the_reference(env, writer, qid):
    segs, jsegs = env[writer]
    sql = _sql(env, qid)
    got = execute_query(segs, "EXPLAIN ANALYZE " + sql, device=CPU)
    want = jax_execute(jsegs, "EXPLAIN ANALYZE " + sql)
    assert got.columns == want.columns == ANALYZE_COLUMNS
    assert [r[:4] for r in got.rows] == [r[:4] for r in want.rows]
    for label, _, _, rows, ms in got.rows:
        assert (ms is None) == (rows is None), label
        assert ms is None or ms >= 0
    assert got.stats["analyze"] is True and got.stats["explain"] is True
    plain = execute_query(segs, sql, device=CPU)
    assert got.rows[0][3] == len(plain.rows)
    assert got.stats["numDocsScanned"] == plain.stats["numDocsScanned"]
    combine = [r for r in got.rows if r[0].startswith("COMBINE")]
    assert combine[0][3] == plain.stats["numDocsScanned"]


def _counted(monkeypatch):
    """Count the scan wrappers' and the plain body's calls: on the card each
    is one launch."""
    counts = {"scan": 0, "body": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    wrap(scan, "masked_sums_answer", "scan")
    wrap(scan, "masked_sums_fused_answer", "scan")
    import pinot_tpu_torch.query.executor as executor
    real = executor.run_kernel

    def body(*a, **k):
        counts["body"] += 1
        return real(*a, **k)
    monkeypatch.setattr(executor, "run_kernel", body)
    return counts


def test_explain_launches_nothing_and_analyze_one_scan_a_segment(env, monkeypatch):
    segs = env["torch"][0]
    counts = _counted(monkeypatch)
    for qid in IDS:
        execute_query(segs, "EXPLAIN PLAN FOR " + _sql(env, qid), device=CPU)
    assert counts == {"scan": 0, "body": 0}
    execute_query(segs, "EXPLAIN ANALYZE " + ssb.QUERY, device=CPU)
    assert counts == {"scan": SEGMENTS, "body": 0}
    execute_query(segs, "EXPLAIN ANALYZE " + ssb.GROUP_QUERY, device=CPU)
    assert counts == {"scan": SEGMENTS, "body": SEGMENTS}


# the set path runs these on the device in both packages: the EXPLAIN flag is
# not read there, and the answer is the query's
SET_DEVICE = ["device_scan", "device_group", "idset"]
# both packages hand these sets to the per-segment executor, which answers EXPLAIN
SET_PER_SEGMENT = ["host_fallback", "selection", "order_by", "metadata", "pruned",
                   "bloom_pruned"]


@pytest.mark.parametrize("prefix", ["EXPLAIN PLAN FOR ", "EXPLAIN ANALYZE "])
@pytest.mark.parametrize("qid", SET_DEVICE + SET_PER_SEGMENT)
def test_set_executor_treats_explain_as_the_reference_does(env, qid, prefix):
    segs, jsegs = env["torch"]
    sql = _sql(env, qid)
    got = MeshQueryExecutor(device=CPU).execute(segs, prefix + sql)
    want = JaxMeshExecutor(default_mesh(1)).execute(jsegs, prefix + sql)
    assert got.columns == want.columns
    if qid in SET_DEVICE:
        assert got.columns == compile_query(sql, segs[0].schema).output_names
        assert _rows_match(got.rows, want.rows)
        assert _rows_match(got.rows, execute_query(segs, sql, device=CPU).rows)
    else:
        assert got.columns[0] == "Operator"
        assert [r[:4] for r in got.rows] == [r[:4] for r in want.rows]


def test_set_executor_answers_a_stacked_star_explain_with_the_query(env):
    """The port stacks a star-tree set at any record count (no 65,536-record
    floor, PERF.md): the set then runs on the device, where the JAX set
    executor reads no EXPLAIN flag either, and the answer is the query's."""
    segs = env["torch"][0]
    got = MeshQueryExecutor(device=CPU).execute(segs, "EXPLAIN PLAN FOR " + ssb.STAR_QUERY)
    assert _rows_match(got.rows, execute_query(segs, ssb.STAR_QUERY, device=CPU).rows)


@pytest.mark.parametrize("prefix", ["EXPLAIN PLAN FOR ", "EXPLAIN ANALYZE "])
@pytest.mark.parametrize("qid", SET_DEVICE + ["host_fallback"])
def test_pipeline_treats_explain_as_the_reference_does(env, qid, prefix):
    """The pipeline's partial for an EXPLAIN context is the query's partial:
    the JAX pipeline's on a device plan; on a host plan the JAX pipeline
    signals its fallback, and the port (which has none) gives the
    per-segment partial of the query, as it does without the flag."""
    segs, jsegs = env["torch"]
    sql = _sql(env, qid)
    pipeline = DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(device=CPU))
    jax_pipeline = JaxPipeline(mesh_exec=JaxMeshExecutor(default_mesh(1)))
    try:
        got = pipeline.execute_partial(compile_query(prefix + sql, segs[0].schema), segs)
        plain = pipeline.execute_partial(compile_query(sql, segs[0].schema), segs)
        want = jax_pipeline.execute_partial(jax_compile(prefix + sql, jsegs[0].schema), jsegs)
    finally:
        pipeline.stop()
        jax_pipeline.stop()
    assert got.kind == plain.kind and got.num_docs_scanned == plain.num_docs_scanned
    assert sorted(got.groups) == sorted(plain.groups)
    if qid in SET_DEVICE:
        assert got.kind == want.kind and got.num_docs_scanned == want.num_docs_scanned
        assert sorted(got.groups) == sorted(want.groups)
        if got.scalar is not None:
            assert all(_close(a, b) for a, b in zip(got.scalar, want.scalar))
    else:
        assert not hasattr(want, "kind")   # the JAX pipeline's fallback sentinel


def test_explain_of_no_segments(env):
    """EXPLAIN over an empty set is the prefix alone, as in the JAX package."""
    schema = env["torch"][0][0].schema
    for prefix in ("EXPLAIN PLAN FOR ", "EXPLAIN ANALYZE "):
        got = ServerQueryExecutor(CPU).execute([], prefix + ssb.GROUP_QUERY, schema)
        want = jax_execute([], prefix + ssb.GROUP_QUERY,
                           JSchema.from_json(schema.to_json()))
        assert [r[:4] for r in got.rows] == [r[:4] for r in want.rows]


def _upsert_manager(segs):
    """A partition's upsert metadata over the segments: random keys, so that
    each segment keeps some rows and hides others."""
    from pinot_tpu_torch import upsert
    rng = np.random.default_rng(SEED + 1)
    mgr = upsert.PartitionUpsertMetadataManager()
    for s in segs:
        for d in range(s.num_docs):
            mgr.add_record(s.name, d, (int(rng.integers(0, ROWS // 3)),), None)
    return mgr


UPSERT_QUERIES = [("count", "SELECT COUNT(*) FROM lineorder", "DEVICE_FUSED_AGGREGATE"),
                  ("q1_1", ssb.QUERY, "DEVICE_FUSED_AGGREGATE"),
                  ("star_tree", ssb.STAR_QUERY, "DEVICE_FUSED_GROUP_BY")]


@pytest.mark.parametrize("qid,sql,label", UPSERT_QUERIES, ids=[q for q, _, _ in UPSERT_QUERIES])
def test_explain_under_upsert_shows_the_plan_that_runs(env, qid, sql, label):
    """Without a mask COUNT(*) is a metadata answer and the star query a
    star-tree rewrite; under one, each segment is a masked device plan."""
    segs = env["torch"][0]
    mgr = _upsert_manager(segs)
    plain = execute_query(segs, "EXPLAIN PLAN FOR " + sql, device=CPU)
    got = execute_query(segs, "EXPLAIN PLAN FOR " + sql, device=CPU, upsert=mgr)
    labels = [r[0] for r in got.rows]
    assert not any(x.startswith(("METADATA_ONLY", "STAR_TREE_REWRITE")) for x in labels)
    assert sum(x.startswith(label) for x in labels) == 1   # one shape for all segments
    assert f"SEGMENT_PLAN(segments:{SEGMENTS})" in labels
    if qid != "q1_1":
        assert [r[0] for r in plain.rows] != labels

    analyzed = execute_query(segs, "EXPLAIN ANALYZE " + sql, device=CPU, upsert=mgr)
    answer = execute_query(segs, sql, device=CPU, upsert=mgr)
    assert [r[:3] for r in analyzed.rows] == got.rows
    for op, _, _, rows, ms in analyzed.rows:
        if not op.startswith("FILTER_"):   # filters carry no rollup, as in the reference
            assert rows is not None and ms is not None and ms >= 0, op
    assert analyzed.rows[0][3] == len(answer.rows)
    scanned = answer.stats["numDocsScanned"]
    assert 0 < scanned < ROWS
    for op, _, _, rows, _ in analyzed.rows:
        if op.startswith(("COMBINE", "SEGMENT_PLAN", label)):
            assert rows == scanned, op
