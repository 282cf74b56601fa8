"""pinot_tpu_torch's multi-value columns against the JAX package's.

The same numpy-seeded rows (a STRING multi-value `tags` of 0-3 values, an INT
multi-value `codes` of 1-5 values with repeats, single-value columns beside
them) are written by the port's writer into dictionary-aligned segments and
read by both packages, on the CPU (`JAX_PLATFORMS=cpu`):

* the files are byte-compatible both ways: each writer's segment equals the
  other's byte for byte, and each reader reads the other's;
* every query shape of the JAX package's `tests/test_mv.py` (but its
  row-append `MutableSegment` cases) answers as the JAX package does;
* any-value filters, NOT, the *MV aggregations, the GROUP BY explode,
  DISTINCT, selections with multi-value cells and ARRAYLENGTH answer per
  segment, over the set, through `execute_many` and through the pipeline,
  over a mixed set with a staged consuming view, and in a join's leaf scan,
  as the JAX package and a numpy oracle over the rows do (a row matches if
  any of its values does, NOT negates the row);
* the trouble spots of the port each hold: an MV band never takes the scan
  route, the fill id matches in no form, the stacked `[S, rows, W]` ids
  flatten with fill rows, the optimizer keeps an MV column's conjuncts apart,
  and a consuming segment whose rows grow wider answers at its new width.
"""

import math

import numpy as np
import pytest
import torch

from pinot_tpu.multistage import execute_multistage as jax_multistage
from pinot_tpu.multistage import make_segment_scan as jax_scan
from pinot_tpu.query.executor import execute_query as jax_execute
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.mutable_device import DeviceMutableSegment as JaxDeviceMutable
from pinot_tpu.segment.writer import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import kernels, scan
from pinot_tpu_torch.engine.datablock import block_for, lut_size
from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.parallel.combine import SegmentSetBlock
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import QueryValidationError, compile_query
from pinot_tpu_torch.query.executor import execute_query, mask_spec, scan_route
from pinot_tpu_torch.query.planner import plan_segment
from pinot_tpu_torch.query.predicate import LutLeaf
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.schema import DataType, FieldRole, FieldSpec, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments

CPU = "cpu"
SEED = 20261101
ROWS, SEGMENTS = 3001, 3
REL_DEVICE, REL_HOST = 1e-5, 1e-9
TAGS = [f"t{i}" for i in range(8)]
INT_NULL = -(2 ** 31)

SCHEMA = Schema("docs", [
    dimension("ok", DataType.INT),
    FieldSpec("tags", DataType.STRING, FieldRole.DIMENSION, single_value=False),
    FieldSpec("codes", DataType.INT, FieldRole.DIMENSION, single_value=False),
    dimension("kind", DataType.STRING),
    dimension("qty", DataType.INT),
    metric("weight", DataType.DOUBLE),
])
CONFIG = dict(inverted_index_columns=["tags"], bloom_filter_columns=["codes"])


def _jax_schema(schema=SCHEMA):
    return JSchema.from_json(schema.to_json())


def _columns(n: int, seed: int, wide_at=()):
    """Seeded rows: tags 0-3 of TAGS drawn by a zipf-like weight (an empty
    row is stored as the one-value null), codes 1-5 of 0..59 with repeats;
    the rows in `wide_at` get 5 tags and 7 codes, so that segments differ in
    their widest row."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(TAGS) + 1) ** 1.1
    p /= p.sum()
    tags, codes = [], []
    for i in range(n):
        k = 5 if i in wide_at else int(rng.integers(0, 4))
        tags.append([str(t) for t in rng.choice(TAGS, k, p=p)] or None)
        codes.append(rng.integers(0, 60, 7 if i in wide_at else int(rng.integers(1, 6)))
                     .astype(np.int32).tolist())
    return {"ok": np.arange(n, dtype=np.int32), "tags": tags, "codes": codes,
            "kind": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
            "qty": rng.integers(0, 50, n).astype(np.int32),
            "weight": np.round(rng.uniform(0.0, 100.0, n), 3)}


def _cells(cols):
    """Each row's stored values, as the writer normalizes them."""
    return ([v if v else ["null"] for v in cols["tags"]],
            [v if v else [INT_NULL] for v in cols["codes"]])


# -- the numpy oracle: a row matches if any of its values matches ---------------

def _any(rows, pred) -> np.ndarray:
    return np.array([any(pred(v) for v in r) for r in rows], dtype=bool)


def _filters(cols):
    tags, codes = _cells(cols)
    qty = np.asarray(cols["qty"])
    return {
        "tags_eq": _any(tags, lambda v: v == "t3"),
        "codes_band_tags_in": _any(codes, lambda v: 10 <= v <= 20)
        & _any(tags, lambda v: v in ("t1", "t5")),
        "not_eq": ~_any(tags, lambda v: v == "t0"),
        "neq": ~_any(tags, lambda v: v == "t0"),
        "not_in": ~_any(tags, lambda v: v in ("t0", "t1")),
        "mixed": (qty < 10) & _any(tags, lambda v: v == "t2"),
        "both_tags": _any(tags, lambda v: v == "t1") & _any(tags, lambda v: v == "t2"),
        "split_range": _any(codes, lambda v: v >= 40) & _any(codes, lambda v: v <= 12),
        "or": _any(codes, lambda v: v == 7) | _any(tags, lambda v: v == "t4"),
        "arraylength": np.array([len(r) >= 2 for r in tags]),
        "null_row": _any(tags, lambda v: v == "null"),
    }


FILTERS = {
    "tags_eq": "tags = 't3'",
    "codes_band_tags_in": "codes BETWEEN 10 AND 20 AND tags IN ('t1', 't5')",
    "not_eq": "NOT tags = 't0'",
    "neq": "tags != 't0'",
    "not_in": "tags NOT IN ('t0', 't1')",
    "mixed": "qty < 10 AND tags = 't2'",
    "both_tags": "tags = 't1' AND tags = 't2'",
    "split_range": "codes >= 40 AND codes <= 12",
    "or": "codes = 7 OR tags = 't4'",
    "arraylength": "ARRAYLENGTH(tags) >= 2",
    "null_row": "tags = 'null'",
}


def _filter_answer(cols, fid):
    m = _filters(cols)[fid]
    return [[int(m.sum()), float(np.asarray(cols["weight"])[m].sum())]]


def _agg_answer(cols):
    _, codes = _cells(cols)
    keep = np.asarray(cols["qty"]) < 25
    flat = np.array([v for r, k in zip(codes, keep) if k for v in r], dtype=np.float64)
    return [[len(flat), float(flat.sum()), float(flat.min()), float(flat.max()),
             float(flat.mean()), len(np.unique(flat))]]


def _group_answer(cols):
    tags, _ = _cells(cols)
    w = np.asarray(cols["weight"])
    out = {}
    for r, x in zip(tags, w):
        for v in r:
            c, s = out.get(v, (0, 0.0))
            out[v] = (c + 1, s + x)
    return [[k, c, s] for k, (c, s) in sorted(out.items())]


def _kind_answer(cols):
    m = _filters(cols)["tags_eq"]
    kinds = np.asarray(cols["kind"])[m]
    return [[k, int((kinds == k).sum())] for k in sorted(set(kinds.tolist()))]


def _selection_answer(cols):
    tags, codes = _cells(cols)
    hit = [i for i, r in enumerate(codes) if 7 in r][:10]
    return [[int(cols["ok"][i]), tags[i]] for i in hit]


AGGS = ("SELECT COUNTMV(codes), SUMMV(codes), MINMV(codes), MAXMV(codes), AVGMV(codes), "
        "DISTINCTCOUNTMV(codes) FROM docs WHERE qty < 25")
GROUP = "SELECT tags, COUNT(*), SUM(weight) FROM docs GROUP BY tags ORDER BY tags LIMIT 20"
KIND = "SELECT kind, COUNT(*) FROM docs WHERE tags = 't3' GROUP BY kind ORDER BY kind LIMIT 10"
SELECT = "SELECT ok, tags FROM docs WHERE codes = 7 ORDER BY ok LIMIT 10"

# (id, sql, oracle(cols) or None: held against the JAX package alone)
QUERIES = [(fid, f"SELECT COUNT(*), SUM(weight) FROM docs WHERE {f}",
            lambda cols, fid=fid: _filter_answer(cols, fid)) for fid, f in FILTERS.items()]
QUERIES += [
    ("mv_aggs", AGGS, _agg_answer),
    ("mv_sketches", "SELECT DISTINCTCOUNTHLLMV(codes), PERCENTILE50MV(codes), "
                    "PERCENTILEMV(codes, 90), MINMAXRANGEMV(codes) FROM docs", None),
    ("group_explode", GROUP, _group_answer),
    ("group_sv_and_mv", "SELECT kind, tags, COUNT(*) FROM docs WHERE qty < 30 "
                        "GROUP BY kind, tags ORDER BY kind, tags LIMIT 100", None),
    ("group_under_mv_filter", KIND, _kind_answer),
    ("distinct", "SELECT DISTINCT tags FROM docs ORDER BY tags LIMIT 20", None),
    ("selection", SELECT, _selection_answer),
    ("selection_arrays", "SELECT ok, ARRAYLENGTH(tags), ARRAYELEMENTAT(codes, 2) FROM docs "
                         "WHERE tags = 't5' ORDER BY ok LIMIT 15", None),
    ("valuein", "SELECT VALUEIN(tags, 't1', 't2'), COUNT(*) FROM docs "
                "GROUP BY VALUEIN(tags, 't1', 't2') ORDER BY COUNT(*) LIMIT 10", None),
]
QIDS = [q[0] for q in QUERIES]


def _cell_match(x, y, rel) -> bool:
    if isinstance(x, (list, tuple)) or isinstance(y, (list, tuple)):
        return isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)) \
            and len(x) == len(y) and all(_cell_match(a, b, rel) for a, b in zip(x, y))
    if x is None or y is None:
        return x is y
    if isinstance(x, float) or isinstance(y, float):
        return math.isclose(float(x), float(y), rel_tol=rel, abs_tol=1e-9)
    return x == y


def _rows_match(got, want, rel=REL_DEVICE) -> bool:
    return len(got) == len(want) and all(
        len(a) == len(b) and all(_cell_match(x, y, rel) for x, y in zip(a, b))
        for a, b in zip(got, want))


def _served(mx, segs, sql):
    ctx = compile_query(sql, segs[0].schema)
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        partial = pipeline.execute_partial(ctx, segs)
    finally:
        pipeline.stop()
    aggs = [make_agg(f) for f in ctx.aggregations]
    group_exprs = [e for e, _ in ctx.select_items] if ctx.distinct else list(ctx.group_by)
    return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                            group_exprs).rows


def _routes(segs, sql):
    mx = MeshQueryExecutor(device=CPU)
    return {"per_segment": execute_query(segs, sql, device=CPU).rows,
            "set": mx.execute(segs, sql).rows,
            "many": mx.execute_many(segs, [sql, sql])[1].rows,
            "pipeline": _served(mx, segs, sql)}


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    out = tmp_path_factory.mktemp("mv")
    cols = _columns(ROWS, SEED, wide_at=(5, ROWS - 3))
    paths = build_aligned_segments(SCHEMA, cols, str(out), "docs", SEGMENTS,
                                   SegmentGeneratorConfig(**CONFIG))
    return {"cols": cols, "segs": [load_segment(p) for p in paths],
            "jax": [jax_load(p) for p in paths], "out": out}


# -- the files ------------------------------------------------------------------------

def test_segments_are_byte_compatible_both_ways(tmp_path):
    """The port's writer and the JAX writer write the same bytes for the same
    rows (the forward index, the offsets, the dictionaries, the inverted
    index over repeated doc ids, the bloom filter, the null bitmap and the
    metadata), and each reader reads the other's segment."""
    cols = _columns(500, SEED + 1)
    cfg = dict(CONFIG)
    ours = SegmentBuilder(SCHEMA, SegmentGeneratorConfig(**cfg)).build(
        dict(cols), str(tmp_path / "ours"), "docs_0")
    theirs = JaxBuilder(_jax_schema(), JaxConfig(**cfg)).build(
        dict(cols), str(tmp_path / "theirs"), "docs_0")
    import filecmp
    import json
    import os
    files = sorted(os.listdir(os.path.join(ours, "cols")))
    assert files == sorted(os.listdir(os.path.join(theirs, "cols")))
    assert {"tags.mvoff.npy", "codes.mvoff.npy", "tags.inv.npz", "codes.bloom.npy",
            "tags.nulls.npy"} <= set(files)
    for f in files:
        assert filecmp.cmp(os.path.join(ours, "cols", f), os.path.join(theirs, "cols", f),
                           shallow=False), f
    meta = [json.load(open(os.path.join(p, "metadata.json")))["columns"] for p in (ours, theirs)]
    assert meta[0] == meta[1]
    tags, codes = _cells(cols)
    for path in (ours, theirs):
        for seg in (load_segment(path), jax_load(path)):
            r = seg.column("tags")
            assert r.is_multi_value and r.max_num_values == max(len(t) for t in tags)
            assert [list(v) for v in r.values()] == tags
            assert [list(v) for v in seg.column("codes").values()] == codes
            np.testing.assert_array_equal(np.asarray(r.mv_offsets),
                                          np.cumsum([0] + [len(t) for t in tags]))
            np.testing.assert_array_equal(r.null_bitmap, [t is None for t in cols["tags"]])


MV_CELLS = {
    "STRING": {"lists": [["a", "b"], [], None, ["c"]],
               "tuples_and_arrays": [("a", "b"), np.array(["c"]), ["d"], None],
               "none_inside": [["a", None], ["b"]], "scalars": ["a", ["b", "c"], 7],
               "numbers": [[1, 2.5], ["3"], []]},
    "INT": {"lists": [[1, 2], [], None, [3]],
            "tuples_and_arrays": [(1, 2), np.array([3], dtype=np.int64), [4], None],
            "none_inside": [[1, None], [2]], "scalars": [5, [6, 7], "8"],
            "floats_and_strings": [[1.0, "2"], [3.7], []]},
    "DOUBLE": {"lists": [[1.5, 2.0], [], None, [3.25]],
               "tuples_and_arrays": [(1.5,), np.array([0.1], dtype=np.float32), [4.0], None],
               "none_inside": [[1.5, None], [2.0]], "scalars": [5.5, [6, 7], "8.5"],
               "ints_and_strings": [[1, "2.5"], [3], []]},
}


@pytest.mark.parametrize("kind,case", [(k, c) for k, cases in MV_CELLS.items() for c in cases])
def test_a_column_normalizes_as_the_jax_packages_cells_do(kind, case):
    """`normalize_mv_column` (one pass over a column of lists, else cell by
    cell) stores what the JAX package's `normalize_mv_cell` makes of each
    cell: the values, the counts and the null rows."""
    from pinot_tpu.schema import normalize_mv_cell as jax_normalize
    from pinot_tpu_torch.schema import normalize_mv_column
    cells = MV_CELLS[kind][case]
    spec = FieldSpec("c", DataType(kind), FieldRole.DIMENSION, single_value=False)
    jspec = _jax_schema(Schema("t", [spec])).field_spec("c")
    want = [jax_normalize(jspec, c) for c in cells]
    values, counts, nulls = normalize_mv_column(spec, cells)
    assert counts.tolist() == [len(v) for v, _ in want]
    assert nulls.tolist() == [null for _, null in want]
    flat = [x for v, _ in want for x in v]
    assert values.tolist() == np.asarray(flat, dtype=spec.data_type.numpy_dtype).tolist()


def test_the_inverted_index_posts_a_repeated_value_once(tmp_path):
    schema = Schema("d", [FieldSpec("tags", DataType.STRING, FieldRole.DIMENSION,
                                    single_value=False)])
    path = SegmentBuilder(schema, SegmentGeneratorConfig(inverted_index_columns=["tags"])) \
        .build({"tags": [["x", "x", "y"], ["y"]]}, str(tmp_path), "d_0")
    r = load_segment(path).column("tags")
    inv, d = r.inverted_index, r.dictionary
    assert inv.doc_ids_for(d.index_of("x")).tolist() == [0]
    assert inv.doc_ids_for(d.index_of("y")).tolist() == [0, 1]


def test_the_device_id_matrix_equals_the_jax_block(table):
    """`SegmentBlock.ids` of an MV column: `[padded, W]`, left-justified ids,
    the fill id `cardinality` elsewhere and on every padding row, as the JAX
    package's block builds it."""
    from pinot_tpu.engine.datablock import SegmentBlock as JaxBlock
    for seg, ref in zip(table["segs"], table["jax"]):
        for col in ("tags", "codes"):
            ours = block_for(seg, torch.device(CPU)).ids(col).numpy()
            theirs = np.asarray(JaxBlock(ref).ids(col))
            assert ours.shape == theirs.shape and ours.shape[1] == \
                seg.column(col).max_num_values
            np.testing.assert_array_equal(ours, theirs)


# -- the JAX package's own MV suite ---------------------------------------------

REF_SCHEMA = Schema("docs", [
    dimension("doc", DataType.STRING),
    FieldSpec("tags", DataType.STRING, FieldRole.DIMENSION, single_value=False),
    FieldSpec("scores", DataType.INT, FieldRole.DIMENSION, single_value=False),
    metric("weight", DataType.DOUBLE),
])
REF_ROWS = {"doc": ["a", "b", "c", "d"], "tags": [["x", "y"], ["y"], ["z", "x", "w"], None],
            "scores": [[1, 2], [2, 3], [5], [7, 8]], "weight": np.array([1.0, 2.0, 3.0, 4.0])}
REF_QUERIES = [
    "SELECT COUNT(*) FROM docs WHERE tags = 'x'",
    "SELECT COUNT(*) FROM docs WHERE tags IN ('y', 'w')",
    "SELECT COUNT(*) FROM docs WHERE scores BETWEEN 3 AND 6",
    "SELECT COUNT(*) FROM docs WHERE NOT tags = 'y'",
    "SELECT SUM(weight) FROM docs WHERE tags = 'x'",
    "SELECT COUNT(*) FROM docs WHERE scores >= 2 AND tags IN ('y','z')",
    "SELECT SUM(weight), COUNT(*) FROM docs WHERE scores < 3",
    "SELECT COUNTMV(scores), SUMMV(scores), MINMV(scores), MAXMV(scores), AVGMV(scores), "
    "DISTINCTCOUNTMV(tags) FROM docs",
    "SELECT COUNTMV(tags) FROM docs WHERE weight < 2.5",
    "SELECT tags, COUNT(*), SUM(weight) FROM docs GROUP BY tags ORDER BY tags LIMIT 20",
    "SELECT doc, tags, COUNT(*) FROM docs WHERE doc IN ('a', 'b') GROUP BY doc, tags "
    "ORDER BY doc, tags LIMIT 20",
    "SELECT DISTINCT tags FROM docs ORDER BY tags LIMIT 20",
    "SELECT doc, ARRAYLENGTH(tags) FROM docs ORDER BY doc LIMIT 10",
    "SELECT doc, tags FROM docs ORDER BY doc LIMIT 10",
    "SELECT COUNT(*) FROM docs WHERE ARRAYLENGTH(tags) >= 2",
    "SELECT doc, ARRAYELEMENTAT(scores, 2) FROM docs ORDER BY doc LIMIT 10",
    "SELECT VALUEIN(tags, 'x', 'y'), COUNTMV(tags) FROM docs "
    "GROUP BY VALUEIN(tags, 'x', 'y') ORDER BY COUNTMV(tags) LIMIT 20",
    "SELECT PERCENTILEMV(scores, 50) FROM docs",
    "SELECT PERCENTILE50MV(scores) FROM docs",
    "SELECT PERCENTILEESTMV(scores, 90), PERCENTILETDIGESTMV(scores, 90) FROM docs",
    "SELECT DISTINCTCOUNTHLLMV(tags) FROM docs",
    "SELECT doc, PERCENTILEMV(scores, 100) FROM docs GROUP BY doc ORDER BY doc LIMIT 10",
    "SELECT MINMAXRANGEMV(scores), DISTINCTCOUNTBITMAPMV(scores) FROM docs",
]


@pytest.fixture(scope="module")
def ref_segment(tmp_path_factory):
    path = SegmentBuilder(REF_SCHEMA, SegmentGeneratorConfig(
        inverted_index_columns=["tags"])).build(dict(REF_ROWS),
                                                str(tmp_path_factory.mktemp("ref")), "docs_0")
    return load_segment(path), jax_load(path)


@pytest.mark.parametrize("sql", REF_QUERIES, ids=[f"r{i}" for i in range(len(REF_QUERIES))])
def test_the_jax_suite_shapes_answer_as_the_jax_package(ref_segment, sql):
    ours, theirs = ref_segment
    want = jax_execute([theirs], sql).rows
    assert _rows_match(execute_query([ours], sql, device=CPU).rows, want, REL_HOST), sql
    assert _rows_match(MeshQueryExecutor(device=CPU).execute([ours, ours], sql).rows,
                       jax_execute([theirs, theirs], sql).rows, REL_HOST), sql


def test_a_single_value_aggregation_over_an_mv_column_is_refused(ref_segment):
    ours, _ = ref_segment
    with pytest.raises(QueryValidationError, match="SUMMV"):
        execute_query([ours], "SELECT SUM(scores) FROM docs", device=CPU)
    with pytest.raises(QueryValidationError, match="multi-value"):
        execute_query([ours], "SELECT doc FROM docs ORDER BY tags LIMIT 5", device=CPU)


# -- every route, against the JAX package and numpy -----------------------------

@pytest.mark.parametrize("qid,sql,oracle", QUERIES, ids=QIDS)
def test_mv_queries_answer_on_every_route(table, qid, sql, oracle):
    want = jax_execute(table["jax"], sql).rows
    if oracle is not None:
        assert _rows_match(want, oracle(table["cols"])), (qid, want)
    for route, got in _routes(table["segs"], sql).items():
        assert _rows_match(got, want), (qid, route, got[:5], want[:5])


@pytest.mark.parametrize("qid", ["tags_eq", "codes_band_tags_in", "not_in", "group_under_mv_filter"])
def test_an_aligned_set_stacks_mv_ids_into_one_plain_body_pass(table, qid, monkeypatch):
    """An MV-filtered device plan over an aligned set is one pass of the plain
    body over the stacked `[S, rows, W]` ids: no per-segment fallback."""
    sql = dict((q[0], q[1]) for q in QUERIES)[qid]
    mx = MeshQueryExecutor(device=CPU)
    plan, view = mx._plan_for_set(compile_query(sql, SCHEMA), table["segs"])
    assert plan is not None and plan.kind == "device" and view is None
    runs = []
    real = kernels.run_kernel
    monkeypatch.setattr("pinot_tpu_torch.parallel.combine.run_kernel",
                        lambda spec, inputs: runs.append(spec.mv_cols) or real(spec, inputs))
    monkeypatch.setattr(mx._fallback, "execute_segment",
                        lambda *a, **k: pytest.fail("per-segment fallback"))
    mx.execute(table["segs"], sql)
    assert len(runs) == 1 and "tags" in runs[0]


# -- trouble spots --------------------------------------------------------------

def test_an_mv_band_never_takes_the_scan_route(table, monkeypatch):
    """`codes BETWEEN 10 AND 20` is one id interval, but over a `[P, W]` id
    matrix: the scan (which reads one id per row) is declined per segment
    and over the set, and the plain body answers."""
    sql = "SELECT COUNT(*), SUM(weight) FROM docs WHERE codes BETWEEN 10 AND 20"
    plan = plan_segment(compile_query(sql, SCHEMA), table["segs"][0])
    assert plan.kind == "device" and scan_route(plan) is None
    sv = plan_segment(compile_query(sql.replace("codes", "qty"), SCHEMA), table["segs"][0])
    assert scan_route(sv) == "masked_sums"    # the same band on a single-value column
    calls = []
    for name in ("masked_sums_answer", "masked_sums_fused_answer"):
        real = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _r=real: calls.append(1) or _r(*a))
    cols = table["cols"]
    m = _any(_cells(cols)[1], lambda v: 10 <= v <= 20)
    want = [[int(m.sum()), float(cols["weight"][m].sum())]]
    for route, got in _routes(table["segs"], sql).items():
        assert _rows_match(got, want), route
    assert calls == []


def test_the_fill_id_matches_in_no_form(table):
    """The fill id `cardinality` pads short rows and padding rows: an
    interval leaf's hi lies below it, and a LUT, a complemented one too,
    holds False there. NOT and != negate the reduced row, not the values."""
    seg = table["segs"][0]
    block = block_for(seg, torch.device(CPU))
    ids = block.ids("tags")
    card = seg.column("tags").cardinality
    assert (ids[seg.num_docs:] == card).all() and (ids == card).any(-1)[:seg.num_docs].any()
    ctx = compile_query("SELECT ok FROM docs WHERE tags = 't0' LIMIT 5", SCHEMA)
    plan = plan_segment(ctx, seg)
    leaf = plan.filter_prog.leaves[0]
    complement = np.zeros(lut_size(card), dtype=bool)
    complement[:card] = ~leaf.lut[:card]            # every real id but t0's
    for lut in (leaf.lut, complement):
        plan.filter_prog.leaves[0] = LutLeaf("tags", lut, intervals=None)
        spec = mask_spec(plan)
        inputs = MeshQueryExecutor(device=CPU)._fallback._kernel_inputs(plan, spec, block)
        got = kernels.filter_mask(spec, inputs).numpy()
        tags = _cells(table["cols"])[0][:seg.num_docs]
        want = np.zeros(block.padded, dtype=bool)
        want[:seg.num_docs] = _any(tags, lambda v: lut[seg.column("tags").dictionary
                                                       .index_of(v)])
        np.testing.assert_array_equal(got, want)
    f = _filters(table["cols"])
    assert not np.array_equal(f["neq"], ~_any(_cells(table["cols"])[0], lambda v: v != "t0"))


def test_stacked_mv_ids_flatten_with_fill_rows(table):
    """The set block stacks `[S, rows, W]` with W the set's widest row, and
    the plain body reads it flattened to `[S * rows, W]`: every fill row and
    every cell past a row's values holds the fill id."""
    segs = table["segs"]
    widths = [s.column("codes").max_num_values for s in segs]
    assert len(set(widths)) > 1
    block = SegmentSetBlock(segs, torch.device(CPU))
    ids = block.ids("codes")
    card = segs[0].column("codes").cardinality
    assert ids.shape == (len(segs), block.rows, max(widths))
    flat = ids.flatten(0, 1)
    assert flat.shape == (len(segs) * block.rows, max(widths))
    for i, s in enumerate(segs):
        rows = ids[i].numpy()
        assert (rows[s.num_docs:] == card).all()
        counts = s.column("codes").mv_counts()
        filled = np.arange(max(widths))[None, :] >= counts[:, None]
        assert (rows[:s.num_docs][filled] == card).all()
        assert (rows[:s.num_docs][~filled] < card).all()


def test_the_optimizer_keeps_an_mv_columns_conjuncts_apart(table):
    """`tags = 't1' AND tags = 't2'` and `codes >= 40 AND codes <= 12` are
    satisfiable on multi-value rows (different values match each conjunct):
    the range merge is for single-value columns only."""
    from pinot_tpu_torch.query.optimizer import optimize_filter
    ctx = compile_query("SELECT COUNT(*) FROM docs WHERE codes >= 40 AND codes <= 12", SCHEMA)
    assert ctx.filter.name == "and" and len(ctx.filter.args) == 2
    assert optimize_filter(ctx.filter, SCHEMA).name == "and"
    cols = table["cols"]
    for fid in ("both_tags", "split_range"):
        want = _filter_answer(cols, fid)
        assert want[0][0] > 0
        sql = f"SELECT COUNT(*), SUM(weight) FROM docs WHERE {FILTERS[fid]}"
        assert _rows_match(jax_execute(table["jax"], sql).rows, want)
        assert _rows_match(execute_query(table["segs"], sql, device=CPU).rows, want)


def _store(schema, staging=True):
    return DeviceMutableSegment("docs__0__0__20261101T0000Z", schema,
                                device_staging=staging, device=CPU if staging else None)


def _batch(cols, lo, hi):
    return {c: (v[lo:hi].tolist() if isinstance(v, np.ndarray) else list(v[lo:hi]))
            for c, v in cols.items()}


def _concat(*parts):
    """Column dicts concatenated row-wise (numpy columns stay numpy)."""
    return {c: (np.concatenate([p[c] for p in parts]) if isinstance(parts[0][c], np.ndarray)
                else [v for p in parts for v in p[c]]) for c in parts[0]}


def _rows(cols, lo, hi):
    return {c: v[lo:hi] for c, v in cols.items()}


def test_a_consuming_segment_that_grows_wider_answers_at_its_new_width(table):
    """A staged consuming segment's view builds its `[P, W]` ids from its
    snapshot; after a wider row arrives the next view (and the set beside
    the table) reads the new W, never the old one."""
    extra = _columns(600, SEED + 2)
    store = _store(SCHEMA)
    store.index_batch(_batch(extra, 0, 300))
    view = store.query_view()
    w0 = view.column("codes").max_num_values
    sql = f"SELECT COUNT(*), SUM(weight) FROM docs WHERE {FILTERS['split_range']}"
    assert _rows_match(execute_query([view], sql, device=CPU).rows,
                       _filter_answer(_rows(extra, 0, 300), "split_range"))
    wide = _columns(1, SEED + 3)
    wide["codes"] = [list(range(40, 40 + w0 + 4))]
    store.index_batch(_batch(wide, 0, 1))
    store.index_batch(_batch(extra, 300, 600))
    view2 = store.query_view()
    assert view2.column("codes").max_num_values == w0 + 4
    assert block_for(view2, torch.device(CPU)).ids("codes").shape[1] == w0 + 4
    grown = _concat(_rows(extra, 0, 300), wide, _rows(extra, 300, 600))
    assert _rows_match(execute_query([view2], sql, device=CPU).rows,
                       _filter_answer(grown, "split_range"))
    want = _filter_answer(_concat(table["cols"], grown), "split_range")
    for route, got in _routes(table["segs"] + [view2], sql).items():
        assert _rows_match(got, want), route


@pytest.mark.parametrize("qid", ["tags_eq", "not_eq", "mixed", "mv_aggs", "group_explode",
                                 "selection"])
def test_a_mixed_set_with_a_staged_consuming_view_answers_per_segment(table, qid):
    """The table beside a staged consuming view: the merged view has no remap
    of multi-value ids, so every route answers such a set per segment, as
    the JAX package's mixed set does."""
    extra = _columns(400, SEED + 4)
    store = _store(SCHEMA)
    store.index_batch(_batch(extra, 0, 400))
    ref = JaxDeviceMutable("docs__0__0__20261101T0000Z", _jax_schema())
    ref.index_batch(_batch(extra, 0, 400))
    segs = table["segs"] + [store.query_view()]
    sql = dict((q[0], q[1]) for q in QUERIES)[qid]
    plan, _ = MeshQueryExecutor(device=CPU)._plan_for_set(compile_query(sql, SCHEMA), segs)
    assert plan is None or plan.kind != "device"
    want = jax_execute(table["jax"] + [ref.query_view()], sql).rows
    for route, got in _routes(segs, sql).items():
        assert _rows_match(got, want), (qid, route, got[:5], want[:5])


def test_a_consuming_segment_keeps_mv_rows_as_the_jax_one_and_commits_them(tmp_path):
    """The JSON lane's rows in a consuming segment: the reader surface
    (offsets, counts, width, the 4-tuple snapshot, values) equals the JAX
    package's consuming segment's, and the committed segment reads back the
    same rows."""
    cols = _columns(300, SEED + 5)
    ours, ref = _store(SCHEMA, staging=False), JaxDeviceMutable("c", _jax_schema())
    for lo in (0, 100, 250):
        for s in (ours, ref):
            s.index_batch(_batch(cols, lo, {0: 100, 100: 250, 250: 300}[lo]))
    for col in ("tags", "codes"):
        a, b = ours.column(col), ref.column(col)
        assert a.is_multi_value and b.is_multi_value and a.has_dictionary
        assert a.max_num_values == b.max_num_values
        np.testing.assert_array_equal(a.mv_offsets, b.mv_offsets)
        np.testing.assert_array_equal(a.mv_counts(), b.mv_counts())
        sa, sb = a.dict_snapshot(), b.dict_snapshot()
        assert len(sa) == len(sb) == 4 and sa[0] == sb[0]
        assert list(sa[1].values) == list(sb[1].values)
        np.testing.assert_array_equal(sa[2], sb[2])
        assert [list(v) for v in a.values()] == [list(v) for v in b.values()]
    tags, codes = _cells(cols)
    path = SegmentBuilder(SCHEMA).build(ours.snapshot_arrays(), str(tmp_path), "c_0")
    for seg in (load_segment(path), jax_load(path)):
        assert [list(v) for v in seg.column("tags").values()] == tags
        assert [list(v) for v in seg.column("codes").values()] == codes
        np.testing.assert_array_equal(seg.column("tags").null_bitmap,
                                      [t is None for t in cols["tags"]])


def test_a_join_leaf_scan_filters_on_an_mv_column(table):
    """A join whose leaf filter reads a multi-value column: the leaf's mask is
    the device mask (`_selection_mask` with the MV leaf), and the join answers
    as the JAX package's and numpy."""
    kinds = Schema("kinds", [dimension("kind", DataType.STRING),
                             dimension("label", DataType.STRING)])
    rows = {"kind": ["a", "b", "c"], "label": ["alpha", "beta", "gamma"]}
    path = SegmentBuilder(kinds).build(rows, str(table["out"]), "kinds_0")
    tables = {"docs": table["segs"], "kinds": [load_segment(path)]}
    jax_tables = {"docs": table["jax"], "kinds": [jax_load(path)]}
    schemas = {"docs": SCHEMA, "kinds": kinds}
    jschemas = {t: JSchema.from_json(s.to_json()) for t, s in schemas.items()}
    sql = ("SELECT k.label, COUNT(*), SUM(d.weight) FROM docs d JOIN kinds k "
           "ON d.kind = k.kind WHERE d.tags = 't3' GROUP BY k.label ORDER BY k.label")
    got = execute_multistage(sql, make_segment_scan(tables, device=CPU), schemas.get).rows
    want = jax_multistage(sql, jax_scan(jax_tables), jschemas.get).rows
    cols = table["cols"]
    m = _filters(cols)["tags_eq"]
    labels = dict(zip(rows["kind"], rows["label"]))
    oracle = [[labels[k], int((cols["kind"][m] == k).sum()),
               float(cols["weight"][m][cols["kind"][m] == k].sum())] for k in "abc"]
    assert _rows_match(want, oracle, REL_HOST)
    assert _rows_match(got, want, REL_HOST)


def test_the_smoke_mv_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `mv` phase at 40,000 rows with the card's calls pointed
    at the CPU, its table and consuming rows made by `start_mv_builds`'s
    jobs: every answer, plan and launch check of the phase passes (the
    kernels' calls counted as launches)."""
    import concurrent.futures

    import chip_smoke
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.segment import mutable_device

    cpu = torch.device(CPU)
    for module in (executor, combine, mutable_device):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: cpu)
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
    for name, value in (("MV_ROWS", 40_000), ("MV_VIEW_ROWS", 8_000), ("MV_RUNS", 1),
                        ("L2_FLUSH_BYTES", 8)):
        monkeypatch.setattr(chip_smoke, name, value)

    class Args:
        seed, trace = SEED, False
    # threads, not the smoke's spawned processes: the builds are the same
    # functions, without two more interpreters importing torch
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = chip_smoke.start_mv_builds(pool, Args(), str(tmp_path))
        launches, by_route, cases = chip_smoke.run_mv(Args(), str(tmp_path), jobs)
    # Q1.1: 1 a segment (4) and 1 a set pass; the mixed tree's bitmap leaf: 1 a
    # segment and a set pass on the table, 4 on each route beside the view
    # no GROUP BY of this phase runs on the card (GROUP BY lo_tags explodes on
    # the host): no grouped_agg launch
    assert by_route["per_segment"] == {"masked_sums": 4, "masked_sums_fused": 0,
                                       "bitmap_filter": 8, "grouped_agg": 0}
    assert by_route["set"] == by_route["pipeline"] == {"masked_sums": 1,
                                                       "masked_sums_fused": 0,
                                                       "bitmap_filter": 5, "grouped_agg": 0}
    assert launches == {"masked_sums": 6, "masked_sums_fused": 0, "bitmap_filter": 18,
                        "grouped_agg": 0}
    assert sorted(cases) == ["codes_band, one segment", "codes_band, stacked set",
                             "tags_eq, one segment", "tags_eq, stacked set",
                             "tags_in9, one segment", "tags_in9, stacked set"]
    assert {c["leaf"] for c in cases.values()} == {"interval", "lut"}
