"""pinot_tpu_torch's search indexes and compressed raw columns against the JAX package's.

The same numpy-seeded rows (`ssb.make_search_columns`: a JSON payload, a
comment, a customer name, a point with nulls) go through both writers, with a
JSON, text, FST and geo index, an inverted index on lo_discount and the raw
columns zlib-compressed, on the CPU (`JAX_PLATFORMS=cpu`):

* each package reads the other's files: JSON and text matches, FST
  candidates, geo candidate masks and decoded compressed columns are equal;
* every query family of the chip smoke's `search` phase answers through the
  port, per segment, over the set and through the pipeline, as the JAX
  package's `execute_query` and a numpy oracle do (counts exactly, sums rel
  1e-5 on device plans, rel 1e-9 on the host), and as the port does on a copy
  built without the search indexes and without compression; over a staged
  consuming segment's view and the table beside it too;
* REGEXP_LIKE's LUT through the FST index equals the dictionary scan's,
  geo candidates are a superset of the matches, and a compressed raw column
  keeps the scan route of its uncompressed copy, decoded once;
* the port's cases of the JAX package's own suites (`test_json_text.py`,
  `test_fst.py`, `test_geo.py`, `test_compression.py`);
* the chip smoke's `search` phase rehearses on the CPU.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

from pinot_tpu.query.executor import execute_query as jax_execute
from pinot_tpu.query.planner import plan_segment as jax_plan
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.writer import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
from pinot_tpu.segment.writer import build_aligned_segments as jax_build
from pinot_tpu_torch import ssb
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import scan
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import QueryValidationError, compile_query
from pinot_tpu_torch.query.executor import execute_query, scan_route
from pinot_tpu_torch.query.planner import plan_segment
from pinot_tpu_torch.query.predicate import DocSetLeaf
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.schema import DataType, FieldRole, FieldSpec, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.segment.compression import CODECS, ChunkedArrayReader, write_chunked
from pinot_tpu_torch.segment.indexes.fst import (FstIndexReader, create_fst_index,
                                                 ids_matching_regex_indexed, required_literals)
from pinot_tpu_torch.segment.indexes.jsonidx import (JsonIndexReader, create_json_index,
                                                     json_match_scan)
from pinot_tpu_torch.segment.indexes.text import text_match_scan
from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments

CPU = "cpu"
SEED = 20261019
ROWS, SEGMENTS = 4000, 4
REL_DEVICE, REL_HOST = 1e-5, 1e-9
RAW = ["lo_extendedprice", "lo_revenue", "lo_lng", "lo_lat"]
SEARCH = dict(json_index_columns=["lo_payload"], text_index_columns=["lo_comment"],
              fst_index_columns=["lo_custname"], geo_index_pairs=["lo_lng,lo_lat"])
INDEXED = dict(SEARCH, inverted_index_columns=["lo_discount"], no_dictionary_columns=RAW,
               raw_compression="zlib")
COPY = dict(inverted_index_columns=["lo_discount"], no_dictionary_columns=RAW)
RADII = (1_000.0, 50_000.0, 500_000.0)
GEO_BAND_M = 10.0      # a distance this close to the radius may compare either way in f32
QIDS = [q for q in ssb.SEARCH_QUERIES if q != "geo_distance"]


def _jax_schema(schema):
    return JSchema.from_json(schema.to_json())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_search")
    schema = ssb.search_schema()
    cols = ssb.make_search_columns(ROWS, SEED)
    ours = build_aligned_segments(schema, cols, str(out / "ours"), "lineorder", SEGMENTS,
                                  SegmentGeneratorConfig(**INDEXED))
    theirs = jax_build(_jax_schema(schema), cols, str(out / "jax"), "lineorder", SEGMENTS,
                       config=JaxConfig(**INDEXED))
    copy = build_aligned_segments(schema, cols, str(out / "copy"), "lineorder", SEGMENTS,
                                  SegmentGeneratorConfig(**COPY))
    import chip_smoke
    masks = chip_smoke.search_masks(cols)
    lng, lat = chip_smoke.stored_points(cols, schema)
    return {"cols": cols, "schema": schema, "ours": ours, "theirs": theirs,
            "segs": [load_segment(p) for p in ours], "copy": [load_segment(p) for p in copy],
            "jax": [jax_load(p) for p in theirs], "masks": masks,
            "answers": chip_smoke.search_answers(cols, masks), "points": (lng, lat),
            "center": (float(lng[0]), float(lat[0])), "chip_smoke": chip_smoke}


def _cells_match(x, y, rel) -> bool:
    if x is None or y is None:
        return x is y
    if isinstance(x, float) or isinstance(y, float):
        return math.isclose(float(x), float(y), rel_tol=rel, abs_tol=1e-9)
    return x == y


def _rows_match(got, want, rel=REL_DEVICE) -> bool:
    return len(got) == len(want) and all(
        len(a) == len(b) and all(_cells_match(x, y, rel) for x, y in zip(a, b))
        for a, b in zip(got, want))


def _served(mx, segs, sql):
    ctx = compile_query(sql, segs[0].schema)
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        partial = pipeline.execute_partial(ctx, segs)
    finally:
        pipeline.stop()
    aggs = [make_agg(f) for f in ctx.aggregations]
    return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                            list(ctx.group_by)).rows


def _three_routes(segs, sql):
    mx = MeshQueryExecutor(device=CPU)
    return {"per_segment": execute_query(segs, sql, device=CPU).rows,
            "set": mx.execute(segs, sql).rows, "pipeline": _served(mx, segs, sql)}


# -- the files: both packages read both writers' indexes ----------------------

JSON_FILTERS = ['"$.type" = \'PushEvent\'', '"$.tags[*]" = \'t3\' AND "$.qty" > 40',
                '"$.actor.org" IS NOT NULL', '"$.actor.login" IN (\'user7\', \'user99\')',
                '"$.qty" BETWEEN 10 AND 12 OR NOT "$.type" <> \'ForkEvent\'']
TEXT_QUERIES = [ssb.SEARCH_TEXT, f"{ssb.SEARCH_PREFIX}*", f"/{ssb.SEARCH_REGEX}/",
                f'"{ssb.SEARCH_PHRASE}" AND NOT {ssb.SEARCH_TERM}', "babe~1", "(baba OR babi)"]
FST_PATTERNS = [ssb.SEARCH_CUSTNAME_REGEX, "Customer#0000[0-9]{2}17$", "0012|0013", "#00"]


@pytest.mark.parametrize("side", ["ours", "theirs"])
@pytest.mark.parametrize("kind", ["json", "text", "fst", "geo", "compression"])
def test_search_files_load_in_both_readers(env, side, kind):
    """Each writer's files, read by each package: equal answers, and equal
    metadata between the two writers."""
    for p_ours, p_theirs, path in zip(env["ours"], env["theirs"], env[side]):
        meta = [json.load(open(os.path.join(q, "metadata.json"))) for q in (p_ours, p_theirs)]
        assert meta[0]["columns"] == meta[1]["columns"]
        assert meta[0]["geoIndexes"] == meta[1]["geoIndexes"]
        a, b = load_segment(path), jax_load(path)
        if kind == "json":
            for f in JSON_FILTERS:
                np.testing.assert_array_equal(a.column("lo_payload").json_index.match(f),
                                              b.column("lo_payload").json_index.match(f))
        elif kind == "text":
            for q in TEXT_QUERIES:
                np.testing.assert_array_equal(a.column("lo_comment").text_index.match(q),
                                              b.column("lo_comment").text_index.match(q))
        elif kind == "fst":
            ra, rb = a.column("lo_custname"), b.column("lo_custname")
            for pattern in FST_PATTERNS:
                ca, cb = ra.fst_index.candidate_ids(pattern), rb.fst_index.candidate_ids(pattern)
                assert (ca is None) == (cb is None), pattern
                if ca is not None:
                    np.testing.assert_array_equal(ca, cb)
        elif kind == "geo":
            ga, gb = a.geo_index("lo_lng", "lo_lat"), b.geo_index("lo_lng", "lo_lat")
            for x, y, r in [(*env["center"], 50_000.0), (179.95, 0.0, 30_000.0),
                            (10.0, 89.99, 50_000.0), (0.0, 0.0, 1_000.0)]:
                np.testing.assert_array_equal(ga.candidate_mask(x, y, r, a.num_docs),
                                              gb.candidate_mask(x, y, r, b.num_docs))
                assert ga.match_estimate(x, y, r) == gb.match_estimate(x, y, r)
        else:
            for col in RAW:
                assert a.column(col).meta["compression"] == "zlib"
                assert isinstance(a.column(col).fwd, ChunkedArrayReader)
                np.testing.assert_array_equal(np.asarray(a.column(col).fwd),
                                              np.asarray(b.column(col).fwd))
                np.testing.assert_array_equal(a.column(col).values(), b.column(col).values())


# -- the smoke's query families -----------------------------------------------

@pytest.mark.parametrize("qid", QIDS)
def test_search_queries_match_the_reference_and_numpy(env, qid):
    """Per segment, over the set and through the pipeline, on the indexed
    table and on the copy: numpy's answer and the JAX package's."""
    sql = ssb.SEARCH_QUERIES[qid]
    want = env["answers"][qid]
    rel = REL_HOST if qid == "text_select" else REL_DEVICE
    jax_rows = jax_execute(env["jax"], sql).rows
    assert _rows_match(jax_rows, want, rel), (jax_rows, want)
    for label in ("segs", "copy"):
        for route, got in _three_routes(env[label], sql).items():
            assert _rows_match(got, want, rel), (label, route, got, want)


@pytest.mark.parametrize("radius", RADII)
def test_distance_filter_with_and_without_the_geo_index(env, radius):
    """The cell candidates (a superset of the matches, each segment) ANDed
    with the exact compare answer as the compare alone on the copy does, as
    the JAX package does, and as numpy does up to the f32 band."""
    lng, lat = env["points"]
    x, y = env["center"]
    chip_smoke = env["chip_smoke"]
    dist = chip_smoke.haversine_m(lng, lat, x, y)
    lo, hi = int((dist < radius - GEO_BAND_M).sum()), int((dist < radius + GEO_BAND_M).sum())
    sql = ssb.SEARCH_QUERIES["geo_distance"].format(lng=repr(x), lat=repr(y), r=radius)
    base = 0
    for seg in env["segs"]:
        cand = seg.geo_index("lo_lng", "lo_lat").candidate_mask(x, y, radius, seg.num_docs)
        assert not (dist[base:base + seg.num_docs] < radius + GEO_BAND_M)[~cand].any()
        base += seg.num_docs
        kinds = [type(leaf).__name__ for leaf in plan_segment(
            compile_query(sql, env["schema"]), seg).filter_prog.leaves]
        assert kinds == ["CmpLeaf", "DocSetLeaf"], kinds
    assert [type(leaf).__name__ for leaf in plan_segment(
        compile_query(sql, env["schema"]), env["copy"][0]).filter_prog.leaves] == ["CmpLeaf"]
    ours, theirs = _three_routes(env["segs"], sql), _three_routes(env["copy"], sql)
    assert ours == theirs
    assert all(lo <= rows[0][0] <= hi for rows in ours.values()), (ours, lo, hi)
    assert jax_execute(env["jax"], sql).rows == ours["per_segment"]


def test_regexp_like_lut_through_the_fst_index_equals_the_scan(env):
    """REGEXP_LIKE over lo_custname: the FST index's LUT equals the copy's
    (the whole dictionary scanned) and the JAX planner's, with fewer regex
    calls."""
    sql = ssb.SEARCH_QUERIES["regexp_fst"]
    for seg, cp, jseg in zip(env["segs"], env["copy"], env["jax"]):
        assert seg.column("lo_custname").fst_index is not None
        assert cp.column("lo_custname").fst_index is None
        luts = [plan_segment(compile_query(sql, env["schema"]), s).filter_prog.leaves[0].lut
                for s in (seg, cp)]
        jlut = jax_plan(jax_compile(sql, jseg.schema), jseg).filter_prog.leaves[0].lut
        np.testing.assert_array_equal(luts[0], luts[1])
        np.testing.assert_array_equal(luts[0], np.asarray(jlut))
        cands = seg.column("lo_custname").fst_index.candidate_ids(ssb.SEARCH_CUSTNAME_REGEX)
        assert luts[0].sum() <= len(cands) < seg.column("lo_custname").cardinality


@pytest.mark.parametrize("qid", ["q1_1", "for_sum"])
def test_compressed_raw_columns_keep_the_scan_route(env, tmp_path, monkeypatch, qid):
    """Q1.1 over the search table (lo_extendedprice compressed) and the FOR
    query over a table with lo_quantity raw and compressed: the same plan,
    route and scan calls as the uncompressed copy, each chunk decoded once."""
    if qid == "q1_1":
        sql, segs, copy, cols = ssb.QUERY, env["segs"], env["copy"], env["cols"]
    else:
        sql, cols = ssb.FOR_QUERY, ssb.make_columns(6000, SEED)
        segs, copy = ([load_segment(p) for p in build_aligned_segments(
            ssb.ssb_schema(), cols, str(tmp_path / name), "lineorder", 2,
            SegmentGeneratorConfig(no_dictionary_columns=["lo_quantity"], raw_compression=codec))]
            for name, codec in (("zlib", "zlib"), ("plain", "")))
        assert segs[0].column("lo_quantity").meta["compression"] == "zlib"
    calls = []
    for name in ("masked_sums_answer", "masked_sums_fused_answer"):
        real = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _n=name, _r=real: (calls.append(_n), _r(*a))[1])
    decoded = []
    codec = CODECS["zlib"]
    monkeypatch.setitem(CODECS, "zlib", (codec[0], lambda b: (decoded.append(1), codec[1](b))[1]))
    answers = []
    for table in (segs, copy):
        ctx = compile_query(sql, table[0].schema)
        assert scan_route(plan_segment(ctx, table[0])) is not None
        answers.append([])
        seen = []
        for route, rows in _three_routes(table, sql).items():
            answers[-1].append(rows)
            seen.append(list(calls))
            calls.clear()
        answers[-1].append(seen)
    assert answers[0][-1] == answers[1][-1]        # the same scan calls, route by route
    assert _rows_match(answers[0][0], answers[1][0])
    before = len(decoded)
    _three_routes(segs, sql)                        # warm: nothing decoded again
    assert len(decoded) == before


# -- the consuming segment ----------------------------------------------------

@pytest.fixture(scope="module")
def consuming(env):
    rt = ssb.make_search_columns(1500, SEED + 1)
    views = {}
    for staged in (True, False):
        store = DeviceMutableSegment("lineorder__0__0__20261019T0000Z", env["schema"],
                                     device_staging=staged, device=CPU)
        store.index_batch({c: list(v) for c, v in rt.items()})
        views[staged] = store.query_view()
    import chip_smoke
    masks = chip_smoke.search_masks(rt)
    both = {k: np.concatenate([env["cols"][k], rt[k]]) for k in rt}
    return {"rt": rt, "views": views, "answers": chip_smoke.search_answers(rt, masks),
            "both": chip_smoke.search_answers(both, {k: np.concatenate([env["masks"][k], masks[k]])
                                                     for k in masks})}


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "mutable"])
@pytest.mark.parametrize("qid", ["json_type", "text_or"])
def test_search_over_a_consuming_view_and_a_mixed_set(env, consuming, tmp_path, qid, staged):
    """The view's readers carry no index: its JSON_MATCH and TEXT_MATCH scan
    the values. Alone and beside the table (the set's per-segment pre-bail
    wherever it would need the merged view), on every route: numpy's answer
    and the JAX package's over the same rows as an immutable segment."""
    sql = ssb.SEARCH_QUERIES[qid]
    view = consuming["views"][staged]
    assert view.column("lo_payload").json_index is None
    assert view.column("lo_comment").text_index is None
    jax_rt = jax_load(JaxBuilder(_jax_schema(env["schema"])).build(
        consuming["rt"], str(tmp_path), "rt_0"))
    members = env["segs"] + [view]
    for segs, want, jsegs in (([view], consuming["answers"][qid], [jax_rt]),
                              (members, consuming["both"][qid], env["jax"] + [jax_rt])):
        assert _rows_match(jax_execute(jsegs, sql).rows, want)
        routes = _three_routes(segs, sql) if staged else {
            "per_segment": execute_query(segs, sql, device=CPU).rows,
            "set": MeshQueryExecutor(device=CPU).execute(segs, sql).rows}
        for route, got in routes.items():
            assert _rows_match(got, want), (route, got, want)
    plan, view_plan = MeshQueryExecutor(device=CPU)._plan_for_set(
        compile_query(sql, env["schema"]), members)
    if qid == "text_or" or not staged:
        assert (plan, view_plan) == (None, None)   # the pre-bail
    else:
        # no compared or grouped dictionary column: the set is aligned, and
        # the view's mask stacks with the segments' masks
        assert isinstance(plan.filter_prog.leaves[0], DocSetLeaf) and view_plan is None


def test_realtime_text_and_inverted_indexes_raise(env, tmp_path):
    """The chunked consuming segment keeps no per-row index: asking it for one
    raises, as in the JAX package. A table that names one consumes into the
    row-append MutableSegment, which keeps it; a table's indexing config still
    reaches the commit."""
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.segment.mutable import MutableSegment
    from pinot_tpu_torch.table import IndexingConfig, StreamConfig, TableConfig
    with pytest.raises(ValueError, match="MutableSegment"):
        DeviceMutableSegment("s", env["schema"], device=CPU, text_index_columns=["lo_comment"])
    with pytest.raises(ValueError, match="MutableSegment"):
        DeviceMutableSegment("s", env["schema"], device=CPU,
                             inverted_index_columns=["lo_discount"])
    MemoryStream.create("search_commit", 1)
    text_consumer = RealtimePartitionConsumer("lineorder__0__0__20261019T0000Z", TableConfig(
        "lineorder", stream=StreamConfig(topic="search_commit"),
        indexing=IndexingConfig(text_index_columns=["lo_comment"])),
        env["schema"], 0, str(tmp_path), device=CPU)
    assert isinstance(text_consumer.mutable, MutableSegment)
    assert set(text_consumer.mutable.text_indexes) == {"lo_comment"}
    rt = ssb.make_search_columns(300, SEED + 2)
    consumer = RealtimePartitionConsumer("lineorder__0__0__20261019T0000Z", TableConfig(
        "lineorder", stream=StreamConfig(topic="search_commit"),
        indexing=IndexingConfig(json_index_columns=["lo_payload"], raw_compression="lzma",
                                no_dictionary_columns=["lo_revenue"])),
        env["schema"], 0, str(tmp_path), device=CPU)
    consumer.mutable.index_batch({c: list(v) for c, v in rt.items()})
    seg = load_segment(consumer.build_immutable())
    assert seg.column("lo_payload").json_index is not None
    assert seg.column("lo_revenue").meta["compression"] == "lzma"
    np.testing.assert_array_equal(seg.column("lo_revenue").values(), rt["lo_revenue"])


# -- the JAX package's own suites, on the port --------------------------------

@pytest.fixture(scope="module")
def jenv(tmp_path_factory):
    """`tests/test_json_text.py`'s people table, built by the port with and
    without the JSON and text indexes, and by the JAX writer."""
    rng = np.random.default_rng(5)
    n = 500
    names, cities = ["alice", "bob", "carol", "dan"], ["sf", "nyc", "sea"]
    docs = []
    for i in range(n):
        d = {"name": names[rng.integers(0, len(names))], "age": int(rng.integers(18, 80)),
             "addr": {"city": cities[rng.integers(0, len(cities))],
                      "zip": str(10000 + int(rng.integers(0, 100)))},
             "tags": [f"t{int(t)}" for t in rng.integers(0, 6, rng.integers(0, 4))]}
        if i % 7 == 0:
            del d["addr"]
        docs.append(d)
    corpus = ["quick brown fox", "lazy dog sleeps", "brown dog barks loudly",
              "the quick red fox jumps", "silent night", "java query engine",
              "distributed query engine rocks"]
    texts = [corpus[rng.integers(0, len(corpus))] for _ in range(n)]
    schema = Schema("people", [dimension("js", DataType.JSON), dimension("doc", DataType.STRING),
                               metric("score", DataType.INT)])
    cols = {"js": [json.dumps(d) for d in docs], "doc": texts,
            "score": rng.integers(0, 100, n).astype(np.int32)}
    out = tmp_path_factory.mktemp("jseg")
    idx = SegmentGeneratorConfig(json_index_columns=["js"], text_index_columns=["doc"])
    seg = load_segment(SegmentBuilder(schema, idx).build(cols, str(out), "people_0"))
    plain = load_segment(SegmentBuilder(schema).build(cols, str(out), "people_1"))
    jseg = jax_load(JaxBuilder(_jax_schema(schema), JaxConfig(
        json_index_columns=["js"], text_index_columns=["doc"])).build(
        cols, str(out / "jax"), "people_0"))
    return seg, plain, jseg, docs, texts, cols


def _lev(a, b):
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _fuzzy(term, k):
    return lambda d, t, s: any(_lev(term, w) <= k for w in t.split())


# (id, filter, oracle(doc, text, score) -> bool), after tests/test_json_text.py
JSON_TEXT_CASES = [
    ("json_eq", "JSON_MATCH(js, '\"$.name\" = ''alice''')", lambda d, t, s: d["name"] == "alice"),
    ("json_nested_and", "JSON_MATCH(js, '\"$.addr.city\" = ''sf'' AND \"$.age\" > 40')",
     lambda d, t, s: d.get("addr", {}).get("city") == "sf" and d["age"] > 40),
    ("json_array_element", "JSON_MATCH(js, '\"$.tags[*]\" = ''t3''')",
     lambda d, t, s: "t3" in d["tags"]),
    ("json_is_null_presence", "JSON_MATCH(js, '\"$.addr.city\" IS NULL')",
     lambda d, t, s: "addr" not in d),
    ("json_in", "JSON_MATCH(js, '\"$.addr.city\" IN (''sf'', ''nyc'')')",
     lambda d, t, s: d.get("addr", {}).get("city") in ("sf", "nyc")),
    ("json_between", "JSON_MATCH(js, '\"$.age\" BETWEEN 30 AND 40')",
     lambda d, t, s: 30 <= d["age"] <= 40),
    ("json_with_other_filter", "JSON_MATCH(js, '\"$.name\" = ''bob''') AND score >= 50",
     lambda d, t, s: d["name"] == "bob" and s >= 50),
    ("json_eq_one", "JSON_MATCH(js, '\"$.name\" = ''bob''') = 1",
     lambda d, t, s: d["name"] == "bob"),
    ("text_term", "TEXT_MATCH(doc, 'fox')", lambda d, t, s: "fox" in t.split()),
    ("text_and", "TEXT_MATCH(doc, 'quick AND fox')",
     lambda d, t, s: "quick" in t.split() and "fox" in t.split()),
    ("text_or", "TEXT_MATCH(doc, 'dog OR fox')",
     lambda d, t, s: "dog" in t.split() or "fox" in t.split()),
    ("text_and_not", "TEXT_MATCH(doc, 'dog AND NOT lazy')",
     lambda d, t, s: "dog" in t.split() and "lazy" not in t.split()),
    ("text_phrase", "TEXT_MATCH(doc, '\"quick brown\"')", lambda d, t, s: "quick brown" in t),
    ("text_phrase_not_adjacent", "TEXT_MATCH(doc, '\"quick fox\"')", lambda d, t, s: False),
    ("text_prefix", "TEXT_MATCH(doc, 'qu*')",
     lambda d, t, s: any(w.startswith("qu") for w in t.split())),
    ("text_regex", "TEXT_MATCH(doc, '/ja.a/')", lambda d, t, s: "java" in t.split()),
    ("text_zero", "TEXT_MATCH(doc, 'fox') = 0", lambda d, t, s: "fox" not in t.split()),
    ("text_fuzzy_1", "TEXT_MATCH(doc, 'fox~1')", _fuzzy("fox", 1)),
    ("text_fuzzy_2", "TEXT_MATCH(doc, 'lazyy~')", _fuzzy("lazyy", 2)),
    ("text_fuzzy_and_not", "TEXT_MATCH(doc, 'fox~1 AND NOT lazy')",
     lambda d, t, s: _fuzzy("fox", 1)(d, t, s) and "lazy" not in t.split()),
]


@pytest.mark.parametrize("case", [c[0] for c in JSON_TEXT_CASES])
def test_reference_json_text_cases(jenv, case):
    """`tests/test_json_text.py`'s queries: the indexed segment, the scan of
    the segment without indexes, the JAX package and Python agree."""
    seg, plain, jseg, docs, texts, cols = jenv
    where, pred = next((w, p) for c, w, p in JSON_TEXT_CASES if c == case)
    sql = f"SELECT COUNT(*) FROM people WHERE {where}"
    want = sum(1 for d, t, s in zip(docs, texts, cols["score"]) if pred(d, t, s))
    assert execute_query([seg], sql, device=CPU).rows == [[want]]
    assert execute_query([plain], sql, device=CPU).rows == [[want]]
    assert jax_execute([jseg], sql).rows == [[want]]


def _json_key_with_control_chars(tmp_path):
    p = str(tmp_path / "j.npz")
    create_json_index(p, ['{"a": "x\\u0002y"}', '{"a": "z"}', '{"b": 1}'])
    idx = JsonIndexReader(p, 3)
    np.testing.assert_array_equal(idx.match('"$.a" = \'z\''), [False, True, False])
    np.testing.assert_array_equal(idx.match('"$.b" = 1'), [False, False, True])


def _text_selection(tmp_path, jenv):
    seg, _, _, _, texts, _ = jenv
    rows = execute_query([seg], "SELECT doc FROM people WHERE "
                         "TEXT_MATCH(doc, '\"query engine\"') LIMIT 500", device=CPU).rows
    assert len(rows) == sum(1 for t in texts if "query engine" in t)
    assert all("query engine" in r[0] for r in rows)


def _json_group_by(tmp_path, jenv):
    seg, _, _, docs, _, _ = jenv
    rows = execute_query([seg], "SELECT COUNT(*) FROM people WHERE "
                         "JSON_MATCH(js, '\"$.age\" > 50') GROUP BY doc", device=CPU).rows
    assert sum(int(r[0]) for r in rows) == sum(1 for d in docs if d["age"] > 50)


def _validation_errors(tmp_path, jenv):
    seg = jenv[0]
    for where in ("TEXT_MATCH(doc, '\"oops')", "JSON_MATCH(js, '''a'' = ''b''')"):
        with pytest.raises(QueryValidationError):
            execute_query([seg], f"SELECT COUNT(*) FROM people WHERE {where}", device=CPU)


def _json_on_a_mutable_segment(tmp_path, jenv):
    store = DeviceMutableSegment("m__0", Schema("m", [dimension("js", DataType.JSON)]),
                                 device=CPU)
    store.index_batch({"js": [f'{{"a": {i % 3}}}' for i in range(10)]})
    assert execute_query([store], "SELECT COUNT(*) FROM m WHERE JSON_MATCH(js, '\"$.a\" = 1')",
                         device=CPU).rows == [[3]]


PRIMITIVE_CASES = {
    "json_key_with_control_chars": lambda tmp_path, jenv: _json_key_with_control_chars(tmp_path),
    "json_double_quote_in_literal": lambda tmp_path, jenv: np.testing.assert_array_equal(
        json_match_scan(['{"a": "say \\"hi\\" ok"}', '{"a": "other"}'],
                        '"$.a" = \'say "hi" ok\''), [True, False]),
    "json_mixed_numeric_forms": lambda tmp_path, jenv: np.testing.assert_array_equal(
        json_match_scan(['{"n": 1}', '{"n": 1.0}', '{"n": 2}'], '"$.n" = 1'),
        [True, True, False]),
    "json_neq_flattened_records": lambda tmp_path, jenv: np.testing.assert_array_equal(
        json_match_scan(['{"arr":[{"x":1},{"x":2}]}', '{"arr":[{"x":3}]}', '{"arr":[{"x":1}]}'],
                        '"$.arr[*].x" <> 1'), [True, True, False]),
    "text_bare_not_is_must_not": lambda tmp_path, jenv: np.testing.assert_array_equal(
        text_match_scan(["apple pie", "banana split", "cherry cake"], "apple NOT banana"),
        [True, False, False]),
    "text_selection": _text_selection,
    "json_group_by": _json_group_by,
    "validation_errors": _validation_errors,
    "json_on_a_mutable_segment": _json_on_a_mutable_segment,
}


@pytest.mark.parametrize("case", sorted(PRIMITIVE_CASES))
def test_reference_json_text_primitives(tmp_path, jenv, case):
    PRIMITIVE_CASES[case](tmp_path, jenv)


@pytest.mark.parametrize("pattern,expected", [
    ("error", ["error"]), ("^error$", ["error"]), ("foo.*bar", ["foo", "bar"]), ("ab", []),
    ("foo|bar", []), ("fooo*", ["foo"]), ("colou?r", ["colo"]),
    ("err[0-9]+code", ["err", "code"]), ("(warn)+fatal", ["fatal"]), ("a{2,3}bcd", ["bcd"]),
    ("abc\\d+", ["abc"]), ("(?i)error", []),
])
def test_required_literals(pattern, expected):
    """`tests/test_fst.py::test_required_literals`, on the port's extraction."""
    assert required_literals(pattern) == expected, pattern


def test_required_literals_never_lose_matches_random():
    """Every literal claimed required appears in every matching value."""
    rng = np.random.default_rng(7)
    values = ["".join(rng.choice(list("abcde"), size=rng.integers(3, 12))) for _ in range(300)]
    pieces = ["abc", "de", "a.c", "b+", "c*", "d?e", "[ab]", "(cd)", "ab|cd", "^ab", "de$",
              "a{2}", "b{0,2}"]
    for _ in range(200):
        pattern = "".join(rng.choice(pieces) for _ in range(rng.integers(1, 4)))
        try:
            rx = re.compile(pattern)
        except re.error:
            continue
        for lit in required_literals(pattern):
            assert all(lit in v for v in values if rx.search(v)), (pattern, lit)


def _fst_equals_full_scan(tmp_path):
    words = ["server", "service", "serial", "verse", "obverse", "nurse", "错误代码", "err_500",
             "err_404", "warning", "fatal_error", "x" * 50, "", "abcabcabc"]
    vals = sorted({w + str(i % 7) for i, w in enumerate(words * 10)})
    path = str(tmp_path / "t.fst.npz")
    create_fst_index(path, vals)
    idx = FstIndexReader(path)
    for pattern in ["err", "err_[0-9]+", "serv(er|ice)", "^obv", "verse[0-9]$", "abcabc",
                    "错误", "nomatchxyz", "fatal_error[0-3]"]:
        got = ids_matching_regex_indexed(idx, vals, pattern)
        if got is not None:
            rx = re.compile(pattern)
            assert got.tolist() == [i for i, v in enumerate(vals) if rx.search(v)], pattern


def _fst_skips_unindexable(tmp_path):
    path = str(tmp_path / "u.fst.npz")
    create_fst_index(path, ["aa", "bb"])
    idx = FstIndexReader(path)
    assert idx.candidate_ids("a|b") is None and idx.candidate_ids("x?y?") is None
    assert ids_matching_regex_indexed(idx, ["aa", "bb"], "a|b") is None


def _fst_nul_in_values(tmp_path):
    vals = ["a\x00bcq", "yellow", "zebra", "zenith", "zzzzzz"]
    path = str(tmp_path / "nul.fst.npz")
    create_fst_index(path, vals)
    idx = FstIndexReader(path)
    for pattern, want in (("zebra", [2]), ("zzzz", [4]), ("a\x00bc", [0])):
        assert ids_matching_regex_indexed(idx, vals, pattern).tolist() == want


def _fst_skipped_for_bytes(tmp_path):
    schema = Schema("b", [FieldSpec("raw", DataType.BYTES, FieldRole.DIMENSION),
                          metric("n", DataType.INT)])
    seg = load_segment(SegmentBuilder(schema, SegmentGeneratorConfig(
        fst_index_columns=["raw"])).build({"raw": [b"\x01\x02", b"\x03"],
                                           "n": np.array([1, 2], dtype=np.int32)},
                                          str(tmp_path), "b_0"))
    assert seg.column("raw").fst_index is None


def _fst_queries_with_and_without(tmp_path):
    rng = np.random.default_rng(5)
    schema = Schema("logs", [dimension("msg", DataType.STRING), metric("n", DataType.INT)])
    stems = ["connection reset", "timeout waiting", "auth failed", "disk full",
             "retry scheduled", "ok"]
    cols = {"msg": [f"{stems[i % len(stems)]} host{i % 17}" for i in range(2000)],
            "n": rng.integers(0, 100, 2000, dtype=np.int32)}
    segs = [load_segment(SegmentBuilder(schema, SegmentGeneratorConfig(**cfg)).build(
        cols, str(tmp_path), name)) for name, cfg in (("fst", {"fst_index_columns": ["msg"]}),
                                                      ("plain", {}))]
    assert segs[0].column("msg").fst_index is not None
    for pattern in ["timeout", "host1[0-9]", "auth.*host3", "resets?", "full|empty", "^ok",
                    "no_such_message"]:
        sql = f"SELECT COUNT(*), SUM(n) FROM logs WHERE REGEXP_LIKE(msg, '{pattern}')"
        a, b = (execute_query([s], sql, device=CPU).rows for s in segs)
        assert a == b, (pattern, a, b)


FST_CASES = {"equals_full_scan": _fst_equals_full_scan,
             "skips_unindexable_patterns": _fst_skips_unindexable,
             "nul_in_values": _fst_nul_in_values, "skipped_for_bytes": _fst_skipped_for_bytes,
             "queries_with_and_without_the_index": _fst_queries_with_and_without}


@pytest.mark.parametrize("case", sorted(FST_CASES))
def test_reference_fst_cases(tmp_path, case):
    """`tests/test_fst.py`'s index cases, on the port."""
    FST_CASES[case](tmp_path)


GEO_SCHEMA = Schema("places", [dimension("name", DataType.STRING), metric("lng", DataType.DOUBLE),
                               metric("lat", DataType.DOUBLE)])
_GEO_RNG = np.random.default_rng(9)
GEO_LNG, GEO_LAT = _GEO_RNG.uniform(-123.0, -118.0, 2000), _GEO_RNG.uniform(33.0, 38.5, 2000)
SFO = (-122.375, 37.619)


def _geo_segment(tmp_path, cols, name, indexed=True):
    cfg = SegmentGeneratorConfig(geo_index_pairs=["lng,lat"] if indexed else [])
    return load_segment(SegmentBuilder(GEO_SCHEMA, cfg).build(cols, str(tmp_path), name))


def _geo_superset(tmp_path, haversine_m):
    seg = _geo_segment(tmp_path, {"name": [f"p{i}" for i in range(2000)], "lng": GEO_LNG,
                                  "lat": GEO_LAT}, "places_idx")
    idx = seg.geo_index("lng", "lat")
    for radius in (20_000, 100_000):
        mask = idx.candidate_mask(*SFO, radius, 2000)
        exact = haversine_m(GEO_LNG, GEO_LAT, *SFO) < radius
        assert (mask | ~exact).all() and mask.sum() < 2000


def _geo_antimeridian_and_poles(tmp_path, haversine_m):
    lng, lat = np.array([-179.95, 179.95, 10.0, 0.0]), np.array([0.0, 0.0, 90.0, -90.0])
    idx = _geo_segment(tmp_path, {"name": list("abcd"), "lng": lng, "lat": lat},
                       "seam_0").geo_index("lng", "lat")
    mask = idx.candidate_mask(179.95, 0.0, 30_000, 4)
    assert (mask | ~(haversine_m(lng, lat, 179.95, 0.0) < 30_000)).all()
    assert mask[0] and mask[1]
    mask = idx.candidate_mask(10.0, 89.99, 50_000, 4)
    assert (mask | ~(haversine_m(lng, lat, 10.0, 89.99) < 50_000)).all() and mask[2]


def _geo_null_coordinates(tmp_path, haversine_m):
    seg = _geo_segment(tmp_path, {"name": ["a", "b"], "lng": [-122.0, None],
                                  "lat": [37.0, None]}, "nulls_0")
    sql = ("SELECT COUNT(*) FROM places WHERE ST_DISTANCE(ST_POINT(lng, lat), "
           "ST_POINT(-122.0, 37.0)) < 1000")
    assert execute_query([seg], sql, device=CPU).rows == [[1]]
    jseg = jax_load(seg.path)
    assert jax_execute([jseg], sql).rows == [[1]]


def _geo_flipped_predicate(tmp_path, haversine_m):
    cols = {"name": [f"p{i}" for i in range(2000)], "lng": GEO_LNG, "lat": GEO_LAT}
    seg, plain = (_geo_segment(tmp_path, cols, name, idx)
                  for name, idx in (("idx", True), ("plain", False)))
    sql = ("SELECT COUNT(*) FROM places WHERE 100000 > "
           "ST_DISTANCE(ST_POINT(lng, lat), ST_POINT(-122.375, 37.619))")
    plan = plan_segment(compile_query(sql, GEO_SCHEMA), seg)
    assert plan.kind == "device"
    assert any(isinstance(leaf, DocSetLeaf) for leaf in plan.filter_prog.leaves)
    straight = sql.replace("100000 > ST_DISTANCE", "ST_DISTANCE").replace(
        "37.619))", "37.619)) < 100000")
    got = {execute_query([s], q, device=CPU).rows[0][0]
           for s in (seg, plain) for q in (sql, straight)}
    assert len(got) == 1


GEO_CASES = {"candidates_superset": _geo_superset,
             "antimeridian_and_poles": _geo_antimeridian_and_poles,
             "null_coordinates": _geo_null_coordinates,
             "flipped_predicate": _geo_flipped_predicate}


@pytest.mark.parametrize("case", sorted(GEO_CASES))
def test_reference_geo_cases(env, tmp_path, case):
    """`tests/test_geo.py`'s geo index cases, on the port."""
    GEO_CASES[case](tmp_path, env["chip_smoke"].haversine_m)


def _compression_round_trip(codec):
    def case(tmp_path):
        arr = np.arange(200_000, dtype=np.int64) % 1000
        path = str(tmp_path / f"c_{codec}.bin")
        write_chunked(path, arr, codec=codec, chunk_rows=4096)
        r = ChunkedArrayReader(path)
        assert len(r) == len(arr) and r.codec == codec
        assert np.array_equal(r.array(), arr)
        if codec != "passthrough":
            assert os.path.getsize(path) < arr.nbytes // 4
        from pinot_tpu.segment.compression import ChunkedArrayReader as JaxReader
        assert np.array_equal(JaxReader(path).array(), arr)
    return case


def _compression_range_reads(tmp_path):
    arr = np.random.default_rng(1).random(10_000)
    path = str(tmp_path / "r.bin")
    write_chunked(path, arr, codec="zlib", chunk_rows=1000)
    r = ChunkedArrayReader(path)
    for lo, hi in [(0, 10), (995, 1005), (2999, 5001), (9990, 10_000), (0, 10_000),
                   (5000, 5000)]:
        assert np.array_equal(r.read_rows(lo, hi), arr[lo:hi]), (lo, hi)
    assert np.array_equal(r.read_rows(-5, 3), arr[0:3])
    assert len(r.read_rows(9_999, 20_000)) == 1
    assert r._full is None
    assert np.array_equal(r[995:1005], arr[995:1005]) and r._full is None


def _compression_empty_and_single(tmp_path):
    for arr in [np.empty(0, dtype=np.float32), np.array([7], dtype=np.int32)]:
        path = str(tmp_path / f"e{len(arr)}.bin")
        write_chunked(path, arr, codec="lzma")
        assert np.array_equal(ChunkedArrayReader(path).array(), arr)


def _compression_fwd_slicing_bounded(tmp_path):
    schema = Schema("m", [dimension("k", DataType.STRING), metric("v", DataType.DOUBLE)])
    rng = np.random.default_rng(3)
    cols = {"k": [f"k{i % 50}" for i in range(20_000)], "v": np.round(rng.random(20_000) * 100, 2)}
    path = SegmentBuilder(schema, SegmentGeneratorConfig(
        no_dictionary_columns=["v"], raw_compression="zlib")).build(cols, str(tmp_path), "c")
    r = load_segment(path).column("v").fwd
    assert r._full is None
    assert np.array_equal(r[:7], cols["v"][:7]) and r._full is None
    assert len(np.asarray(r)) == 20_000 and r._full is not None
    assert np.array_equal(np.asarray(jax_load(path).column("v").fwd), cols["v"])


COMPRESSION_CASES = dict({f"round_trip_{c}": _compression_round_trip(c) for c in sorted(CODECS)},
                         range_reads_cross_chunks=_compression_range_reads,
                         empty_and_single_chunk=_compression_empty_and_single,
                         fwd_slicing_is_bounded=_compression_fwd_slicing_bounded)


@pytest.mark.parametrize("case", sorted(COMPRESSION_CASES))
def test_reference_compression_cases(tmp_path, case):
    """`tests/test_compression.py`'s codec round trips and chunked reads, on
    the port (each file also read by the JAX package's reader)."""
    COMPRESSION_CASES[case](tmp_path)


# -- the chip smoke's phase ---------------------------------------------------

def test_the_smoke_search_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `search` phase at 16,000 rows with the card's calls
    pointed at the CPU, its tables built by `start_search_builds`'s worker
    processes: every answer, plan, launch and decompression check of the
    phase passes (the kernels' calls counted as launches)."""
    import chip_smoke
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.segment import mutable_device

    cpu = torch.device(CPU)
    for module in (executor, combine, mutable_device):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
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
    for name, value in (("SEARCH_ROWS", 16_000), ("SEARCH_VIEW_ROWS", 4_000),
                        ("FOR_ROWS", 16_000), ("SEARCH_RUNS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    cols = ssb.make_columns(16_000, SEED)
    for_table = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), cols, str(tmp_path / "for"), "lineorder", chip_smoke.FOR_SEGMENTS,
        SegmentGeneratorConfig(no_dictionary_columns=["lo_quantity"]))]

    class Args:   # phase 4's table: 16,000 rows, its first FOR_ROWS the FOR table
        seed, trace, rows = SEED, False, 16_000
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = chip_smoke.start_search_builds(pool, Args(), str(tmp_path))
        launches, by_route = chip_smoke.run_search(Args(), cols, for_table, str(tmp_path),
                                                   jobs)
    # Q1.1 on the table and the copy: 4 + 4 per segment, 1 + 1 set, 1 + 1 served;
    # the FOR query on both FOR tables: 2 + 2 fused per segment, 1 + 1 set and served
    # grouped_agg: text_or's GROUP BY, a pass: per segment on the table and the
    # copy (8), the view (1) and the table beside it (5); over the set and
    # through the pipeline the table, the copy, the view (3) and the per-segment
    # pre-bail beside it (5)
    assert by_route["per_segment"] == {"masked_sums": 8, "masked_sums_fused": 4,
                                       "bitmap_filter": 8, "grouped_agg": 14}
    assert by_route["set"] == by_route["pipeline"] == {"masked_sums": 4, "masked_sums_fused": 0,
                                                       "bitmap_filter": 2, "grouped_agg": 8}
    assert launches == {"masked_sums": 16, "masked_sums_fused": 4, "bitmap_filter": 12,
                        "grouped_agg": 30}


# -- a set whose segments compile different doc-set leaves -------------------------

DOCSET_SCHEMA = Schema("places", [metric("lng", DataType.DOUBLE), metric("lat", DataType.DOUBLE),
                                  dimension("k", DataType.LONG), metric("v", DataType.DOUBLE)])
DOCSET_DISTANCE = "ST_DISTANCE(ST_POINT(lng, lat), ST_POINT(-122.375, 37.619)) < 100000"


def _docset_pair(tmp_path):
    """Two segments of 2,000 rows, only the first built with the geo index
    (its distance filter compiles a candidate doc-set leaf there only), and
    a raw LONG `k` (its IN_ID_SET is a doc-set leaf on both)."""
    rng = np.random.default_rng(17)
    segs, cols = [], []
    for i, geo in enumerate((True, False)):
        c = {"lng": rng.uniform(-123.5, -121.0, 2000), "lat": rng.uniform(36.5, 38.5, 2000),
             "k": np.arange(i * 2000, (i + 1) * 2000, dtype=np.int64) * 7919,
             "v": np.round(rng.uniform(0, 10, 2000), 2)}
        cfg = SegmentGeneratorConfig(geo_index_pairs=["lng,lat"] if geo else [],
                                     no_dictionary_columns=["k", "v"])
        segs.append(load_segment(SegmentBuilder(DOCSET_SCHEMA, cfg).build(
            c, str(tmp_path), f"places_{i}")))
        cols.append(c)
    assert segs[0].geo_index("lng", "lat") is not None
    assert segs[1].geo_index("lng", "lat") is None
    return segs, cols


@pytest.mark.parametrize("order", ["indexed_first", "plain_first"])
@pytest.mark.parametrize("with_id_set", [False, True], ids=["distance", "distance_and_id_set"])
def test_a_set_whose_segments_compile_other_doc_set_leaves_answers_per_segment(
        env, tmp_path, order, with_id_set):
    """Segment 0's plan holds a geo candidate leaf where the segment has the
    index; a segment without it compiles no such leaf. The set path must not
    pair the masks by position: it answers that set per segment (the
    reference's `DocsetPlanDivergence`), through `execute`, `execute_many`
    and the pipeline, equal to the per-segment answer and to numpy."""
    from pinot_tpu_torch.query.idset import IdSet
    segs, cols = _docset_pair(tmp_path)
    if order == "plain_first":
        segs, cols = segs[::-1], cols[::-1]
    k = np.concatenate([c["k"] for c in cols])
    even = k[k % 2 == 0]
    sql = f"SELECT COUNT(*), SUM(v) FROM places WHERE {DOCSET_DISTANCE}"
    if with_id_set:
        sql += f" AND IN_ID_SET(k, '{IdSet.from_values(even).serialize()}') = 1"
    lng = np.concatenate([c["lng"] for c in cols])
    lat = np.concatenate([c["lat"] for c in cols])
    dist = env["chip_smoke"].haversine_m(lng, lat, -122.375, 37.619)
    assert not (np.abs(dist - 100_000) < GEO_BAND_M).any()
    m = dist < 100_000
    if with_id_set:
        m &= k % 2 == 0
    v = np.concatenate([c["v"] for c in cols])
    want = [[int(m.sum()), float(v[m].sum())]]
    per_segment = execute_query(segs, sql, device=CPU).rows
    assert _rows_match(per_segment, want)
    mx = MeshQueryExecutor(device=CPU)
    for route, got in (("set", mx.execute(segs, sql).rows),
                       ("many", mx.execute_many(segs, [sql, sql])[0].rows),
                       ("pipeline", _served(mx, segs, sql))):
        assert _rows_match(got, per_segment), (route, got, per_segment)
