"""Differential test: pinot_tpu_torch's stacked segment-set executor against the JAX package.

The same SQL over the same aligned SSB segment sets (5 segments, seeded; one
set of equal sizes and one of uneven sizes, so the uneven one has fill rows
inside the stacked block) runs through `pinot_tpu.parallel.MeshQueryExecutor`
on a one-device mesh and on the 8-device CPU mesh of tests/conftest.py,
through the port's `MeshQueryExecutor(device="cpu")` and through the port's
per-segment `execute_query`. Rows must match at the reference's device
tolerance (rel 1e-5, abs 0.05: f32 device partials), counts exactly.

Also: `execute_many` against `execute` one by one with one fetch for the list,
the routing of a stacked set (one `masked_sums` launch for the whole set),
and the shapes the port does not run, which raise NotImplementedError.
"""

import math

import numpy as np
import pytest

from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.dictionary import build_dictionary as jax_build_dictionary
from pinot_tpu.segment.writer import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
from pinot_tpu_torch import execute_query, segments_from_columns
from pinot_tpu_torch.engine import scan
from pinot_tpu_torch.parallel import MeshQueryExecutor, combine
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.ssb import FOR_QUERY, GROUP_QUERY, QUERY, make_columns, ssb_schema

REL, ABS = 1e-5, 0.05
SEED = 20260729
# segment boundaries: five segments of one padded size (no fill in the
# stacked block), and five of uneven sizes padded to 4096 rows each
BOUNDS = {"equal": [0, 4096, 8192, 12288, 16384, 20480],
          "uneven": [0, 900, 4000, 4300, 8000, 12000]}
COUNT_QUERY = "SELECT COUNT(*) FROM lineorder WHERE lo_quantity < 10 LIMIT 5"
BAND_FREE_QUERY = "SELECT SUM(lo_revenue), COUNT(*) FROM lineorder"

# (id, sql, table, the set's scan route)
QUERIES = [
    ("q1_1", QUERY, "main", "masked_sums"),
    ("group_query", GROUP_QUERY, "main", None),
    ("for_sum", FOR_QUERY, "for", "masked_sums"),
    ("count_quantity", COUNT_QUERY, "main", "masked_sums"),
    ("band_free_sum", BAND_FREE_QUERY, "main", None),
]


def _build_set(cols, bounds, out_dir, config=None):
    """`build_aligned_segments` with chosen boundaries: dictionaries over the
    whole batch, shared by every segment."""
    schema = JSchema.from_json(ssb_schema().to_json())
    config = config or JaxConfig()
    n = len(next(iter(cols.values())))
    fixed = {}
    for spec in schema.fields:
        if spec.name in config.no_dictionary_columns:
            continue
        d, _ = jax_build_dictionary(np.asarray(cols[spec.name]), spec.data_type)
        if spec.data_type.is_numeric and d.cardinality > config.raw_cardinality_fraction * n:
            config.no_dictionary_columns.append(spec.name)
            continue
        fixed[spec.name] = d
    builder = JaxBuilder(schema, config)
    return [builder.build({c: v[lo:hi] for c, v in cols.items()}, out_dir,
                          f"lineorder_{i}", fixed_dictionaries=fixed)
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]


@pytest.fixture(scope="module")
def cols():
    return make_columns(BOUNDS["equal"][-1], seed=SEED)


@pytest.fixture(scope="module")
def sets(tmp_path_factory, cols):
    """(kind, table) -> (JAX segments, port segments) over the same directories."""
    out = tmp_path_factory.mktemp("torch_parallel")
    built = {}
    for kind, bounds in BOUNDS.items():
        for table, config in (("main", None),
                              ("for", JaxConfig(no_dictionary_columns=["lo_quantity"]))):
            part = {c: v[:bounds[-1]] for c, v in cols.items()}
            paths = _build_set(part, bounds, str(out / f"{kind}_{table}"), config)
            built[kind, table] = ([jax_load(p) for p in paths], [load_segment(p) for p in paths])
    return built


@pytest.fixture(scope="module")
def jax_mesh1():
    return JaxMeshExecutor(default_mesh(1))


@pytest.fixture(scope="module")
def jax_mesh8():
    return JaxMeshExecutor()


def _rows_match(a, b) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                if not math.isclose(float(x), float(y), rel_tol=REL, abs_tol=ABS):
                    return False
            elif x != y:
                return False
    return True


def test_sets_are_aligned_and_the_uneven_one_has_fill(sets):
    for kind in BOUNDS:
        _, segs = sets[kind, "main"]
        assert len(segs) == 5
        block = combine.SegmentSetBlock(segs, "cpu")
        assert block.s_pad == 5
        assert block.rows == 4096
        assert (block.pad_waste_pct > 0) == (kind == "uneven")


@pytest.mark.parametrize("kind", list(BOUNDS))
@pytest.mark.parametrize("qid, sql, table, route", QUERIES, ids=[q[0] for q in QUERIES])
def test_set_executor_matches_reference(sets, jax_mesh1, jax_mesh8, qid, sql, table,
                                        route, kind):
    jax_segs, segs = sets[kind, table]
    got = MeshQueryExecutor(device="cpu").execute(segs, sql).rows
    ref1 = jax_mesh1.execute(jax_segs, sql).rows
    ref8 = jax_mesh8.execute(jax_segs, sql).rows
    per_segment = execute_query(segs, sql, device="cpu").rows
    assert _rows_match(got, ref1), (qid, got, ref1)
    assert _rows_match(got, ref8), (qid, got, ref8)
    assert _rows_match(got, per_segment), (qid, got, per_segment)
    ctx = compile_query(sql, segs[0].schema)
    plan, view = MeshQueryExecutor(device="cpu")._plan_for_set(ctx, segs)
    assert view is None   # aligned: no merged view
    assert combine.set_scan_route(plan) == route


def test_padding_rows_never_count(sets, cols):
    """The uneven set's fill rows enter neither a count nor a sum, on the scan
    route (an id band fails them) nor on the plain body (`valid` masks them)."""
    _, segs = sets["uneven", "main"]
    n = BOUNDS["uneven"][-1]
    mx = MeshQueryExecutor(device="cpu")
    revenue, count = mx.execute(segs, BAND_FREE_QUERY).rows[0]
    assert count == n
    assert math.isclose(revenue, float(cols["lo_revenue"][:n].sum()), rel_tol=REL)
    assert mx.execute(segs, COUNT_QUERY).rows == [[int((cols["lo_quantity"][:n] < 10).sum())]]


def test_execute_many_matches_execute_with_one_fetch(sets, monkeypatch):
    _, segs = sets["uneven", "main"]
    mx = MeshQueryExecutor(device="cpu")
    queries = [QUERY, GROUP_QUERY, COUNT_QUERY, BAND_FREE_QUERY, QUERY,
               "SELECT COUNT(*) FROM lineorder",   # answered from metadata
               "SELECT lo_region, COUNT(*) FROM lineorder GROUP BY lo_region "
               "ORDER BY COUNT(*) DESC LIMIT 2"]
    one_by_one = [mx.execute(segs, q).rows for q in queries]
    fetches = []
    real_fetch = mx.fetch

    def spy(trees):
        fetches.append(len(trees))
        return real_fetch(trees)
    monkeypatch.setattr(mx, "fetch", spy)
    assert [r.rows for r in mx.execute_many(segs, queries)] == one_by_one
    assert fetches == [6]


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("kind", list(BOUNDS))
def test_stacked_q11_is_one_scan_launch_and_group_by_the_plain_body(sets, monkeypatch,
                                                                    kind):
    _, segs = sets[kind, "main"]
    scans = _spy(monkeypatch, scan, "masked_sums_answer")
    bodies = _spy(monkeypatch, combine, "run_kernel")
    mx = MeshQueryExecutor(device="cpu")
    mx.execute(segs, QUERY)
    assert len(scans) == 1 and not bodies
    mask_cols = scans[0][0]
    assert [c.shape[0] for c in mask_cols] == [5 * 4096] * 3   # the whole block
    mx.execute(segs, GROUP_QUERY)
    assert len(scans) == 1 and len(bodies) == 1


def test_band_free_plan_takes_the_plain_body(sets, monkeypatch):
    _, segs = sets["uneven", "main"]
    scans = _spy(monkeypatch, scan, "masked_sums_answer")
    MeshQueryExecutor(device="cpu").execute(segs, BAND_FREE_QUERY)
    assert not scans


def test_scan_over_more_rows_than_one_launch_takes_raises(sets, monkeypatch):
    _, segs = sets["equal", "main"]
    monkeypatch.setattr(combine, "MAX_SCAN_ROWS", 5 * 4096 - 1)
    mx = MeshQueryExecutor(device="cpu")
    with pytest.raises(NotImplementedError, match="at most"):
        mx.execute(segs, QUERY)
    assert mx.execute(segs, GROUP_QUERY).rows   # the plain body has no such limit


def test_peers_decide_folding(tmp_path, cols):
    """A raw-column range that covers the first segment's values but not the
    others' must not fold to match-all for the whole set. (The JAX package's
    set executor folds it by the first segment alone; the port folds a leaf
    only where every segment folds it the same way.)"""
    order = np.argsort(-cols["lo_extendedprice"], kind="stable")
    sorted_cols = {k: v[order] for k, v in cols.items()}
    segs = [load_segment(p) for p in _build_set(sorted_cols, BOUNDS["equal"],
                                                  str(tmp_path))]
    assert not segs[0].column("lo_extendedprice").has_dictionary
    low = float(segs[0].column("lo_extendedprice").min_value)
    sql = ("SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
           f"WHERE lo_extendedprice >= {low}")
    m = sorted_cols["lo_extendedprice"] >= low
    want = [[int(m.sum()), float(sorted_cols["lo_revenue"][m].sum())]]
    assert _rows_match(MeshQueryExecutor(device="cpu").execute(segs, sql).rows, want)
    assert _rows_match(execute_query(segs, sql, device="cpu").rows, want)


def test_unaligned_set_raises(tmp_path, cols, jax_mesh1, monkeypatch):
    """Two segments built apart have dictionaries of their own. The set no
    longer raises: it is planned on the merged-dictionary view and stacked in
    global-id space, one launch for Q1.1, and answers as the reference's set
    executor (its merged view too) and the per-segment path do."""
    a = segments_from_columns(ssb_schema(), {k: v[:3000] for k, v in cols.items()},
                              str(tmp_path / "a"), 1)
    b = segments_from_columns(ssb_schema(), {k: v[3000:5000] for k, v in cols.items()},
                              str(tmp_path / "b"), 1)
    jax_segs = [jax_load(s.path) for s in a + b]
    mx = MeshQueryExecutor(device="cpu")
    scans = _spy(monkeypatch, scan, "masked_sums_answer")
    # the GROUP BY filters on lo_orderdate, whose dictionaries differ
    group_by_date = GROUP_QUERY.replace("WHERE", "WHERE lo_orderdate < 19950101 AND")
    for sql, route in ((QUERY, "masked_sums"), (group_by_date, None)):
        plan, view = mx._plan_for_set(compile_query(sql, a[0].schema), a + b)
        assert view is not None and combine.set_scan_route(plan) == route
        del scans[:]
        got = mx.execute(a + b, sql).rows
        assert len(scans) == (1 if route else 0)
        assert _rows_match(got, jax_mesh1.execute(jax_segs, sql).rows), sql
        assert _rows_match(got, execute_query(a + b, sql, device="cpu").rows), sql


@pytest.mark.parametrize("first_segment", ["matches_all", "matches_none"])
def test_unaligned_set_raises_where_the_first_segment_folds(tmp_path, cols, first_segment):
    """Two segments with dictionaries of their own, and an id condition that
    the first segment alone would fold to a constant (every row matches, or
    no value of its dictionary does) while it matches only part of the
    second. The set must not fold it by the first segment's dictionary: it
    is planned on the merged view, whose global dictionary folds nothing
    here, and answers as the per-segment path and numpy do. (The second
    segment has fewer dates than the first, so the first one's id table
    covers all of its ids.)"""
    dates = cols["lo_orderdate"]
    cut = int(np.median(dates[:3000]))
    low = dates[:3000] <= cut
    first = {k: v[:3000][low if first_segment == "matches_all" else ~low]
             for k, v in cols.items()}
    # the second segment: 400 dates around the cut, so that it keeps a
    # dictionary and has fewer dates than the first
    later = np.unique(dates[3000:])
    keep = np.concatenate([later[later <= cut][-200:], later[later > cut][:200]])
    sel = np.isin(dates[3000:], keep)
    second = {k: v[3000:][sel][:3000] for k, v in cols.items()}
    a = segments_from_columns(ssb_schema(), first, str(tmp_path / "a"), 1)
    b = segments_from_columns(ssb_schema(), second, str(tmp_path / "b"), 1)
    # the first segment's id table covers every id of the second
    assert 0 < b[0].column("lo_orderdate").cardinality \
        <= a[0].column("lo_orderdate").cardinality
    if first_segment == "matches_all":
        sql = f"SELECT SUM(lo_revenue), COUNT(*) FROM lineorder WHERE lo_orderdate <= {cut}"
        m = second["lo_orderdate"] <= cut
        want = (first["lo_revenue"].sum() + second["lo_revenue"][m].sum(),
                len(first["lo_revenue"]) + int(m.sum()))
    else:
        value = int(next(d for d in second["lo_orderdate"] if d <= cut))
        sql = f"SELECT SUM(lo_revenue), COUNT(*) FROM lineorder WHERE lo_orderdate = {value}"
        m = second["lo_orderdate"] == value
        want = (second["lo_revenue"][m].sum(), int(m.sum()))
    assert 0 < m.sum() < len(m)   # part of the second segment matches
    mx = MeshQueryExecutor(device="cpu")
    plan, view = mx._plan_for_set(compile_query(sql, a[0].schema), a + b)
    assert view is not None and plan.kind == "device"
    assert _rows_match(mx.execute(a + b, sql).rows, [[float(want[0]), want[1]]])
    assert _rows_match(execute_query(a + b, sql, device="cpu").rows,
                       [[float(want[0]), want[1]]])


def test_star_tree_mutable_and_selection_raise(sets, cols):
    """A set where only some members have a star-tree takes the set scan and
    answers as the set without trees does (the star path needs every member
    to fit). A mutable member (a consuming segment without staging) plans the
    set on the merged view, as the JAX set executor does, and answers as the
    immutable set does; a selection whose filter needs the host mask is the
    per-segment executor's partial."""
    from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
    from pinot_tpu_torch.segment.reader import ImmutableSegment

    _, segs = sets["equal", "main"]

    class StarTree(ImmutableSegment):
        has_star_tree = True
        star_trees = []

        def __init__(self, seg):
            self.__dict__.update(seg.__dict__)

    mx = MeshQueryExecutor(device="cpu")
    mixed_trees = segs[:2] + [StarTree(segs[2])] + segs[3:]
    assert _rows_match(mx.execute(mixed_trees, QUERY).rows, mx.execute(segs, QUERY).rows)
    lo, hi = BOUNDS["equal"][2], BOUNDS["equal"][3]
    mutable = DeviceMutableSegment("consuming", ssb_schema())
    mutable.index_batch({c: v[lo:hi].tolist() for c, v in cols.items()})
    mixed = segs[:2] + [mutable] + segs[3:]
    for sql in (QUERY, GROUP_QUERY):
        plan, view = mx._plan_for_set(compile_query(sql, segs[0].schema), mixed)
        assert view is not None and plan.kind == "device"
        assert _rows_match(mx.execute(mixed, sql).rows, mx.execute(segs, sql).rows), sql
    selection = ("SELECT lo_region, lo_revenue FROM lineorder WHERE LENGTH(lo_region) > 4 "
                 "LIMIT 5")
    want = [[r, v] for r, v in zip(cols["lo_region"], cols["lo_revenue"].tolist())
            if len(r) > 4][:5]
    assert _rows_match(mx.execute(segs, selection).rows, want)
    assert mx.prepare_partial(compile_query(selection, segs[0].schema), segs).kind == "exact"


def test_dispatch_partial_matches_prepared_partials(sets):
    """`dispatch_partial` launches one set partial; fetched and decoded, it
    reduces to the set's answer."""
    _, segs = sets["uneven", "main"]
    mx = MeshQueryExecutor(device="cpu")
    for sql in (QUERY, GROUP_QUERY):
        ctx = compile_query(sql, segs[0].schema)
        packed, decode = mx.dispatch_partial(ctx, segs)
        partial = decode(mx.fetch([packed])[0])
        aggs = [make_agg(f) for f in ctx.aggregations]
        merged = merge_segment_results([partial], aggs)
        rows = reduce_to_result(ctx, merged, aggs, list(ctx.group_by)).rows
        assert _rows_match(rows, mx.execute(segs, sql).rows), sql
