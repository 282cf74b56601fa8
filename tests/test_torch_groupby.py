"""Differential test: the port's GROUP BY (`engine/grouped.py`) and its
array-form server partial (`reduce.DensePartial`) against the JAX package.

The same segment directories (written by the port's writer, loaded by both
packages, inputs made from a seed with numpy) go through both on the CPU:

* GROUP BY answers at 300, 700, 2,500, 5,000 and 40,000 keys (the JAX
  package's one-hot matmul up to 512 keys, its chunked matmul past it, its
  radix-partitioned sort past 131,072 cells through a two-column key; and
  the port's warp, block and global rungs), per segment (against the
  reference's `ServerQueryExecutor`), over the set and through the pipeline
  (against its `MeshQueryExecutor` on a one-device mesh): count, SUM of a
  float and an int column, the moments, MIN/MAX, and grouped and scalar
  DISTINCTCOUNT;
* MIN/MAX and COUNT with NaN and +-inf rows against the reference; the SUM of
  those rows against numpy, because the reference's one-hot matmul spreads a
  NaN or inf row into every cell (NaN * 0, inf * 0);
* the `DensePartial` round trip (the counterpart of
  `test_dense_partial_roundtrip`): two server partials of a 6,000-key set,
  dense, merged elementwise and reduced, equal to the reference's merged
  dense partials and to its full answer; through the pipeline too;
* partials whose tokens differ (sets built apart), or a dense partial beside
  a state-dict one, materialize and merge to the same answer;
* each of `_decode_dense_partial`'s declines;
* `grouped_agg_plain` against a numpy oracle (an empty group, every row
  masked, the overflow cell left at 0 or the identity, NaN and +-inf rows,
  int64 sums past 2^53), and the wrapper taking it for CPU tensors;
* the rung choice at its boundaries, as pure Python.

Tolerances: counts, int sums, DISTINCTCOUNT, MIN and MAX exactly; float sums
(and AVG) at rel 1e-5, abs 0.05 against the reference, whose f32 matmul and
bf16-split rungs round otherwise; moments at rel 1e-5, abs 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from pinot_tpu.parallel import MeshQueryExecutor as JaxMeshExecutor
from pinot_tpu.parallel import default_mesh
from pinot_tpu.query.aggregates import make_agg as jax_make_agg
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.reduce import merge_segment_results as jax_merge
from pinot_tpu.query.reduce import reduce_to_result as jax_reduce
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu_torch import execute_query
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import grouped
from pinot_tpu_torch.engine.datablock import block_for
from pinot_tpu_torch.engine.grouped import (choose_rung, grouped_agg, grouped_agg_plain,
                                            launch_grid, region_bytes)
from pinot_tpu_torch.engine.kernels import run_kernel
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query import executor as port_executor
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.executor import (DENSE_PARTIAL_MIN_GROUPS, ServerQueryExecutor,
                                            kernel_spec)
from pinot_tpu_torch.query.planner import build_device_geometry, plan_segment
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.segment.writer import build_aligned_segments

CPU = "cpu"
SEED = 20261018
SEGMENTS = 4
FSUM_REL, FSUM_ABS = 1e-5, 0.05
MOMENT_REL, MOMENT_ABS = 1e-5, 1e-4
CARDS = (300, 700, 2500, 5000, 40_000)

# (sql, one tolerance kind per select item): "exact" (keys, counts, int sums,
# distinct counts, min, max), "fsum" (float sums and AVG), "moment"
GROUP_SHAPES = [
    ("SELECT k, COUNT(*), SUM(v), SUM(q) FROM t GROUP BY k ORDER BY k LIMIT 100000",
     ("exact", "exact", "fsum", "exact")),
    ("SELECT k, AVG(v), MIN(q), MAX(q), MIN(v), MAX(v) FROM t WHERE q < 500 "
     "GROUP BY k ORDER BY k LIMIT 100000",
     ("exact", "fsum", "exact", "exact", "exact", "exact")),
    # two columns: the combined key space g * k crosses the reference's caps
    ("SELECT g, k, SUM(v), COUNT(*) FROM t WHERE q >= 250 GROUP BY g, k "
     "ORDER BY g, k LIMIT 100000", ("exact", "exact", "fsum", "exact")),
    ("SELECT k, VAR_POP(d), KURTOSIS(d), STDDEV_SAMP(d) FROM t GROUP BY k "
     "ORDER BY k LIMIT 100000", ("exact", "moment", "moment", "moment")),
    ("SELECT g, DISTINCTCOUNT(d), DISTINCTCOUNT(k), COUNT(*) FROM t WHERE q < 700 "
     "GROUP BY g ORDER BY g", ("exact", "exact", "exact", "exact")),
    ("SELECT DISTINCTCOUNT(k), VAR_POP(d), SKEWNESS(d), COUNT(*) FROM t WHERE q < 300",
     ("exact", "moment", "moment", "exact")),
]


def _schema() -> Schema:
    return Schema("t", [dimension("k", DataType.INT), dimension("g", DataType.STRING),
                        dimension("d", DataType.INT), metric("v", DataType.DOUBLE),
                        metric("q", DataType.INT)])


def _columns(card: int, rows: int, seed: int) -> dict:
    """Every key of [0, card) at least once (where rows allow), the rest drawn."""
    rng = np.random.default_rng(seed)
    base = min(card, rows)
    k = np.concatenate([np.arange(base), rng.integers(0, card, rows - base)])
    rng.shuffle(k)
    return {"k": k.astype(np.int32),
            "g": [f"g{i}" for i in rng.integers(0, 6, rows)],
            "d": rng.integers(0, 11, rows).astype(np.int32),
            "v": np.round(rng.uniform(-500.0, 500.0, rows), 2),
            "q": rng.integers(0, 1000, rows).astype(np.int32)}


def _build(tmp_path_factory, name: str, cols: dict, segments: int = SEGMENTS):
    out = tmp_path_factory.mktemp(name)
    paths = build_aligned_segments(_schema(), cols, str(out), "t", segments)
    return [load_segment(p) for p in paths], [jax_load(p) for p in paths]


@pytest.fixture(scope="module")
def jax_mesh():
    return JaxMeshExecutor(default_mesh(1))


@pytest.fixture(scope="module", params=CARDS)
def card_table(request, tmp_path_factory):
    card = request.param
    rows = 60_000 if card > 5000 else 30_000
    return card, _build(tmp_path_factory, f"card{card}", _columns(card, rows, SEED + card))


def assert_rows(got, want, kinds, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w) == len(kinds), (what, g, w)
        for x, y, kind in zip(g, w, kinds):
            if kind == "exact" or not isinstance(y, float):
                assert x == y, (what, g, w)
            elif kind == "fsum":
                assert math.isclose(x, y, rel_tol=FSUM_REL, abs_tol=FSUM_ABS), (what, g, w)
            else:
                assert math.isclose(x, y, rel_tol=MOMENT_REL, abs_tol=MOMENT_ABS), (what, g, w)


def _pipeline_rows(mx, segs, sql):
    ctx = compile_query(sql, segs[0].schema)
    aggs = [make_agg(f) for f in ctx.aggregations]
    p = DeviceQueryPipeline(mesh_exec=mx)
    try:
        partial = p.execute_partial(ctx, segs)
    finally:
        p.stop()
    return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                            list(ctx.group_by)).rows


@pytest.mark.parametrize("path", ["per_segment", "set", "pipeline"])
def test_group_by_matches_the_reference_across_the_rungs(card_table, jax_mesh, path):
    """Every shape at every cardinality and path equals the reference's
    answer; every plan is a device plan (the body, not the host)."""
    card, (segs, jsegs) = card_table
    mx = MeshQueryExecutor(device=CPU)
    for sql, kinds in GROUP_SHAPES:
        assert plan_segment(compile_query(sql, segs[0].schema), segs[0]).kind == "device"
        if path == "per_segment":
            got = execute_query(segs, sql, device=CPU).rows
            want = JaxExecutor().execute(jsegs, sql).rows
        else:
            got = mx.execute(segs, sql).rows if path == "set" else _pipeline_rows(mx, segs, sql)
            want = jax_mesh.execute(jsegs, sql).rows
        assert_rows(got, want, kinds, (card, path, sql))


NAN_SQL = "SELECT k, MIN(v), MAX(v), COUNT(*) FROM t GROUP BY k ORDER BY k LIMIT 100000"
NAN_SUM_SQL = "SELECT k, SUM(v) FROM t GROUP BY k ORDER BY k LIMIT 100000"


@pytest.fixture(scope="module")
def nan_table(tmp_path_factory):
    cols = _columns(300, 12_000, SEED)
    v = cols["v"]
    for i, x in zip(range(0, 40, 4), [np.nan, np.inf, -np.inf] * 4):
        v[i * 97] = x
    segs, jsegs = _build(tmp_path_factory, "nan", cols)
    return cols, segs, jsegs


@pytest.mark.parametrize("path", ["per_segment", "set", "pipeline"])
def test_nan_and_inf_rows_in_min_max_and_sum(nan_table, jax_mesh, path):
    """MIN and MAX take a group's NaN (it wins) and infinities as the
    reference does; SUM gives numpy's float64 answer (inf, -inf or NaN in
    those groups only), where the reference's matmul gives NaN everywhere."""
    cols, segs, jsegs = nan_table
    mx = MeshQueryExecutor(device=CPU)
    run = {"per_segment": lambda sql: execute_query(segs, sql, device=CPU).rows,
           "set": lambda sql: mx.execute(segs, sql).rows,
           "pipeline": lambda sql: _pipeline_rows(mx, segs, sql)}[path]
    want = (JaxExecutor().execute(jsegs, NAN_SQL) if path == "per_segment"
            else jax_mesh.execute(jsegs, NAN_SQL)).rows
    got = run(NAN_SQL)
    assert len(got) == len(want) == 300
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        for x, y in zip(g[1:3], w[1:3]):
            assert (math.isnan(x) and math.isnan(y)) or x == y, (g, w)
    assert any(math.isnan(r[1]) for r in got) and any(r[2] == math.inf for r in got)
    v32 = cols["v"].astype(np.float32).astype(np.float64)
    sums = np.zeros(300)
    np.add.at(sums, cols["k"], v32)
    for k, s in run(NAN_SUM_SQL):
        if math.isfinite(sums[k]):
            assert math.isclose(s, sums[k], rel_tol=FSUM_REL, abs_tol=FSUM_ABS), (k, s)
        else:
            assert (math.isnan(s) and math.isnan(sums[k])) or s == sums[k], (k, s, sums[k])


# -- the DensePartial ------------------------------------------------------------------

DENSE_SQL = ("SELECT k, COUNT(*), SUM(v), SUM(q), MIN(q), MAX(v), VAR_POP(d) FROM t "
             "GROUP BY k ORDER BY k LIMIT 3000000")
DENSE_KINDS = ("exact", "exact", "fsum", "exact", "exact", "exact", "moment")


@pytest.fixture(scope="module")
def vhc_table(tmp_path_factory):
    cols = _columns(6000, 40_000, SEED + 7)
    return cols, _build(tmp_path_factory, "vhc", cols)


def _dense_partial(mx, ctx, segs):
    packed, decode = mx.dispatch_partial(ctx, segs)
    return decode(mx.fetch([packed])[0])


def test_dense_partial_roundtrip(vhc_table, jax_mesh):
    """Two server partials of 6,000 keys come back dense (no state dict),
    share a token, merge elementwise and reduce to the reference's merged
    dense partials' answer and to its full answer."""
    _, (segs, jsegs) = vhc_table
    ctx = compile_query(DENSE_SQL, segs[0].schema)
    mx = MeshQueryExecutor(device=CPU)
    halves = [segs[:2], segs[2:]]
    parts = [_dense_partial(mx, ctx, h) for h in halves]
    for part in parts:
        assert part.dense is not None and not part.groups
        assert part.dense.num_keys_real == 6000 >= DENSE_PARTIAL_MIN_GROUPS
    assert parts[0].dense.token == parts[1].dense.token
    assert sum(p.num_docs_scanned for p in parts) == 40_000
    aggs = [make_agg(f) for f in ctx.aggregations]
    merged = merge_segment_results(parts, aggs)
    assert merged.dense is not None and merged.num_docs_scanned == 40_000
    got = reduce_to_result(ctx, merged, aggs, list(ctx.group_by)).rows

    jctx = jax_compile(DENSE_SQL, jsegs[0].schema)
    jparts = []
    for half in (jsegs[:2], jsegs[2:]):
        outs, decode = jax_mesh.dispatch_partial(jctx, half)
        jparts.append(decode(outs))
        assert jparts[-1].dense is not None
    jaggs = [jax_make_agg(f) for f in jctx.aggregations]
    ref = jax_reduce(jctx, jax_merge(jparts, jaggs), jaggs, list(jctx.group_by)).rows
    assert_rows(got, ref, DENSE_KINDS, "merged partials")
    assert_rows(got, jax_mesh.execute(jsegs, DENSE_SQL).rows, DENSE_KINDS, "full answer")


def test_the_pipeline_returns_the_dense_partial(vhc_table, jax_mesh):
    _, (segs, jsegs) = vhc_table
    ctx = compile_query(DENSE_SQL, segs[0].schema)
    p = DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(device=CPU))
    try:
        parts = [p.execute_partial(ctx, half) for half in (segs[:2], segs[2:])]
    finally:
        p.stop()
    assert all(part.dense is not None and not part.groups for part in parts)
    aggs = [make_agg(f) for f in ctx.aggregations]
    got = reduce_to_result(ctx, merge_segment_results(parts, aggs), aggs,
                           list(ctx.group_by)).rows
    assert_rows(got, jax_mesh.execute(jsegs, DENSE_SQL).rows, DENSE_KINDS, "pipeline")


@pytest.mark.parametrize("mix", ["tokens_differ", "dense_beside_dict"])
def test_partials_that_cannot_merge_dense_materialize(tmp_path_factory, vhc_table, jax_mesh,
                                                      mix):
    """Partials of sets built apart (their dictionaries, and so their tokens,
    differ), or a dense partial beside a state-dict one, are turned into
    state dicts and merge to the reference's full answer."""
    cols, (segs, jsegs) = vhc_table
    ctx = compile_query(DENSE_SQL, segs[0].schema)
    mx = MeshQueryExecutor(device=CPU)
    if mix == "tokens_differ":
        half = {c: v[:20_000] for c, v in cols.items()}
        rest = {c: v[20_000:] for c, v in cols.items()}
        a, ja = _build(tmp_path_factory, "apart_a", half, 2)
        b, jb = _build(tmp_path_factory, "apart_b", rest, 2)
        parts = [_dense_partial(mx, ctx, a), _dense_partial(mx, ctx, b)]
        assert all(p.dense is not None for p in parts)
        assert parts[0].dense.token != parts[1].dense.token
        jall = ja + jb
    else:
        parts = [_dense_partial(mx, ctx, segs[:2]),
                 mx._per_segment_partial(ctx, segs[2:])]
        assert parts[0].dense is not None and parts[1].dense is None and parts[1].groups
        jall = jsegs
    aggs = [make_agg(f) for f in ctx.aggregations]
    merged = merge_segment_results(parts, aggs)
    assert merged.dense is None and len(merged.groups) == 6000
    assert all(p.dense is None for p in parts)
    got = reduce_to_result(ctx, merged, aggs, list(ctx.group_by)).rows
    assert_rows(got, jax_mesh.execute(jall, DENSE_SQL).rows, DENSE_KINDS, mix)


def test_materialize_dense_gives_the_state_dict(vhc_table):
    _, (segs, _) = vhc_table
    ctx = compile_query(DENSE_SQL, segs[0].schema)
    mx = MeshQueryExecutor(device=CPU)
    part = _dense_partial(mx, ctx, segs)
    aggs = [make_agg(f) for f in ctx.aggregations]
    dense_rows = reduce_to_result(ctx, merge_segment_results([part], aggs), aggs,
                                  list(ctx.group_by)).rows
    part.materialize_dense()
    assert part.dense is None and len(part.groups) == 6000
    dict_rows = reduce_to_result(ctx, merge_segment_results([part], aggs), aggs,
                                 list(ctx.group_by)).rows
    assert_rows(dense_rows, dict_rows, DENSE_KINDS, "materialized")
    part = _dense_partial(mx, ctx, segs)
    part.dense.aggs = None
    with pytest.raises(ValueError, match="aggregations"):
        part.materialize_dense()


@pytest.mark.parametrize("case", ["dense", "few_keys", "no_dense_values", "distinct",
                                  "no_dict_hash"])
def test_decode_dense_partial_declines(vhc_table, monkeypatch, case):
    """`_decode_dense_partial` gives the array form for a 6,000-key plan of
    dense-finalizable aggregations, and None below DENSE_PARTIAL_MIN_GROUPS
    keys, for an aggregation without `dense_values` (BOOL_AND), for a
    `distinct` output, and for a group column without a `dictHash`."""
    _, (segs, _) = vhc_table
    sql = {"dense": "SELECT k, SUM(v) FROM t GROUP BY k",
           "few_keys": "SELECT g, SUM(v) FROM t GROUP BY g",
           "no_dense_values": "SELECT k, BOOL_AND(q > 10) FROM t GROUP BY k",
           "distinct": "SELECT k, DISTINCTCOUNT(d) FROM t GROUP BY k",
           "no_dict_hash": "SELECT k, SUM(v) FROM t GROUP BY k"}[case]
    seg = segs[0]
    plan = plan_segment(compile_query(sql, seg.schema), seg)
    assert plan.kind == "device"
    build_device_geometry(plan)
    ex, spec = ServerQueryExecutor(CPU), kernel_spec(plan)
    outs = {k: v.numpy() for k, v in run_kernel(
        spec, ex._kernel_inputs(plan, spec, block_for(seg, ex.device))).items()}
    if case == "no_dict_hash":
        assert seg.column("k") is seg.column("k")
        monkeypatch.delitem(seg.column("k").meta, "dictHash")
    got = ex._decode_dense_partial(plan, outs)
    if case == "dense":
        assert got is not None and got.dense.num_keys_real == 6000 and not got.groups
        assert got.num_docs_scanned == seg.num_docs
    else:
        assert got is None


# -- grouped_agg_plain against numpy -----------------------------------------------------

def _oracle(ids, strides, mask, vals, ops, num_cells):
    """numpy: count and each op per cell over the kept rows, a row at a time."""
    n = len(mask)
    key = np.zeros(n, dtype=np.int64)
    for t, s in zip(ids, strides):
        key += t.astype(np.int64) * s
    keep = mask & (key >= 0) & (key < num_cells)
    counts = np.bincount(key[keep], minlength=num_cells).astype(np.int32)
    res = [counts]
    for v, op in zip(vals, ops):
        ident = grouped.identity(op, torch.from_numpy(v[:0]).dtype)
        if op == "isum":
            acc = np.zeros(num_cells, dtype=np.int64)
            np.add.at(acc, key[keep], v[keep].astype(np.int64))
        elif op in ("min", "max"):
            acc = np.full(num_cells, ident, dtype=v.dtype)
            for k, x in zip(key[keep], v[keep]):
                if np.isnan(acc[k]) or (isinstance(x, np.floating) and np.isnan(x)):
                    acc[k] = np.nan
                else:
                    acc[k] = min(acc[k], x) if op == "min" else max(acc[k], x)
        else:
            p = {"sum": 1, "sum2": 2, "sum3": 3, "sum4": 4}[op]
            x = v[keep].astype(np.float64) if p == 1 else \
                v[keep].astype(np.float32).astype(np.float64)
            acc = np.zeros(num_cells)
            with np.errstate(invalid="ignore"):   # inf - inf in a NaN case
                np.add.at(acc, key[keep], x ** p)
            acc = acc.astype(np.float32)
        res.append(acc)
    return res


def _plain_case(name):
    rng = np.random.default_rng(abs(hash(name)) % (1 << 32))
    n = 5000
    g0 = rng.integers(0, 7, n).astype(np.int32)
    g1 = rng.integers(0, 5, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    f = rng.normal(0, 100, n).astype(np.float32)
    d = rng.normal(0, 1e6, n)
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i64 = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    vals = [f, f, f, f, d, i32, i64, i32, f, i64, d]
    ops = ["sum", "sum2", "sum3", "sum4", "sum", "isum", "isum", "min", "max", "min", "max"]
    ids, strides, cells = [g0, g1], [1, 7], 64   # cells 35..63 take no row
    if name == "empty_group":
        g0 = np.where(g0 == 3, 4, g0).astype(np.int32)
        ids = [g0, g1]
    elif name == "all_masked":
        mask = np.zeros(n, dtype=bool)
    elif name == "nan_inf":
        f[::50], f[7::50], f[13::50] = np.nan, np.inf, -np.inf
        d[3::70] = np.nan
    elif name == "past_2_53":
        i64 = np.full(n, (1 << 52) + 3, dtype=np.int64)
        vals[6] = vals[9] = i64
    elif name == "one_key":
        ids, strides, cells = [], [], 1
    elif name == "out_of_range_keys":
        g0 = g0.copy()
        g0[::9] = 40   # key 40 + 7 * g1 >= 35 < 64: kept; past 64 dropped
        g0[::11] = -3
        ids = [g0, g1]
    return ids, strides, mask, vals, ops, cells


@pytest.mark.parametrize("name", ["plain", "empty_group", "all_masked", "nan_inf",
                                  "past_2_53", "one_key", "out_of_range_keys"])
def test_grouped_agg_plain_matches_numpy(name):
    """Counts, int sums, min and max exactly (NaN where a group holds one);
    f64-accumulated sums rounded to f32 at rel 2.5e-7 (one f32 ulp: numpy
    adds in another order); cells no kept row reaches hold 0 or the
    identity, the overflow cell among them."""
    ids, strides, mask, vals, ops, cells = _plain_case(name)
    got = grouped_agg_plain([torch.from_numpy(t) for t in ids], strides,
                            torch.from_numpy(mask), [torch.from_numpy(v) for v in vals],
                            ops, cells)
    want = _oracle(ids, strides, mask, vals, ops, cells)
    assert [g.dtype for g in got] == [torch.int32] + [
        grouped.out_dtype(op, torch.from_numpy(v[:0]).dtype) for v, op in zip(vals, ops)]
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        assert g.shape == (cells,)
        if g.dtype.kind == "f" and i and ops[i - 1] not in ("min", "max"):
            np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=0, equal_nan=True)
        else:
            np.testing.assert_array_equal(g, w)
    if name == "all_masked":
        assert not got[0].any()
    if name == "past_2_53":
        assert int(got[7][0]) == int(want[7][0]) > (1 << 53)
    if name not in ("one_key", "out_of_range_keys"):
        # keys reach 0..34 only: the cells past them (the overflow cell's
        # place) keep 0 or the identity
        assert not got[0][35:].any()
        for v, op, r in zip(vals, ops, got[1:]):
            fill = grouped.identity(op, torch.from_numpy(v[:0]).dtype)
            assert (r[35:] == fill).all()


def test_the_wrapper_takes_the_plain_version_for_cpu_tensors():
    ids, strides, mask, vals, ops, cells = _plain_case("plain")
    args = ([torch.from_numpy(t) for t in ids], strides, torch.from_numpy(mask),
            [torch.from_numpy(v) for v in vals], ops, cells)
    before = grouped_agg.launches
    for g, w in zip(grouped_agg(*args), grouped_agg_plain(*args)):
        assert torch.equal(g, w)
    assert grouped_agg.launches == before


@pytest.mark.parametrize("bad", ["float_ids", "short_mask", "isum_float", "op", "cells",
                                 "strided"])
def test_the_wrapper_refuses_what_it_does_not_take(bad):
    ids, strides, mask, vals, ops, cells = _plain_case("plain")
    ids = [torch.from_numpy(t) for t in ids]
    vals = [torch.from_numpy(v) for v in vals]
    mask = torch.from_numpy(mask)
    if bad == "float_ids":
        ids[0] = ids[0].float()
    elif bad == "short_mask":
        mask = mask[:-1]
    elif bad == "isum_float":
        ops = ["isum"] + ops[1:]
    elif bad == "op":
        ops = ["median"] + ops[1:]
    elif bad == "cells":
        cells = 0
    else:
        vals[0] = torch.from_numpy(np.repeat(vals[0].numpy(), 2))[::2]
    with pytest.raises(ValueError):
        grouped_agg(ids, strides, mask, vals, ops, cells)


# -- the rung choice -----------------------------------------------------------------------

SMEM = 232_448   # an H100 block's opt-in shared memory


@pytest.mark.parametrize("cells, widths, want", [
    (1, [8, 8, 8], ("thread", 7_168)),             # the scalar power sums 2-4
    (1, [8] * 13, ("thread", 27_648)),             # one cell of 13 outputs
    (1, [8] * 14, ("warp", 960)),
    (2, [8], ("thread", 6_144)),
    (9, [8], ("thread", 27_648)),                  # GROUP_QUERY: 9 cells, one f64 sum
    (10, [8], ("warp", 960)),                      # 30,720 bytes of thread copies
    (16, [], ("thread", 16_384)),                  # a scalar DISTINCTCOUNT's 16 ids
    (27, [], ("thread", 27_648)),
    (28, [], ("warp", 896)),
    (144, [], ("warp", 4_608)),                    # DISTINCTCOUNT by lo_region
    (256, [8], ("warp", 24_576)),                  # every warp's copy exactly 24 KiB
    (257, [8], ("block", 3_088)),
    (4097, [8, 4, 4], ("block", 81_944)),          # GROUP BY lo_orderdate
    (32_768, [], ("block", 131_072)),              # lo_suppkey's presence
    (19_370, [8], ("block", 232_440)),             # one copy exactly fits
    (19_371, [8], ("cluster", 116_232)),           # half a copy a block
    (20_481, [8, 8], ("cluster", 204_824)),        # GROUP BY lo_suppkey, VAR_POP
    (38_740, [8], ("cluster", 232_440)),           # half a copy exactly fits
    (38_741, [8], ("global", 0)),
    (503_809, [8], ("global", 0)),                 # GROUP BY lo_custkey
])
def test_the_rung_choice_at_its_boundaries(cells, widths, want):
    assert region_bytes(cells, widths) == -(-cells * (4 + sum(widths)) // 8) * 8
    assert choose_rung(cells, widths, SMEM) == want
    # a 64-bit min or max keeps a launch off the cluster rung
    assert choose_rung(cells, widths, SMEM, max64=True) == (
        ("global", 0) if want[0] == "cluster" else want)


@pytest.mark.parametrize("rung, n, smem, want", [
    # BLOCKS_PER_SM[rung] blocks an SM (3 of 256 threads on the thread rung,
    # 4 on the warp rung, 1 of 1024 on the block and cluster rungs, 2 on the
    # global rung), fewer where their copies do not fit beside each other
    # (233,472 bytes an SM, 1,024 of them kept a block); fewer where the rows
    # would give a thread fewer than ROWS_PER_THREAD
    ("thread", 2_097_152, 27_648, 132 * 3),        # GROUP_QUERY, one segment
    ("thread", 16_777_216, 27_648, 132 * 3),       # GROUP_QUERY, stacked
    ("thread", 16_777_216, 76_800, 132 * 3),       # 3 copies exactly fit an SM
    ("thread", 16_777_216, 76_801, 132 * 2),
    ("thread", 2_097_152, 7_168, 132 * 3),         # the power sums, one segment
    ("thread", 1_048_576, 7_168, 256),             # fewer rows: 16 a thread
    ("warp", 16_777_216, 4_608, 132 * 4),          # DISTINCTCOUNT by lo_region
    ("block", 16_777_216, 81_944, 132),            # GROUP BY lo_orderdate
    ("block", 16_777_216, 131_072, 132),           # lo_suppkey's presence
    ("block", 2_097_152, 131_072, 128),
    ("global", 16_777_216, 0, 132 * 2),
    ("global", 2_097_152, 0, 132 * 2),
    ("global", 65_536, 0, 16),
    ("thread", 5, 27_648, 1),
    ("global", 0, 0, 1),
])
def test_the_launch_grid(rung, n, smem, want):
    assert launch_grid(rung, n, smem, 132, 233_472) == want


@pytest.mark.parametrize("n, smem, want", [
    (16_777_216, 204_824, 132),                    # lo_suppkey VAR_POP: 66 clusters of 2
    (1_048_576, 116_232, 128),                     # 16 rows a thread of 512
    (1_048_575, 116_232, 128),
    (100_000, 116_232, 12),
    (0, 116_232, 2),                               # one cluster at the least
])
def test_the_cluster_rungs_grid_is_whole_clusters(n, smem, want):
    assert launch_grid("cluster", n, smem, 131, 233_472) == min(want, 130)
    assert launch_grid("cluster", n, smem, 132, 233_472) == want


def test_the_scratch_and_tile_sizes():
    """The wrapper's sizes, as pure Python: the thread rung's copies (every
    thread's cells, unrounded), the workspace (the ticket, then one rounded
    copy of the accumulators), and the rows read one by one before the
    16-byte loads: none where every column is aligned, 8 - k for columns
    that all start k rows past an aligned address, every row where no head
    aligns them all."""
    assert grouped.thread_copies_bytes(9, [8]) == 9 * 12 * 256
    assert grouped.thread_copies_bytes(1, [8, 8, 8]) == 28 * 256
    assert grouped.workspace_bytes(9, [8]) == grouped.TICKET_BYTES + 112
    assert grouped.workspace_bytes(4097, [8, 4, 4]) == grouped.TICKET_BYTES + 81_944
    assert grouped.workspace_bytes(503_809, [8]) == grouped.TICKET_BYTES + 6_045_712
    base = 1 << 20   # an allocation's 512-byte aligned start
    for k in range(grouped.ROWS):
        cols = [(base + k, 1, 8), (base + 4 * k, 4, 16), (base + 4 * k, 4, 16),
                (base + 8 * k, 8, 16)]
        assert grouped.row_tiling(cols) == ((grouped.ROWS - k) % grouped.ROWS, True)
    # the mask alone one row on: no head aligns it with the ids
    assert grouped.row_tiling([(base + 1, 1, 8), (base, 4, 16)]) == (0, False)
    # f64 values one row on and the mask seven: a head of 1 aligns both
    assert grouped.row_tiling([(base + 7, 1, 8), (base + 8, 8, 16)]) == (1, True)
    assert grouped.row_tiling([]) == (0, True)


def test_the_smoke_groupby_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `groupby` phase at 120,000 rows with the card's calls
    pointed at the CPU: every answer, launch count (one grouped_agg a GROUP
    BY pass, one more a distinct output, one a server partial), dense
    partial and group_case check passes; the rungs are those the H100's
    shared memory gives."""
    import chip_smoke
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig

    cpu = torch.device(CPU)
    for module in (port_executor, combine):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    counts = {"masked_sums": 0, "masked_sums_fused": 0, "bitmap_filter": 0, "grouped_agg": 0}
    real = kernels.grouped_agg

    def counted(*args):
        counts["grouped_agg"] += 1
        return real(*args)
    monkeypatch.setattr(kernels, "grouped_agg", counted)
    monkeypatch.setattr(chip_smoke, "reset_launch_counts",
                        lambda: counts.update(dict.fromkeys(counts, 0)))
    monkeypatch.setattr(chip_smoke, "launch_counts", lambda: dict(counts))
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, flush, runs=0: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, flush, runs=0: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "L2_FLUSH_BYTES", 8)
    monkeypatch.setattr(chip_smoke, "GROUPBY_RUNS", 1)
    monkeypatch.setattr(grouped, "device_caps", lambda device: (132, SMEM, 233_472))
    traced = []

    def trace(fn, runs=chip_smoke.TRACED_RUNS):
        counts["grouped_agg"] = 0
        for _ in range(runs):
            fn()
        traced.append(counts["grouped_agg"])
        return {"op_counts": {"grouped_agg_kernel<2>": counts["grouped_agg"]}}
    monkeypatch.setattr(chip_smoke, "trace_query", trace)
    cols = ssb.make_columns(120_000, SEED)
    table = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), cols, str(tmp_path / "main"), "lineorder", 8,
        SegmentGeneratorConfig(raw_cardinality_fraction=1.0))]

    class Args:
        seed, trace = SEED, False
    launches, cases = chip_smoke.run_groupby(Args(), table, cols)
    # six queries per segment (8 passes; lo_custkey's per-segment run reads
    # the first GROUPBY_CUSTKEY_PER_SEGMENT_SEGMENTS, 2) and over the set (1):
    # 1 a pass, 2 for the grouped distinct; then the two server partials
    assert chip_smoke.GROUPBY_CUSTKEY_PER_SEGMENT_SEGMENTS == 2
    assert launches == {"masked_sums": 0, "masked_sums_fused": 0, "bitmap_filter": 0,
                        "grouped_agg": 9 * 4 + (2 + 1) + 18 + 2}
    assert traced == [chip_smoke.TRACED_RUNS * 8]
    assert {k: c["rung"] for k, c in cases.items()} == {
        "region, one segment": "thread", "region, stacked set": "thread",
        "orderdate, stacked set": "block", "suppkey var_pop, stacked set": "cluster",
        "custkey, stacked set": "global", "region distinct, stacked set": "warp",
        "q11 distinct, stacked set": "thread"}
    assert all(c["bound_by"] == "bytes" and c["bound_ms"] > 0 for c in cases.values())
