"""pinot_tpu_torch's filter indexes against the JAX package's, on the CPU.

The same numpy-seeded SSB rows go through both packages:

* the writers' inverted, range and bloom indexes (and the `bloomHex`
  metadata payload) load in the other package's reader, and both readers
  answer alike: postings, range masks, `might_contain`;
* `SegmentBlock.bitmap_words` equals the forward column and the JAX block's;
* `engine.bitmap.bitmap_filter_plain`, the CUDA kernel's plain version,
  equals the JAX word-domain filter (`_make_word_fn`, `_unpack_words`,
  `_pack_valid`) on random trees, with NOT over padding bits, empty leaves and
  up to 64 selected rows; `compute_filter_count` equals the mask's sum;
* `select_bitmap_leaves` picks the JAX planner's leaves;
* all-bitmap and mixed bitmap filters, IS NULL / IS NOT NULL and IN_ID_SET
  over a raw column answer as the JAX `execute_query` does and as numpy
  does, per segment, over the set and through the pipeline (counts exactly,
  sums rel 1e-6);
* bloom-pruned plans are the JAX plans' `empty`, and the inverted-index host
  mask equals the forward gather.
"""

import math

import numpy as np
import pytest
import torch

from pinot_tpu.engine import kernels as jax_kernels
from pinot_tpu.engine.datablock import SegmentBlock as JaxBlock
from pinot_tpu.query.context import compile_query as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.planner import plan_segment as jax_plan
from pinot_tpu.query.planner import select_bitmap_leaves as jax_select_bitmap_leaves
from pinot_tpu.query.predicate import FilterProgram as JaxFilterProgram
from pinot_tpu.query.predicate import LutLeaf as JaxLutLeaf
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
from pinot_tpu.segment.writer import build_aligned_segments as jax_build
from pinot_tpu_torch import ssb
from pinot_tpu_torch.cluster import DeviceQueryPipeline
from pinot_tpu_torch.engine import bitmap
from pinot_tpu_torch.engine.bitmap import BitmapLeaf, bitmap_filter_plain, word_program
from pinot_tpu_torch.engine.datablock import SegmentBlock, block_for
from pinot_tpu_torch.engine.kernels import KernelSpec, compute_filter_count
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.executor import ServerQueryExecutor, execute_query, host_filter_mask
from pinot_tpu_torch.query.planner import BITMAP_SEL_CAP, plan_segment, select_bitmap_leaves
from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.segment.writer import (SegmentBuilder, SegmentGeneratorConfig,
                                            build_aligned_segments)

CPU = "cpu"
SEED = 20261018
ROWS, SEGMENTS = 3 * 7000 + 13, 3
REL = 1e-6
INDEXED = dict(inverted_index_columns=["lo_region", "lo_discount", "lo_quantity"],
               range_index_columns=["lo_orderdate"],
               bloom_filter_columns=["lo_custkey", "lo_region"],
               raw_cardinality_fraction=0.7)

# (id, sql): the filter shapes of this slice
QUERIES = [
    ("all_bitmap", "SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
     "WHERE lo_discount = 2 AND lo_quantity IN (1, 7, 13) GROUP BY lo_region "
     "ORDER BY lo_region"),
    ("bitmap_or_not", "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
     "WHERE lo_quantity IN (3, 4) OR NOT lo_discount = 5"),
    ("mixed", "SELECT lo_region, COUNT(*), SUM(lo_extendedprice) FROM lineorder "
     "WHERE lo_discount = 2 AND lo_revenue > 30000 GROUP BY lo_region ORDER BY lo_region"),
    ("mixed_not", "SELECT COUNT(*), MAX(lo_revenue) FROM lineorder "
     "WHERE NOT (lo_quantity = 9 OR lo_custkey < 250000) AND lo_region = 'ASIA'"),
    ("bitmap_topk", "SELECT lo_custkey, lo_revenue FROM lineorder "
     "WHERE lo_quantity = 7 AND lo_discount = 3 ORDER BY lo_revenue DESC LIMIT 5"),
    ("bitmap_select", "SELECT lo_custkey, lo_discount FROM lineorder "
     "WHERE lo_quantity = 11 AND lo_discount IN (1, 2) LIMIT 7"),
    ("absent_key", "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_custkey = 500123"),
]
IDS = [q[0] for q in QUERIES]


def _jax_schema(schema):
    return JSchema.from_json(schema.to_json())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_indexes")
    cols = ssb.make_columns(ROWS, SEED)
    ours = build_aligned_segments(ssb.ssb_schema(), cols, str(out / "ours"), "lineorder",
                                  SEGMENTS, SegmentGeneratorConfig(**INDEXED))
    theirs = jax_build(_jax_schema(ssb.ssb_schema()), cols, str(out / "jax"), "lineorder",
                       SEGMENTS, config=JaxConfig(**INDEXED))
    return {"cols": cols, "ours": ours, "theirs": theirs,
            "segs": [load_segment(p) for p in ours], "jax": [jax_load(p) for p in ours]}


@pytest.mark.parametrize("side", ["ours", "theirs"])
def test_index_files_load_in_both_readers(env, side):
    """Each writer's segments: equal metadata (the bloom payload too) and
    equal reader answers in both packages."""
    import json
    import os
    for p_ours, p_theirs, p in zip(env["ours"], env["theirs"], env[side]):
        meta = [json.load(open(os.path.join(q, "metadata.json")))["columns"]
                for q in (p_ours, p_theirs)]
        assert meta[0] == meta[1]
        a, b = load_segment(p), jax_load(p)
        for col in INDEXED["inverted_index_columns"]:
            ra, rb = a.column(col), b.column(col)
            assert ra.index_types == rb.index_types == ["inverted"] + (
                ["bloom"] if col in INDEXED["bloom_filter_columns"] else [])
            ids = np.arange(ra.cardinality)
            np.testing.assert_array_equal(ra.inverted_index.doc_ids_for_ids(ids[::2]),
                                          rb.inverted_index.doc_ids_for_ids(ids[::2]))
            for i in ids:
                assert ra.inverted_index.match_count_for_ids([i]) == \
                    rb.inverted_index.match_count_for_ids([i])
                assert ra.inverted_index.match_count_for_range(0, i) == \
                    rb.inverted_index.match_count_for_range(0, i)
        ra, rb = a.column("lo_orderdate"), b.column("lo_orderdate")
        for lo, hi in [(0, 10), (100, 900), (2000, ra.cardinality), (7, 7)]:
            np.testing.assert_array_equal(ra.range_index.mask_range(lo, hi),
                                          rb.range_index.mask_range(lo, hi))
        assert ra.range_index.num_docs == rb.range_index.num_docs
        keys = np.concatenate([np.asarray(a.column("lo_custkey").fwd)[:50],
                               np.arange(500_000, 500_400)])
        assert [a.column("lo_custkey").bloom_filter.might_contain(int(k)) for k in keys] == \
            [b.column("lo_custkey").bloom_filter.might_contain(int(k)) for k in keys]
        assert all(a.column("lo_custkey").bloom_filter.might_contain(int(k)) for k in keys[:50])
        for f in ("lo_custkey.bloom.npy", "lo_region.bloom.npy"):
            assert open(os.path.join(p_ours, "cols", f), "rb").read() == \
                open(os.path.join(p_theirs, "cols", f), "rb").read()


def test_bloom_hex_payload_probes_alike(env):
    from pinot_tpu.segment.indexes.bloom import bloom_hex_might_contain as jax_probe
    from pinot_tpu_torch.segment.indexes.bloom import bloom_hex_might_contain
    meta = load_segment(env["ours"][0]).column("lo_region").meta
    for v in list(ssb.REGIONS) + ["NOWHERE", "ASI", ""]:
        assert bloom_hex_might_contain(meta["bloomHex"], v) == jax_probe(meta["bloomHex"], v)
    assert all(bloom_hex_might_contain(meta["bloomHex"], v) for v in ssb.REGIONS)


@pytest.mark.parametrize("col", ["lo_region", "lo_discount", "lo_quantity", "lo_custkey"])
def test_bitmap_words_equal_the_forward_column(env, col):
    seg, jseg = env["segs"][1], env["jax"][1]
    block = SegmentBlock(seg, torch.device(CPU))
    words = block.bitmap_words(col)
    reader = seg.column(col)
    if not reader.has_dictionary:
        assert words is None and JaxBlock(jseg).bitmap_words(col) is None
        return
    fwd = np.asarray(reader.fwd).astype(np.int64)
    bits = ((words.numpy()[:, :, None] >> np.arange(32)) & 1).reshape(reader.cardinality, -1)
    for c in range(reader.cardinality):
        np.testing.assert_array_equal(bits[c, :seg.num_docs].astype(bool), fwd == c)
        assert not bits[c, seg.num_docs:].any()
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(JaxBlock(jseg).bitmap_words(col)))
    vw = block.valid_words.numpy().view(np.uint32)
    np.testing.assert_array_equal(vw, np.asarray(JaxBlock(jseg).valid_words))


def _random_tree(rng, leaves: int, depth: int = 0):
    if depth >= 3 or leaves == 1 or rng.random() < 0.25:
        node = ("leaf", int(rng.integers(0, leaves)))
    else:
        kind = ("and", "or")[int(rng.integers(0, 2))]
        node = (kind, tuple(_random_tree(rng, leaves, depth + 1)
                            for _ in range(int(rng.integers(2, 4)))))
    return ("not", node) if rng.random() < 0.3 else node


@pytest.mark.parametrize("trial", range(12))
def test_bitmap_filter_plain_equals_the_jax_word_domain(trial):
    """Random trees over leaves of random cards (up to 64 selected rows, empty
    leaves among them), with a NOT setting padding bits: the plain version's
    words, mask and count equal the JAX word function's."""
    rng = np.random.default_rng([SEED, trial])
    n_leaves = int(rng.integers(1, 6))
    padded, num_docs = 2048, int(rng.integers(1000, 2049))
    tree = _random_tree(rng, n_leaves)
    if all(node != ("leaf", i) for i in range(n_leaves) for node in [tree]):
        tree = ("and", (tree, ("not", ("leaf", 0))))
    leaves, jax_bitmaps, jax_leaves = [], [], []
    for i in range(n_leaves):
        card = int(rng.choice([1, 5, 11, 50, 64]))
        words = rng.integers(0, 1 << 32, (card, padded // 32), dtype=np.uint64).astype(np.uint32)
        k = int(rng.integers(0, card + 1)) if i else card   # leaf 0 selects every row
        rows = np.sort(rng.choice(card, k, replace=False))
        lut = np.zeros(card + 1, dtype=bool)
        lut[rows] = True
        leaves.append(BitmapLeaf(torch.from_numpy(words.view(np.int32)), tuple(rows.tolist())))
        if k == 0:
            jax_bitmaps.append(np.zeros((1, padded // 32), dtype=np.uint32))
        else:
            kp = 1 << int(k - 1).bit_length()
            jax_bitmaps.append(words[np.concatenate([rows, np.full(kp - k, rows[0])])])
        jax_leaves.append(JaxLutLeaf(f"c{i}", lut))
    valid = np.zeros(padded, dtype=bool)
    valid[:num_docs] = True
    spec = jax_kernels.KernelSpec(JaxFilterProgram(tree, jax_leaves), (), 1, (), {}, padded,
                                  bitmap_leaves=tuple(range(n_leaves)))
    word_fn = jax_kernels._make_word_fn(spec)
    jax_words = np.asarray(word_fn(tuple(jax_bitmaps))
                           & jax_kernels._pack_valid(jax_kernels.jnp.asarray(valid)))
    jax_mask = np.asarray(jax_kernels._unpack_words(jax_kernels.jnp.asarray(jax_words)))
    program = word_program(tree, {i: i for i in range(n_leaves)})
    valid_words = bitmap.pack_valid(torch.from_numpy(valid))
    np.testing.assert_array_equal(
        np.asarray(jax_kernels._pack_valid(jax_kernels.jnp.asarray(valid))),
        valid_words.numpy().view(np.uint32))
    words = bitmap_filter_plain(program, leaves, valid_words, "words")
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jax_words)
    mask = bitmap.bitmap_filter(program, leaves, valid_words, "mask")
    np.testing.assert_array_equal(mask.numpy(), jax_mask)
    assert not mask[num_docs:].any()
    count = bitmap_filter_plain(program, leaves, valid_words, "count")
    assert int(count) == int(jax_mask.sum())
    # the same leaves stacked as a set of two segments
    stacked = [BitmapLeaf(torch.stack([leaf.words, leaf.words]), leaf.rows) for leaf in leaves]
    set_words = bitmap_filter_plain(program, stacked, torch.cat([valid_words, valid_words]),
                                    "words")
    np.testing.assert_array_equal(set_words.numpy(), np.concatenate([words.numpy()] * 2))


def test_compute_filter_count_equals_the_mask_sum(env):
    seg = env["segs"][0]
    ex = ServerQueryExecutor(CPU)
    for sql in (QUERIES[0][1], QUERIES[1][1], QUERIES[2][1]):
        plan = plan_segment(compile_query(sql, seg.schema), seg)
        plan.bitmap_leaves = select_bitmap_leaves(plan, seg)
        spec = KernelSpec(plan.filter_prog, (), 1, (), bitmap_leaves=plan.bitmap_leaves)
        inputs = ex._kernel_inputs(plan, spec, block_for(seg, torch.device(CPU)))
        mask = host_filter_mask(plan, seg)
        count = compute_filter_count(spec, inputs)
        if spec.word_program() is None:
            assert count is None
        else:
            assert count == int(mask.sum())


@pytest.mark.parametrize("sql", [q[1] for q in QUERIES] + [
    "SELECT COUNT(*) FROM lineorder WHERE lo_discount BETWEEN 1 AND 3",
    "SELECT COUNT(*) FROM lineorder WHERE lo_region IN ('ASIA', 'EUROPE') AND lo_quantity = 2",
    "SELECT COUNT(*) FROM lineorder WHERE lo_suppkey = 17 AND lo_orderdate < 19940101",
], ids=IDS + ["dense", "two_columns", "high_card"])
def test_select_bitmap_leaves_picks_the_jax_leaves(env, sql):
    """The port's rule is the JAX planner's: held at the port's cap (set on
    the H100) and at the JAX package's default (the TPU's)."""
    from pinot_tpu.engine import calibrate
    from pinot_tpu_torch.query import planner
    old = calibrate.get_caps()
    try:
        for cap in (BITMAP_SEL_CAP, old.bitmap_sel_cap):
            calibrate.set_caps(calibrate.KernelCaps(**{**old.__dict__, "bitmap_sel_cap": cap}))
            planner.BITMAP_SEL_CAP = cap
            for seg, jseg in zip(env["segs"], env["jax"]):
                plan = plan_segment(compile_query(sql, seg.schema), seg)
                jplan = jax_plan(jax_compile(sql, jseg.schema), jseg)
                assert plan.kind == jplan.kind
                if plan.kind != "empty":
                    assert select_bitmap_leaves(plan, seg) == \
                        jax_select_bitmap_leaves(jplan, jseg)
    finally:
        calibrate.set_caps(old)
        planner.BITMAP_SEL_CAP = BITMAP_SEL_CAP


def _oracle(cols, qid):
    c = cols
    if qid == "all_bitmap":
        m = (c["lo_discount"] == 2) & np.isin(c["lo_quantity"], [1, 7, 13])
        return [[r, c["lo_revenue"][m & (c["lo_region"] == r)].sum(),
                 int((m & (c["lo_region"] == r)).sum())]
                for r in ssb.REGIONS if (m & (c["lo_region"] == r)).any()]
    if qid == "bitmap_or_not":
        m = np.isin(c["lo_quantity"], [3, 4]) | (c["lo_discount"] != 5)
        return [[int(m.sum()), c["lo_revenue"][m].sum()]]
    if qid == "mixed":
        m = (c["lo_discount"] == 2) & (c["lo_revenue"] > 30000)
        return [[r, int((m & (c["lo_region"] == r)).sum()),
                 c["lo_extendedprice"][m & (c["lo_region"] == r)].sum()]
                for r in ssb.REGIONS if (m & (c["lo_region"] == r)).any()]
    if qid == "mixed_not":
        m = ~((c["lo_quantity"] == 9) | (c["lo_custkey"] < 250000)) & (c["lo_region"] == "ASIA")
        return [[int(m.sum()), c["lo_revenue"][m].max()]]
    if qid == "bitmap_topk":
        m = (c["lo_quantity"] == 7) & (c["lo_discount"] == 3)
        idx = np.nonzero(m)[0]
        idx = idx[np.argsort(-c["lo_revenue"][idx], kind="stable")][:5]
        return [[int(c["lo_custkey"][i]), c["lo_revenue"][i]] for i in idx]
    if qid == "bitmap_select":
        return None   # LIMIT without ORDER BY: any 7 matching rows
    return [[0, None]]


def _rows_match(got, want) -> bool:
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None or not math.isclose(x, y, rel_tol=REL):
                    return False
            elif x != y:
                return False
    return True


@pytest.mark.parametrize("qid, sql", QUERIES, ids=IDS)
def test_bitmap_filters_match_the_reference_and_numpy(env, qid, sql):
    """Per segment, over the set and through the pipeline: the JAX answer and
    numpy's (counts exactly, sums rel 1e-6)."""
    segs, cols = env["segs"], env["cols"]
    want = _oracle(cols, qid)
    jax_rows = JaxExecutor().execute(env["jax"], sql).rows
    ctx = compile_query(sql, segs[0].schema)
    pipeline = DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(device=CPU))
    try:
        partial = pipeline.execute_partial(ctx, segs)
    finally:
        pipeline.stop()
    from pinot_tpu_torch.query.aggregates import make_agg
    aggs = [make_agg(f) for f in ctx.aggregations]
    group_exprs = list(ctx.group_by)
    served = reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                              group_exprs).rows
    for got in (execute_query(segs, sql, device=CPU).rows,
                MeshQueryExecutor(device=CPU).execute(segs, sql).rows, served):
        if want is None:
            m = (cols["lo_quantity"] == 11) & np.isin(cols["lo_discount"], [1, 2])
            pairs = set(zip(cols["lo_custkey"][m].tolist(), cols["lo_discount"][m].tolist()))
            assert len(got) == 7 and all(tuple(r) in pairs for r in got)
            continue
        assert _rows_match(got, want), (got, want)
        assert _rows_match(got, jax_rows), (got, jax_rows)


def test_bitmap_leaves_launch_on_the_served_paths(env, monkeypatch):
    """The plain body's selective dictionary leaves go through
    `bitmap.bitmap_filter`: the whole tree in "mask" mode when every leaf is a
    bitmap leaf (one call per segment, one for the set), and a one-leaf
    "mask" call per bitmap leaf in a mixed tree; the scan's band plans never
    call it."""
    calls = []
    real = bitmap.bitmap_filter

    def counted(program, leaves, valid_words, mode):
        calls.append((mode, len(leaves), int(leaves[0].words.dim())))
        return real(program, leaves, valid_words, mode)
    from pinot_tpu_torch.engine import kernels
    monkeypatch.setattr(kernels, "bitmap_filter", counted)
    segs = env["segs"]
    execute_query(segs, QUERIES[0][1], device=CPU)
    assert calls == [("mask", 2, 2)] * SEGMENTS
    calls.clear()
    MeshQueryExecutor(device=CPU).execute(segs, QUERIES[0][1])
    assert calls == [("mask", 2, 3)]
    calls.clear()
    execute_query(segs, QUERIES[2][1], device=CPU)
    assert calls == [("mask", 1, 2)] * SEGMENTS
    calls.clear()
    execute_query(segs, "SELECT COUNT(*) FROM lineorder WHERE lo_discount = 2", device=CPU)
    assert calls == []


@pytest.fixture(scope="module")
def nulls_env(tmp_path_factory):
    """lineorder with 1% of lo_revenue and 2% of lo_region null, at seeded rows."""
    out = tmp_path_factory.mktemp("torch_nulls")
    cols = ssb.make_columns(2 * 5000 + 3, SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    rev_null = rng.random(len(cols["lo_revenue"])) < 0.01
    reg_null = rng.random(len(cols["lo_region"])) < 0.02
    cols["lo_revenue"] = np.array([None if n else v for v, n in
                                   zip(cols["lo_revenue"].tolist(), rev_null)], dtype=object)
    cols["lo_region"] = np.array([None if n else v for v, n in
                                  zip(cols["lo_region"], reg_null)], dtype=object)
    # built apart (a dictionary over None and strings cannot be merged), so the
    # set executor plans the pair on its merged view
    half = len(rev_null) // 2
    paths = [SegmentBuilder(ssb.ssb_schema()).build({k: v[lo:hi] for k, v in cols.items()},
                                                    str(out), f"lineorder_{i}")
             for i, (lo, hi) in enumerate([(0, half), (half, len(rev_null))])]
    return {"cols": cols, "rev_null": rev_null, "reg_null": reg_null,
            "segs": [load_segment(p) for p in paths], "jax": [jax_load(p) for p in paths]}


@pytest.mark.parametrize("sql", [
    "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder WHERE lo_revenue IS NULL",
    "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder WHERE lo_revenue IS NOT NULL "
    "AND lo_discount < 4",
    "SELECT lo_discount, COUNT(*) FROM lineorder WHERE lo_region IS NULL OR lo_quantity = 3 "
    "GROUP BY lo_discount ORDER BY lo_discount",
    "SELECT lo_custkey, lo_quantity FROM lineorder WHERE lo_revenue IS NULL "
    "AND lo_discount = 4 ORDER BY lo_quantity, lo_custkey LIMIT 20",
], ids=["is_null", "is_not_null", "region_null_or", "null_selection"])
def test_null_leaves_match_the_reference_and_numpy(nulls_env, sql):
    e = nulls_env
    c, rev_null, reg_null = e["cols"], e["rev_null"], e["reg_null"]
    want = JaxExecutor().execute(e["jax"], sql).rows
    if "lo_revenue IS NULL" in sql and "SUM" in sql:
        assert want == [[int(rev_null.sum()), float(c["lo_quantity"][rev_null].sum())]]
    if "IS NOT NULL" in sql:
        m = ~rev_null & (c["lo_discount"] < 4)
        assert want == [[int(m.sum()), float(c["lo_quantity"][m].sum())]]
    plan = plan_segment(compile_query(sql, e["segs"][0].schema), e["segs"][0])
    assert plan.kind in ("device", "selection") and not plan.fallback_reason
    for got in (execute_query(e["segs"], sql, device=CPU).rows,
                MeshQueryExecutor(device=CPU).execute(e["segs"], sql).rows):
        assert got == want


@pytest.mark.parametrize("key_kind", ["absent", "present"])
def test_bloom_pruned_plans_are_the_jax_plans_empty(env, key_kind):
    """EQ and IN on the raw lo_custkey: a plan is `empty` exactly where the
    JAX plan is (min/max cannot decide these keys, the bloom filter does)."""
    cols = env["cols"]
    rng = np.random.default_rng(SEED + 1)
    present = set(cols["lo_custkey"].tolist())
    if key_kind == "absent":
        keys = [k for k in rng.integers(1000, 499_000, 200).tolist() if k not in present][:60]
    else:
        keys = rng.choice(cols["lo_custkey"], 20).tolist()
    empties = 0
    for k in keys:
        for sql in (f"SELECT COUNT(*) FROM lineorder WHERE lo_custkey = {k}",
                    f"SELECT SUM(lo_revenue) FROM lineorder WHERE lo_custkey IN ({k}, {k + 1})"):
            kinds = [plan_segment(compile_query(sql, s.schema), s).kind for s in env["segs"]]
            jkinds = [jax_plan(jax_compile(sql, s.schema), s).kind for s in env["jax"]]
            assert kinds == jkinds
            empties += kinds.count("empty")
    if key_kind == "absent":
        assert empties > 0.9 * 2 * len(keys) * SEGMENTS
    else:
        sql = f"SELECT COUNT(*) FROM lineorder WHERE lo_custkey = {keys[0]}"
        assert execute_query(env["segs"], sql, device=CPU).rows == [
            [int((cols["lo_custkey"] == keys[0]).sum())]]


@pytest.mark.parametrize("where", [
    "lo_quantity = 7", "lo_quantity IN (1, 2, 3)", "lo_discount IN (1, 2)",
    "lo_region = 'ASIA' AND lo_quantity < 3", "NOT lo_quantity = 7",
])
def test_inverted_index_host_mask_equals_the_forward_gather(env, where):
    """The postings path (leaves matching at most 1/8 of the docs) and the
    gather give one mask; a segment without inverted indexes gathers."""
    sql = f"SELECT lo_custkey FROM lineorder WHERE {where}"
    for seg in env["segs"]:
        plan = plan_segment(compile_query(sql, seg.schema), seg)
        got = host_filter_mask(plan, seg)
        want = np.ones(seg.num_docs, dtype=bool)
        for leaf in plan.filter_prog.leaves:
            assert seg.column(leaf.col).inverted_index is not None
        c = {k: np.asarray(seg.column(k).values()) for k in
             ("lo_quantity", "lo_discount", "lo_region")}
        want = {"lo_quantity = 7": c["lo_quantity"] == 7,
                "lo_quantity IN (1, 2, 3)": np.isin(c["lo_quantity"], [1, 2, 3]),
                "lo_discount IN (1, 2)": np.isin(c["lo_discount"], [1, 2]),
                "lo_region = 'ASIA' AND lo_quantity < 3":
                    (c["lo_region"] == "ASIA") & (c["lo_quantity"] < 3),
                "NOT lo_quantity = 7": c["lo_quantity"] != 7}[where]
        np.testing.assert_array_equal(got, want)


def test_the_smoke_index_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `index` phase at 60,000 rows with the card's calls
    pointed at the CPU: every answer, plan and launch check of the phase
    passes (`bitmap_filter` calls counted as launches), the bitmap cases agree
    with the plain version, and the crossover regimes agree with each other."""
    import chip_smoke
    from pinot_tpu_torch.engine import kernels, scan
    from pinot_tpu_torch.parallel import combine
    from pinot_tpu_torch.query import executor

    cpu = torch.device(CPU)
    for module in (executor, combine):
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
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, flush: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, flush: (fn(), 1.0)[1])
    for name, value in (("L2_FLUSH_BYTES", 8), ("INDEX_RUNS", 1), ("INDEX_CROSSOVER_RUNS", 1),
                        ("INDEX_NULL_ROWS", 20_000)):
        monkeypatch.setattr(chip_smoke, name, value)
    cols = ssb.make_columns(60_000, SEED)
    plain = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), cols, str(tmp_path / "main"), "lineorder", 8)]

    class Args:
        seed, trace = SEED, False
    launches, by_route, cases = chip_smoke.run_index(Args(), plain, cols, str(tmp_path))
    assert launches["masked_sums"] == launches["masked_sums_fused"] == 0
    # the all-bitmap and the mixed query: 8 per segment, 1 over the set, 1 served
    assert by_route["per_segment"]["bitmap_filter"] == 16
    assert by_route["set"]["bitmap_filter"] == by_route["pipeline"]["bitmap_filter"] == 2
    assert {k.split(", ")[1] for k in cases} == {"one segment", "stacked set"}
    assert all(c["equal"] and c["bound_by"] == "bytes" for c in cases.values())
