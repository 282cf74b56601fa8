"""Differential test: pinot_tpu_torch's multistage join path against pinot_tpu's.

The same numpy inputs (and the same segment directories, written once by the
port's writer and loaded by both packages) go through both packages on the
CPU: the JAX package's join programs run under `JAX_PLATFORMS=cpu`, the
port's torch programs on `device="cpu"`. Held equal:

* the stable exchange hashes (`stable_hash_codes`) and `fold_codes32`, bit
  for bit, over ints, floats with -0.0 and NaN, ASCII and non-ASCII strings,
  None and multi-column keys;
* the device programs' host functions: `sort_merge_probe` (lo, cnt, order with the
  reference's pow2 pads dropped, skew) and `scatter_probe` (cand, None on
  duplicate keys), with real codes of 0xFFFFFFFF beside the pads;
* `hash_join` for the six join types x int / string / null / dtype-promoted
  keys, as exact rows in order, against the reference's `hash_join` and the
  host oracle, with the device route forced (`min_rows=0`);
* the partitioned exchange at widths 1 and 8, broadcast against partitioned,
  and the capacity-pinned admission (`joinServedHostTier`);
* `plan_multistage` shapes and errors, `execute_multistage` on the
  reference's join fixture against the reference and sqlite, IN / NOT IN
  lowering against sqlite;
* the slice as a whole: the chip smoke's four queries over a 60,000-row,
  3-segment lineorder and scaled-down dimension tables, both exchanges,
  against the reference and the smoke's numpy oracle.

Rows equal (order included); sums at rel 1e-9: both packages sum joined rows
on the host in float64.
"""

import math
import sqlite3

import numpy as np
import pytest

import chip_smoke
from pinot_tpu.engine import join_kernels as jax_jk
from pinot_tpu.engine.expr import eval_expr
from pinot_tpu.multistage import execute_multistage as jax_execute
from pinot_tpu.multistage import make_segment_scan as jax_scan
from pinot_tpu.multistage import runtime as jax_rt
from pinot_tpu.multistage.planner import JoinSpec as JaxJoinSpec
from pinot_tpu.query import stats as jax_stats
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.sql.parser import parse_query as jax_parse
from pinot_tpu_torch import ssb
from pinot_tpu_torch.engine import join_kernels as jk
from pinot_tpu_torch.engine.expr import eval_host
from pinot_tpu_torch.multistage import (configure_device_join, execute_multistage,
                                        hash_join, make_segment_scan, plan_multistage)
from pinot_tpu_torch.multistage import planner, runtime as rt
from pinot_tpu_torch.multistage.planner import JoinSpec
from pinot_tpu_torch.query import stats as qstats
from pinot_tpu_torch.query.context import QueryValidationError, compile_query
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment, segments_from_columns
from pinot_tpu_torch.sql.parser import parse_query

JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")
REL = 1e-9
CPU = "cpu"


@pytest.fixture(autouse=True)
def _force_device_join():
    """The device route in both packages for every join of the test (the
    rows floor would send these small joins to the host oracle)."""
    saved, jax_saved = dict(rt._DEVICE_JOIN), dict(jax_rt._DEVICE_JOIN)
    configure_device_join(min_rows=0)
    jax_rt.configure_device_join(enabled=True, min_rows=0)
    yield
    configure_device_join(**saved)
    jax_rt.configure_device_join(**jax_saved)


# -- helpers ---------------------------------------------------------------------------

def _cell_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        fa, fb = float(a), float(b)
        if math.isnan(fa) or math.isnan(fb):
            return math.isnan(fa) and math.isnan(fb)
        return math.isclose(fa, fb, rel_tol=REL, abs_tol=0.0)
    return a == b


def _assert_blocks_equal(got, want):
    """Same columns, dtypes, and cells in the same order (NaN equals NaN)."""
    assert list(got) == list(want)
    for c in want:
        g, w = got[c], want[c]
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        assert len(g) == len(w), (c, len(g), len(w))
        assert all(_cell_equal(x, y) for x, y in zip(g.tolist(), w.tolist())), c


def _assert_rows_equal(got, want):
    assert len(got) == len(want), (got[:5], want[:5])
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw) and all(_cell_equal(x, y) for x, y in zip(rg, rw)), \
            (rg, rw)


def _spec(how, cls=JoinSpec):
    return cls(right_alias="r", join_type=how, left_keys=["lk"], right_keys=["rk"])


def _int_blocks(rng, n=1500, m=400, card=120):
    left = {"lk": rng.integers(0, card, n).astype(np.int64),
            "v": np.round(rng.uniform(0, 100, n), 3)}
    right = {"rk": rng.integers(0, card, m).astype(np.int64),  # dup build keys
             "w": np.round(rng.uniform(0, 100, m), 3)}
    return left, right


def _string_blocks(rng):
    univ = np.array([f"k{i}" for i in range(90)], dtype=object)
    left = {"lk": univ[rng.integers(0, 90, 1200)],
            "v": rng.integers(0, 50, 1200).astype(np.int32)}
    right = {"rk": univ[rng.integers(0, 90, 300)],
             "w": np.round(rng.uniform(0, 10, 300), 3)}
    return left, right


def _null_blocks(rng):
    lk = rng.integers(0, 60, 900).astype(np.float64)
    lk[rng.random(900) < 0.15] = np.nan
    rk = rng.integers(0, 60, 250).astype(np.float64)
    rk[rng.random(250) < 0.15] = np.nan
    return ({"lk": lk, "v": rng.integers(0, 9, 900).astype(np.int64)},
            {"rk": rk, "w": rng.integers(0, 9, 250).astype(np.int64)})


def _promoted_blocks(rng):
    """int32 probe keys joining float64 build keys: int 3 meets double 3.0.
    The build keys are unique, so the join takes the scatter regime."""
    return ({"lk": rng.integers(0, 80, 1000).astype(np.int32),
             "v": np.round(rng.uniform(0, 5, 1000), 3)},
            {"rk": rng.permutation(100).astype(np.float64)[:70],
             "w": np.round(rng.uniform(0, 5, 70), 3)})


KEY_KINDS = {"int": (_int_blocks, 17), "string": (_string_blocks, 23),
             "null": (_null_blocks, 31), "promoted": (_promoted_blocks, 41)}


# -- hashes ----------------------------------------------------------------------------

def _hash_inputs():
    rng = np.random.default_rng(3)
    mixed_str = np.array(["", "a", "AMERICA", None, "ünïcödé", "日本", "x\x00y", "a" * 70,
                          None, "MIDDLE EAST"], dtype=object)
    return {
        "int": {"k": rng.integers(-(1 << 40), 1 << 40, 500)},
        "int32": {"k": rng.integers(-1000, 1000, 500).astype(np.int32)},
        "float": {"k": np.array([0.0, -0.0, np.nan, 1.5, -2.25, 1e300, np.inf, 3.0])},
        "ascii": {"k": np.array([f"s{i}" for i in range(300)], dtype=object)},
        "non_ascii_and_none": {"k": mixed_str},
        "all_none": {"k": np.array([None, None], dtype=object)},
        "mixed_objects": {"k": np.array([1, "a", None, 2.5, b"by"], dtype=object)},
        "multi": {"a": rng.integers(0, 9, 400), "k": rng.uniform(0, 3, 400).round(1),
                  "s": np.array(["p", "q", None, "ü"] * 100, dtype=object)},
    }


@pytest.mark.parametrize("name", list(_hash_inputs()))
def test_stable_hash_codes_and_fold_are_bit_equal(name):
    block = _hash_inputs()[name]
    keys = list(block)
    got = rt.stable_hash_codes(block, keys)
    want = jax_rt.stable_hash_codes(block, keys)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jk.fold_codes32(got), jax_jk.fold_codes32(want))
    # -0.0 and 0.0 (and int 3 and 3.0) hash alike
    if name == "float":
        assert got[0] == got[1]


# -- the device programs' host functions ----------------------------------------------

def test_device_codes_keep_uint32_order_with_pads_last():
    """The int32 form of the codes orders as uint32 does, so a real code of
    0xFFFFFFFF sorts last; the reference's pads (also 0xFFFFFFFF) sort after
    it, since the sort is stable and they come after every real row."""
    codes = np.array([0xFFFFFFFF, 0, 0x80000000, 0x7FFFFFFF, 5, 0xFFFFFFFF, 1],
                     dtype=np.uint32)
    dev = jk.device_codes(codes, "cpu").numpy()
    np.testing.assert_array_equal(np.argsort(dev, kind="stable"),
                                  np.argsort(codes, kind="stable"))
    _, order = jk.sort_build_program(jk.device_codes(codes, "cpu"))
    padded = np.full(8, 0xFFFFFFFF, np.uint32)
    padded[:7] = codes
    ref_order = np.argsort(padded, kind="stable")
    np.testing.assert_array_equal(order.numpy(), ref_order[ref_order < 7])
    assert ref_order[-1] == 7   # the pad sorts after both real 0xFFFFFFFF codes


@pytest.mark.parametrize("m,n", [(1000, 3000), (37, 700), (1024, 1)])
def test_sort_merge_probe_matches_the_reference(m, n):
    rng = np.random.default_rng(m + n)
    build = rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
    build[::7] = build[0]                      # duplicate codes
    build[1::11] = 0xFFFFFFFF                  # real codes equal to the pad
    probe = np.concatenate([build[rng.integers(0, m, n // 2)],
                            rng.integers(0, 1 << 32, n - n // 2, dtype=np.uint64)
                            .astype(np.uint32)])
    probe[::5] = 0xFFFFFFFF
    with qstats.collect_stats() as st:
        lo, cnt, order, skew = jk.sort_merge_probe(build, probe, device=CPU)
    assert {qstats.JOIN_BUILD_MS, qstats.JOIN_PROBE_MS} <= set(st.counters)
    rlo, rcnt, rorder, rskew = jax_jk.sort_merge_probe(build, probe)
    np.testing.assert_array_equal(order, rorder[rorder < m])       # pads dropped
    np.testing.assert_array_equal(lo, rlo)
    # the reference's count of a 0xFFFFFFFF probe takes in its pads, which sort
    # after the real rows; its caller drops them
    real = np.array([int(np.sum(rorder[a:a + c] < m)) for a, c in zip(rlo, rcnt)])
    np.testing.assert_array_equal(cnt, real)
    if m == _pow2(m):
        np.testing.assert_array_equal(cnt, rcnt)
    assert skew == rskew
    # the candidates are the build rows with the probe's code
    for i in range(0, n, max(1, n // 50)):
        assert set(order[lo[i]:lo[i] + cnt[i]]) == set(np.flatnonzero(build == probe[i]))


def _pow2(n):
    return 1 << (max(1, n) - 1).bit_length()


def test_scatter_probe_matches_the_reference_and_declines_duplicates():
    rng = np.random.default_rng(9)
    size = 5000
    build = rng.permutation(size)[:3000].astype(np.int32)
    build[:40] = size                         # null rows: out of range, dropped
    probe = rng.integers(-3, size + 50, 20000).astype(np.int32)
    got = jk.scatter_probe(build, probe, size, device=CPU)
    want = jax_jk.scatter_probe(build, probe, size)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    build[41] = build[42]                     # a duplicate key
    assert jk.scatter_probe(build, probe, size, device=CPU) is None
    assert jax_jk.scatter_probe(build, probe, size) is None


# -- hash_join ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KEY_KINDS))
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_hash_join_matches_the_reference(how, kind):
    make, seed = KEY_KINDS[kind]
    left, right = make(np.random.default_rng(seed))
    jk.reset_launch_counts()
    with qstats.collect_stats() as st:
        got = hash_join(left, right, _spec(how), device=CPU)
    want = jax_rt.hash_join(left, right, _spec(how, JaxJoinSpec))
    _assert_blocks_equal(got, want)
    _assert_blocks_equal(rt.hash_join_host(left, right, _spec(how)),
                         jax_rt.hash_join_host(left, right, _spec(how, JaxJoinSpec)))
    assert {qstats.JOIN_BUILD_MS, qstats.JOIN_PROBE_MS} <= set(st.counters)
    launches = jk.launch_counts()
    regime = "scatter" if kind == "promoted" else "sort"
    assert launches[f"{regime}_build"] == 1, launches
    # and the host oracle's rows, as a multiset
    host = rt.hash_join_host(left, right, _spec(how))
    assert sorted(map(repr, zip(*[got[c].tolist() for c in got]))) == \
        sorted(map(repr, zip(*[host[c].tolist() for c in host])))


def _tuple_cells(rng, n):
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = ("a", int(rng.integers(0, 30)))
    return out


@pytest.mark.parametrize("kind", ("mv_tuples", "mixed_objects"))
def test_mv_and_mixed_object_keys_take_the_host_oracle(kind):
    """Key cells the device codes cannot carry (tuple cells, mixed types) go
    to the host join, as in the reference: the same rows, no program run."""
    if kind == "mv_tuples":
        rng = np.random.default_rng(47)
        lk, rk = _tuple_cells(rng, 600), _tuple_cells(rng, 90)
    else:
        lk = np.array([("s%d" % i) if i % 2 else i for i in range(400)], dtype=object)
        rk = lk[:100].copy()
    left = {"lk": lk, "v": np.arange(len(lk), dtype=np.int64)}
    right = {"rk": rk, "w": np.arange(len(rk), dtype=np.int64)}
    jk.reset_launch_counts()
    got = hash_join(left, right, _spec("inner"), device=CPU)
    assert not any(jk.launch_counts().values())
    _assert_blocks_equal(got, jax_rt.hash_join(left, right, _spec("inner", JaxJoinSpec)))


def test_zipf_probe_records_join_skew_pct():
    rng = np.random.default_rng(53)
    card = 64
    p = np.arange(1, card + 1, dtype=np.float64) ** -1.6
    p /= p.sum()
    left = {"lk": rng.choice(card, 6000, p=p).astype(np.int64),
            "v": rng.integers(0, 9, 6000).astype(np.int64)}
    right = {"rk": np.arange(card, dtype=np.int64),
             "w": rng.integers(0, 9, card).astype(np.int64)}
    with qstats.collect_stats() as st:
        got = hash_join(left, right, _spec("inner"), device=CPU)
    with jax_stats.collect_stats() as jst:
        want = jax_rt.hash_join(left, right, _spec("inner", JaxJoinSpec))
    assert st.counters[qstats.JOIN_SKEW_PCT] > 0.0
    assert st.counters[qstats.JOIN_SKEW_PCT] == jst.counters[jax_stats.JOIN_SKEW_PCT]
    _assert_blocks_equal(got, want)


@pytest.mark.parametrize("p", (1, 8))
def test_partitioned_exchange_widths(p):
    """Both sides hash-partitioned across `p` partitions, each co-partition
    joined with its staged codes: the union equals the whole-block host join.
    The integer keys spread: no bucket reads hot, no build row is replicated,
    and no partition holds more than twice its share of either side."""
    rng = np.random.default_rng(59 + p)
    left, right = _int_blocks(rng, n=2200, m=500, card=150)
    lc, rc = rt.stable_hash_codes(left, ["lk"]), rt.stable_hash_codes(right, ["rk"])
    lparts, rparts, skew = rt._partition_join_sides(left, lc, right, rc, p, "inner")
    assert skew < rt.JOIN_SKEW_HOT_BUCKET_PCT
    assert sum(len(lp.codes) for lp in lparts) == len(lc)
    assert sum(len(rp.codes) for rp in rparts) == len(rc)
    assert max(len(lp.codes) for lp in lparts) <= 2 * len(lc) / p
    assert max(len(rp.codes) for rp in rparts) <= 2 * len(rc) / p
    got = []
    for lp, rp in zip(lparts, rparts):
        j = hash_join(lp.block, rp.block, _spec("inner"), lcodes=lp.codes,
                      rcodes=rp.codes, device=CPU)
        got += list(zip(*[j[c].tolist() for c in j]))
    host = rt.hash_join_host(left, right, _spec("inner"))
    assert sorted(got) == sorted(zip(*[host[c].tolist() for c in host]))


def test_broadcast_exchange_equals_partitioned():
    rng = np.random.default_rng(67)
    left, right = _int_blocks(rng, n=1800, m=120, card=80)
    lc, rc = rt.stable_hash_codes(left, ["lk"]), rt.stable_hash_codes(right, ["rk"])
    results = []
    for lparts, rparts in (rt._broadcast_join_sides(left, lc, right, rc, 4),
                           rt._partition_join_sides(left, lc, right, rc, 4, "inner")[:2]):
        rows = []
        for lp, rp in zip(lparts, rparts):
            j = hash_join(lp.block, rp.block, _spec("inner"), lcodes=lp.codes,
                          rcodes=rp.codes, device=CPU)
            rows += list(zip(*[j[c].tolist() for c in j]))
        results.append(sorted(rows))
    assert results[0] == results[1]
    host = rt.hash_join_host(left, right, _spec("inner"))
    assert results[0] == sorted(zip(*[host[c].tolist() for c in host]))


def test_capacity_pinned_admission_serves_from_the_host(monkeypatch):
    """A device budget of 900 bytes (the reference's capacity pinned at 1000,
    less its 10% headroom) prices the join off the device in both packages:
    `joinServedHostTier`, no program launched, the host oracle's rows."""
    from pinot_tpu.utils.memledger import reset_ledger
    monkeypatch.setattr(rt, "_join_budget_bytes", lambda device: 900)
    monkeypatch.setenv("PINOT_TPU_HBM_CAPACITY_BYTES", "1000")
    reset_ledger()
    try:
        left, right = _int_blocks(np.random.default_rng(71), n=3000, m=600, card=40)
        jk.reset_launch_counts()
        with qstats.collect_stats() as st:
            got = hash_join(left, right, _spec("inner"), device=CPU)
        with jax_stats.collect_stats() as jst:
            want = jax_rt.hash_join(left, right, _spec("inner", JaxJoinSpec))
        assert st.counters.get(qstats.JOIN_SERVED_HOST_TIER) == 1
        assert jst.counters.get(jax_stats.JOIN_SERVED_HOST_TIER) == 1
        assert not any(jk.launch_counts().values())
        _assert_blocks_equal(got, want)
        _assert_blocks_equal(got, rt.hash_join_host(left, right, _spec("inner")))
    finally:
        monkeypatch.delenv("PINOT_TPU_HBM_CAPACITY_BYTES")
        reset_ledger()


def test_an_error_in_a_device_program_propagates(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("device program failed")
    monkeypatch.setattr(jk, "sort_build_program", broken)
    left, right = _string_blocks(np.random.default_rng(5))
    with pytest.raises(RuntimeError, match="device program failed"):
        hash_join(left, right, _spec("inner"), device=CPU)


# -- expressions on joined blocks ---------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "a.x + b.y * 2 - a.x / 4", "a.x > b.y AND NOT (b.y = 3)", "a.x <= 2 OR b.s = 'q'",
    "b.s IN ('p', 'q')", "a.x NOT IN (1, 2)", "a.x BETWEEN 1 AND 3", "a.x % 3 = 1",
    "b.s <> 'p'", "CASE WHEN a.x > 2 THEN b.y ELSE 0 END"])
def test_host_expressions_match_the_reference(expr):
    """`eval_host` over a joined block with nulls as NaN and None, against the
    reference's `eval_expr`, as `_null_safe_mask`, residual ON terms,
    post-filters and aggregate arguments use it. CASE is held against
    np.where instead: the reference's CASE fold reads each WHEN one argument
    to the left of its place (tests/test_torch_expr.py)."""
    block = {"a.x": np.array([1.0, np.nan, 3.0, 2.0, 4.0]),
             "b.y": np.array([3.0, 1.0, np.nan, 2.0, 5.0]),
             "b.s": np.array(["p", None, "q", "r", "p"], dtype=object)}
    e = parse_query(f"SELECT {expr} FROM t").select[0][0]
    je = jax_parse(f"SELECT {expr} FROM t").select[0][0]
    want = (np.where(block["a.x"] > 2, block["b.y"], 0) if expr.startswith("CASE")
            else np.asarray(eval_expr(je, block, np)))
    np.testing.assert_array_equal(np.asarray(eval_host(e, block)), want)
    if np.asarray(eval_host(e, block)).dtype == bool:
        np.testing.assert_array_equal(rt._null_safe_mask(e, block),
                                      jax_rt._null_safe_mask(je, block))


# -- planner and execute_multistage on the reference's fixture -------------------------

@pytest.fixture(scope="module")
def jenv(tmp_path_factory):
    """orders (2 segments) + customers + regions, mirrored into sqlite: the
    fixture of tests/test_multistage.py, written by the port's writer and
    loaded by both packages."""
    rng = np.random.default_rng(5)
    out = str(tmp_path_factory.mktemp("torch_join"))
    n_cust = 40
    customers = {
        "cust_id": np.arange(1, n_cust + 1, dtype=np.int64),
        "cust_name": [f"cust{i}" for i in range(1, n_cust + 1)],
        "region_id": rng.integers(0, 6, n_cust).astype(np.int32),
    }
    regions = {"region_id": np.arange(0, 5, dtype=np.int32),
               "region_name": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MEA"]}
    n_ord = 800
    orders_all = {"cust_id": rng.integers(1, 46, n_ord).astype(np.int64),
                  "amount": np.round(rng.uniform(1, 1000, n_ord), 2),
                  "qty": rng.integers(1, 20, n_ord).astype(np.int32)}
    schemas = {
        "customers": Schema("customers", [dimension("cust_id", DataType.LONG),
                                          dimension("cust_name", DataType.STRING),
                                          dimension("region_id", DataType.INT)]),
        "regions": Schema("regions", [dimension("region_id", DataType.INT),
                                      dimension("region_name", DataType.STRING)]),
        "orders": Schema("orders", [dimension("cust_id", DataType.LONG),
                                    metric("amount", DataType.DOUBLE),
                                    metric("qty", DataType.INT)]),
    }
    half = n_ord // 2
    parts = {"customers": [("cust_0", customers)], "regions": [("reg_0", regions)],
             "orders": [("ord_0", {k: v[:half] for k, v in orders_all.items()}),
                        ("ord_1", {k: v[half:] for k, v in orders_all.items()})]}
    paths = {t: [SegmentBuilder(schemas[t]).build(cols, out, name) for name, cols in ps]
             for t, ps in parts.items()}
    tables = {t: [load_segment(p) for p in ps] for t, ps in paths.items()}
    jax_tables = {t: [jax_load(p) for p in ps] for t, ps in paths.items()}

    db = sqlite3.connect(":memory:")
    db.execute("CREATE TABLE customers (cust_id, cust_name, region_id)")
    db.executemany("INSERT INTO customers VALUES (?,?,?)",
                   list(zip(customers["cust_id"].tolist(), customers["cust_name"],
                            customers["region_id"].tolist())))
    db.execute("CREATE TABLE regions (region_id, region_name)")
    db.executemany("INSERT INTO regions VALUES (?,?)",
                   list(zip(regions["region_id"].tolist(), regions["region_name"])))
    db.execute("CREATE TABLE orders (cust_id, amount, qty)")
    db.executemany("INSERT INTO orders VALUES (?,?,?)",
                   list(zip(orders_all["cust_id"].tolist(), orders_all["amount"].tolist(),
                            orders_all["qty"].tolist())))
    return tables, jax_tables, schemas, db


def _jax_schema_for(schemas):
    from pinot_tpu.schema import Schema as JSchema
    converted = {t: JSchema.from_json(s.to_json()) for t, s in schemas.items()}
    return converted.get


def _norm(v):
    return round(v, 2) if isinstance(v, float) else v


def _sorted_rows(rows):
    return sorted((tuple(r) for r in rows), key=lambda r: repr(tuple(map(_norm, r))))


def _run_both(jenv, sql, sqlite_sql=None, ordered=True):
    """The port against the reference (rows in order, sums at rel 1e-9; as a
    multiset where not `ordered`) and against sqlite (as a multiset, floats at
    rel 1e-6)."""
    tables, jax_tables, schemas, db = jenv
    ours = execute_multistage(sql, make_segment_scan(tables, device=CPU), schemas.get)
    ref = jax_execute(sql, jax_scan(jax_tables), _jax_schema_for(schemas))
    if ordered:
        _assert_rows_equal(ours.rows, ref.rows)
    else:
        _assert_rows_equal(_sorted_rows(ours.rows), _sorted_rows(ref.rows))
    assert ours.stats["joinStrategy"] == ref.stats["joinStrategy"]
    oracle = db.execute(sqlite_sql or sql).fetchall()
    got, want = _sorted_rows(ours.rows), _sorted_rows(oracle)
    assert len(got) == len(want), (got[:5], want[:5])
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(gv, float) or isinstance(wv, float):
                assert gv == pytest.approx(wv, rel=1e-6, abs=1e-6), (g, w)
            else:
                assert gv == wv, (g, w)
    return ours


INNER_QUERIES = [
    "SELECT o.cust_id, c.cust_name, o.amount FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id LIMIT 100000",
    "SELECT c.cust_name, COUNT(*), SUM(o.amount) FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id GROUP BY c.cust_name LIMIT 100000",
    "SELECT r.region_name, SUM(o.amount) FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id "
    "JOIN regions r ON c.region_id = r.region_id GROUP BY r.region_name LIMIT 100000",
    "SELECT c.cust_name, SUM(o.amount) FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id "
    "WHERE o.qty > 5 AND c.region_id <= 3 GROUP BY c.cust_name LIMIT 100000",
    "SELECT cust_name, SUM(amount) FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id GROUP BY cust_name LIMIT 100000",
    "SELECT COUNT(*) FROM orders o JOIN customers c "
    "ON o.cust_id = c.cust_id AND o.qty > c.region_id",
    "SELECT c.cust_name, SUM(o.amount) AS total FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id GROUP BY c.cust_name "
    "HAVING SUM(o.amount) > 2000 ORDER BY total DESC LIMIT 5",
    "SELECT o.cust_id + c.region_id, AVG(o.amount) FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id "
    "GROUP BY o.cust_id + c.region_id LIMIT 100000",
    "SELECT DISTINCT c.region_id FROM orders o "
    "JOIN customers c ON o.cust_id = c.cust_id LIMIT 100000",
    "SELECT o.cust_id, c.cust_name FROM orders o "
    "LEFT JOIN customers c ON o.cust_id = c.cust_id LIMIT 100000",
    "SELECT o.cust_id, COUNT(c.cust_name) FROM orders o "
    "LEFT JOIN customers c ON o.cust_id = c.cust_id GROUP BY o.cust_id LIMIT 100000",
    "SELECT o.cust_id, c.cust_name FROM orders o "
    "LEFT JOIN customers c ON o.cust_id = c.cust_id WHERE c.region_id <= 2 LIMIT 100000",
]


@pytest.mark.parametrize("sql", INNER_QUERIES)
def test_execute_multistage_matches_the_reference_and_sqlite(jenv, sql):
    _run_both(jenv, sql)


def test_right_and_full_joins_match_the_reference_and_sqlite(jenv):
    # sqlite emulates the RIGHT JOIN by swapping the sides. RIGHT and FULL
    # joins are partitioned, and the reference puts every integer key in
    # partition 0 (its exchange hash's low bits are zero): the port spreads
    # them, so rows that no ORDER BY orders come out of the partitions in
    # another order, and both are compared as multisets
    _run_both(jenv, "SELECT c.cust_id, COUNT(o.amount) FROM orders o "
              "RIGHT JOIN customers c ON o.cust_id = c.cust_id "
              "GROUP BY c.cust_id LIMIT 100000",
              "SELECT c.cust_id, COUNT(o.amount) FROM customers c "
              "LEFT JOIN orders o ON o.cust_id = c.cust_id GROUP BY c.cust_id",
              ordered=False)
    tables, jax_tables, schemas, db = jenv
    sql = ("SELECT o.cust_id, c.cust_id FROM orders o "
           "FULL JOIN customers c ON o.cust_id = c.cust_id LIMIT 100000")
    full = execute_multistage(sql, make_segment_scan(tables, device=CPU), schemas.get)
    ref = jax_execute(sql, jax_scan(jax_tables), _jax_schema_for(schemas))
    _assert_rows_equal(_sorted_rows(full.rows), _sorted_rows(ref.rows))
    inner = db.execute("SELECT COUNT(*) FROM orders o JOIN customers c "
                       "ON o.cust_id = c.cust_id").fetchone()[0]
    left_un = db.execute("SELECT COUNT(*) FROM orders WHERE cust_id NOT IN "
                         "(SELECT cust_id FROM customers)").fetchone()[0]
    right_un = db.execute("SELECT COUNT(*) FROM customers WHERE cust_id NOT IN "
                          "(SELECT cust_id FROM orders)").fetchone()[0]
    assert len(full.rows) == inner + left_un + right_un


def test_plan_shapes(jenv):
    schemas = jenv[2]
    plan = plan_multistage(
        "SELECT c.cust_name, SUM(o.amount) FROM orders o "
        "JOIN customers c ON o.cust_id = c.cust_id "
        "WHERE o.qty > 5 AND c.region_id = 2 GROUP BY c.cust_name", schemas.get)
    assert plan.scans["o"].filter is not None
    assert plan.scans["c"].filter is not None
    assert plan.post_filter is None
    assert plan.joins[0].left_keys == ["o.cust_id"]
    assert plan.joins[0].right_keys == ["c.cust_id"]
    assert plan.scans["c"].columns == ["cust_id", "cust_name"]
    plan2 = plan_multistage(
        "SELECT o.cust_id FROM orders o LEFT JOIN customers c "
        "ON o.cust_id = c.cust_id WHERE c.region_id = 2 AND o.qty > 5", schemas.get)
    assert plan2.scans["c"].filter is None
    assert plan2.post_filter is not None
    assert plan2.scans["o"].filter is not None
    semi = plan_multistage(
        "SELECT COUNT(*) FROM orders WHERE cust_id NOT IN "
        "(SELECT cust_id FROM customers WHERE region_id = 1)", schemas.get)
    assert [(j.right_alias, j.join_type, j.left_keys, j.right_keys) for j in semi.joins] \
        == [("__in0", "anti", ["orders.cust_id"], ["__in0.cust_id"])]
    assert semi.scans["__in0"].filter is not None


def test_plan_errors(jenv):
    schemas = jenv[2]
    with pytest.raises(QueryValidationError, match="equality key"):
        plan_multistage("SELECT 1 FROM orders o JOIN customers c ON o.qty > c.region_id",
                        schemas.get)
    with pytest.raises(QueryValidationError, match="ambiguous"):
        plan_multistage("SELECT cust_id FROM orders o JOIN customers c "
                        "ON o.cust_id = c.cust_id", schemas.get)
    with pytest.raises(QueryValidationError, match="CROSS"):
        plan_multistage("SELECT 1 FROM orders o CROSS JOIN customers c", schemas.get)
    with pytest.raises(QueryValidationError, match="multistage"):
        compile_query("SELECT 1 FROM a JOIN b ON a.x = b.x")


# -- IN / NOT IN against sqlite ----------------------------------------------------------

@pytest.fixture(scope="module")
def subquery_env(tmp_path_factory):
    rng = np.random.default_rng(83)
    n, m = 1200, 60
    orders = {"cust_id": [f"c{i}" for i in rng.integers(0, 80, n)],
              "qty": rng.integers(1, 20, n).astype(np.int32),
              "amount": np.round(rng.uniform(1, 200, n), 2)}
    custs = {"cust_id": [f"c{i}" for i in range(m)],
             "region": [["east", "west"][i % 2] for i in range(m)],
             "tier": rng.integers(1, 4, m).astype(np.int32)}
    schemas = {"orders": Schema("orders", [dimension("cust_id"), metric("qty", DataType.INT),
                                           metric("amount", DataType.DOUBLE)]),
               "custs": Schema("custs", [dimension("cust_id"), dimension("region"),
                                         metric("tier", DataType.INT)])}
    tmp = str(tmp_path_factory.mktemp("torch_insub"))
    paths = {"orders": SegmentBuilder(schemas["orders"]).build(orders, tmp, "o_0"),
             "custs": SegmentBuilder(schemas["custs"]).build(custs, tmp, "c_0")}
    tables = {t: [load_segment(p)] for t, p in paths.items()}
    jax_tables = {t: [jax_load(p)] for t, p in paths.items()}
    db = sqlite3.connect(":memory:")
    db.execute("CREATE TABLE orders (cust_id TEXT, qty INTEGER, amount REAL)")
    db.execute("CREATE TABLE custs (cust_id TEXT, region TEXT, tier INTEGER)")
    db.executemany("INSERT INTO orders VALUES (?,?,?)",
                   list(zip(orders["cust_id"], orders["qty"].tolist(),
                            orders["amount"].tolist())))
    db.executemany("INSERT INTO custs VALUES (?,?,?)",
                   list(zip(custs["cust_id"], custs["region"], custs["tier"].tolist())))
    return tables, jax_tables, schemas, db


@pytest.mark.parametrize("neg", (False, True))
def test_in_subquery_lowers_to_semi_anti_vs_sqlite(subquery_env, neg):
    op = "NOT IN" if neg else "IN"
    sql = (f"SELECT COUNT(*), SUM(amount) FROM orders WHERE qty > 3 AND "
           f"cust_id {op} (SELECT cust_id FROM custs WHERE tier = 2) LIMIT 5")
    got = _run_both(subquery_env, sql, sql.replace(" LIMIT 5", ""))
    assert got.stats["joinStrategy"] == "broadcast"


def test_in_subquery_grouped_vs_sqlite(subquery_env):
    sql = ("SELECT cust_id, COUNT(*) FROM orders WHERE cust_id IN "
           "(SELECT cust_id FROM custs WHERE region = 'east') "
           "GROUP BY cust_id LIMIT 1000")
    _run_both(subquery_env, sql, sql.replace(" LIMIT 1000", ""))


# -- the slice as a whole ------------------------------------------------------------------

SLICE_ROWS, SLICE_SUPPLIERS, SLICE_CUSTOMERS = 60_000, 20_000, 20_000


@pytest.fixture(scope="module")
def slice_env(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_join_slice"))
    seed = 20260729
    cols = ssb.make_columns(SLICE_ROWS, seed)
    dims = {"supplier": (ssb.supplier_schema(), ssb.make_supplier(SLICE_SUPPLIERS, seed)),
            "customer": (ssb.customer_schema(), ssb.make_customer(SLICE_CUSTOMERS, seed)),
            "region": (ssb.region_schema(), ssb.make_region())}
    tables = {"lineorder": segments_from_columns(ssb.ssb_schema(), cols, out + "/lo", 3)}
    schemas = {"lineorder": ssb.ssb_schema()}
    for name, (schema, dcols) in dims.items():
        tables[name] = segments_from_columns(schema, dcols, f"{out}/{name}", 1)
        schemas[name] = schema
    jax_tables = {t: [jax_load(s.path) for s in segs] for t, segs in tables.items()}
    oracles = chip_smoke.join_oracles(cols, dims["supplier"][1], dims["customer"][1])
    return tables, jax_tables, schemas, oracles


@pytest.mark.parametrize("exchange", ("default", "partitioned"))
@pytest.mark.parametrize("qid", list(ssb.JOIN_QUERIES))
def test_the_smoke_join_queries_match_the_reference_and_numpy(slice_env, qid, exchange,
                                                              monkeypatch):
    """Both exchanges: the scaled-down builds all broadcast by default; a
    broadcast limit of 0 bytes partitions every join, in both packages."""
    tables, jax_tables, schemas, oracles = slice_env
    sql = ssb.JOIN_QUERIES[qid]
    kw = {}
    if exchange == "partitioned":
        monkeypatch.setattr(planner, "BROADCAST_MAX_BYTES_DEFAULT", 0)
        kw = {"broadcast_max_bytes": 0}
    jk.reset_launch_counts()
    got = execute_multistage(sql, make_segment_scan(tables, device=CPU), schemas.get)
    launches = jk.launch_counts()
    want = jax_execute(sql, jax_scan(jax_tables), _jax_schema_for(schemas), **kw)
    _assert_rows_equal(got.rows, want.rows)
    _assert_rows_equal(got.rows, oracles[qid])
    regime = chip_smoke.JOIN_EXPECT[qid][0]
    assert chip_smoke.regime_of(launches, 1) == regime, launches
    strategy = "partitioned" if exchange == "partitioned" else "broadcast"
    assert got.stats["joinStrategy"] == want.stats["joinStrategy"] == strategy
    for key in ("joinBuildMs", "joinProbeMs"):
        assert key in got.stats
    assert "joinServedHostTier" not in got.stats
    if exchange == "partitioned" and qid != "join_region":
        # the reference buckets these integer keys by the low bits of their
        # float64 hash, all zero: every bucket reads hot and the whole build
        # side is replicated to every partition. The port mixes the codes
        # first. (Its joinSkewPct is the largest of the exchange's and each
        # partition's device probe histogram, a few dozen rows here.)
        assert want.stats["joinSkewPct"] == 100.0
        assert got.stats["joinSkewPct"] < 100.0
        assert got.stats["joinShuffleBytes"] < want.stats["joinShuffleBytes"]
    else:
        assert got.stats["joinShuffleBytes"] == want.stats["joinShuffleBytes"]
    assert got.stats["numDocsScanned"] == want.stats["numDocsScanned"]
    assert set(got.stats["phaseTimesMs"]) == {"plan", "scan", "exchange", "stages", "join",
                                              "partialAggregate", "reduce"}
