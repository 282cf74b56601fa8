"""Differential test: pinot_tpu_torch's expression library against the JAX package's.

* The registries: every name the JAX package registers (`lookup` aside, which
  waits with `query/lookup.py`) is registered in the port, and the port's
  `DEVICE_FUNCS` is the JAX planner's `_DEVICE_FUNCS`.
* Every registered function, one case each, through the port's `eval_host`
  and the reference's `eval_expr(..., np)` on the same seeded numpy inputs:
  equal results (the library is a copy: the same values and dtypes; NOW and
  AGO read the clock, so they agree within 5 s).
* Every device function through the port's `eval_device` on CPU tensors and
  the reference's `eval_expr(..., jax.numpy)` in 32 bits: the same dtype,
  integers and booleans exact (int32 products wrap alike), floats at rel 1e-6.
  CASE is held against `np.select` instead: the reference's right fold reads
  each WHEN one argument to the left of its place (its default or a THEN
  value), the port's takes the first true WHEN.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinot_tpu.engine.datetime_fns  # noqa: F401 -- registers its functions
import pinot_tpu.engine.geo_fns  # noqa: F401
import pinot_tpu.engine.json_fns  # noqa: F401
import pinot_tpu.engine.string_fns  # noqa: F401
from pinot_tpu.engine import expr as jexpr
from pinot_tpu.query.planner import _DEVICE_FUNCS
from pinot_tpu.sql import ast as jast
from pinot_tpu.sql.parser import Parser as JaxParser
from pinot_tpu_torch.engine import expr as pexpr
from pinot_tpu_torch.sql import ast as past
from pinot_tpu_torch.sql.parser import Parser
from test_torch_kernels_gpu import DEVICE_EXPR_CASES, device_expr_columns

N = 40
POLYGON = "POLYGON ((0 0, 60 0, 60 50, 0 50, 0 0))"


def _host_columns():
    rng = np.random.default_rng(20260729)
    words = ["alpha", "Beta", "gamma delta", "  padded ", "eps", "zeta-eta", "mu nu xi",
             "ASIA", "café", "a+b c"]
    s = np.array([words[k] for k in rng.integers(0, len(words), N)], dtype=object)
    s2 = np.array([words[k] for k in rng.integers(0, len(words), N)], dtype=object)
    ts = rng.integers(0, 2_000_000_000_000, N)
    mv = np.empty(N, dtype=object)
    mv2 = np.empty(N, dtype=object)
    mvs = np.empty(N, dtype=object)
    mvs2 = np.empty(N, dtype=object)
    for r in range(N):
        mv[r] = rng.integers(0, 5, rng.integers(1, 5))
        mv2[r] = rng.integers(0, 5, rng.integers(1, 5))
        mvs[r] = np.array([str(x) for x in "abcd"[:rng.integers(1, 5)]])
        mvs2[r] = np.array([str(x) for x in "bcde"[:rng.integers(1, 5)]])
    fnan = rng.normal(0, 10, N)
    fnan[::3] = np.nan
    lng, lat = rng.uniform(-10, 70, N), rng.uniform(-10, 60, N)
    import base64
    import urllib.parse
    return {
        "i": rng.integers(-1000, 1000, N), "p": rng.integers(1, 100, N),
        "f": rng.normal(0, 10, N), "u": rng.uniform(-0.9, 0.9, N), "fnan": fnan,
        "ts": ts, "ts2": ts + rng.integers(-10 ** 11, 10 ** 11, N),
        "days": ts // 86_400_000, "s": s, "s2": s2, "mv": mv, "mv2": mv2,
        "mvs": mvs, "mvs2": mvs2, "lng": lng, "lat": lat,
        "b64": np.array([base64.b64encode(x.encode()).decode() for x in s], dtype=object),
        "url": np.array([urllib.parse.quote(x, safe="") for x in s], dtype=object),
        "hexs": np.array([x.encode().hex() for x in s], dtype=object),
        "bts": np.array([x.encode() for x in s], dtype=object),
        "wkt": np.array([f"POINT ({x:.3f} {y:.3f})" for x, y in zip(lng, lat)], dtype=object),
        "dts": np.array([f"20{k % 30:02d}-{k % 12 + 1:02d}-{k % 28 + 1:02d} "
                         f"{k % 24:02d}:{k % 60:02d}:{(7 * k) % 60:02d}"
                         for k in rng.integers(0, 10_000, N)], dtype=object),
        "js": np.array([f'{{"a": {k}, "b": "v{k % 3}", "c": {k / 4}, "d": {{"e": [{k}, 2]}}}}'
                        if k % 5 else "" for k in rng.integers(0, 100, N)], dtype=object),
    }


def _pt():
    return ("stpoint", "@lng", "@lat")


# one call per registered name: "@c" is column c, a tuple is a nested call
HOST_CALLS = {
    "__pack": ("@f", "@i"), "__packobj": ("@s", "@i"),
    "abs": ("@i",), "acos": ("@u",), "asin": ("@u",), "atan": ("@f",), "atan2": ("@f", "@i"),
    "ceil": ("@f",), "cos": ("@f",), "cosh": ("@u",), "cot": ("@u",), "degrees": ("@f",),
    "exp": ("@u",), "floor": ("@f",), "greatest": ("@i", "@p", 3), "least": ("@f", "@i"),
    "ln": ("@p",), "log": ("@p",), "log10": ("@p",), "log2": ("@p",), "power": ("@f", 2),
    "radians": ("@f",), "round": ("@f", 2), "sign": ("@i",), "sin": ("@f",), "sinh": ("@u",),
    "sqrt": ("@p",), "tan": ("@u",), "tanh": ("@f",), "truncate": ("@f", 1),
    "coalesce": ("@fnan", "@f"), "nullif": ("@i", 3),
    "arraylength": ("@mv",), "cardinality": ("@mv",), "valuein": ("@mv", 1, 2, 3),
    "arrayelementat": ("@mv", 2), "arraysum": ("@mv",), "arraymin": ("@mv",),
    "arraymax": ("@mv",), "arrayaverage": ("@mv",), "arraysortasc": ("@mv",),
    "arraysortdesc": ("@mv",), "arraysortint": ("@mv",), "arraysortstring": ("@mvs",),
    # datetime
    "ago": ("PT3H",), "now": (), "dateadd": ("MONTH", 2, "@ts"),
    "timestampadd": ("DAY", 3, "@ts"), "datediff": ("MONTH", "@ts", "@ts2"),
    "timestampdiff": ("HOUR", "@ts", "@ts2"),
    "datetimeconvert": ("@ts", "1:MILLISECONDS:EPOCH", "1:DAYS:EPOCH", "1:DAYS"),
    "datetrunc": ("month", "@ts"), "fromdatetime": ("@dts", "yyyy-MM-dd HH:mm:ss"),
    "todatetime": ("@ts", "yyyy-MM-dd HH:mm:ss"), "fromtimestamp": ("@ts",),
    "totimestamp": ("@ts",), "timeconvert": ("@ts", "MILLISECONDS", "HOURS"),
    "timezonehour": ("Asia/Kolkata", 1_600_000_000_000),
    "timezoneminute": ("America/St_Johns", 0),
    # strings
    "base64decode": ("@b64",), "base64encode": ("@s",), "bytestohex": ("@bts",),
    "hextobytes": ("@hexs",), "fromutf8": ("@bts",), "toutf8": ("@s",), "chr": ("@p",),
    "codepoint": ("@s",), "concat": ("@s", "@s2", "-"), "concat_ws": ("/", "@s", "@s2"),
    "contains": ("@s", "a"), "decodeurl": ("@url",), "encodeurl": ("@s",),
    "endswith": ("@s", "a"), "frombase64": ("@b64",), "hammingdistance": ("@s", "alpha"),
    "leftsubstr": ("@s", 3), "length": ("@s",), "lower": ("@s",), "lpad": ("@s", 10, "*"),
    "ltrim": ("@s",), "md5": ("@s",), "normalize": ("@s", "NFD"),
    "regexp_extract": ("@s", "([a-z]+)", 1), "regexp_replace": ("@s", "[aeiou]", "#"),
    "remove": ("@s", "a"), "repeat": ("@s", ",", 2), "replace": ("@s", "a", "A"),
    "reverse": ("@s",), "rightsubstr": ("@s", 2), "rpad": ("@s", 10, "-"), "rtrim": ("@s",),
    "sha": ("@s",), "sha256": ("@s",), "sha512": ("@s",), "split": ("@s", " "),
    "splitpart": ("@s", " ", 1), "startswith": ("@s", "a"), "strcmp": ("@s", "gamma"),
    "strpos": ("@s", "a"), "strrpos": ("@s", "a", 4), "substr": ("@s", 1, 3),
    "substring": ("@s", 2, 3), "toascii": ("@s",), "tobase64": ("@s",), "trim": ("@s",),
    "upper": ("@s",),
    # json
    "json_extract_key": ("@js", "$.d"), "json_extract_scalar": ("@js", "$.a", "LONG", 0),
    "json_format": ("@js",), "jsonpath": ("@js", "$.b"), "jsonpathdouble": ("@js", "$.c"),
    "jsonpathlong": ("@js", "$.a"), "jsonpathstring": ("@js", "$.d.e[0]"),
    # geo
    "stpoint": ("@lng", "@lat"), "stastext": (_pt(),), "stgeogfromtext": ("@wkt",),
    "stx": (_pt(),), "sty": (_pt(),), "stdistance": (_pt(), ("stpoint", 1.5, 2.5)),
    "stequals": (_pt(), ("stgeogfromtext", "@wkt")),
    "stcontains": (("stgeogfromtext", POLYGON), _pt()),
    "stwithin": (_pt(), ("stgeogfromtext", POLYGON)),
}
_MV_ARGS = {"arraydistinct": (("@mv",), ("@mvs",)), "arrayreverse": (("@mv",), ("@mvs",)),
            "arraycontains": (("@mv", 2), ("@mvs", "b")),
            "arrayindexof": (("@mv", 2), ("@mvs", "b")),
            "arrayremove": (("@mv", 2), ("@mvs", "b")),
            "arrayslice": (("@mv", 0, 2), ("@mvs", 1, 3)),
            "arrayunion": (("@mv", "@mv2"), ("@mvs", "@mvs2")),
            "arrayconcat": (("@mv", "@mv2"), ("@mvs", "@mvs2"))}
for _base, (_num, _str) in _MV_ARGS.items():
    HOST_CALLS[_base] = _num
    for _suffix in ("int", "long", "float", "double"):
        HOST_CALLS[_base + _suffix] = _num
    HOST_CALLS[_base + "string"] = _str
for _fn in ("day", "dayofmonth", "dayofweek", "dayofyear", "dow", "doy", "hour",
            "millisecond", "minute", "month", "monthofyear", "quarter", "second", "week",
            "weekofyear", "year", "yearofweek", "yow"):
    HOST_CALLS[_fn] = ("@ts",)
for _unit in ("seconds", "minutes", "hours", "days"):
    HOST_CALLS[f"toepoch{_unit}"] = ("@ts",)
    HOST_CALLS[f"toepoch{_unit}bucket"] = ("@ts", 3)
    HOST_CALLS[f"fromepoch{_unit}"] = ("@days",)
    HOST_CALLS[f"fromepoch{_unit}bucket"] = ("@days", 2)
CLOCK = {"now", "ago"}


def _ast(mod, name, args):
    def arg(a):
        if isinstance(a, tuple):
            return _ast(mod, a[0], a[1:])
        if isinstance(a, str) and a.startswith("@"):
            return mod.Identifier(a[1:])
        return mod.Literal(a)
    return mod.Function(name, tuple(arg(a) for a in args))


def _same(a, b) -> bool:
    """Equal values of equal types; floats equal or both NaN; geometries
    (one class per package) by their WKT."""
    if hasattr(a, "to_wkt") or hasattr(b, "to_wkt"):
        return a.to_wkt() == b.to_wkt()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            return False
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype == object:
            return all(_same(x, y) for x, y in zip(a.ravel(), b.ravel()))
        return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if type(a) is not type(b):
        return False
    if isinstance(a, (float, np.floating)) and math.isnan(a):
        return math.isnan(b)
    return bool(a == b)


def test_registries_match_the_reference():
    assert set(pexpr._FUNCTIONS) == set(jexpr._FUNCTIONS)
    assert pexpr.DEVICE_FUNCS == _DEVICE_FUNCS
    # LOOKUP reads a registered dimension table: tests/test_torch_gapfill_lookup.py
    # holds it against the reference
    assert set(HOST_CALLS) == set(pexpr._FUNCTIONS) - {"lookup"}
    assert set(DEVICE_EXPR_CASES) == set(pexpr.DEVICE_FUNCS)


@pytest.fixture(scope="module")
def host_columns():
    return _host_columns()


@pytest.mark.parametrize("name", sorted(HOST_CALLS))
def test_host_function_matches_the_reference(host_columns, name):
    args = HOST_CALLS[name]
    got = pexpr.eval_host(_ast(past, name, args), host_columns)
    want = jexpr.eval_expr(_ast(jast, name, args), host_columns, np)
    if name in CLOCK:
        assert abs(got - want) <= 5000, (got, want)
    else:
        assert _same(got, want), (name, got, want)


@pytest.mark.parametrize("name", sorted(DEVICE_EXPR_CASES))
def test_device_function_matches_the_reference(name):
    cols = device_expr_columns(512)
    sql = DEVICE_EXPR_CASES[name]
    got = pexpr.eval_device(Parser(sql).expression(),
                            {c: torch.from_numpy(v) for c, v in cols.items()})
    want = np.asarray(jexpr.eval_expr(JaxParser(sql).expression(),
                                      {c: jnp.asarray(v) for c, v in cols.items()}, jnp))
    got = got.numpy()
    if name == "case":
        want = _case_oracle(cols)
    assert got.dtype == want.dtype, (sql, got.dtype, want.dtype)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _case_oracle(cols):
    """DEVICE_EXPR_CASES["case"] in numpy: the first true WHEN wins."""
    return np.select([cols["k"] > 0, cols["f"] < 0],
                     [cols["i"].astype(np.float32) * 2, cols["f"]],
                     np.float32(0)).astype(np.float32)


def test_case_takes_the_first_true_when_on_host_and_device():
    cols = device_expr_columns(512)
    sql = "CASE WHEN k > 0 THEN i * 2 WHEN f < 0 THEN f ELSE 0 END"
    e = Parser(sql).expression()
    np.testing.assert_array_equal(pexpr.eval_host(e, cols), _case_oracle(cols))
    dev = pexpr.eval_device(e, {c: torch.from_numpy(v) for c, v in cols.items()}).numpy()
    np.testing.assert_array_equal(dev, _case_oracle(cols))
    words = np.array(["a", "b", "c", "d"], dtype=object)[np.abs(cols["k"][:8]) % 4]
    e = Parser("CASE w WHEN 'a' THEN 1 WHEN 'b' THEN 2 END").expression()
    assert pexpr.eval_host(e, {"w": words}).tolist() == [
        {"a": 1, "b": 2}.get(w) for w in words]


def test_device_int32_products_wrap_as_in_jax():
    cols = device_expr_columns(512)
    got = pexpr.eval_device(Parser("i * 3000000").expression(),
                            {c: torch.from_numpy(v) for c, v in cols.items()}).numpy()
    assert got.dtype == np.int32
    assert (np.abs(cols["i"].astype(np.int64) * 3000000) >= 1 << 31).any()
    np.testing.assert_array_equal(got, (cols["i"].astype(np.int64) * 3000000)
                                  .astype(np.int32))


_WEAK_CASES = {
    # CASE branches against jnp.where directly (the reference's CASE fold
    # misreads its WHENs, see the module docstring)
    "case_literals": ("CASE WHEN k > 0 THEN 1 ELSE 2.5 END",
                      lambda c: jnp.where(c["k"] > 0, 1, 2.5)),
    "case_weak_float": ("CASE WHEN k > 0 THEN k ELSE 0.5 END",
                        lambda c: jnp.where(c["k"] > 0, c["k"], 0.5)),
    "const_condition": ("CASE WHEN 1 = 1 THEN i ELSE 0 END",
                        lambda c: jnp.where(True, c["i"], 0)),
    "bool_times_float": ("(k > 0) * 2.5", None), "bool_plus_int": ("(k > 0) + 1", None),
    "power_int_base": ("power(p, 0.5)", None), "round_int": ("round(i)", None),
    "least_int": ("least(k, 3)", None), "const_subtree": ("abs(-3) + i", None),
}


@pytest.mark.parametrize("case", sorted(_WEAK_CASES))
def test_device_promotion_matches_jax_weak_typing(case):
    sql, jax_fn = _WEAK_CASES[case]
    cols = device_expr_columns(64)
    got = pexpr.eval_device(Parser(sql).expression(),
                            {c: torch.from_numpy(v) for c, v in cols.items()})
    jcols = {c: jnp.asarray(v) for c, v in cols.items()}
    want = np.asarray(jax_fn(jcols) if jax_fn is not None else
                      jexpr.eval_expr(JaxParser(sql).expression(), jcols, jnp))
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (sql, got.dtype, want.dtype)
    np.testing.assert_allclose(np.broadcast_to(got, want.shape), want, rtol=1e-6)


@pytest.mark.parametrize("sql", ["ln(lo_quantity)", "sqrt(lo_revenue)",
                                 "sqrt(lo_revenue) + ln(lo_quantity) * power(lo_discount, 2) "
                                 "+ floor(lo_extendedprice / 100) + abs(lo_discount - 5)"],
                         ids=["ln", "sqrt", "math_family"])
def test_cpu_transcendentals_give_the_same_bits_under_any_thread_count(sql, monkeypatch):
    """The chip smoke's `math` family over its rehearsal's 100,000 rows: the
    CPU evaluation of ln and sqrt (the terms whose f32 values were off by
    ~2e-4 from row 50,000 on, the second of two intra-op threads' halves, in
    one rehearsal run) gives the same bits under 1 thread and under 2 and 8,
    equal to numpy's float32 functions over the whole row; row 50,000 holds
    the f32 of the float64 answer."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.engine.datablock import _narrow
    cols = {c: _narrow(v) for c, v in ssb.make_columns(100_000, 20260729).items()
            if v.dtype != object}
    e = Parser(sql).expression()
    threads = torch.get_num_threads()
    runs = []
    try:
        for n in (1, 2, 8, 1):
            torch.set_num_threads(n)
            runs.append(pexpr.eval_device(e, {c: torch.from_numpy(v)
                                              for c, v in cols.items()}).numpy())
    finally:
        torch.set_num_threads(threads)
    for got in runs[1:]:
        assert got.dtype == np.float32 and np.array_equal(got.view(np.int32),
                                                         runs[0].view(np.int32))
    if sql == "ln(lo_quantity)":
        np.testing.assert_array_equal(runs[0], np.log(cols["lo_quantity"].astype(np.float32)))
    if sql == "sqrt(lo_revenue)":
        np.testing.assert_array_equal(runs[0], np.sqrt(cols["lo_revenue"]))
    host = {c: v.astype(np.float64 if v.dtype.kind == "f" else np.int64)
            for c, v in cols.items()}
    want = float(np.asarray(pexpr.eval_host(e, host))[50_000])
    assert abs(float(runs[0][50_000]) - want) <= 1e-6 * abs(want)
