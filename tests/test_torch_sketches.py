"""pinot_tpu_torch's copies of the sketch and id-set modules against the JAX package's.

`pinot_tpu_torch.query.sketches` and `pinot_tpu_torch.query.idset` are numpy
copies of `pinot_tpu/query/sketches.py` and `pinot_tpu/query/idset.py`: on
the same inputs, made from a seed, they give the same hashes, the same
sketch bytes, estimates and quantiles, the same serialized id sets and the
same membership, bit for bit, and each side reads the other's bytes. The
unit behaviors of tests/test_sketches.py and tests/test_idset.py (accuracy,
merge, set operations, bounded size, precision above 2^53, malformed
literals) are held on the port's classes. The HLL hash, (bucket, rank) and
estimator of the port's aggregates and the theta set-op evaluator are held
against the reference's too.
"""

import numpy as np
import pytest

from pinot_tpu.query import aggregates as jax_aggregates
from pinot_tpu.query import sketches as jax_sketches
from pinot_tpu.query.context import QueryValidationError as JaxValidationError
from pinot_tpu.query.idset import IdSet as JaxIdSet
from pinot_tpu_torch.query import aggregates, idset
from pinot_tpu_torch.query.context import QueryValidationError
from pinot_tpu_torch.query.idset import IdSet, IdSetError
from pinot_tpu_torch.query.sketches import TDigest, ThetaSketch, hash64

SEED = 20261017


def _values(kind: str, n: int = 5000, seed: int = SEED):
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(-10**6, 10**6, n).astype(np.int32)
    if kind == "int64":
        return rng.integers(-2**62, 2**62, n, dtype=np.int64)
    if kind == "uint8":
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == "float64":
        return np.round(rng.normal(0, 1e4, n), 3)
    if kind == "float32":
        return rng.normal(0, 100, n).astype(np.float32)
    if kind == "str":
        return np.array([f"v{k}" for k in rng.integers(0, 3000, n)], dtype=object)
    return np.array([bytes([k % 256, k // 256]) for k in rng.integers(0, 4000, n)],
                    dtype=object)


KINDS = ["int32", "int64", "uint8", "float64", "float32", "str", "bytes"]


@pytest.mark.parametrize("kind", KINDS)
def test_hash64_equals_the_reference(kind):
    v = _values(kind)
    np.testing.assert_array_equal(hash64(v), jax_sketches.hash64(v))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [64, 4096])
def test_theta_sketches_equal_the_reference(kind, k):
    a, b = _values(kind, seed=SEED), _values(kind, seed=SEED + 1)
    ours = [ThetaSketch.from_values(x, k) for x in (a, b)]
    refs = [jax_sketches.ThetaSketch.from_values(x, k) for x in (a, b)]
    for s, r in zip(ours, refs):
        assert s.to_bytes() == r.to_bytes() and s.estimate() == r.estimate()
    for op in ("union", "intersect", "a_not_b"):
        got = getattr(ours[0], op)(ours[1])
        want = getattr(refs[0], op)(refs[1])
        assert got.to_bytes() == want.to_bytes() and got.estimate() == want.estimate(), op
    back = ThetaSketch.from_bytes(refs[0].to_bytes())
    assert back.to_bytes() == refs[0].to_bytes()
    assert jax_sketches.ThetaSketch.from_bytes(ours[1].to_bytes()).to_bytes() == \
        ours[1].to_bytes()


def test_theta_absorb_of_presorted_hashes_equals_from_values():
    """The device path absorbs the dictionary's cached, sorted unique hashes."""
    v = _values("int64", 20_000)
    sk = ThetaSketch(1024)
    sk._absorb(np.unique(hash64(v)))
    ref = jax_sketches.ThetaSketch(1024)
    ref._absorb(np.unique(jax_sketches.hash64(v)))
    assert sk.to_bytes() == ref.to_bytes() == ThetaSketch.from_values(v, 1024).to_bytes()


def test_theta_accuracy_merge_and_set_operations():
    assert ThetaSketch.from_values(np.arange(1000), k=4096).estimate() == 1000
    rng = np.random.default_rng(0)
    v = rng.integers(0, 10**12, 200_000)
    assert ThetaSketch.from_values(v, k=4096).estimate() == pytest.approx(
        len(np.unique(v)), rel=0.05)
    a, b = rng.integers(0, 10**9, 50_000), rng.integers(0, 10**9, 50_000)
    merged = ThetaSketch.from_values(a, 2048).union(ThetaSketch.from_values(b, 2048))
    assert merged.estimate() == pytest.approx(len(np.unique(np.concatenate([a, b]))),
                                              rel=0.08)
    x = ThetaSketch.from_values(np.arange(0, 1000), 4096)
    y = ThetaSketch.from_values(np.arange(500, 1500), 4096)
    assert x.intersect(y).estimate() == pytest.approx(500, rel=0.01)
    assert x.a_not_b(y).estimate() == pytest.approx(500, rel=0.01)
    assert x.union(y).estimate() == pytest.approx(1500, rel=0.01)


def _digest_equal(a, b):
    return (a.compression == b.compression and np.array_equal(a.means, b.means)
            and np.array_equal(a.weights, b.weights) and a.to_bytes() == b.to_bytes())


@pytest.mark.parametrize("dist", ["normal", "integers", "with_nan", "single", "empty"])
def test_tdigests_equal_the_reference(dist):
    rng = np.random.default_rng(SEED)
    v = {"normal": rng.normal(100, 15, 20_000),
         "integers": rng.integers(0, 11, 20_000).astype(np.float64),
         "with_nan": np.where(rng.random(5000) < 0.1, np.nan, rng.uniform(0, 1, 5000)),
         "single": np.array([3.5]), "empty": np.empty(0)}[dist]
    ours, ref = TDigest.from_values(v), jax_sketches.TDigest.from_values(v)
    assert _digest_equal(ours, ref)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    half = len(v) // 2
    parts = [TDigest.from_values(v[:half]), TDigest.from_values(v[half:])]
    ref_parts = [jax_sketches.TDigest.from_values(v[:half]),
                 jax_sketches.TDigest.from_values(v[half:])]
    assert _digest_equal(parts[0].merge(parts[1]), ref_parts[0].merge(ref_parts[1]))
    assert _digest_equal(TDigest.from_bytes(ref.to_bytes()), ref)
    assert _digest_equal(jax_sketches.TDigest.from_bytes(ours.to_bytes()), ours)


def test_weighted_tdigest_equals_the_reference():
    """The device counts path: a dictionary's sorted values with per-id counts
    (zeros included: ids the filter removed)."""
    rng = np.random.default_rng(SEED)
    values = np.sort(rng.choice(np.arange(5000.0), 800, replace=False))
    counts = rng.integers(0, 40, 800) * (rng.random(800) < 0.7)
    ours = TDigest.from_weighted(values, counts)
    ref = jax_sketches.TDigest.from_weighted(values, counts)
    assert _digest_equal(ours, ref)
    assert ours.quantile(0.95) == ref.quantile(0.95)


def test_tdigest_accuracy_merge_and_bounded_size():
    rng = np.random.default_rng(2)
    v = rng.normal(100, 15, 100_000)
    td = TDigest.from_values(v)
    for q in (0.01, 0.25, 0.5, 0.75, 0.99):
        assert td.quantile(q) == pytest.approx(np.quantile(v, q), abs=1.0)
    parts = [rng.uniform(0, 1000, 20_000) for _ in range(5)]
    merged = TDigest.from_values(parts[0])
    for p in parts[1:]:
        merged = merged.merge(TDigest.from_values(p))
    assert merged.quantile(0.5) == pytest.approx(np.quantile(np.concatenate(parts), 0.5),
                                                 rel=0.02)
    assert len(TDigest.from_values(rng.uniform(0, 1, 500_000)).means) < 200


@pytest.mark.parametrize("kind", ["int32", "float64", "str", "bytes"])
def test_hll_hash_bucket_rank_and_estimate_equal_the_reference(kind):
    v = _values(kind, 3000)
    vals = np.asarray(v, dtype=object)
    for p in (8, 12):
        ours = [aggregates.hll_bucket_rank(x, p) for x in vals[:500]]
        assert ours == [jax_aggregates.hll_bucket_rank(x, p) for x in vals[:500]]
        regs = aggregates.DistinctCountHLLAgg(_call("distinctcounthll", p)).host_state(vals)
        ref = jax_aggregates.DistinctCountHLLAgg(_jax_call("distinctcounthll", p)
                                                 ).host_state(vals)
        assert np.array_equal(regs, ref)
        assert aggregates.hll_estimate(regs) == jax_aggregates.hll_estimate(ref)
    assert aggregates.hll_hash(2.0) == jax_aggregates.hll_hash(2.0) == aggregates.hll_hash(2)


def _call(name, *lits):
    from pinot_tpu_torch.sql.ast import Function, Identifier, Literal
    return Function(name, (Identifier("x"), *[Literal(v) for v in lits]))


def _jax_call(name, *lits):
    from pinot_tpu.sql.ast import Function, Identifier, Literal
    return Function(name, (Identifier("x"), *[Literal(v) for v in lits]))


class _Dict:
    """A dictionary surface: sorted values and `take`."""

    def __init__(self, values):
        self.values = values

    def __len__(self):
        return len(self.values)

    def take(self, ids):
        return self.values[ids]


def test_device_states_from_a_dictionary_equal_the_reference():
    """HLL registers, theta sketch and t-digest from a presence or count
    vector over a dictionary, through the caches on the dictionary; a longer
    dictionary object (a consuming segment that grew) gets tables of its own."""
    rng = np.random.default_rng(SEED)
    values = np.unique(rng.integers(0, 10**7, 6000)).astype(np.int32)
    counts = rng.integers(0, 3, len(values))
    present = np.nonzero(counts)[0]
    for name, p in (("distinctcounthll", 12), ("distinctcountthetasketch", "nominalEntries=512")):
        ours = aggregates.make_agg(_call(name, p))
        ref = jax_aggregates.make_agg(_jax_call(name, p))
        d = _Dict(values)
        for _ in range(2):   # the second call reads the cache
            got = ours.finalize(ours.state_from_present_ids(d, present))
            assert got == ref.finalize(ref.state_from_present_ids(_Dict(values), present))
        grown = _Dict(np.concatenate([values, values[-1] + 1 + np.arange(100, dtype=np.int32)]))
        ids = np.concatenate([present, len(values) + np.arange(100)])
        assert ours.finalize(ours.state_from_present_ids(grown, ids)) == \
            ref.finalize(ref.state_from_present_ids(_Dict(grown.values), ids))
    ours = aggregates.make_agg(_call("percentiletdigest", 95))
    ref = jax_aggregates.make_agg(_jax_call("percentiletdigest", 95))
    assert _digest_equal(ours.state_from_id_counts(_Dict(values), counts),
                         ref.state_from_id_counts(_Dict(values), counts))


@pytest.mark.parametrize("expr", ["$1", "SET_UNION($1, $2)", "SET_INTERSECT($1, $2, $3)",
                                  "SET_DIFF($2, $1)", "set_union(SET_DIFF($1, $3), $2)"])
def test_theta_set_op_expressions_equal_the_reference(expr):
    rng = np.random.default_rng(SEED)
    parts = [rng.integers(0, 5000, 3000) for _ in range(3)]
    ours = aggregates._eval_theta_setop(expr, [ThetaSketch.from_values(p, 1024)
                                               for p in parts])
    ref = jax_aggregates._eval_theta_setop(expr, [jax_sketches.ThetaSketch.from_values(p, 1024)
                                                  for p in parts])
    assert ours.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("expr", ["$4", "SET_XOR($1, $2)", "SET_DIFF($1)", "SET_UNION($1 $2",
                                  "$1 $2", "SET_UNION($1, @)"])
def test_bad_theta_set_op_expressions_raise_as_the_reference(expr):
    sketches = [ThetaSketch.from_values(np.arange(10), 64) for _ in range(3)]
    jax_sketches_ = [jax_sketches.ThetaSketch.from_values(np.arange(10), 64) for _ in range(3)]
    with pytest.raises(QueryValidationError):
        aggregates._eval_theta_setop(expr, sketches)
    with pytest.raises(JaxValidationError):
        jax_aggregates._eval_theta_setop(expr, jax_sketches_)


ID_SETS = {
    "int": lambda: np.array([5, 1, 5, 9, 3, -2**40], dtype=np.int64),
    "int32": lambda: np.arange(0, 3000, 7, dtype=np.int32),
    "float": lambda: np.array([1.5, -2.25, 1.5, np.nan, 2.0**53]),
    "str": lambda: ["b", "a", "b", "c", "a\x00b", "", None],
    "empty": lambda: np.empty(0, dtype=np.int64),
}
PROBES = [np.array([1, 2, 3, 9, 100, -2**40], dtype=np.int64),
          np.array([2.0, 2.5, 4.0, 1.5, 2.0**53, 9.0]),
          np.array([2**53 + 1, 2**53, 7], dtype=np.int64),
          np.array([2**63, 5], dtype=np.uint64),
          np.array(["a", "z", "", "a\x00b"], dtype=object)]


@pytest.mark.parametrize("kind", list(ID_SETS))
def test_id_sets_equal_the_reference(kind):
    values = ID_SETS[kind]()
    ours, ref = IdSet.from_values(values), JaxIdSet.from_values(values)
    assert ours.kind == ref.kind and ours.to_bytes() == ref.to_bytes()
    assert ours.serialize() == ref.serialize()
    assert IdSet.deserialize(ref.serialize()).to_bytes() == ref.to_bytes()
    assert JaxIdSet.deserialize(ours.serialize()).to_bytes() == ours.to_bytes()
    for probe in PROBES:
        np.testing.assert_array_equal(ours.contains(probe), ref.contains(probe))


def test_id_set_union_promotion_and_errors():
    a = IdSet.from_values(np.array([1, 2], dtype=np.int64))
    u = a.union(IdSet.from_values(np.array([2.5])))
    ref = JaxIdSet.from_values(np.array([1, 2], dtype=np.int64)).union(
        JaxIdSet.from_values(np.array([2.5])))
    assert u.kind == "f8" and u.to_bytes() == ref.to_bytes()
    assert u.contains(np.array([1.0, 2.5, 3.0])).tolist() == [True, True, False]
    with pytest.raises(IdSetError):
        a.union(IdSet.from_values(["x"]))
    with pytest.raises(IdSetError):
        IdSet.deserialize("not-a-real-idset")
    empty = IdSet.deserialize(IdSet.empty().serialize())
    assert len(empty) == 0 and empty.contains(np.array([1, 2])).tolist() == [False, False]


def test_id_set_precision_above_2_53():
    s = IdSet.from_values(np.array([2**53 + 1], dtype=np.int64))
    assert s.contains(np.array([2.0**53, float(2**54), 1.5])).tolist() == [False] * 3
    assert IdSet.from_values(np.array([2**54], dtype=np.int64)).contains(
        np.array([float(2**54)])).tolist() == [True]
    f = IdSet.from_values(np.array([2.0**53]))
    assert f.contains(np.array([2**53 + 1, 2**53], dtype=np.int64)).tolist() == [False, True]
    assert IdSet.from_values(np.array([2.5])).contains(
        np.array([2], dtype=np.int64)).tolist() == [False]


def test_the_deserialize_cache_bounds_its_decoded_values(monkeypatch):
    monkeypatch.setattr(idset, "_CACHE_MAX_TOTAL_VALUES", 250)
    idset._CACHE.clear()
    literals = [IdSet.from_values(np.arange(k, k + 100)).serialize() for k in range(0, 500, 100)]
    first = IdSet.deserialize(literals[0])
    assert IdSet.deserialize(literals[0]) is first   # memoized
    for lit in literals[1:]:
        IdSet.deserialize(lit)
    assert sum(len(v) for v in idset._CACHE.values()) <= 250
    assert literals[0] not in idset._CACHE and literals[-1] in idset._CACHE
    idset._CACHE.clear()
