"""pinot_tpu_torch segments against the JAX package's: one on-disk format.

Segments built by `pinot_tpu`'s writer load in `pinot_tpu_torch` with equal
forward ids, dictionaries, min/max and frame-of-reference forms; segments built
by `pinot_tpu_torch`'s writer load in `pinot_tpu` with equal columns; and both
packages' device blocks keep one padding contract."""

import numpy as np
import pytest
import torch

from pinot_tpu.engine.datablock import SegmentBlock as JaxBlock
from pinot_tpu.schema import DataType as JDataType
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.schema import dimension as jdim
from pinot_tpu.schema import metric as jmetric
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.writer import SegmentGeneratorConfig as JaxConfig
from pinot_tpu.segment.writer import build_aligned_segments as jax_build
from pinot_tpu_torch.engine.datablock import SegmentBlock, lut_size, padded_rows
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.segment.writer import (SegmentBuilder, SegmentGeneratorConfig,
                                            build_aligned_segments, segments_from_columns)
from pinot_tpu_torch.ssb import make_columns, ssb_schema

COLS = ["lo_region", "lo_suppkey", "lo_custkey", "lo_orderdate", "lo_quantity",
        "lo_extendedprice", "lo_discount", "lo_revenue"]


def _jax_schema():
    return JSchema.from_json(ssb_schema().to_json())


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """SSB segments written by the JAX package (lo_quantity raw, so it has a FOR form)."""
    out = tmp_path_factory.mktemp("jaxseg")
    cols = make_columns(3 * 20000 + 17, seed=3)
    paths = jax_build(_jax_schema(), cols, str(out), "lineorder", 3,
                      config=JaxConfig(no_dictionary_columns=["lo_quantity"]))
    return paths


def test_port_reader_loads_jax_segments(jax_built):
    for path in jax_built:
        ours, ref = load_segment(path), jax_load(path)
        assert ours.num_docs == ref.num_docs and ours.name == ref.name
        assert ours.column_names == ref.column_names
        for c in COLS:
            a, b = ours.column(c), ref.column(c)
            assert a.has_dictionary == b.has_dictionary
            assert a.cardinality == b.cardinality
            assert a.min_value == b.min_value and a.max_value == b.max_value
            np.testing.assert_array_equal(np.asarray(a.fwd), np.asarray(b.fwd))
            assert np.asarray(a.fwd).dtype == np.asarray(b.fwd).dtype
            if a.has_dictionary:
                np.testing.assert_array_equal(np.asarray(a.dictionary.values, dtype=object),
                                              np.asarray(b.dictionary.values, dtype=object))
            np.testing.assert_array_equal(a.values(), b.values())


def test_port_blocks_match_jax_blocks(jax_built):
    """ids, raw, decode tables and FOR forms: the same padding contract."""
    for path in jax_built:
        ours = SegmentBlock(load_segment(path), torch.device("cpu"))
        ref = JaxBlock(jax_load(path))
        assert ours.padded == ref.padded == padded_rows(ours.num_docs)
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        for c in ("lo_region", "lo_orderdate", "lo_discount", "lo_suppkey"):
            np.testing.assert_array_equal(ours.ids(c).numpy(), np.asarray(ref.ids(c)))
            assert ours.ids(c).dtype == torch.int32
            np.testing.assert_array_equal(ours.ids(c).numpy()[ours.num_docs:],
                                          ours.segment.column(c).cardinality)
        for c in ("lo_orderdate", "lo_discount", "lo_suppkey"):
            tbl = ours.dict_values(c)
            assert tbl.shape[0] == lut_size(ours.segment.column(c).cardinality)
            np.testing.assert_array_equal(tbl.numpy(), np.asarray(ref.dict_values(c)))
        for c in ("lo_quantity", "lo_extendedprice", "lo_revenue"):
            assert not ours.segment.column(c).has_dictionary
            np.testing.assert_array_equal(ours.raw(c).numpy(), np.asarray(ref.raw(c)))
        assert ours.raw("lo_revenue").dtype == torch.float32   # f64 narrows
        base, deltas = ours.for_form("lo_quantity")
        rbase, rdeltas = ref.for_form("lo_quantity")
        assert base == rbase == 1
        assert deltas.dtype == torch.uint8
        np.testing.assert_array_equal(deltas.numpy(), np.asarray(rdeltas))
        assert ours.for_form("lo_revenue") is None and ref.for_form("lo_revenue") is None
        # decoded values, whatever the encoding
        for c in ("lo_discount", "lo_quantity"):
            np.testing.assert_array_equal(ours.values(c).numpy()[:ours.num_docs],
                                          np.asarray(ref.values(c))[:ours.num_docs])


def test_jax_reader_loads_port_segments(tmp_path):
    cols = make_columns(2 * 5000 + 3, seed=9)
    paths = build_aligned_segments(ssb_schema(), cols, str(tmp_path), "lineorder", 2,
                                   config=SegmentGeneratorConfig(
                                       no_dictionary_columns=["lo_quantity"]))
    ref_dir = tmp_path / "ref"
    ref_paths = jax_build(_jax_schema(), cols, str(ref_dir), "lineorder", 2,
                          config=JaxConfig(no_dictionary_columns=["lo_quantity"]))
    for path, ref_path in zip(paths, ref_paths):
        seg, ref = jax_load(path), jax_load(ref_path)
        assert seg.num_docs == ref.num_docs
        for c in COLS:
            a, b = seg.column(c), ref.column(c)
            for key in ("hasDictionary", "cardinality", "fwdDtype", "sorted", "minValue",
                        "maxValue", "dictHash"):
                assert a.meta.get(key) == b.meta.get(key), (c, key)
            np.testing.assert_array_equal(np.asarray(a.fwd), np.asarray(b.fwd))
            np.testing.assert_array_equal(a.values(), b.values())


def test_nulls_strings_and_types_round_trip(tmp_path):
    schema = Schema("t", [dimension("s", DataType.STRING), metric("l", DataType.LONG),
                          metric("f", DataType.FLOAT), dimension("b", DataType.BYTES),
                          metric("i", DataType.INT)])
    cols = {"s": ["x", None, "y", "x"], "l": np.array([5, -(1 << 40), 7, 5], dtype=np.int64),
            "f": np.array([1.5, 2.5, 1.5, 0.0], dtype=np.float32),
            "b": [b"\x01", b"\x02", b"\x01", b"\x03"], "i": [1, None, 3, 4]}
    path = SegmentBuilder(schema, SegmentGeneratorConfig(
        no_dictionary_columns=["l"])).build(cols, str(tmp_path), "t_0")
    seg, ref = load_segment(path), jax_load(path)
    for c in ("s", "l", "f", "b", "i"):
        np.testing.assert_array_equal(seg.column(c).values(), ref.column(c).values())
        nb, rnb = seg.column(c).null_bitmap, ref.column(c).null_bitmap
        assert (nb is None) == (rnb is None)
        if nb is not None:
            np.testing.assert_array_equal(nb, rnb)
    assert seg.column("s").null_bitmap.tolist() == [False, True, False, False]
    # the JAX writer on the same input writes the same metadata
    jschema = JSchema("t", [jdim("s", JDataType.STRING), jmetric("l", JDataType.LONG),
                            jmetric("f", JDataType.FLOAT), jdim("b", JDataType.BYTES),
                            jmetric("i", JDataType.INT)])
    from pinot_tpu.segment.writer import SegmentBuilder as JaxBuilder
    jpath = JaxBuilder(jschema, JaxConfig(no_dictionary_columns=["l"])).build(
        cols, str(tmp_path / "ref"), "t_0")
    jref = jax_load(jpath)
    for c in ("s", "l", "f", "b", "i"):
        for key in ("hasDictionary", "cardinality", "fwdDtype", "minValue", "maxValue",
                    "hasNulls"):
            assert seg.column(c).meta.get(key) == jref.column(c).meta.get(key), (c, key)


def test_segments_from_columns_loads_a_table(tmp_path):
    cols = make_columns(1000, seed=1)
    segs = segments_from_columns(ssb_schema(), cols, str(tmp_path), 4)
    assert [s.num_docs for s in segs] == [250] * 4
    assert len({s.column("lo_region").meta["dictHash"] for s in segs}) == 1
    np.testing.assert_array_equal(
        np.concatenate([s.column("lo_discount").values() for s in segs]), cols["lo_discount"])


@pytest.mark.parametrize("config", [
    dict(raw_compression="zlib"),
    dict(json_index_columns=["lo_payload"]),
    dict(text_index_columns=["lo_comment"]),
    dict(fst_index_columns=["lo_custname"]),
    dict(geo_index_pairs=["lo_lng,lo_lat"]),
], ids=["compression", "json", "text", "fst", "geo"])
def test_writer_rejects_unported_indexes(tmp_path, config):
    """The five options the port's writer once refused (it writes them since
    the search slice): the port's files equal the JAX writer's on the same
    rows, array for array (compressed columns byte for byte), with the same
    metadata."""
    import json
    import os

    from pinot_tpu.segment.writer import SegmentBuilder as JaxBuilder
    from pinot_tpu_torch.ssb import make_search_columns, search_schema
    cols = make_search_columns(3000, seed=4)
    ours = SegmentBuilder(search_schema(), SegmentGeneratorConfig(**config)).build(
        cols, str(tmp_path / "ours"), "s_0")
    theirs = JaxBuilder(JSchema.from_json(search_schema().to_json()), JaxConfig(**config)).build(
        cols, str(tmp_path / "theirs"), "s_0")
    meta = [json.load(open(os.path.join(p, "metadata.json"))) for p in (ours, theirs)]
    assert meta[0]["columns"] == meta[1]["columns"]
    assert meta[0].get("geoIndexes") == meta[1].get("geoIndexes")
    files = sorted(os.listdir(os.path.join(ours, "cols")))
    assert files == sorted(os.listdir(os.path.join(theirs, "cols")))
    written = [f for f in files if f.endswith((".fwdc.bin", ".json.npz", ".text.npz",
                                               ".fst.npz", ".geo.npz"))]
    assert written, files
    for f in written:
        a, b = (os.path.join(p, "cols", f) for p in (ours, theirs))
        if f.endswith(".bin"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
            continue
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("config, col, index", [
    (SegmentGeneratorConfig(inverted_index_columns=["lo_region"]), "lo_region", "inverted"),
    (SegmentGeneratorConfig(bloom_filter_columns=["lo_region"]), "lo_region", "bloom"),
    (SegmentGeneratorConfig(range_index_columns=["lo_discount"]), "lo_discount", "range"),
    (SegmentGeneratorConfig(star_tree_configs=[{"dimensionsSplitOrder": ["lo_region"],
                                                "functionColumnPairs": ["SUM__lo_revenue"]}]),
     None, "star_tree"),
], ids=["inverted", "bloom", "range", "star_tree"])
def test_writer_builds_ported_indexes(tmp_path, config, col, index):
    """The indexes the port writes: the JAX reader loads each, and reads what
    the port's reader reads."""
    cols = make_columns(3000, seed=4)
    path = SegmentBuilder(ssb_schema(), config).build(cols, str(tmp_path), "idx_0")
    ours, ref = load_segment(path), jax_load(path)
    if index == "star_tree":
        assert ours.has_star_tree and len(ours.star_trees) == len(ref.star_trees) == 1
        a, b = ours.star_trees[0], ref.star_trees[0]
        assert a.num_records == b.num_records and a.dims == b.dims
        for k in b.metric_arrays:
            np.testing.assert_array_equal(a.metric_arrays[k], b.metric_arrays[k])
        return
    assert ours.column(col).index_types == ref.column(col).index_types == [index]
    r_ours, r_ref = ours.column(col), ref.column(col)
    if index == "inverted":
        for i in range(r_ref.cardinality):
            np.testing.assert_array_equal(r_ours.inverted_index.doc_ids_for(i),
                                          r_ref.inverted_index.doc_ids_for(i))
    elif index == "bloom":
        for v in ["ASIA", "EUROPE", "NOWHERE", "AFRIC"]:
            assert r_ours.bloom_filter.might_contain(v) == r_ref.bloom_filter.might_contain(v)
    else:
        for lo, hi in [(0, 3), (2, 11), (5, 5)]:
            np.testing.assert_array_equal(r_ours.range_index.mask_range(lo, hi),
                                          r_ref.range_index.mask_range(lo, hi))


def test_writer_rejects_multi_value_columns(tmp_path):
    """The writer takes multi-value columns now: a STRING MV column reads
    back, through the JAX reader too, as the rows it was given."""
    schema = Schema("mv", [dimension("tags", DataType.STRING, single_value=False)])
    rows = [["x", "y"], None, ["z"]]
    path = SegmentBuilder(schema).build({"tags": rows}, str(tmp_path), "mv_0")
    for seg in (load_segment(path), jax_load(path)):
        assert [list(v) for v in seg.column("tags").values()] == [["x", "y"], ["null"], ["z"]]


def test_aligned_segments_build_on_an_executor_as_in_one_process(tmp_path):
    """`build_aligned_segments(..., executor=)` writes the same column files
    (and checksums) as the serial build, in the same order."""
    import concurrent.futures
    import filecmp
    import json
    import os
    cols = make_columns(30_000, 3)
    serial = build_aligned_segments(ssb_schema(), cols, str(tmp_path / "a"), "lo", 3)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        pooled = build_aligned_segments(ssb_schema(), cols, str(tmp_path / "b"), "lo", 3,
                                        executor=pool)
    assert [os.path.basename(p) for p in pooled] == [os.path.basename(p) for p in serial]
    for a, b in zip(serial, pooled):
        files = sorted(os.listdir(os.path.join(a, "cols")))
        assert files == sorted(os.listdir(os.path.join(b, "cols"))) and files
        assert all(filecmp.cmp(os.path.join(a, "cols", f), os.path.join(b, "cols", f),
                               shallow=False) for f in files)
        crc = [json.load(open(os.path.join(d, "creation.meta.json")))["crc"] for d in (a, b)]
        assert crc[0] == crc[1]


@pytest.mark.parametrize("values", [
    ["b", "a", "é", "", "a", "Z", "naïve ∑", "b"],
    [b"\x00\xff", b"a", b"\x00\xff", b""],
    [f"s{i % 37}" for i in range(500)],
], ids=["unicode", "bytes", "many"])
def test_string_dictionaries_equal_numpy_unique(values):
    """A string column's dictionary (a hash set and one sort) has np.unique's
    values and ids."""
    from pinot_tpu_torch.segment.dictionary import build_dictionary
    dt = DataType.BYTES if isinstance(values[0], bytes) else DataType.STRING
    d, ids = build_dictionary(values, dt)
    want, inverse = np.unique(np.array(values, dtype=object), return_inverse=True)
    assert list(d.values) == list(want)
    np.testing.assert_array_equal(ids, inverse)
