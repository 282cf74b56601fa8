"""pinot_tpu_torch's `preprocess_segment` against the JAX package's, on the CPU.

One segment of the search table (`ssb.search_schema`: lineorder with a JSON
payload, a free-text comment and a customer name) and one of the
multi-value table are written without indexes by the port's writer and
copied; each package preprocesses its copy with the same indexing config:

* for each index kind (inverted, range, bloom, JSON, text, FST, and an
  inverted index over a multi-value column) the returned changes are equal,
  every file is equal byte for byte (metadata.json and the crc too), and the
  queries that read the index answer alike, and as the same segment built
  with the config from the start;
* a second run is converged ([]), a config without the index removes it;
* a schema that gained columns backfills them with their default values.
"""

import json
import math
import os
import shutil

import pytest

from pinot_tpu.query.executor import execute_query as jax_execute
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.segment.preprocess import preprocess_segment as jax_preprocess
from pinot_tpu.table import IndexingConfig as JaxIndexing
from pinot_tpu_torch import ssb
from pinot_tpu_torch.query.executor import execute_query
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.segment.preprocess import desired_indexes, preprocess_segment
from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig
from pinot_tpu_torch.table import IndexingConfig

CPU = "cpu"
SEED = 20261117
ROWS = 3000

# (id, indexing config, queries that read the index)
KINDS = [
    ("inverted", dict(inverted_index_columns=["lo_region", "lo_discount"]),
     ["SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_discount = 2 "
      "GROUP BY lo_region ORDER BY lo_region",
      "SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_region = 'ASIA' "
      "AND lo_discount IN (1, 9) ORDER BY lo_revenue DESC LIMIT 5"]),
    ("range", dict(range_index_columns=["lo_quantity", "lo_orderdate"]),
     ["SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_quantity BETWEEN 5 AND 9",
      ssb.QUERY]),
    ("bloom", dict(bloom_filter_columns=["lo_custkey", "lo_region"]),
     ["SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_custkey = 499999",
      "SELECT COUNT(*) FROM lineorder WHERE lo_region = 'ANTARCTICA'"]),
    ("json", dict(json_index_columns=["lo_payload"]),
     [ssb.SEARCH_QUERIES["json_type"], ssb.SEARCH_QUERIES["json_array_range"]]),
    ("text", dict(text_index_columns=["lo_comment"]),
     [ssb.SEARCH_QUERIES["text_or"], ssb.SEARCH_QUERIES["text_prefix"]]),
    ("fst", dict(fst_index_columns=["lo_custname"]),
     [ssb.SEARCH_QUERIES["regexp_fst"]]),
    ("all", dict(inverted_index_columns=["lo_region"], range_index_columns=["lo_quantity"],
                 bloom_filter_columns=["lo_custkey"], json_index_columns=["lo_payload"],
                 text_index_columns=["lo_comment"], fst_index_columns=["lo_custname"]),
     [ssb.QUERY, ssb.GROUP_QUERY, ssb.SEARCH_QUERIES["text_mixed"]]),
]


def _rows_match(got, want, rel=1e-5) -> bool:
    def close(a, b):
        if isinstance(a, float) or isinstance(b, float):
            return math.isclose(a, b, rel_tol=rel, abs_tol=1e-6)
        return a == b
    return len(got) == len(want) and all(
        len(g) == len(w) and all(close(x, y) for x, y in zip(g, w)) for g, w in zip(got, want))


def _files(seg_dir: str) -> dict:
    out = {}
    for d, _, fs in os.walk(seg_dir):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), seg_dir)
            data = open(os.path.join(d, f), "rb").read()
            if rel == "creation.meta.json":
                data = json.loads(data)["crc"]
            out[rel] = data
    return out


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    cols = ssb.make_search_columns(ROWS, SEED)
    cfg = SegmentGeneratorConfig(no_dictionary_columns=["lo_custkey"],
                                 raw_cardinality_fraction=0.7)
    path = SegmentBuilder(ssb.search_schema(), cfg).build(cols, str(root), "lineorder_0")
    return path, cols


def _copies(base_path: str, tmp_path):
    out = []
    for side in ("ours", "theirs"):
        dst = str(tmp_path / side / "lineorder_0")
        shutil.copytree(base_path, dst)
        out.append(dst)
    return out


@pytest.mark.parametrize("kind, indexing, queries", KINDS, ids=[k for k, _, _ in KINDS])
def test_preprocess_matches_the_reference(base, tmp_path, kind, indexing, queries):
    ours, theirs = _copies(base[0], tmp_path)
    before = [execute_query([load_segment(ours)], sql, device=CPU).rows for sql in queries]
    changes = preprocess_segment(ours, IndexingConfig(**indexing))
    assert changes == jax_preprocess(theirs, JaxIndexing(**indexing))
    assert changes and all("added" in c for c in changes)
    assert _files(ours) == _files(theirs)
    built = SegmentBuilder(ssb.search_schema(), SegmentGeneratorConfig(
        no_dictionary_columns=["lo_custkey"], **indexing)).build(
        base[1], str(tmp_path / "built"), "lineorder_0")
    seg, jseg, bseg = load_segment(ours), jax_load(theirs), load_segment(built)
    for sql, was in zip(queries, before):
        got = execute_query([seg], sql, device=CPU).rows
        assert _rows_match(got, jax_execute([jseg], sql).rows), sql
        assert _rows_match(got, was), sql
        assert got == execute_query([bseg], sql, device=CPU).rows, sql
    for name, meta in json.load(open(os.path.join(ours, "metadata.json")))["columns"].items():
        assert sorted(meta.get("indexes", [])) == sorted(
            json.load(open(os.path.join(built, "metadata.json")))["columns"][name].get(
                "indexes", []))
    assert preprocess_segment(ours, IndexingConfig(**indexing)) == []   # converged


@pytest.mark.parametrize("keep", [dict(inverted_index_columns=["lo_region"]), {}],
                         ids=["at_once", "every_index"])
def test_preprocess_removes_what_the_config_drops(base, tmp_path, keep):
    ours, theirs = _copies(base[0], tmp_path)
    full = KINDS[-1][1]
    preprocess_segment(ours, IndexingConfig(**full))
    jax_preprocess(theirs, JaxIndexing(**full))
    changes = preprocess_segment(ours, IndexingConfig(**keep))
    assert changes == jax_preprocess(theirs, JaxIndexing(**keep))
    assert len(changes) == 6 - len(keep) and all("removed" in c for c in changes)
    assert _files(ours) == _files(theirs)
    seg = load_segment(ours)
    assert seg.column("lo_region").meta.get("indexes", []) == (["inverted"] if keep else [])
    assert execute_query([seg], ssb.SEARCH_QUERIES["text_or"], device=CPU).rows == \
        execute_query([load_segment(base[0])], ssb.SEARCH_QUERIES["text_or"], device=CPU).rows


def test_preprocess_inverted_over_a_multi_value_column(tmp_path):
    cols = ssb.make_mv_columns(2000, SEED)
    path = SegmentBuilder(ssb.mv_schema()).build(cols, str(tmp_path / "base"), "mv_0")
    copies = []
    for side in ("ours", "theirs"):
        copies.append(str(tmp_path / side / "mv_0"))
        shutil.copytree(path, copies[-1])
    indexing = dict(inverted_index_columns=["lo_tags"], range_index_columns=["lo_tags"],
                    json_index_columns=["lo_tags"])
    changes = preprocess_segment(copies[0], IndexingConfig(**indexing))
    assert changes == jax_preprocess(copies[1], JaxIndexing(**indexing)) == \
        ["lo_tags: added inverted index"]      # range and JSON take one value a row
    assert _files(copies[0]) == _files(copies[1])
    sql = ssb.MV_QUERIES["tags_eq"]
    assert _rows_match(execute_query([load_segment(copies[0])], sql, device=CPU).rows,
                       jax_execute([jax_load(copies[1])], sql).rows)


def test_preprocess_backfills_default_columns(base, tmp_path):
    ours, theirs = _copies(base[0], tmp_path)
    schema = Schema("lineorder", ssb.search_schema().fields + [
        dimension("lo_shipmode", DataType.STRING), metric("lo_tax", DataType.INT),
        metric("lo_supplycost", DataType.DOUBLE)])
    indexing = dict(inverted_index_columns=["lo_shipmode"])
    changes = preprocess_segment(ours, IndexingConfig(**indexing), schema=schema)
    assert changes == jax_preprocess(theirs, JaxIndexing(**indexing),
                                     schema=JSchema.from_json(schema.to_json()))
    assert changes[:3] == ["lo_shipmode: added default column (STRING)",
                           "lo_tax: added default column (INT)",
                           "lo_supplycost: added default column (DOUBLE)"]
    assert changes[3:] == ["lo_shipmode: added inverted index"]
    assert _files(ours) == _files(theirs)
    sql = ("SELECT lo_shipmode, COUNT(*), SUM(lo_tax), MAX(lo_supplycost) FROM lineorder "
           "GROUP BY lo_shipmode")
    got = execute_query([load_segment(ours)], sql, device=CPU).rows
    assert _rows_match(got, jax_execute([jax_load(theirs)], sql).rows)
    assert got[0][1] == ROWS


def test_desired_indexes_limits_to_what_the_encoding_supports():
    idx = IndexingConfig(inverted_index_columns=["a", "b"], range_index_columns=["a", "m"],
                         bloom_filter_columns=["b"], fst_index_columns=["a", "y"],
                         json_index_columns=["m"], text_index_columns=["m"])
    assert desired_indexes({"hasDictionary": True, "dataType": "STRING"}, "a", idx) == \
        ["inverted", "range", "fst"]
    assert desired_indexes({"hasDictionary": False}, "b", idx) == ["bloom"]
    assert desired_indexes({"hasDictionary": True, "multiValue": True}, "m", idx) == []
    assert desired_indexes({"hasDictionary": True, "dataType": "BYTES"}, "y", idx) == []
