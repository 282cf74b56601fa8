"""pinot_tpu_torch's batch ingestion against the JAX package's, on the CPU.

The same numpy-seeded SSB lineorder rows, written as files by the port's
writers (`ssb.write_lineorder_file`), are ingested by both packages:

* `ingest_file_to_segments` of a CSV, JSON-lines, Avro, Thrift, Protobuf,
  Parquet and ORC file (the last two behind `importorskip`), and the
  streaming `run_batch_ingestion` of several CSV files (segments cut across
  file boundaries, with and without aligned dictionaries), each package
  handed a local controller stub that copies each directory it is given
  before the runner removes it: the segment directories' files are equal
  byte for byte (creation.meta.json but its time), and the SQL answers are
  equal;
* the aligned output stacks in the set executor (one scan launch for Q1.1);
* the runner buffers at most `segment_rows` rows;
* the dataframe connector (`schema_from_dataframe`, `segments_from_dataframe`,
  `push_dataframe`) behind `importorskip("pandas")`;
* `RealtimePartitionConsumer` over Avro (confluent frames), Protobuf and
  Thrift messages answers as over the same rows in JSON.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest

from pinot_tpu.ingest import batch as ref_batch
from pinot_tpu.ingest import dataframe as ref_dataframe
from pinot_tpu.query.executor import execute_query as jax_execute
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.segment import load_segment as jax_load
from pinot_tpu.table import IndexingConfig as JaxIndexing
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu_torch import ssb
from pinot_tpu_torch.engine import scan
from pinot_tpu_torch.ingest import avro, batch, dataframe, stream
from pinot_tpu_torch.ingest.proto import make_proto_decoder
from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
from pinot_tpu_torch.ingest.thriftfmt import ThriftIDL, encode_struct, make_thrift_decoder
from pinot_tpu_torch.parallel import MeshQueryExecutor
from pinot_tpu_torch.query.context import compile_query
from pinot_tpu_torch.query.executor import execute_query
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.table import IndexingConfig, StreamConfig, TableConfig

CPU = "cpu"
SEED = 20261116
ROWS = 6000
DATA = os.path.join(os.path.dirname(__file__), "torch_data")
INDEXING = dict(no_dictionary_columns=["lo_custkey"], inverted_index_columns=["lo_region"],
                bloom_filter_columns=["lo_custkey"])
QUERIES = [ssb.QUERY, ssb.GROUP_QUERY, ssb.FOR_QUERY,
           "SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity < 3 "
           "ORDER BY lo_revenue DESC, lo_custkey LIMIT 5"]
TABLE = "lineorder_OFFLINE"


def _descriptor() -> bytes:
    with open(os.path.join(DATA, "lineorder.desc"), "rb") as f:
        return f.read()


class _Meta:
    def __init__(self, name):
        self.name = name


class _Catalog:
    def __init__(self, table_cfg, schema):
        self.table_configs = {TABLE: table_cfg}
        self.schemas = {table_cfg.name: schema}


class LocalController:
    """What `run_batch_ingestion` pushes to: the catalog it reads and an
    upload that copies the segment directory (the runner removes its own)."""

    def __init__(self, table_cfg, schema, store: str):
        self.catalog = _Catalog(table_cfg, schema)
        self.store = store
        self.uploaded = []

    def upload_segment(self, table, seg_dir):
        assert table == TABLE
        dst = os.path.join(self.store, os.path.basename(seg_dir))
        shutil.copytree(seg_dir, dst)
        self.uploaded.append(dst)
        return _Meta(os.path.basename(seg_dir))


def _configs(**indexing):
    return (TableConfig("lineorder", indexing=IndexingConfig(**indexing)),
            JaxTableConfig("lineorder", indexing=JaxIndexing(**indexing)))


def _schemas():
    schema = ssb.ssb_schema()
    return schema, JSchema.from_json(schema.to_json())


def assert_same_segment(ours: str, theirs: str) -> None:
    """Every file equal byte for byte, but creation.meta.json's time."""
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    for f in files:
        a, b = (open(os.path.join(p, f), "rb").read() for p in (ours, theirs))
        if f == "creation.meta.json":
            assert json.loads(a)["crc"] == json.loads(b)["crc"]
        else:
            assert a == b, f


def _rows_match(got, want, rel=1e-5) -> bool:
    def close(a, b):
        if isinstance(a, float) or isinstance(b, float):
            return math.isclose(a, b, rel_tol=rel, abs_tol=1e-6)
        return a == b
    return len(got) == len(want) and all(
        len(g) == len(w) and all(close(x, y) for x, y in zip(g, w)) for g, w in zip(got, want))


def assert_same_answers(our_dirs, their_dirs) -> None:
    segs = [load_segment(p) for p in our_dirs]
    jsegs = [jax_load(p) for p in their_dirs]
    for sql in QUERIES:
        assert _rows_match(execute_query(segs, sql, device=CPU).rows,
                           jax_execute(jsegs, sql).rows), sql


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch_files")
    cols = ssb.make_columns(ROWS, SEED)
    out = {"cols": cols, "csv_parts": []}
    for fmt in ssb.LINEORDER_FORMATS:
        out[fmt] = ssb.write_lineorder_file(fmt, cols, str(root / f"lineorder.{fmt}"),
                                            descriptor_set=_descriptor())
    for i in range(3):
        part = {c: v[i * 2000:(i + 1) * 2000] for c, v in cols.items()}
        out["csv_parts"].append(ssb.write_lineorder_file(
            "csv", part, str(root / f"part_{i}.csv")))
    return out


def _frame_file(files, tmp_path, fmt: str) -> str:
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    frame = pd.DataFrame({c: v for c, v in files["cols"].items()})
    path = str(tmp_path / f"lineorder.{fmt}")
    if fmt == "parquet":
        frame.to_parquet(path)
    else:
        import pyarrow as pa
        import pyarrow.orc as orc
        orc.write_table(pa.Table.from_pandas(frame, preserve_index=False), path)
    return path


@pytest.mark.parametrize("fmt", list(ssb.LINEORDER_FORMATS) + ["parquet", "orc"])
def test_ingest_file_to_segments_matches_the_reference(files, tmp_path, fmt):
    path = files[fmt] if fmt in files else _frame_file(files, tmp_path, fmt)
    schema, jschema = _schemas()
    cfg, jcfg = _configs(**INDEXING)
    kw = dict(segment_rows=2500, prefix=f"lineorder_{fmt}")
    ours = batch.ingest_file_to_segments(schema, cfg, path, build_dir=str(tmp_path / "o"), **kw)
    theirs = ref_batch.ingest_file_to_segments(jschema, jcfg, path,
                                               build_dir=str(tmp_path / "t"), **kw)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] == \
        [f"lineorder_{fmt}_{i}" for i in range(3)]
    for a, b in zip(ours, theirs):
        assert_same_segment(a, b)
    assert sum(load_segment(p).num_docs for p in ours) == ROWS
    assert_same_answers(ours, theirs)


def test_ingest_applies_the_filter_and_transforms(files, tmp_path):
    schema, jschema = _schemas()
    cfg, jcfg = _configs()
    kw = dict(filter_expr="lo_discount > 8", column_transforms={"lo_quantity": "lo_quantity * 2"},
              prefix="t")
    ours = batch.ingest_file_to_segments(schema, cfg, files["json"],
                                         build_dir=str(tmp_path / "o"), **kw)
    theirs = ref_batch.ingest_file_to_segments(jschema, jcfg, files["json"],
                                               build_dir=str(tmp_path / "t"), **kw)
    assert_same_segment(ours[0], theirs[0])
    seg = load_segment(ours[0])
    keep = files["cols"]["lo_discount"] <= 8
    assert seg.num_docs == int(keep.sum())
    assert np.array_equal(np.asarray(seg.column("lo_quantity").values()),
                          files["cols"]["lo_quantity"][keep] * 2)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "per_segment_dicts"])
def test_run_batch_ingestion_matches_the_reference(files, tmp_path, aligned):
    schema, jschema = _schemas()
    cfg, jcfg = _configs(**INDEXING)
    ctl = LocalController(cfg, schema, str(tmp_path / "ours"))
    jctl = LocalController(jcfg, jschema, str(tmp_path / "theirs"))
    for c in (ctl, jctl):
        os.makedirs(c.store)
    kw = dict(input_paths=files["csv_parts"], table=TABLE, segment_rows=2500,
              aligned_dictionaries=aligned)
    pushed = batch.run_batch_ingestion(batch.BatchIngestionJobSpec(**kw), ctl,
                                       work_dir=str(tmp_path / "w1"))
    jpushed = ref_batch.run_batch_ingestion(ref_batch.BatchIngestionJobSpec(**kw), jctl,
                                            work_dir=str(tmp_path / "w2"))
    assert pushed == jpushed == ["lineorder_0", "lineorder_1", "lineorder_2"]
    assert os.listdir(str(tmp_path / "w1" / "batch_build")) == []   # removed once pushed
    for a, b in zip(ctl.uploaded, jctl.uploaded):
        assert_same_segment(a, b)
    assert_same_answers(ctl.uploaded, jctl.uploaded)
    segs = [load_segment(p) for p in ctl.uploaded]
    assert [s.num_docs for s in segs] == [2500, 2500, 1000]
    hashes = [s.column("lo_orderdate").meta.get("dictHash") for s in segs]
    assert (len(set(hashes)) == 1 and None not in hashes) == aligned


def test_aligned_batch_output_stacks_in_the_set_executor(files, tmp_path, monkeypatch):
    schema, _ = _schemas()
    cfg, _ = _configs(**INDEXING)
    ctl = LocalController(cfg, schema, str(tmp_path / "store"))
    os.makedirs(ctl.store)
    batch.run_batch_ingestion(batch.BatchIngestionJobSpec(
        input_paths=files["csv_parts"], table=TABLE, segment_rows=2500), ctl,
        work_dir=str(tmp_path / "w"))
    segs = [load_segment(p) for p in ctl.uploaded]
    mx = MeshQueryExecutor(device=CPU)
    plan, view = mx._plan_for_set(compile_query(ssb.QUERY, schema), segs)
    assert plan.kind == "device" and view is None
    calls = []
    real = scan.masked_sums_answer
    monkeypatch.setattr(scan, "masked_sums_answer", lambda *a: calls.append(1) or real(*a))
    got = mx.execute(segs, ssb.QUERY).rows
    assert len(calls) == 1
    c = files["cols"]
    m = ((c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19931231)
         & (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3) & (c["lo_quantity"] < 25))
    assert math.isclose(got[0][0], float((c["lo_extendedprice"][m] * c["lo_discount"][m]).sum()),
                        rel_tol=1e-5)


@pytest.mark.parametrize("segment_rows, chunk_rows", [(2500, 700), (1000, 4096), (6000, 512)])
def test_run_batch_ingestion_buffers_at_most_segment_rows(files, tmp_path, monkeypatch,
                                                          segment_rows, chunk_rows):
    schema, _ = _schemas()
    cfg, _ = _configs(**INDEXING)
    ctl = LocalController(cfg, schema, str(tmp_path / "store"))
    os.makedirs(ctl.store)
    monkeypatch.setattr(batch, "CHUNK_ROWS", chunk_rows)
    built, chunks = [], []
    real_build = batch.SegmentBuilder.build

    def build(self, columns, *a, **k):
        built.append(len(next(iter(columns.values()))))
        return real_build(self, columns, *a, **k)
    monkeypatch.setattr(batch.SegmentBuilder, "build", build)
    real_chunks = batch._iter_transformed_chunks

    def counted(*a, **k):
        for cols in real_chunks(*a, **k):
            chunks.append(len(next(iter(cols.values()))))
            yield cols
    monkeypatch.setattr(batch, "_iter_transformed_chunks", counted)
    batch.run_batch_ingestion(batch.BatchIngestionJobSpec(
        input_paths=files["csv_parts"], table=TABLE, segment_rows=segment_rows), ctl,
        work_dir=str(tmp_path / "w"))
    assert max(built) <= segment_rows and sum(built) == ROWS
    assert max(chunks) <= min(segment_rows, chunk_rows)
    assert sum(chunks) == 2 * ROWS   # the stats pass and the write pass


def test_run_batch_ingestion_of_nothing_pushes_nothing(tmp_path):
    schema, _ = _schemas()
    cfg, _ = _configs()
    empty = tmp_path / "empty.csv"
    empty.write_text(",".join(f.name for f in schema.fields) + "\n")
    ctl = LocalController(cfg, schema, str(tmp_path / "store"))
    for aligned in (True, False):
        assert batch.run_batch_ingestion(batch.BatchIngestionJobSpec(
            input_paths=[str(empty)], table=TABLE, aligned_dictionaries=aligned), ctl,
            work_dir=str(tmp_path / "w")) == []
    assert batch.ingest_file_to_segments(schema, cfg, str(empty), prefix="e",
                                         build_dir=str(tmp_path / "b")) == []


# -- the dataframe connector ----------------------------------------------------------

def test_dataframe_ingestion_matches_the_reference(files, tmp_path):
    pd = pytest.importorskip("pandas")
    c = files["cols"]
    frame = pd.DataFrame({k: v for k, v in c.items()})
    frame["lo_flag"] = np.arange(ROWS, dtype=np.uint32) % 3 == 0
    frame.loc[frame.index[::7], "lo_region"] = None
    schema = dataframe.schema_from_dataframe(frame, "lineorder",
                                             metrics=["lo_revenue", "lo_quantity"],
                                             time_column="lo_orderdate")
    jschema = ref_dataframe.schema_from_dataframe(frame, "lineorder",
                                                  metrics=["lo_revenue", "lo_quantity"],
                                                  time_column="lo_orderdate")
    assert schema.to_json() == jschema.to_json()
    parts = [frame.iloc[:2500], frame.iloc[2500:2500], frame.iloc[2500:]]
    ours = dataframe.segments_from_dataframe(parts, schema, str(tmp_path / "o"), "df",
                                             rows_per_segment=2000)
    theirs = ref_dataframe.segments_from_dataframe(parts, jschema, str(tmp_path / "t"), "df",
                                                   rows_per_segment=2000)
    assert [os.path.basename(p) for p in ours] == [f"df_{i}" for i in range(4)]
    for a, b in zip(ours, theirs):
        assert_same_segment(a, b)
    segs = [load_segment(p) for p in ours]
    sql = ("SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder "
           "GROUP BY lo_region ORDER BY lo_region")
    assert _rows_match(execute_query(segs, sql, device=CPU).rows,
                       jax_execute([jax_load(p) for p in theirs], sql).rows)
    ctl = LocalController(TableConfig("lineorder"), schema, str(tmp_path / "store"))
    os.makedirs(ctl.store)
    names = dataframe.push_dataframe(frame, schema, ctl, TABLE, str(tmp_path / "p"))
    assert len(names) == len(ctl.uploaded) == 1
    assert load_segment(ctl.uploaded[0]).num_docs == ROWS


# -- realtime decoders --------------------------------------------------------------

def _consume(tmp_path, decoder: str, messages) -> list:
    topic = f"lo_{decoder}"
    stream.MemoryStream.reset_all()
    s = stream.MemoryStream.create(topic, 1)
    for m in messages:
        s.produce(m, partition=0)
    cfg = TableConfig("lineorder", stream=StreamConfig(topic=topic, decoder=decoder))
    consumer = RealtimePartitionConsumer("lineorder__0__0__20261018T0000Z", cfg,
                                         ssb.ssb_schema(), 0, str(tmp_path / decoder),
                                         device=CPU)
    while consumer.pump(700):
        assert consumer.last_decode_path == "batch"
    view = consumer.query_segment()
    assert view.num_docs == len(messages)
    return [execute_query([view], sql, device=CPU).rows for sql in QUERIES]


def test_realtime_consumer_decodes_avro_protobuf_and_thrift(files, tmp_path):
    c = {k: v[:3000] for k, v in files["cols"].items()}
    rows = ssb.lineorder_rows(c)
    want = _consume(tmp_path, "json", ssb.json_messages(c, ssb.ssb_schema()))
    sid = avro.DEFAULT_REGISTRY.register(ssb.LINEORDER_AVRO_SCHEMA)
    assert _consume(tmp_path, "avro", [avro.encode_confluent(
        sid, ssb.LINEORDER_AVRO_SCHEMA, r) for r in rows]) == want
    desc = _descriptor()
    stream.register_decoder("lineorder_pb", make_proto_decoder(desc, "ssb.LineOrder"))
    from pinot_tpu_torch.ingest.proto import DescriptorPool, encode_message
    pool = DescriptorPool(desc)
    assert _consume(tmp_path, "lineorder_pb", [encode_message(
        pool, pool.message("ssb.LineOrder"), r) for r in rows]) == want
    stream.register_decoder("lineorder_thrift",
                            make_thrift_decoder(ssb.LINEORDER_THRIFT_IDL, "LineOrder"))
    idl = ThriftIDL(ssb.LINEORDER_THRIFT_IDL)
    assert _consume(tmp_path, "lineorder_thrift", [encode_struct(
        idl, idl.struct("LineOrder"), r) for r in rows]) == want
    with pytest.raises(NotImplementedError, match="no stream decoder"):
        _consume(tmp_path, "lineorder_orc", [b""])


def test_the_batch_lane_decodes_a_fetch_with_the_batch_decoder(files, tmp_path, monkeypatch):
    """A row stream with a batch decoder (JSON's, or one registered for a
    Thrift stream) decodes each fetch in one call and answers as per-message
    decode does; a fetch with a malformed message, or a batch decoder that
    gives another number of rows, is decoded message by message, so that
    the malformed message raises alone."""
    monkeypatch.setattr(stream, "_BATCH_DECODERS", dict(stream._BATCH_DECODERS))
    c = {k: v[:3000] for k, v in files["cols"].items()}
    rows = ssb.lineorder_rows(c)
    calls = []

    def counted(fn):
        def batch_decoder(values):
            calls.append(len(values))
            return fn(values)
        return batch_decoder

    stream.register_batch_decoder("json", counted(stream.get_batch_decoder("json")))
    messages = ssb.json_messages(c, ssb.ssb_schema())
    want = _consume(tmp_path, "json", messages)
    assert calls == [700] * 4 + [200]
    thrift = make_thrift_decoder(ssb.LINEORDER_THRIFT_IDL, "LineOrder")
    stream.register_decoder("lineorder_thrift", thrift)
    stream.register_batch_decoder("lineorder_thrift",
                                  counted(lambda values: [thrift(v) for v in values]))
    idl = ThriftIDL(ssb.LINEORDER_THRIFT_IDL)
    del calls[:]
    assert _consume(tmp_path, "lineorder_thrift", [encode_struct(
        idl, idl.struct("LineOrder"), r) for r in rows]) == want
    assert calls == [700] * 4 + [200]
    # a batch decoder that drops a row: the row decoder decodes the fetch
    stream.register_batch_decoder("json", counted(lambda values: [json.loads(v)
                                                                  for v in values[1:]]))
    del calls[:]
    assert _consume(tmp_path, "json", messages) == want
    assert calls == [700] * 4 + [200]
    stream.register_batch_decoder("json", counted(stream._json_batch_decoder))
    del calls[:]
    with pytest.raises(json.JSONDecodeError):
        _consume(tmp_path, "json", messages[:10] + [b'{"lo_quantity": '] + messages[10:20])
    assert calls == [21]


# -- the smoke's phase, rehearsed ------------------------------------------------------

def test_the_smoke_batch_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `batch` phase at 1/16 of its size (4 CSV files of
    32,768 rows, single-file tables of 16,384), the card's calls pointed at
    the CPU and its files made by `start_batch_builds`'s jobs: every answer,
    plan and launch check of the phase passes (the kernels' calls counted as
    launches)."""
    import concurrent.futures

    import torch

    import chip_smoke
    import pinot_tpu_torch.parallel.combine as combine_mod
    import pinot_tpu_torch.query.executor as executor_mod
    from pinot_tpu_torch.engine import kernels

    cpu = torch.device(CPU)
    monkeypatch.setattr(executor_mod, "resolve_device", lambda device=None: cpu)
    monkeypatch.setattr(combine_mod, "resolve_device", lambda device=None: cpu)
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
    for name, value in (("BATCH_ROWS", 131_072), ("BATCH_SEGMENT_ROWS", 32_768),
                        ("BATCH_FILE_ROWS", 16_384), ("BATCH_RUNS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)

    class Args:
        seed, trace = SEED, False
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = chip_smoke.start_batch_builds(pool, Args(), str(tmp_path))
        launches, numbers = chip_smoke.run_batch(Args(), str(tmp_path), jobs)
    # masked_sums: Q1.1 per segment (4), over the set (1), over three of the
    # format tables (the Protobuf one holds lo_quantity raw: the plain body),
    # EXPLAIN ANALYZE (4), Q1.1 over the preprocessed copies (4); the FOR sum;
    # bitmap_filter: GAPFILL's two leaves per segment (8) and over the set
    # (2), the region band (one all-bitmap mask a segment: 4); grouped_agg:
    # GAPFILL's GROUP BY per segment (4) and over the set (1), GROUP_QUERY and
    # the region band over the preprocessed copies (4 each)
    assert launches == {"masked_sums": 16, "masked_sums_fused": 1, "bitmap_filter": 14,
                        "grouped_agg": 13}
    assert numbers["ingest"]["aligned"] and numbers["ingest"]["segments"] == 4
    assert sorted(numbers["readers"]) == ["avro", "csv", "json", "pb", "thrift"]
    assert [r[0] for r in numbers["analyze_rows"]][:3] == [
        "BROKER_REDUCE(limit:10)", "COMBINE_AGGREGATE", "SEGMENT_PLAN(segments:4)"]
