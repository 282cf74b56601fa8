"""pinot_tpu_torch stands alone: no JAX, nothing of pinot_tpu, no silent CPU runs.

* A fresh interpreter imports pinot_tpu_torch, builds a table and answers a
  query on the CPU without `jax` or `pinot_tpu` ever entering sys.modules;
  so does one that runs a CSV and an Avro batch ingestion, EXPLAIN ANALYZE,
  GAPFILL and LOOKUP (and loads neither pandas nor pyarrow).
* No module of the package, nor chip_smoke.py, imports either (AST scan),
  and a server process of a `ProcessCluster` reports through `/debug` that
  neither ever entered its sys.modules after it answered a query.
* Without CUDA the default-device entry points (the join path's too) raise
  RuntimeError.
* Unported shapes raise NotImplementedError instead of taking another path;
  the shapes once refused answer as numpy (or the JAX package) does.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pinot_tpu_torch import ServerQueryExecutor, execute_query, segments_from_columns
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment import SegmentBuilder, load_segment
from pinot_tpu_torch.ssb import make_columns, ssb_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pinot_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    return segments_from_columns(ssb_schema(), make_columns(4000, seed=5),
                                 str(tmp_path_factory.mktemp("iso")), 2)


def test_subprocess_import_and_query_never_loads_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from pinot_tpu_torch import execute_query, segments_from_columns
        from pinot_tpu_torch.ssb import QUERY, GROUP_QUERY, make_columns, ssb_schema
        segs = segments_from_columns(ssb_schema(), make_columns(5000, 1), {str(tmp_path)!r}, 2)
        print(execute_query(segs, QUERY, device="cpu").rows)
        print(execute_query(segs, GROUP_QUERY, device="cpu").rows)
        print(execute_query(segs, "SELECT lo_custkey, lo_revenue FROM lineorder "
                            "WHERE lo_quantity >= 10 ORDER BY lo_revenue DESC LIMIT 7",
                            device="cpu").rows)
        from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
        from pinot_tpu_torch.ssb import JOIN_QUERIES, make_supplier, supplier_schema
        sup = segments_from_columns(supplier_schema(), make_supplier(), {str(tmp_path)!r}, 1)
        scan = make_segment_scan({{"lineorder": segs, "supplier": sup}}, device="cpu")
        schemas = {{"lineorder": ssb_schema(), "supplier": supplier_schema()}}
        result = execute_multistage(JOIN_QUERIES["join_supplier"], scan, schemas.get)
        print(result.rows, result.stats["joinStrategy"], "joinBuildMs" in result.stats)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert out.stdout.splitlines()[-2].endswith("broadcast True"), out.stdout  # the join ran


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _package_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pinot_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_module_imports_jax_or_pinot_tpu():
    files = _package_files()
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if _forbidden(m)]
    assert not bad, bad


def test_scan_covers_the_set_executor_and_the_pipeline():
    rel = {os.path.relpath(f, REPO) for f in _package_files()}
    for module in ("parallel/__init__.py", "parallel/combine.py",
                   "cluster/__init__.py", "cluster/device_server.py",
                   "query/dense_reduce.py", "query/executor.py", "engine/kernels.py",
                   "multistage/__init__.py", "multistage/planner.py",
                   "multistage/runtime.py", "multistage/shuffle.py", "engine/join_kernels.py",
                   "query/stats.py",
                   "cluster/tiering.py", "table.py", "ingest/__init__.py",
                   "ingest/vectorized.py", "ingest/stream.py", "ingest/transform.py",
                   "ingest/realtime.py", "segment/mutable_device.py", "parallel/merged.py",
                   "segment/compression.py", "segment/indexes/jsonidx.py",
                   "segment/indexes/text.py", "segment/indexes/fst.py",
                   "segment/indexes/geo.py", "upsert.py", "segment/mutable.py",
                   "query/explain.py", "query/lookup.py", "ingest/readers.py",
                   "ingest/avro.py", "ingest/thriftfmt.py", "ingest/proto.py",
                   "ingest/batch.py", "ingest/dataframe.py", "segment/preprocess.py",
                   "engine/grouped.py", "query/reduce.py", "cluster/broker.py",
                   "cluster/controller.py", "cluster/server.py", "cluster/enclosure.py",
                   "cluster/catalog.py", "cluster/assignment.py", "cluster/deepstore.py",
                   "cluster/routing.py", "cluster/admission.py", "query/scheduler.py",
                   "cluster/completion.py",
                   "utils/__init__.py", "utils/metrics.py", "utils/trace.py",
                   "utils/events.py", "utils/periodic.py", "config.py", "auth.py",
                   "plugins.py", "client.py", "cluster/http_service.py", "cluster/wire.py",
                   "cluster/mux.py", "cluster/remote.py", "cluster/services.py",
                   "cluster/process.py", "tools/__init__.py", "tools/admin.py",
                   "tools/segment.py", "native/__init__.py", "ingest/kafka_wire.py",
                   "ingest/kafkalite.py", "cluster/peers.py"):
        assert os.path.join("pinot_tpu_torch", module) in rel, module


def test_a_server_process_never_loads_jax(tmp_path):
    """A ProcessCluster's server process (on the CPU) answers a query through
    the HTTP broker and reports, through /debug, that neither `jax` nor
    `pinot_tpu` entered its sys.modules."""
    from pinot_tpu_torch.cluster.http_service import get_json
    from pinot_tpu_torch.cluster.process import ProcessCluster
    from pinot_tpu_torch.ssb import QUERY
    from pinot_tpu_torch.table import TableConfig
    seg = segments_from_columns(ssb_schema(), make_columns(4000, seed=7),
                                str(tmp_path / "seg"), 1)[0]
    with ProcessCluster(num_servers=1, device="cpu", work_dir=str(tmp_path / "pc"),
                        startup_timeout_s=90.0) as pc:
        pc.controller.add_schema(ssb_schema())
        pc.controller.add_table(TableConfig("lineorder"))
        pc.controller.upload_segment("lineorder_OFFLINE", seg.path)
        from conftest import wait_until
        assert wait_until(lambda: pc.query(QUERY)["numSegmentsQueried"] == 1, timeout=30.0)
        debug = get_json(f"{pc.server_url('server_0')}/debug")
    assert debug["device"] == "cpu"
    assert debug["importedPackages"] == {"jax": False, "pinot_tpu": False}


def test_subprocess_quick_cluster_query_never_loads_jax(tmp_path):
    """A QuickCluster on the CPU: upload, assign, load, and Q1.1, GROUP_QUERY
    and EXPLAIN ANALYZE through the broker, in a fresh interpreter: neither jax
    nor pinot_tpu enters sys.modules."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import pinot_tpu_torch
        from pinot_tpu_torch.ssb import QUERY, GROUP_QUERY, make_columns, ssb_schema
        from pinot_tpu_torch.table import TableConfig
        cluster = pinot_tpu_torch.QuickCluster(num_servers=2, work_dir={str(tmp_path)!r},
                                               device="cpu")
        cfg = cluster.create_table(ssb_schema(), TableConfig("lineorder", replication=2))
        cols = make_columns(6000, 1)
        for i in range(3):
            cluster.ingest_columns(cfg, {{k: v[i * 2000:(i + 1) * 2000]
                                         for k, v in cols.items()}})
        r = cluster.query(QUERY)
        print(r.rows, r.stats["numSegmentsQueried"], r.stats["partialResult"])
        print(cluster.query(GROUP_QUERY).rows[:1])
        print(len(cluster.query("EXPLAIN ANALYZE " + QUERY).rows) > 2)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert out.stdout.splitlines()[0].endswith("3 False"), out.stdout


def test_subprocess_realtime_cluster_never_loads_jax(tmp_path):
    """A REALTIME table on a QuickCluster on the CPU consumed past its flush
    threshold (a commit through the completion protocol), then made hybrid,
    queried through the broker in a fresh interpreter: neither jax nor
    pinot_tpu enters sys.modules."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from pinot_tpu_torch import QuickCluster, ssb
        from pinot_tpu_torch.ingest.stream import MemoryStream
        from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
        from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
        schema = ssb.ssb_schema()
        cluster = QuickCluster(num_servers=2, work_dir={str(tmp_path)!r}, device="cpu")
        cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=2,
                          time_column="lo_orderdate", stream=StreamConfig(
                              topic="lo_rt", decoder="columnar", flush_threshold_rows=4000))
        cluster.create_realtime_table(schema, cfg, 1)
        cols = ssb.make_columns(6000, 1)
        for lo in range(0, 6000, 2000):
            MemoryStream.get("lo_rt").produce(encode_columnar_block(
                schema, {{k: v[lo:lo + 2000] for k, v in cols.items()}}), partition=0)
            cluster.pump_realtime("lineorder_REALTIME")
        r = cluster.query("SELECT COUNT(*) FROM lineorder")
        print(r.rows, r.stats["numConsumingSegmentsQueried"], r.stats["partialResult"])
        off = TableConfig("lineorder", replication=2, time_column="lo_orderdate")
        cluster.controller.add_table(off)
        cluster.ingest_columns(off, {{k: v[:100] for k, v in cols.items()}})
        print(len(cluster.query(ssb.GROUP_QUERY).rows) > 0)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert out.stdout.splitlines()[0] == "[[6000]] 1 False", out.stdout


def test_subprocess_batch_ingestion_and_explain_analyze_never_load_jax(tmp_path):
    """A CSV and an Avro file through the streaming batch runner and the
    per-file unit, then EXPLAIN ANALYZE, GAPFILL and LOOKUP over the output,
    in a fresh interpreter: neither jax nor pinot_tpu enters sys.modules, and
    neither pandas nor pyarrow does."""
    code = textwrap.dedent(f"""
        import os, shutil, sys
        sys.path.insert(0, {REPO!r})
        from pinot_tpu_torch import execute_query, load_segment, ssb
        from pinot_tpu_torch.ingest.batch import (BatchIngestionJobSpec,
                                                  ingest_file_to_segments,
                                                  run_batch_ingestion)
        from pinot_tpu_torch.query.lookup import register_dim_table_from_segments
        from pinot_tpu_torch.segment.writer import segments_from_columns
        from pinot_tpu_torch.table import IndexingConfig, TableConfig
        work = {str(tmp_path)!r}
        cols = ssb.make_columns(4000, 3)
        csv = ssb.write_lineorder_file("csv", cols, os.path.join(work, "lo.csv"))
        avro = ssb.write_lineorder_file("avro", cols, os.path.join(work, "lo.avro"))
        cfg = TableConfig("lineorder", indexing=IndexingConfig(no_dictionary_columns=["lo_custkey"]))

        class Catalog:
            table_configs = {{"lineorder_OFFLINE": cfg}}
            schemas = {{"lineorder": ssb.ssb_schema()}}

        class Controller:
            catalog = Catalog()
            segs = []
            def upload_segment(self, table, seg_dir):
                dst = os.path.join(work, "store", os.path.basename(seg_dir))
                shutil.copytree(seg_dir, dst)
                self.segs.append(load_segment(dst))
                return self.segs[-1]

        ctl = Controller()
        print(run_batch_ingestion(BatchIngestionJobSpec(input_paths=[csv], table="lineorder_OFFLINE",
                                                        segment_rows=2000), ctl,
                                  work_dir=os.path.join(work, "job")))
        segs = [load_segment(p) for p in ingest_file_to_segments(
            ssb.ssb_schema(), cfg, avro, prefix="avro", build_dir=os.path.join(work, "avro"))]
        a = execute_query(ctl.segs, ssb.QUERY, device="cpu").rows
        b = execute_query(segs, ssb.QUERY, device="cpu").rows
        print(a, b, abs(a[0][0] - b[0][0]) <= 1e-5 * abs(b[0][0]))
        r = execute_query(ctl.segs, "EXPLAIN ANALYZE " + ssb.QUERY, device="cpu")
        print(r.columns, r.rows[0][3])
        g = execute_query(ctl.segs, "SELECT GAPFILL(lo_orderdate, 19930202, 19930210, 1), "
                          "lo_region, FILL(COUNT(*), 'FILL_DEFAULT_VALUE', 0) FROM lineorder "
                          "WHERE lo_orderdate BETWEEN 19930202 AND 19930209 "
                          "GROUP BY lo_orderdate, lo_region LIMIT 100", device="cpu")
        print("GAPFILL", len(g.rows), 8 * len({{r[1] for r in g.rows}}))
        register_dim_table_from_segments("customer", ["c_custkey"], segments_from_columns(
            ssb.customer_schema(), ssb.make_customer(1000, 3), os.path.join(work, "c"), 1))
        l = execute_query(ctl.segs, "SELECT LOOKUP('customer', 'c_nation', 'c_custkey', "
                          "lo_custkey), COUNT(*) FROM lineorder GROUP BY LOOKUP('customer', "
                          "'c_nation', 'c_custkey', lo_custkey) LIMIT 100", device="cpu")
        print("LOOKUP", sum(n for _, n in l.rows))
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "pinot_tpu", "pandas", "pyarrow"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "['lineorder_0', 'lineorder_1']", out.stdout
    assert lines[1].endswith("True"), out.stdout
    assert lines[2] == "['Operator', 'Operator_Id', 'Parent_Id', 'Rows', 'Ms'] 1", out.stdout
    n, want = map(int, lines[3].split()[1:])
    assert n == want > 0 and lines[4] == "LOOKUP 4000", out.stdout
    assert lines[-1] == "BAD []", out.stdout


def test_subprocess_realtime_consumer_and_mixed_set_never_load_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from pinot_tpu_torch import execute_query, segments_from_columns
        from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
        from pinot_tpu_torch.ingest.stream import MemoryStream
        from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
        from pinot_tpu_torch.parallel import MeshQueryExecutor
        from pinot_tpu_torch.ssb import QUERY, make_columns, ssb_schema
        from pinot_tpu_torch.table import StreamConfig, TableConfig
        schema = ssb_schema()
        segs = segments_from_columns(schema, make_columns(5000, 1), {str(tmp_path)!r}, 2)
        cols = make_columns(3000, 2)
        stream = MemoryStream.create("lo", 1)
        for lo in range(0, 3000, 1000):
            stream.produce(encode_columnar_block(
                schema, {{c: v[lo:lo + 1000] for c, v in cols.items()}}), partition=0)
        cfg = TableConfig("lineorder", stream=StreamConfig(
            topic="lo", decoder="columnar",
            properties={{"realtime.ingest.device.staging": "true"}}))
        consumer = RealtimePartitionConsumer("lineorder__0__0__20261017T0000Z", cfg, schema,
                                             0, {str(tmp_path)!r}, device="cpu")
        print(consumer.pump())
        view = consumer.query_segment()
        print(execute_query([view], QUERY, device="cpu").rows)
        print(MeshQueryExecutor(device="cpu").execute(segs + [view], QUERY).rows)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert out.stdout.splitlines()[0] == "3000", out.stdout


def test_subprocess_upsert_consumer_never_loads_jax(tmp_path):
    """An upsert table consumed row by row into the MutableSegment, committed
    and queried under its valid-doc masks, without JAX."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from pinot_tpu_torch import execute_query, load_segment, ssb
        from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
        from pinot_tpu_torch.ingest.stream import MemoryStream
        from pinot_tpu_torch.table import IndexingConfig, StreamConfig, TableConfig, UpsertConfig
        from pinot_tpu_torch.upsert import TableUpsertMetadataManager
        schema = ssb.upsert_schema()
        stream = MemoryStream.create("up", 1)
        for m in ssb.json_messages(ssb.make_upsert_events(3000, 400, 1), schema):
            stream.produce(m, partition=0)
        cfg = TableConfig("lineorder", stream=StreamConfig(topic="up", flush_threshold_rows=2000),
                          indexing=IndexingConfig(inverted_index_columns=["lo_region"]),
                          upsert=UpsertConfig(comparison_column="lo_ts"))
        up = TableUpsertMetadataManager()
        first = RealtimePartitionConsumer("lineorder__0__0__20261017T0000Z", cfg, schema, 0,
                                          {str(tmp_path)!r}, upsert=up)
        first.pump(max_messages=2000)
        seg = load_segment(first.build_immutable())
        rest = RealtimePartitionConsumer("lineorder__0__1__20261017T0000Z", cfg, schema,
                                         first.offset, {str(tmp_path)!r}, upsert=up)
        rest.pump()
        print(type(rest.mutable).__name__, rest.last_decode_path)
        print(execute_query([seg, rest.query_segment()], "SELECT COUNT(*) FROM lineorder",
                            device="cpu", upsert=up).rows)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    lines = out.stdout.splitlines()
    assert lines[0] == "MutableSegment row", out.stdout
    import pinot_tpu_torch.ssb as ssb
    assert lines[1] == f"[[{len(np.unique(ssb.make_upsert_events(3000, 400, 1)['lo_orderkey']))}]]"


def test_realtime_entry_points_without_cuda_raise(monkeypatch):
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
    from pinot_tpu_torch.table import StreamConfig, TableConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMutableSegment("s", ssb_schema(), device_staging=True)
    MemoryStream.create("iso_lo", 1)
    cfg = TableConfig("lineorder", stream=StreamConfig(
        topic="iso_lo", properties={"realtime.ingest.device.staging": "true"}))
    with pytest.raises(RuntimeError, match="CUDA"):
        RealtimePartitionConsumer("lineorder__0__0__20261017T0000Z", cfg, ssb_schema(), 0,
                                  "unused")
    # the CPU only when asked for
    assert DeviceMutableSegment("s", ssb_schema(), device_staging=True,
                                device="cpu").device.type == "cpu"


def test_subprocess_set_executor_and_pipeline_never_load_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from pinot_tpu_torch import segments_from_columns
        from pinot_tpu_torch.cluster import DeviceQueryPipeline
        from pinot_tpu_torch.parallel import MeshQueryExecutor
        from pinot_tpu_torch.query.context import compile_query
        from pinot_tpu_torch.ssb import QUERY, make_columns, ssb_schema
        segs = segments_from_columns(ssb_schema(), make_columns(5000, 1), {str(tmp_path)!r}, 3)
        mx = MeshQueryExecutor(device="cpu")
        print(mx.execute(segs, QUERY).rows)
        pipeline = DeviceQueryPipeline(mesh_exec=mx)
        try:
            print(pipeline.execute_partial(compile_query(QUERY, segs[0].schema), segs).scalar)
            topk = ("SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
                    "ORDER BY lo_revenue DESC LIMIT 7")
            print(pipeline.execute_partial(compile_query(topk, segs[0].schema), segs).rows)
            print(pipeline.stats()["topkLaunches"])
        finally:
            pipeline.stop()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert out.stdout.splitlines()[-2] == "1", out.stdout   # the stacked top-k ran


def test_subprocess_high_cardinality_group_by_and_dense_partial_never_load_jax(tmp_path):
    """A GROUP BY over 6,000 keys per segment, over the set, and as a server
    partial through the pipeline (the array-form DensePartial), merged and
    reduced, in a fresh interpreter without JAX."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        sys.path.insert(0, {REPO!r})
        from pinot_tpu_torch import execute_query
        from pinot_tpu_torch.cluster import DeviceQueryPipeline
        from pinot_tpu_torch.parallel import MeshQueryExecutor
        from pinot_tpu_torch.query.aggregates import make_agg
        from pinot_tpu_torch.query.context import compile_query
        from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
        from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
        from pinot_tpu_torch.segment import load_segment
        from pinot_tpu_torch.segment.writer import build_aligned_segments
        rng = np.random.default_rng(3)
        k = np.concatenate([np.arange(6000), rng.integers(0, 6000, 14000)]).astype(np.int32)
        schema = Schema("t", [dimension("k", DataType.INT), metric("q", DataType.INT)])
        segs = [load_segment(p) for p in build_aligned_segments(
            schema, {{"k": k, "q": (k % 7).astype(np.int32)}}, {str(tmp_path)!r}, "t", 4)]
        sql = "SELECT k, COUNT(*), SUM(q), MAX(q) FROM t GROUP BY k ORDER BY k LIMIT 100000"
        a = execute_query(segs, sql, device="cpu").rows
        mx = MeshQueryExecutor(device="cpu")
        b = mx.execute(segs, sql).rows
        ctx = compile_query(sql, schema)
        aggs = [make_agg(f) for f in ctx.aggregations]
        p = DeviceQueryPipeline(mesh_exec=mx)
        try:
            parts = [p.execute_partial(ctx, half) for half in (segs[:2], segs[2:])]
        finally:
            p.stop()
        print([part.dense is not None for part in parts])
        c = reduce_to_result(ctx, merge_segment_results(parts, aggs), aggs,
                             list(ctx.group_by)).rows
        print(len(a), a == b == c)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["[True, True]", "6000 True", "BAD []"], out.stdout


def test_set_executor_and_pipeline_without_cuda_raise(monkeypatch):
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshQueryExecutor()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceQueryPipeline()
    assert MeshQueryExecutor(device="cpu").device.type == "cpu"


def test_default_device_without_cuda_raises(segs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServerQueryExecutor()
    with pytest.raises(RuntimeError, match="CUDA"):
        execute_query(segs, "SELECT COUNT(*) FROM lineorder WHERE lo_discount = 3")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServerQueryExecutor(device="cuda")
    # the CPU only when asked for
    assert ServerQueryExecutor(device="cpu").device.type == "cpu"


def test_join_entry_points_without_cuda_raise(segs, monkeypatch):
    from pinot_tpu_torch.multistage import execute_multistage, hash_join, make_segment_scan
    from pinot_tpu_torch.multistage.planner import JoinSpec
    from pinot_tpu_torch.ssb import JOIN_QUERIES, supplier_schema

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = {"lineorder": segs, "supplier": []}
    with pytest.raises(RuntimeError, match="CUDA"):
        make_segment_scan(tables)
    schemas = {"lineorder": ssb_schema(), "supplier": supplier_schema()}.get
    block = {"k": np.arange(4)}
    with pytest.raises(RuntimeError, match="CUDA"):
        hash_join(block, block, JoinSpec("r", "inner", ["k"], ["k"]))
    # the CPU only when asked for; execute_multistage joins on its scan's device
    scan = make_segment_scan(tables, device="cpu")
    assert scan.device.type == "cpu"
    assert execute_multistage(JOIN_QUERIES["join_supplier"], scan, schemas).rows == []


def _hll_within(c):
    """The HLL estimate (p = 12) within 5% of the exact distinct count."""
    exact = len(np.unique(c["lo_orderdate"][c["lo_quantity"] < 25]))
    return lambda rows: abs(rows[0][0] - exact) <= 0.05 * exact


_ANSWERED = {
    # a selection filtered by a device function (SQRT), a GROUP BY on an
    # expression (a host plan) and the aggregation library: each runs, and is
    # held against numpy here (tests/test_torch_host.py and
    # tests/test_torch_aggregates.py hold such shapes against the reference)
    "selection": lambda c: lambda rows: [[r, float(v)] for r, v in rows] == [
        [r, float(v)] for r, v in zip(c["lo_region"], c["lo_revenue"]) if np.sqrt(v) > 100][:5],
    "distinctcount": lambda c: lambda rows: rows == [
        [len(np.unique(c["lo_suppkey"][c["lo_discount"] == 3]))]],
    "count_distinct": lambda c: lambda rows: rows == [[len(np.unique(c["lo_suppkey"]))]],
    "hll": _hll_within,
    "percentile": lambda c: lambda rows: rows == [[float(np.percentile(c["lo_revenue"], 90))]],
    "variance": lambda c: lambda rows: np.isclose(rows[0][0], np.var(c["lo_revenue"]),
                                                  rtol=1e-9, atol=0.0),
    "host_group_expr": lambda c: lambda rows: len(rows) == 10 and all(
        int((c["lo_custkey"] == k - 1).sum()) == n for k, n in rows),
    # JSON_MATCH over a JSON column with a JSON index (the search table)
    "json_match_index": lambda c: lambda rows: rows == [[int(sum(
        json.loads(d)["type"] == "PushEvent" for d in c["lo_payload"]))]],
}


@pytest.mark.parametrize("sql", [
    "SELECT lo_region, lo_revenue FROM lineorder WHERE SQRT(lo_revenue) > 100 LIMIT 5",
    "SELECT DISTINCTCOUNT(lo_suppkey) FROM lineorder WHERE lo_discount = 3",
    "SELECT COUNT(DISTINCT lo_suppkey) FROM lineorder",
    "SELECT DISTINCTCOUNTHLL(lo_orderdate) FROM lineorder WHERE lo_quantity < 25",
    "SELECT PERCENTILE90(lo_revenue) FROM lineorder",
    "SELECT VARPOP(lo_revenue) FROM lineorder",
    "SELECT lo_custkey + 1, COUNT(*) FROM lineorder GROUP BY lo_custkey + 1",
    "SELECT SUM(lo_revenue) FROM lineorder WHERE JSON_MATCH(lo_region, '\"$.a\"=1')",
    "SELECT COUNT(*) FROM lineorder WHERE JSON_MATCH(lo_payload, '\"$.type\"=''PushEvent''')",
], ids=["selection", "distinctcount", "count_distinct", "hll", "percentile",
        "variance", "host_group_expr", "json_match", "json_match_index"])
def test_unported_shapes_raise_not_implemented(segs, sql, request, tmp_path):
    """The shapes this package once refused (the aggregation library, JSON_MATCH
    among them) answer as numpy does. JSON_MATCH over a column that holds no
    JSON does what the JAX package does there: the same answer (no document
    parses, so none matches), or the same error."""
    case = request.node.callspec.id
    if case == "json_match":
        from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
        from pinot_tpu.segment import load_segment as jax_load
        jax_segs = [jax_load(s.path) for s in segs]
        try:
            want = JaxExecutor().execute(jax_segs, sql).rows
        except Exception as exc:   # the port must raise the same
            with pytest.raises(type(exc)):
                execute_query(segs, sql, device="cpu")
            return
        assert execute_query(segs, sql, device="cpu").rows == want == [[None]]
        return
    if case == "json_match_index":
        from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig
        from pinot_tpu_torch.ssb import make_search_columns, search_schema
        cols = make_search_columns(3000, seed=5)
        table = segments_from_columns(search_schema(), cols, str(tmp_path), 2,
                                      SegmentGeneratorConfig(json_index_columns=["lo_payload"]))
        assert table[0].column("lo_payload").json_index is not None
        rows = execute_query(table, sql, device="cpu").rows
        assert _ANSWERED[case](cols)(rows), rows
        return
    rows = execute_query(segs, sql, device="cpu").rows
    assert _ANSWERED[case](make_columns(4000, seed=5))(rows), rows


def test_null_leaf_raises_not_implemented(tmp_path):
    """IS NULL and IS NOT NULL over a column with nulls answer (the device
    filter's null leaf); a column without nulls folds them at plan time."""
    schema = Schema("t", [dimension("s", DataType.STRING), metric("v", DataType.DOUBLE)])
    path = SegmentBuilder(schema).build({"s": ["a", None, "b", "a"],
                                         "v": np.array([1.0, 2.0, 3.0, 4.0])},
                                        str(tmp_path), "t_0")
    t = [load_segment(path)]
    assert execute_query(t, "SELECT SUM(v) FROM t WHERE s IS NULL", device="cpu").rows == [[2.0]]
    assert execute_query(t, "SELECT COUNT(*), SUM(v) FROM t WHERE s IS NOT NULL",
                         device="cpu").rows == [[3, 8.0]]
    # a column without nulls folds IS NULL at plan time and runs
    assert execute_query(t, "SELECT COUNT(*) FROM t WHERE v IS NOT NULL AND v > 1",
                         device="cpu").rows == [[3]]


def test_star_tree_and_mutable_segments_raise(segs, tmp_path):
    """A star-tree segment answers from its record table, as the same rows
    without the tree do; a mutable (non-staging consuming) segment is planned
    on the host and answers."""
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.planner import plan_segment
    from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig

    cols = make_columns(500, seed=6)
    mutable = DeviceMutableSegment("consuming", ssb_schema())
    mutable.index_batch({c: v.tolist() for c, v in cols.items()})
    sql = "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder WHERE lo_discount < 5"
    plan = plan_segment(compile_query(sql, ssb_schema()), mutable)
    assert (plan.kind, plan.fallback_reason) == ("host", "mutable (consuming) segment")
    m = cols["lo_discount"] < 5
    assert execute_query([mutable], sql, device="cpu").rows == [
        [int(m.sum()), float(cols["lo_quantity"][m].sum())]]

    config = SegmentGeneratorConfig(star_tree_configs=[{
        "dimensionsSplitOrder": ["lo_region"], "functionColumnPairs": ["SUM__lo_revenue"]}])
    star = [load_segment(SegmentBuilder(ssb_schema(), config).build(
        make_columns(4000, seed=5), str(tmp_path), "star_0"))]
    assert star[0].has_star_tree
    sql = "SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder GROUP BY lo_region"
    got, want = (execute_query(t, sql, device="cpu").rows for t in (star, segs))
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert np.allclose([r[2] for r in got], [r[2] for r in want], rtol=1e-6)
