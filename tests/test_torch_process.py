"""pinot_tpu_torch's roles as OS processes, held against the JAX package's cluster.

One `ProcessCluster(device="cpu")` a module: a controller, two server
processes on the serving pipeline (`server.device.enabled`, over the set
executor on the CPU) and a broker, joined over HTTP. The same segment
directories go to it and to the JAX package's in-process `QuickCluster`
(JAX on the CPU), both with replication 2:

* Q1.1, a GROUP BY, COUNT(*), an ORDER BY ... LIMIT, a GROUP BY of more than
  4,096 keys (its server partials ride the wire as `DensePartial`), EXPLAIN
  and EXPLAIN ANALYZE through the HTTP broker equal the JAX cluster's, at
  tests/test_torch_cluster.py's tolerances;
* two brokers in this process on the cluster's catalog, one on the mux
  transport and one wired under `broker.mux.enabled=false` (one `POST
  /query` a partial), give identical rows and stats keys, and the mux
  broker's scatter pool never runs a task;
* the admin CLI's `query` and `client.connect` answer; concurrent uploads
  converge; a server started for CUDA on this machine exits at start;
* a SIGKILLed server process: the next queries answer exactly from the
  other replica (last in the file: the cluster keeps one server).
"""

import concurrent.futures
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from pinot_tpu.cluster import QuickCluster as JaxQuickCluster
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu_torch.cluster.broker import Broker
from pinot_tpu_torch.cluster.process import ProcessCluster
from pinot_tpu_torch.cluster.remote import RemoteCatalog, RemoteServerHandle
from pinot_tpu_torch.cluster.services import BrokerService
from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY, make_columns, ssb_schema
from pinot_tpu_torch.table import TableConfig

REL, ABS = 1e-5, 0.05       # tests/test_torch_cluster.py's tolerances
ROWS, SEGMENTS, SEED = 48_000, 4, 29
TABLE = "lineorder_OFFLINE"
SUPPKEY_GROUP = ("SELECT lo_suppkey, SUM(lo_revenue), COUNT(*) FROM lineorder "
                 "GROUP BY lo_suppkey ORDER BY lo_suppkey LIMIT 100000")
QUERIES = {
    "q1_1": QUERY,
    "group_query": GROUP_QUERY,
    "count": "SELECT COUNT(*) FROM lineorder",
    "selection": ("SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
                  "ORDER BY lo_revenue DESC LIMIT 7"),
    "suppkey_group": SUPPKEY_GROUP,
    "explain": "EXPLAIN PLAN FOR " + QUERY,
    "explain_analyze": "EXPLAIN ANALYZE " + GROUP_QUERY,
}


def _wait(fn, timeout=30.0):
    from conftest import wait_until
    return wait_until(fn, timeout=timeout, interval=0.1)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = tmp_path_factory.mktemp("process")
    cols = make_columns(ROWS, SEED)
    dirs = build_aligned_segments(ssb_schema(), cols, str(root / "segments"), "lineorder",
                                  SEGMENTS, SegmentGeneratorConfig(raw_cardinality_fraction=1.0))
    cfg = TableConfig("lineorder", replication=2)
    ref = JaxQuickCluster(num_servers=2, work_dir=str(root / "ref"))
    ref.create_table(JSchema.from_json(ssb_schema().to_json()),
                     JaxTableConfig.from_json(cfg.to_json()))
    for d in dirs:
        ref.controller.upload_segment(TABLE, d)
    with ProcessCluster(num_servers=2, device="cpu", work_dir=str(root / "proc"),
                        server_config={"server.device.enabled": "true"},
                        startup_timeout_s=90.0) as pc:
        pc.controller.add_schema(ssb_schema())
        pc.controller.add_table(cfg)
        for d in dirs:
            pc.controller.upload_segment(TABLE, d)
        assert _wait(lambda: pc.controller.table_status(TABLE)["converged"])
        # the broker's catalog mirror and routing catch up with the servers'
        assert _wait(lambda: pc.query("SELECT COUNT(*) FROM lineorder")
                     ["resultTable"]["rows"] == [[ROWS]])
        yield {"ref": ref, "pc": pc, "dirs": dirs, "root": root}


def _cell_equal(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(float(a), float(b), rel_tol=REL, abs_tol=ABS)
    return a == b


def _rows_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(_cell_equal(x, y) for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


@pytest.mark.parametrize("qid", list(QUERIES))
def test_same_sql_through_the_http_broker(clusters, qid):
    sql = QUERIES[qid]
    want = clusters["ref"].query(sql)
    got = clusters["pc"].query(sql)
    rows = got["resultTable"]["rows"]
    assert got["resultTable"]["dataSchema"]["columnNames"] == want.columns
    if qid == "explain_analyze":
        # the plan and each operator's rows; the milliseconds are the runs' own
        assert [r[:4] for r in rows] == [r[:4] for r in want.rows]
        assert got["analyze"] is True
    else:
        assert _rows_equal(rows, want.rows), (rows[:5], want.rows[:5])
    if qid == "suppkey_group":
        assert len(rows) > 4096
    if qid != "explain":
        for key in ("numSegmentsQueried", "numSegmentsPruned"):
            assert got[key] == want.stats[key], key
        assert got["partialResult"] is want.stats["partialResult"] is False
        assert got["numSegmentsRetried"] == 0


def test_a_high_cardinality_partial_rides_the_wire_dense(clusters):
    """A server's partial of the GROUP BY over lo_suppkey comes back over
    both transports in array form (over POST /query its arrays are read-only
    views of the response bytes; a mux frame is a private bytearray)."""
    pc = clusters["pc"]
    segments = sorted(pc.controller.segments_meta(TABLE)["segments"])
    for use_mux in (True, False):
        handle = RemoteServerHandle(pc.server_url("server_0"), use_mux=use_mux)
        try:
            r = handle(TABLE, SUPPKEY_GROUP, segments)
        finally:
            handle.close()
        assert r.dense is not None and r.dense.num_keys_real > 4096
        assert r.dense.counts.flags.writeable is use_mux
        assert int(r.dense.counts.sum()) == ROWS


@pytest.fixture(scope="module")
def dual_brokers(clusters):
    """Two brokers in this process on the cluster's catalog: one wired while
    the cluster sets `broker.mux.enabled=false` (the legacy one exchange a
    partial, POST /query), one wired after the knob is gone (the mux)."""
    pc = clusters["pc"]
    out, catalogs = {}, []
    for name, knob in (("legacy", "false"), ("mux", None)):
        pc.controller.set_cluster_config("broker.mux.enabled", knob)
        rc = RemoteCatalog(pc.controller_url, poll_timeout_s=1.0)
        catalogs.append(rc)
        out[name] = BrokerService(Broker(f"broker_{name}", rc, max_scatter_threads=4))
    for name, svc in out.items():
        assert svc._handles and all(h.use_mux is (name == "mux")
                                    for h in svc._handles.values())
    for svc in out.values():
        assert _wait(lambda: svc.broker.handle_query(
            "SELECT COUNT(*) FROM lineorder").rows == [[ROWS]])
    yield out
    for svc in out.values():
        svc.stop()
    for rc in catalogs:
        rc.close()


def test_mux_and_legacy_transports_answer_alike(clusters, dual_brokers):
    from pinot_tpu_torch.cluster.process import BrokerClient
    clients = {name: BrokerClient(svc.url) for name, svc in dual_brokers.items()}
    deterministic = ("numDocsScanned", "numSegmentsQueried", "numServersQueried",
                     "numServersResponded", "partialResult")
    for qid in ("q1_1", "group_query", "count", "selection", "suppkey_group",
                "explain_analyze"):
        resp_m = clients["mux"].query(QUERIES[qid])
        resp_l = clients["legacy"].query(QUERIES[qid])
        if qid == "explain_analyze":
            assert ([r[:4] for r in resp_m["resultTable"]["rows"]]
                    == [r[:4] for r in resp_l["resultTable"]["rows"]])
        else:
            assert (json.dumps(resp_m["resultTable"], sort_keys=True)
                    == json.dumps(resp_l["resultTable"], sort_keys=True)), qid
        assert set(resp_m) == set(resp_l), qid
        assert "muxFrameQueueMs" in resp_m and "muxFlowControlMs" in resp_m
        for k in deterministic:
            assert resp_m[k] == resp_l[k], (qid, k)


def test_mux_dispatch_holds_no_scatter_thread(clusters, dual_brokers):
    """Concurrent queries through the mux broker: every partial is a mux
    Future (`submit_async`) and the scatter pool never runs a task; the
    legacy broker takes one pool thread a partial."""
    calls = {}
    for name, svc in dual_brokers.items():
        pool = svc.broker._pool
        orig = pool.submit
        calls[name] = []

        def spy(*a, _orig=orig, _calls=calls[name], **kw):
            _calls.append(1)
            return _orig(*a, **kw)
        pool.submit = spy
        try:
            with concurrent.futures.ThreadPoolExecutor(8) as clients:
                results = list(clients.map(lambda _: svc.broker.handle_query(GROUP_QUERY),
                                           range(16)))
        finally:
            pool.submit = orig
        assert all(r.stats["partialResult"] is False for r in results)
        assert len({json.dumps(r.rows) for r in results}) == 1
    assert calls["mux"] == [] and len(dual_brokers["mux"].broker._pool._threads) == 0
    assert len(calls["legacy"]) == 16 * 2   # one a server a query


def test_admin_cli_query_and_client_connect(clusters):
    from pinot_tpu_torch.client import connect
    pc = clusters["pc"]
    want = clusters["ref"].query(QUERY).rows
    out = subprocess.run([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "query",
                          "--broker", pc.broker_url, "--sql", QUERY, "--json"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__)))))
    assert out.returncode == 0, out.stderr
    assert _rows_equal(json.loads(out.stdout)["resultTable"]["rows"], want)
    conn = connect(pc.broker_url, controller=pc.controller_url)
    rs = conn.execute(QUERIES["count"])
    assert rs.scalar() == ROWS and rs.columns == ["count(*)"] and len(rs) == 1
    assert TABLE in conn.admin.list_tables()["tables"]


def test_query_stream_and_the_controller_sql_proxy(clusters):
    """POST /queryStream yields the columns, then the rows; the controller's
    /sql proxy answers through a live broker."""
    from pinot_tpu_torch.cluster.http_service import post_json
    pc = clusters["pc"]
    sql = QUERIES["selection"]
    want = clusters["ref"].query(sql)
    events = list(pc.broker.query_stream(sql))
    assert events[0] == ("schema", want.columns)
    assert _rows_equal([r for kind, batch in events[1:] for r in batch], want.rows)
    proxied = post_json(f"{pc.controller_url}/sql", {"sql": QUERIES["count"]})
    assert proxied["resultTable"]["rows"] == [[ROWS]]


def test_concurrent_uploads_converge(clusters):
    """Eight copies of the segments pushed at once from eight threads into a
    second table: every one ends loaded on both replicas and reported
    ONLINE, and the table answers their rows exactly."""
    pc, root = clusters["pc"], clusters["root"]
    schema = ssb_schema()
    from pinot_tpu_torch.schema import Schema
    pc.controller.add_schema(Schema("lineorder_up", list(schema.fields)))
    pc.controller.add_table(TableConfig("lineorder_up", replication=2))
    names = []
    for i, d in enumerate(clusters["dirs"] * 2):
        out = root / "copies" / f"lineorder_up_{i}"
        shutil.copytree(d, out)
        meta = out / "metadata.json"
        m = json.loads(meta.read_text())
        m["segmentName"] = f"lineorder_up_{i}"
        meta.write_text(json.dumps(m))
        names.append(str(out))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        done = list(pool.map(lambda d: pc.controller.upload_segment("lineorder_up_OFFLINE", d),
                             names))
    assert all(r["status"] == "OK" for r in done)
    assert _wait(lambda: pc.controller.table_status("lineorder_up_OFFLINE")["converged"])
    status = pc.controller.table_status("lineorder_up_OFFLINE")
    assert status["segments"] == len(names)
    assert set(status["replicas_online"].values()) == {2}
    assert _wait(lambda: pc.query("SELECT COUNT(*) FROM lineorder_up")
                 ["resultTable"]["rows"] == [[2 * ROWS]])


def test_a_cuda_server_without_a_card_exits_at_start(clusters, tmp_path):
    """Started for CUDA (the default) on a machine without a card, a server
    process exits non-zero before it is ready: it never serves on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pc = clusters["pc"]
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    out = subprocess.run(
        [sys.executable, "-m", "pinot_tpu_torch.cluster.process", "--role", "server",
         "--instance-id", "server_cuda", "--controller-url", pc.controller_url,
         "--work-dir", str(tmp_path), "--run-dir", str(run_dir)],
        capture_output=True, text=True, timeout=120, env=pc._env)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not list(run_dir.iterdir())   # no ready file
    assert "server_cuda" not in pc.controller.segments_meta(TABLE)


def test_role_routes_that_wait_answer_501(clusters):
    """The minion's task routes and the admin UI answer 501 with their
    ROADMAP.md item; the realtime routes over processes answer: a segment
    this server does not serve is a 404 from segmentData, an unknown
    segment's report a FAILED, and a realtime table without its schema a 400
    (tests/test_torch_realtime_process.py drives them end to end)."""
    from pinot_tpu_torch.cluster.http_service import HttpError, http_call, post_json
    pc = clusters["pc"]
    for url, method in ((f"{pc.controller_url}/tasks", "GET"),
                        (f"{pc.controller_url}/ui", "GET")):
        with pytest.raises(HttpError) as e:
            http_call(method, url, b"{}" if method == "POST" else None)
        assert e.value.status == 501 and "ROADMAP" in str(e.value), url
    with pytest.raises(HttpError) as e:
        http_call("GET", f"{pc.server_url('server_0')}/segmentData/{TABLE}/x")
    assert e.value.status == 404
    assert post_json(f"{pc.controller_url}/segmentConsumed",
                     {"segment": "x__0__0__1", "server": "server_0", "offset": 3}) == \
        {"status": "FAILED", "offset": 3}
    from pinot_tpu_torch.table import StreamConfig, TableType
    rt = TableConfig("no_schema", table_type=TableType.REALTIME,
                     stream=StreamConfig(topic="t"))
    with pytest.raises(HttpError) as e:
        post_json(f"{pc.controller_url}/tables", {"config": rt.to_json()})
    assert e.value.status == 400 and "schema" in str(e.value)


def test_a_killed_server_process_answers_from_its_replica(clusters):
    """SIGKILL server_1: the next queries answer exactly from server_0, the
    first through the retry round, the next with server_1 out of routing."""
    pc, ref = clusters["pc"], clusters["ref"]
    pc.kill_server("server_1")
    for attempt in range(3):
        for qid in ("q1_1", "group_query", "count"):
            got = pc.query(QUERIES[qid])
            want = ref.query(QUERIES[qid]).rows
            assert _rows_equal(got["resultTable"]["rows"], want), (attempt, qid)
            assert "segmentsUnavailable" not in got
            assert got["numSegmentsQueried"] == SEGMENTS
    last = pc.query(QUERY)
    assert last["partialResult"] is False and last["numServersQueried"] == 1
