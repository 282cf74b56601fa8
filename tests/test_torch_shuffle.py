"""The multistage data plane of pinot_tpu_torch held against the JAX package's.

* Unit parity with `pinot_tpu.multistage.shuffle`: `stable_hash_key`,
  `stable_hash_codes`, `partition_groups_stable` and `partition_block_stable`
  route every key to the same partition (in this process and in interpreters
  with other `PYTHONHASHSEED`s); `trim_group_result` (HAVING, top-k) keeps the
  same groups; block and partial frames, stage contexts and join specs are
  byte- or JSON-equal; the mailbox's back-pressure, cancellation, tombstones
  and TTL sweep behave alike.
* A cluster in one process: a `ControllerService`, two `ServerService`s and a
  `BrokerService` on `device="cpu"` (the reference's `shuffle_cluster`):
  two- and three-way joins, a selection join with ORDER BY and LIMIT and the
  funnel path (`OPTION(useMailboxShuffle=false)`), each with
  `broker.shuffle.device.routing` on (local legs) and off (every leg framed
  over HTTP), against sqlite (sums at REL/ABS, counts exact); the distributed
  GROUP BY, explicit and through the doc threshold, against sqlite and the
  scatter/gather answer; `IN_SUBQUERY` with `IDSET`, the SEMI-join form and
  EXPLAIN of a join, each equal to the JAX package's broker over the same
  segment directories; the data-plane cap; a worker cancelled mid-shuffle
  fails the query with one error within a bound, and its mailboxes go after
  the TTL.
* A `ProcessCluster(device="cpu")`: a join and a distributed GROUP BY whose
  leaves and workers are separate server processes, then a worker SIGKILLed
  mid-shuffle: the query ends within a bound.
"""

import json
import math
import sqlite3
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pinot_tpu.cluster import QuickCluster as JaxQuickCluster
from pinot_tpu.multistage import runtime as jax_rt
from pinot_tpu.multistage import shuffle as jax_sh
from pinot_tpu.query.aggregates import make_agg as jax_make_agg
from pinot_tpu.query.reduce import SegmentResult as JaxSegmentResult
from pinot_tpu.schema import Schema as JSchema
from pinot_tpu.sql.ast import Function as JFunction
from pinot_tpu.sql.ast import Identifier as JIdentifier
from pinot_tpu.sql.ast import Literal as JLiteral
from pinot_tpu.sql.ast import OrderByItem as JOrderByItem
from pinot_tpu.table import TableConfig as JaxTableConfig
from pinot_tpu_torch.cluster.broker import Broker
from pinot_tpu_torch.cluster.catalog import Catalog
from pinot_tpu_torch.cluster.controller import Controller
from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
from pinot_tpu_torch.cluster.http_service import HttpError
from pinot_tpu_torch.cluster.process import BrokerClient, ControllerClient, ProcessCluster
from pinot_tpu_torch.cluster.remote import ControllerDeepStore, RemoteCatalog
from pinot_tpu_torch.cluster.server import ServerNode
from pinot_tpu_torch.cluster.services import BrokerService, ControllerService, ServerService
from pinot_tpu_torch.multistage import runtime as rt
from pinot_tpu_torch.multistage import shuffle as sh
from pinot_tpu_torch.query.aggregates import make_agg
from pinot_tpu_torch.query.reduce import SegmentResult
from pinot_tpu_torch.schema import DataType, Schema, dimension, metric
from pinot_tpu_torch.segment.writer import SegmentBuilder
from pinot_tpu_torch.sql.ast import Function, Identifier, Literal, OrderByItem
from pinot_tpu_torch.table import TableConfig

from conftest import wait_until

REL, ABS = 1e-9, 1e-6        # joins: f64 sums of the same rows in another order
# a single-table partial's sums come from the device scan in f32
# (tests/test_torch_parallel.py's tolerances)
GROUP_REL, GROUP_ABS = 1e-5, 0.05
DEADLINE_S = 60.0            # a query that hangs fails the test after this

# -- unit parity -------------------------------------------------------------

KEYS = [("x",), ("y", 3), (None,), (3,), (3.0,), (-0.0,), (float("nan"),), ("héllo", 7.5),
        (b"raw",), ([1, 2],), (True,), (12345678901,), ("", None)]


def test_stable_hash_key_and_codes_equal_the_reference():
    assert [sh.stable_hash_key(k) for k in KEYS] == [jax_sh.stable_hash_key(k) for k in KEYS]
    rng = np.random.default_rng(5)
    block = {"s": np.array([f"u{i}" for i in rng.integers(0, 50, 400)] + [None, "é", ""],
                           dtype=object),
             "i": np.concatenate([rng.integers(-5, 5, 400), [0, 1, 2]]).astype(np.int64),
             "f": np.concatenate([rng.uniform(-3, 3, 400), [np.nan, -0.0, 0.0]])}
    for keys in (["s"], ["i"], ["f"], ["s", "i", "f"]):
        assert np.array_equal(sh.stable_hash_codes(block, keys),
                              jax_sh.stable_hash_codes(block, keys)), keys
        for p in (1, 3, 8):
            ours = rt.partition_block_stable(block, keys, p)
            ref = jax_rt.partition_block_stable(block, keys, p)
            assert [len(b["i"]) for b in ours] == [len(b["i"]) for b in ref]
            for a, b in zip(ours, ref):
                assert all(np.array_equal(a[c].astype(object), b[c].astype(object))
                           for c in ("s", "i")), keys


@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_partition_groups_stable_routes_as_the_reference(p):
    groups = {(f"k{i}", i % 3): [float(i), i] for i in range(200)}
    groups.update({(i,): [1.0, 1] for i in range(50)})
    ours = SegmentResult("groups", num_docs_scanned=1234)
    ours.groups = dict(groups)
    ref = JaxSegmentResult("groups", num_docs_scanned=1234)
    ref.groups = dict(groups)
    got = sh.partition_groups_stable(ours, p)
    want = jax_sh.partition_groups_stable(ref, p)
    assert [set(g.groups) for g in got] == [set(w.groups) for w in want]
    assert [g.num_docs_scanned for g in got] == [w.num_docs_scanned for w in want]
    merged = {}
    for g in got:
        assert not set(g.groups) & set(merged)     # disjoint key ranges
        merged.update(g.groups)
    assert merged == groups


def test_routing_does_not_depend_on_the_process_hash_seed():
    """A key's partition in interpreters started with other PYTHONHASHSEEDs
    is this process's (Python's `hash()` of a str would change)."""
    keys = [(f"cust{i}", i % 5) for i in range(64)]
    want = [sh.stable_hash_key(k) % 8 for k in keys]
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "from pinot_tpu_torch.multistage.shuffle import stable_hash_key; "
            f"print(json.dumps([stable_hash_key(k) % 8 for k in {keys!r}]))")
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for seed in ("987654",):
        out = subprocess.run([sys.executable, "-c", code, repo], capture_output=True,
                             text=True, timeout=120, env={**os.environ, "PYTHONHASHSEED": seed})
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.splitlines()[-1]) == want
    assert len(set(want)) > 1


def _sum_ctx(pkg, having=True, limit=3, order=True):
    F, I, L, O = ((Function, Identifier, Literal, OrderByItem) if pkg == "ours"
                  else (JFunction, JIdentifier, JLiteral, JOrderByItem))
    call = F("sum", (I("v"),))
    stage = sh.StageCtx if pkg == "ours" else jax_sh.StageCtx
    return stage(select_items=[(I("g"), "g"), (call, "s")], group_by=[I("g")],
                 aggregations=[call], having=F("gt", (call, L(10.0))) if having else None,
                 order_by=[O(call, desc=True)] if order else [], limit=limit, offset=0)


@pytest.mark.parametrize("having,limit,order", [(True, 3, True), (False, 5, True),
                                                (True, 1 << 40, False), (False, 1 << 40, False),
                                                (False, 4, False)])
def test_trim_group_result_keeps_the_reference_groups(having, limit, order):
    groups = {(f"g{i}",): [float((i * 7) % 30)] for i in range(30)}
    out = {}
    for pkg, mod, result, agg in (("ours", sh, SegmentResult, make_agg),
                                  ("ref", jax_sh, JaxSegmentResult, jax_make_agg)):
        ctx = _sum_ctx(pkg, having, limit, order)
        merged = result("groups", num_docs_scanned=30)
        merged.groups = dict(groups)
        trimmed = mod.trim_group_result(ctx, merged, [agg(ctx.aggregations[0])])
        out[pkg] = (trimmed.groups, trimmed is merged)
    assert out["ours"] == out["ref"]


def test_block_and_partial_frames_are_byte_equal():
    rng = np.random.default_rng(9)
    block = {"o.k": np.array([f"c{i}" for i in rng.integers(0, 9, 70_000)], dtype=object),
             "o.v": rng.uniform(0, 1, 70_000), "o.q": rng.integers(0, 9, 70_000).astype(np.int32)}
    ours = [sh.frame_bytes(f) for f in sh.block_frames(block)]
    ref = [jax_sh.frame_bytes(f) for f in jax_sh.block_frames(block)]
    assert len(ours) == 3 and ours == ref
    empty = {c: v[:0] for c, v in block.items()}
    assert [sh.frame_bytes(f) for f in sh.block_frames(empty)] == \
        [jax_sh.frame_bytes(f) for f in jax_sh.block_frames(empty)]
    for kind in ("groups", "selection", "scalar"):
        a, b = SegmentResult(kind, num_docs_scanned=77), JaxSegmentResult(kind, num_docs_scanned=77)
        if kind == "groups":
            a.groups = b.groups = {(f"k{i}", i): [float(i), i] for i in range(20_000)}
        elif kind == "selection":
            a.rows = b.rows = [(f"r{i}", float(i)) for i in range(40_000)]
            a.sort_keys = b.sort_keys = [(float(i),) for i in range(40_000)]
        else:
            a.scalar = b.scalar = [3.5, 7]
        got = [sh.frame_bytes(f) for f in sh.partial_frames(a)]
        want = [jax_sh.frame_bytes(f) for f in jax_sh.partial_frames(b)]
        assert got == want, kind
        assert len(got) == {"groups": 3, "selection": 2, "scalar": 1}[kind]
    # and they decode back through either package's reader
    import io
    back = sh.read_frame(io.BytesIO(ours[1]))
    assert back["kind"] == "block" and len(back["block"]["o.v"]) == 32768


def test_stage_plans_serialize_as_the_reference():
    from pinot_tpu.multistage.planner import plan_multistage as jax_plan
    from pinot_tpu.schema import DataType as JDT
    from pinot_tpu.schema import dimension as jdim
    from pinot_tpu.schema import metric as jmetric
    from pinot_tpu_torch.multistage.planner import plan_multistage
    sql = ("SELECT c.region, COUNT(*), SUM(o.amount) FROM orders o JOIN custs c "
           "ON o.cust_id = c.cust_id AND o.qty > c.tier WHERE o.qty > 3 GROUP BY c.region "
           "HAVING COUNT(*) > 2 ORDER BY c.region DESC NULLS LAST LIMIT 7")
    ours = plan_multistage(sql, {"orders": ORDERS_SCHEMA, "custs": CUSTS_SCHEMA}.get)
    jschemas = {"orders": JSchema("orders", [jdim("cust_id"), jmetric("qty", JDT.INT),
                                             jmetric("amount", JDT.DOUBLE)]),
                "custs": JSchema("custs", [jdim("cust_id"), jdim("region"),
                                           jmetric("tier", JDT.INT)])}
    ref = jax_plan(sql, jschemas.get)
    assert sh.stage_ctx_to_json(ours.ctx) == jax_sh.stage_ctx_to_json(ref.ctx)
    assert rt.spec_to_json(ours.joins[0]) == jax_rt.spec_to_json(ref.joins[0])
    assert rt.agg_spec_to_json(rt.agg_spec_from_ctx(ours.ctx)) == \
        jax_rt.agg_spec_to_json(jax_rt.agg_spec_from_ctx(ref.ctx))
    back = sh.stage_ctx_from_json(sh.stage_ctx_to_json(ours.ctx))
    assert sh.stage_ctx_to_json(back) == sh.stage_ctx_to_json(ours.ctx)
    spec = rt.spec_from_json(rt.spec_to_json(ours.joins[0]))
    assert rt.spec_to_json(spec) == rt.spec_to_json(ours.joins[0])
    agg = rt.agg_spec_from_json(rt.agg_spec_to_json(rt.agg_spec_from_ctx(ours.ctx)))
    assert rt.agg_spec_to_json(agg) == rt.agg_spec_to_json(rt.agg_spec_from_ctx(ours.ctx))


def test_mailbox_backpressure_cancellation_and_tombstones(monkeypatch):
    box = sh._Mailbox(window=2)
    box.put(("block", 1))
    box.put(("block", 2))
    done = []
    t0 = time.time()
    producer = threading.Thread(target=lambda: (box.put(("block", 3), timeout_s=10),
                                                done.append(time.time() - t0)))
    producer.start()
    time.sleep(0.3)
    assert not done                       # held at the full window
    assert box.get() == ("block", 1)
    producer.join(timeout=5)
    assert done and done[0] >= 0.25
    # a cancel wakes a blocked producer and any later consumer
    box = sh._Mailbox(window=1)
    box.put(("block", 1))
    errs = []

    def blocked():
        try:
            box.put(("block", 2), timeout_s=30)
        except sh.MailboxCancelled:
            errs.append("producer")
    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.1)
    box.cancelled.set()
    t.join(timeout=5)
    assert errs == ["producer"]
    with pytest.raises(sh.MailboxCancelled):
        box.get(timeout_s=30)
    # a stalled consumer times out instead of waiting forever
    with pytest.raises(TimeoutError):
        sh._Mailbox().get(timeout_s=0.3)
    # a cancelled query's tombstone refuses new mailboxes until the TTL
    reg = sh.MailboxRegistry()
    kept = reg.open("qlive", "join0.L.0")
    reg.open("qdead", "join0.R.1")
    reg.cancel_query("qdead")
    with pytest.raises(sh.MailboxCancelled):
        reg.open("qdead", "join0.L.0")
    monkeypatch.setattr(sh, "MAILBOX_TTL_S", 0.2)
    time.sleep(0.3)
    kept.last_active = time.time()        # a live query's box is not idle
    reg.open("qother", "agg0.A.0")        # any open sweeps
    assert ("qdead", "join0.R.1") not in reg._boxes and "qdead" not in reg._cancelled
    assert ("qlive", "join0.L.0") in reg._boxes
    reg.open("qdead", "join0.L.0")        # the tombstone is gone with the TTL


# -- a cluster in one process --------------------------------------------------

RNG = np.random.default_rng(42)
N_ORDERS = 2000
ORDERS = {"cust_id": [f"c{i}" for i in RNG.integers(0, 100, N_ORDERS)],
          "qty": RNG.integers(1, 20, N_ORDERS).astype(np.int32),
          "amount": np.round(RNG.uniform(1, 500, N_ORDERS), 2)}
CUSTS = {"cust_id": [f"c{i}" for i in range(80)],
         "region": [["east", "west", "north"][i % 3] for i in range(80)],
         "tier": RNG.integers(1, 4, 80).astype(np.int32)}
REGIONS = {"region": ["east", "west", "north"], "zone": ["Z1", "Z2", "Z1"]}
ORDERS_SCHEMA = Schema("orders", [dimension("cust_id"), metric("qty", DataType.INT),
                                  metric("amount", DataType.DOUBLE)])
CUSTS_SCHEMA = Schema("custs", [dimension("cust_id"), dimension("region"),
                                metric("tier", DataType.INT)])
REGIONS_SCHEMA = Schema("regions", [dimension("region"), dimension("zone")])
TABLES = [(ORDERS_SCHEMA, ORDERS, 4), (CUSTS_SCHEMA, CUSTS, 2), (REGIONS_SCHEMA, REGIONS, 1)]


def _slice(cols, lo, hi):
    return {k: (v[lo:hi] if isinstance(v, np.ndarray) else list(v[lo:hi]))
            for k, v in cols.items()}


def _build(tmp, tables):
    """Segment directories of each table, built once: {schema name: [dirs]}."""
    out = {}
    for schema, cols, n_segs in tables:
        n = len(next(iter(cols.values())))
        step = (n + n_segs - 1) // n_segs
        out[schema.name] = [SegmentBuilder(schema).build(
            _slice(cols, lo, lo + step), str(tmp / f"b_{schema.name}_{si}"),
            f"{schema.name}_{si}") for si, lo in enumerate(range(0, n, step))]
    return out


def _sqlite(tables):
    db = sqlite3.connect(":memory:", check_same_thread=False)
    for schema, cols, _ in tables:
        names = [f.name for f in schema.fields]
        db.execute(f"CREATE TABLE {schema.name} ({', '.join(names)})")
        rows = zip(*[[v.item() if isinstance(v, np.generic) else v for v in cols[c]]
                     for c in names])
        db.executemany(f"INSERT INTO {schema.name} VALUES ({', '.join('?' * len(names))})",
                       list(rows))
    return db


def _norm(rows):
    return sorted([[float(v) if isinstance(v, (int, float)) and not isinstance(v, bool)
                    else v for v in r] for r in rows],
                  key=lambda r: [(x is None, str(type(x)), x) for x in r])


def _match(got, want, ordered=False, rel=REL, abs_=ABS) -> bool:
    a, b = (list(map(list, got)), list(map(list, want))) if ordered else (_norm(got), _norm(want))
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, (int, float)) and isinstance(y, (int, float)):
                if not math.isclose(float(x), float(y), rel_tol=rel, abs_tol=abs_):
                    return False
            elif x != y:
                return False
    return True


def _oracle(db, sql):
    import re
    return db.execute(re.sub(r" LIMIT \d+", "", sql.split(" OPTION")[0])).fetchall()


@pytest.fixture(scope="module")
def shuffle_cluster(tmp_path_factory):
    """Controller, 2 servers and a broker as services in this process, on
    the CPU; orders in 4 segments over both servers (replication 1), so
    every join crosses between them. Beside it the JAX package's
    QuickCluster over the same segment directories."""
    tmp = tmp_path_factory.mktemp("shuffle")
    dirs = _build(tmp, TABLES)
    catalog = Catalog()
    controller = Controller("controller_0", catalog, LocalDeepStore(str(tmp / "deepstore")),
                            str(tmp / "c"))
    csvc = ControllerService(controller)
    services, catalogs, nodes = [csvc], [], []
    try:
        for i in range(2):
            rc = RemoteCatalog(csvc.url, poll_timeout_s=1.0)
            catalogs.append(rc)
            node = ServerNode(f"server_{i}", rc, ControllerDeepStore(csvc.url),
                              str(tmp / f"s{i}"), device="cpu")
            services.append(ServerService(node))
            nodes.append(node)
        brc = RemoteCatalog(csvc.url, poll_timeout_s=1.0)
        catalogs.append(brc)
        broker = Broker("broker_0", brc, device="cpu")
        broker.stage_timeout_s = 30.0
        bsvc = BrokerService(broker)
        services.append(bsvc)
        cc = ControllerClient(csvc.url)
        jax = JaxQuickCluster(num_servers=2, work_dir=str(tmp / "jax"))
        for schema, _, _ in TABLES:
            cc.add_schema(schema)
            cc.add_table(TableConfig(schema.name, replication=1))
            jax.create_table(JSchema.from_json(schema.to_json()), JaxTableConfig(schema.name))
            for d in dirs[schema.name]:
                cc.upload_segment(f"{schema.name}_OFFLINE", d)
                jax.controller.upload_segment(f"{schema.name}_OFFLINE", d)
        bc = BrokerClient(bsvc.url)
        counts = {"orders": N_ORDERS, "custs": 80, "regions": 3}
        # the broker's catalog mirror routes every segment, not only the servers
        assert wait_until(lambda: all(
            bc.query(f"SELECT COUNT(*) FROM {t}")["resultTable"]["rows"] == [[n]]
            for t, n in counts.items()), timeout=30, interval=0.1)
        yield {"broker": broker, "bc": bc, "db": _sqlite(TABLES), "nodes": nodes,
               "jax": jax, "catalog": catalog}
    finally:
        for rc in catalogs:
            rc.close()
        for s in services:
            s.stop()


def _set_config(cluster, key: str, value) -> None:
    """A cluster config set on the controller's catalog, once the broker's
    mirror shows it (a mirror refresh in flight would otherwise undo a write
    made to the mirror)."""
    prop = f"clusterConfig/{key}"
    cluster["catalog"].put_property(prop, value)
    assert wait_until(lambda: cluster["broker"].catalog.get_property(prop) == value,
                      timeout=20, interval=0.02)


@pytest.fixture(params=["device_routing", "framed"])
def routing(request, shuffle_cluster):
    """`broker.shuffle.device.routing` on (legs between the in-process
    servers skip the codec) or off (every leg framed over HTTP)."""
    from pinot_tpu_torch.utils.metrics import get_registry
    local = get_registry().counter("pinot_server_mailbox_local_sends")
    framed = get_registry().counter("pinot_server_mailbox_frames")
    _set_config(shuffle_cluster, "broker.shuffle.device.routing",
                "true" if request.param == "device_routing" else "false")
    before = (local.value, framed.value)
    yield request.param
    moved = (local.value - before[0], framed.value - before[1])
    _set_config(shuffle_cluster, "broker.shuffle.device.routing", None)
    if request.param == "device_routing":
        assert moved[0] > 0 and moved[1] == 0, moved
    else:
        assert moved[0] == 0 and moved[1] > 0, moved


def _query(bc, sql):
    resp = bc.query(sql, timeout=DEADLINE_S)
    if "error" in resp:
        raise RuntimeError(resp["error"])
    return resp, resp["resultTable"]["rows"]


JOINS = {
    "two_way": ("SELECT c.region, COUNT(*), SUM(o.amount) FROM orders o "
                "JOIN custs c ON o.cust_id = c.cust_id WHERE o.qty > 3 "
                "GROUP BY c.region LIMIT 100"),
    "two_way_left": ("SELECT c.region, c.tier, SUM(o.qty), MIN(o.amount) FROM orders o "
                     "LEFT JOIN custs c ON o.cust_id = c.cust_id GROUP BY c.region, c.tier "
                     "LIMIT 100"),
    "three_way": ("SELECT r.zone, COUNT(*), SUM(o.amount) FROM orders o "
                  "JOIN custs c ON o.cust_id = c.cust_id "
                  "JOIN regions r ON c.region = r.region GROUP BY r.zone LIMIT 1000"),
    "scalar": ("SELECT COUNT(*), SUM(o.amount), MAX(o.qty) FROM orders o "
               "JOIN custs c ON o.cust_id = c.cust_id WHERE c.tier = 2"),
}


@pytest.mark.parametrize("qid", sorted(JOINS))
def test_mailbox_join_matches_sqlite(shuffle_cluster, routing, qid):
    """Through the server-to-server shuffle, with the data-plane cap at one
    byte (the funnel path would trip it): the answer is sqlite's."""
    sql = JOINS[qid]
    shuffle_cluster["broker"].max_data_plane_bytes = 1
    try:
        resp, got = _query(shuffle_cluster["bc"], sql)
    finally:
        shuffle_cluster["broker"].max_data_plane_bytes = None
    assert resp.get("mailboxShuffle") and resp.get("multistage"), resp.keys()
    assert resp["numStageWorkers"] == 2
    assert _match(got, _oracle(shuffle_cluster["db"], sql)), (qid, got)


def test_selection_join_order_limit(shuffle_cluster, routing):
    """A selection join with ORDER BY and LIMIT: each worker trims its
    partition, the broker merges the trimmed partials."""
    sql = ("SELECT o.cust_id, o.amount, c.region FROM orders o "
           "JOIN custs c ON o.cust_id = c.cust_id ORDER BY o.amount DESC, o.cust_id LIMIT 10")
    resp, got = _query(shuffle_cluster["bc"], sql)
    assert resp.get("mailboxShuffle")
    assert _match(got, shuffle_cluster["db"].execute(sql).fetchall(), ordered=True)


def test_funnel_path_option_and_data_plane_cap(shuffle_cluster, routing):
    """OPTION(useMailboxShuffle=false) takes the funnel path: each partition
    on a server's POST /stage; under a data-plane cap it fails with a clear
    error while the mailbox path still answers."""
    from pinot_tpu_torch.utils.metrics import get_registry
    bc, db, broker = shuffle_cluster["bc"], shuffle_cluster["db"], shuffle_cluster["broker"]
    sql = ("SELECT c.region, COUNT(*), SUM(o.amount) FROM orders o "
           "JOIN custs c ON o.cust_id = c.cust_id GROUP BY c.region "
           "LIMIT 100 OPTION(useMailboxShuffle=false)")
    reg = get_registry()
    before = (reg.counter("pinot_server_join_stages").value,
              reg.counter("pinot_broker_data_plane_bytes").value,
              reg.counter("pinot_broker_stage_dispatch_failures").value)
    resp, got = _query(bc, sql)
    assert "mailboxShuffle" not in resp and resp.get("multistage")
    assert _match(got, _oracle(db, sql))
    assert reg.counter("pinot_server_join_stages").value > before[0]
    assert reg.counter("pinot_broker_data_plane_bytes").value > before[1]
    assert reg.counter("pinot_broker_stage_dispatch_failures").value == before[2]
    broker.max_data_plane_bytes = 4096
    try:
        with pytest.raises(HttpError, match="data-plane memory cap"):
            _query(bc, sql)
        resp, got = _query(bc, sql.split(" OPTION")[0])
        assert resp.get("mailboxShuffle")
        assert _match(got, _oracle(db, sql))
    finally:
        broker.max_data_plane_bytes = None


def test_distributed_group_by_partitions_the_key_space(shuffle_cluster):
    """OPTION(distributedGroupBy=true): exact rows against sqlite and the
    scatter/gather answer; HAVING, ORDER BY and LIMIT through the workers'
    trim on disjoint key ranges; with device routing the in-process
    exchange collapses to one partition, pinned partitions stay framed."""
    bc, db = shuffle_cluster["bc"], shuffle_cluster["db"]
    boxes = len(sh.REGISTRY._boxes)
    sql = ("SELECT cust_id, COUNT(*), SUM(amount), MIN(qty) FROM orders WHERE qty > 2 "
           "GROUP BY cust_id LIMIT 100000")
    for opt, routed in ((" OPTION(distributedGroupBy=true)", True),
                        (" OPTION(distributedGroupBy=true, numPartitions=3)", None)):
        resp, got = _query(bc, sql + opt)
        assert resp.get("distributedGroupBy") and resp.get("deviceRoutedShuffle") is routed
        assert resp["numStageWorkers"] == (1 if routed else 2)
        assert _match(got, _oracle(db, sql), rel=GROUP_REL, abs_=GROUP_ABS)
    _, plain = _query(bc, sql)
    assert _match(got, plain)
    top = ("SELECT cust_id, SUM(amount) AS total FROM orders GROUP BY cust_id "
           "HAVING total > 2000 ORDER BY total DESC LIMIT 7")
    resp, got = _query(bc, top + " OPTION(useMultistageEngine=true, numPartitions=4)")
    assert resp.get("distributedGroupBy")
    assert _match(got, db.execute(top).fetchall(), ordered=True, rel=GROUP_REL, abs_=GROUP_ABS)
    assert len(sh.REGISTRY._boxes) <= boxes   # every mailbox of these queries drained


def test_distributed_group_by_through_the_doc_threshold(shuffle_cluster):
    bc = shuffle_cluster["bc"]
    sql = "SELECT cust_id, COUNT(*) FROM orders GROUP BY cust_id LIMIT 100000"
    _set_config(shuffle_cluster, "broker.distributedGroupByDocThreshold", "100")
    try:
        resp, got = _query(bc, sql)
        assert resp.get("distributedGroupBy")
        assert _match(got, _oracle(shuffle_cluster["db"], sql))   # counts: exact
    finally:
        _set_config(shuffle_cluster, "broker.distributedGroupByDocThreshold", None)
    resp, _ = _query(bc, sql)
    assert "distributedGroupBy" not in resp


@pytest.mark.parametrize("sql", [
    "SELECT COUNT(*), SUM(amount) FROM orders WHERE IN_SUBQUERY(cust_id, "
    "'SELECT IDSET(cust_id) FROM custs WHERE region = ''east''') AND qty < 15",
    "SELECT COUNT(*), SUM(amount) FROM orders WHERE cust_id IN "
    "(SELECT cust_id FROM custs WHERE region = 'east') AND qty < 15",
    "SELECT qty, COUNT(*) FROM orders WHERE cust_id NOT IN "
    "(SELECT cust_id FROM custs WHERE tier = 1) GROUP BY qty ORDER BY qty LIMIT 100",
], ids=["in_subquery_idset", "semi_join", "anti_join"])
def test_in_subqueries_equal_the_jax_broker(shuffle_cluster, sql):
    resp, got = _query(shuffle_cluster["bc"], sql)
    want = shuffle_cluster["jax"].query(sql).rows
    assert _match(got, want), (got, want)
    if "IN_SUBQUERY" in sql:
        assert "mailboxShuffle" not in resp     # the id set rewrote it: one stage
        oracle = ("SELECT COUNT(*), SUM(amount) FROM orders WHERE cust_id IN (SELECT cust_id "
                  "FROM custs WHERE region = 'east') AND qty < 15")
        assert _match(got, shuffle_cluster["db"].execute(oracle).fetchall(),
                      rel=GROUP_REL, abs_=GROUP_ABS)
    else:
        assert resp.get("mailboxShuffle")
        assert _match(got, _oracle(shuffle_cluster["db"], sql))


def test_explain_of_a_join_equals_the_jax_broker(shuffle_cluster):
    for sql in ("EXPLAIN PLAN FOR " + JOINS["three_way"],
                "EXPLAIN PLAN FOR SELECT o.cust_id FROM orders o JOIN custs c "
                "ON o.cust_id = c.cust_id WHERE c.region = 'west' LIMIT 5"):
        resp, got = _query(shuffle_cluster["bc"], sql)
        assert got == [list(r) for r in shuffle_cluster["jax"].query(sql).rows]
    # a join streams whole, as one batch
    stream = list(shuffle_cluster["broker"].stream_query(JOINS["two_way"]))
    assert stream[0][0] == "schema" and _match(stream[1][1],
                                               _oracle(shuffle_cluster["db"], JOINS["two_way"]))


def test_a_worker_cancelled_mid_shuffle_fails_cleanly_and_its_mailboxes_go(
        shuffle_cluster, monkeypatch):
    """Every mailbox of the query cancelled while it runs (what a dead
    worker's cancellation does): one error within the bound, never a hang;
    the cluster answers afterwards; the cancelled boxes and tombstones go
    after the TTL."""
    bc = shuffle_cluster["bc"]
    sql = JOINS["two_way"]
    results, stop, seen = [], threading.Event(), set()

    def run():
        try:
            results.append(("ok", _query(bc, sql)[1]))
        except Exception as e:
            results.append(("err", str(e)))

    def killer():
        while not stop.is_set():
            for key in list(sh.REGISTRY._boxes):
                seen.add(key[0])
                sh.REGISTRY.cancel_query(key[0])
            time.sleep(0.002)

    kt = threading.Thread(target=killer, daemon=True)
    kt.start()
    t0 = time.time()
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=DEADLINE_S)
    stop.set()
    kt.join(timeout=5)
    assert not t.is_alive(), "the query hung after its mailboxes were cancelled"
    assert time.time() - t0 < shuffle_cluster["broker"].stage_timeout_s
    kind, payload = results[0]
    if kind == "err":
        assert any(w in payload.lower() for w in ("cancel", "stage worker failed", "truncated")), \
            payload
    else:   # the cancel landed after the last frame: the answer is whole
        assert _match(payload, _oracle(shuffle_cluster["db"], sql))
    assert seen
    with monkeypatch.context() as m:
        m.setattr(sh, "MAILBOX_TTL_S", 0.05)
        time.sleep(0.1)
        with sh.REGISTRY._lock:
            sh.REGISTRY._gc_locked()
    assert not any(q in seen for q, _ in sh.REGISTRY._boxes)
    assert not seen & set(sh.REGISTRY._cancelled)
    resp, got = _query(bc, sql)
    assert resp.get("mailboxShuffle") and _match(got, _oracle(shuffle_cluster["db"], sql))


# -- a ProcessCluster: leaves and workers in separate server processes -----------

FACT_N = 60_000
_FRNG = np.random.default_rng(5)
FACT = {"k": [f"u{i}" for i in _FRNG.integers(0, 5000, FACT_N)],
        "v": np.round(_FRNG.uniform(0, 1, FACT_N), 3)}
DIMS = {"k": [f"u{i}" for i in range(5000)], "grp": [f"g{i % 7}" for i in range(5000)]}
FACT_SCHEMA = Schema("fact", [dimension("k"), metric("v", DataType.DOUBLE)])
DIM_SCHEMA = Schema("dims", [dimension("k"), dimension("grp")])
PROC_TABLES = [(FACT_SCHEMA, FACT, 4), (DIM_SCHEMA, DIMS, 2)]


@pytest.fixture(scope="module")
def proc_cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shuffle_proc")
    dirs = _build(tmp, PROC_TABLES)
    with ProcessCluster(num_servers=2, work_dir=str(tmp / "pc"), device="cpu") as pc:
        for schema, _, _ in PROC_TABLES:
            pc.controller.add_schema(schema)
            pc.controller.add_table(TableConfig(schema.name, replication=1))
            for d in dirs[schema.name]:
                pc.controller.upload_segment(f"{schema.name}_OFFLINE", d)
        assert wait_until(lambda: all(
            pc.query(f"SELECT COUNT(*) FROM {t}")["resultTable"]["rows"] == [[n]]
            for t, n in (("fact", FACT_N), ("dims", 5000))), timeout=60, interval=0.1)
        yield pc, _sqlite(PROC_TABLES)


def test_process_cluster_join_and_distributed_group_by(proc_cluster):
    """Leaves and workers in two server processes, each with its own
    PYTHONHASHSEED: the join over the framed shuffle, and the distributed
    GROUP BY with HAVING on 3 partitions (a key routed to two partitions
    would fail HAVING on both halves) and its ordered top-k."""
    pc, db = proc_cluster
    bc = pc.broker
    join = ("SELECT d.grp, COUNT(*), SUM(f.v) FROM fact f JOIN dims d ON f.k = d.k "
            "WHERE f.v < 0.9 GROUP BY d.grp LIMIT 100")
    resp, got = _query(bc, join)
    assert resp.get("mailboxShuffle") and resp["numStageWorkers"] == 2
    assert resp["joinStrategy"] == "broadcast"
    assert _match(got, _oracle(db, join))
    resp, got = _query(bc, join.replace("LIMIT 100", "LIMIT 100 OPTION(useMailboxShuffle=false)"))
    assert "mailboxShuffle" not in resp and _match(got, _oracle(db, join))
    group = ("SELECT k, COUNT(*), SUM(v) FROM fact GROUP BY k HAVING COUNT(*) >= 14 "
             "LIMIT 100000")
    resp, got = _query(bc, group + " OPTION(distributedGroupBy=true, numPartitions=3)")
    assert resp.get("distributedGroupBy") and "deviceRoutedShuffle" not in resp
    assert resp["numStageWorkers"] == 2
    want = _oracle(db, group)
    assert want and _match(got, want, rel=GROUP_REL, abs_=GROUP_ABS)
    top = ("SELECT k, SUM(v) AS total FROM fact GROUP BY k ORDER BY total DESC, k LIMIT 5")
    resp, got = _query(bc, top + " OPTION(distributedGroupBy=true)")
    assert resp.get("distributedGroupBy")
    assert _match(got, db.execute(top).fetchall(), ordered=True, rel=GROUP_REL, abs_=GROUP_ABS)


def test_process_cluster_sigkilled_worker_ends_the_query(proc_cluster):
    """SIGKILL a server that is both a leaf and a stage worker while a join
    shuffles: the query ends within the bound, with an error or (when the
    kill came after its frames) the whole answer."""
    pc, db = proc_cluster
    sql = ("SELECT d.grp, COUNT(*), SUM(f.v) FROM fact f JOIN dims d ON f.k = d.k "
           "GROUP BY d.grp LIMIT 100 OPTION(numPartitions=16)")
    results = []

    def run():
        try:
            results.append(("ok", pc.query(sql)))
        except Exception as e:
            results.append(("err", f"{type(e).__name__}: {e}"))

    t = threading.Thread(target=run)
    t0 = time.time()
    t.start()
    time.sleep(0.3)
    pc.kill_server("server_1")
    t.join(timeout=DEADLINE_S + 30)
    assert not t.is_alive(), "the query hung after a stage worker's SIGKILL"
    assert time.time() - t0 < 150
    kind, payload = results[0]
    if kind == "ok" and "error" not in payload:
        assert _match(payload["resultTable"]["rows"], _oracle(db, sql))
    else:
        assert payload
