"""pinot_tpu_torch's wire codec, mux transport, configuration and plugins
held against the JAX package's.

* The codec, differential: scalars, strings, nested containers, every ndarray
  dtype the engines emit, the three `SegmentResult` kinds with a
  `DensePartial`, the theta, t-digest and idset states and the query
  requests encode to the very bytes `pinot_tpu.cluster.wire` writes, and
  each package decodes the other's bytes to equal values.
* Zero copy: decoded arrays are views over the frame (`np.shares_memory`),
  and the reduce takes the read-only partials a frame decodes to.
* Mux interop over loopback, both ways (the JAX package's `MuxClient`
  against this package's `serve_mux_stream`, and this package's client
  against the JAX one): tags match under concurrency, responses complete
  out of order, and a disconnect fails the tags in flight, after which the
  next submit reconnects.
* `Configuration` and `plugins` answer as the JAX package's on the same file
  and environment.
"""

import json
import socket
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import pinot_tpu.cluster.http_service as jax_http
import pinot_tpu.cluster.mux as jax_mux
import pinot_tpu.cluster.wire as jax_wire
import pinot_tpu.config as jax_config
import pinot_tpu.plugins as jax_plugins
import pinot_tpu.query.reduce as jax_reduce
from pinot_tpu.query.idset import IdSet as JaxIdSet
from pinot_tpu.query.sketches import TDigest as JaxTDigest
from pinot_tpu.query.sketches import ThetaSketch as JaxTheta
from pinot_tpu.utils.metrics import get_registry as jax_registry
from pinot_tpu_torch import config as port_config
from pinot_tpu_torch import plugins as port_plugins
from pinot_tpu_torch.cluster import http_service as port_http
from pinot_tpu_torch.cluster import mux as port_mux
from pinot_tpu_torch.cluster import wire as port_wire
from pinot_tpu_torch.query import reduce as port_reduce
from pinot_tpu_torch.query.idset import IdSet
from pinot_tpu_torch.query.sketches import TDigest, ThetaSketch
from pinot_tpu_torch.utils.metrics import get_registry as port_registry

RNG_SEED = 20261018


def _arrays():
    rng = np.random.default_rng(RNG_SEED)
    out = {}
    for dt in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
               "float32", "float64"):
        # small (copied into the accumulator) and large (a gathered part)
        for n in (3, 4096):
            a = (rng.integers(0, 100, n) if dt[0] in "iu" else rng.normal(size=n))
            out[f"{dt}[{n}]"] = a.astype(dt)
    out["bool[700]"] = rng.integers(0, 2, 700).astype(bool)
    out["float64[3,4]"] = rng.normal(size=(3, 4))
    out["int32[0]"] = np.empty(0, dtype=np.int32)
    out["float32 scalar"] = np.array(2.5, dtype=np.float32)
    out["object str[3]"] = np.array(["a", "é", None], dtype=object)
    return out


SCALARS = {
    "none": None, "true": True, "false": False, "int": -7, "int64 max": (1 << 63) - 1,
    "big int": 1 << 70, "np.int32": np.int32(9), "float": 3.25, "nan": float("nan"),
    "np.float32": np.float32(1.5), "str": "lineorder", "unicode": "naïve ∑",
    "bytes": b"\x00\xff\x10", "empty": "",
}
CONTAINERS = {
    "tuple": (1, "a", 2.0, None),
    "list": [1, [2, [3, (4,)]]],
    "set": frozenset({1, 2, 3}),
    "dict": {"a": 1, 2: "b", (1, "x"): [1.5, None]},
    "nested": {"groups": [((1, "ASIA"), [3, 4.5])], "stats": {"numDocsScanned": 9}},
    # a row of the types the codec takes first and their neighbours
    "mixed row": (1 << 70, True, np.float32(2.5), np.int64(3), -(1 << 63), (1 << 63) - 1,
                  1 << 63, "é", None, float("inf"), [False, 0.0, -0.0, b"x"]),
    "rows": [(i, float(i) / 3, f"r{i}") for i in range(50)],
}


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return a.shape == b.shape and list(a.reshape(-1)) == list(b.reshape(-1))
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


VALUES = {**SCALARS, **CONTAINERS, **_arrays()}


@pytest.mark.parametrize("name", list(VALUES))
def test_value_bytes_equal_the_reference_and_decode_across(name):
    v = VALUES[name]
    port_bytes = port_wire.encode_value(v)
    assert port_bytes == jax_wire.encode_value(v)
    assert b"".join(bytes(p) for p in port_wire.encode_value_parts(v)) == port_bytes
    for decoded in (port_wire.decode_value(jax_wire.encode_value(v)),
                    jax_wire.decode_value(port_bytes)):
        want = v
        if isinstance(v, (np.integer, np.floating)):
            want = v.item()
        if isinstance(v, frozenset):
            want = set(v)
        if isinstance(v, np.ndarray) and v.dtype == object:
            want = v.tolist()   # object arrays decay to lists on the wire
        assert _equal(decoded, want), (decoded, want)


def _sketches(pkg: str):
    rng = np.random.default_rng(RNG_SEED + 1)
    vals = rng.integers(0, 5000, 20_000)
    theta, tdigest, idset = ((ThetaSketch, TDigest, IdSet) if pkg == "port"
                             else (JaxTheta, JaxTDigest, JaxIdSet))
    return {"theta": theta.from_values(vals, k=256),
            "tdigest": tdigest.from_values(rng.normal(size=5000)),
            "idset": idset.from_values(np.unique(vals)[:100]),
            "idset_str": idset.from_values(["b", "a", "c"])}


@pytest.mark.parametrize("kind", ["theta", "tdigest", "idset", "idset_str"])
def test_sketch_states_encode_to_the_reference_bytes(kind):
    port, ref = _sketches("port")[kind], _sketches("ref")[kind]
    assert port.to_bytes() == ref.to_bytes()
    port_bytes = port_wire.encode_value([port, {"state": port}])
    assert port_bytes == jax_wire.encode_value([ref, {"state": ref}])
    back = port_wire.decode_value(jax_wire.encode_value(ref))
    assert type(back) is type(port) and back.to_bytes() == port.to_bytes()
    fwd = jax_wire.decode_value(port_bytes)[0]
    assert type(fwd) is type(ref) and fwd.to_bytes() == ref.to_bytes()


def _dense(mod, keys=5000):
    rng = np.random.default_rng(RNG_SEED + 2)
    return mod.DensePartial(
        token=(("lo_suppkey",), (keys,), ("h0",), keys), cards=(keys,), strides=(1,),
        num_keys_real=keys, counts=rng.integers(0, 9, keys).astype(np.int64),
        outs={"0.sum": rng.normal(size=keys), "1.min": rng.normal(size=keys).astype(np.float32)},
        group_values=[np.arange(keys, dtype=np.int32)])


def _results(mod, pkg: str):
    """The three SegmentResult kinds (and a dense partial) of one package."""
    sk = _sketches(pkg)
    stats = {"numDocsScanned": 12.0, "numSegmentsQueried": 2.0, "op:FILTER:rows": 5.0}
    spans = [{"name": "segment:s0", "startMs": 0.5, "durationMs": 1.25, "depth": 1}]
    groups = mod.SegmentResult("groups", groups={("ASIA", 3): [4, 10.5, sk["theta"]],
                                                 ("EUROPE", 1): [1, -2.0, sk["theta"]]},
                               num_docs_scanned=5, served=["s0", "s1"], stats=stats)
    scalar = mod.SegmentResult("scalar", scalar=[7, 1.5, sk["tdigest"], sk["idset"]],
                               num_docs_scanned=7, served=["s0"])
    selection = mod.SegmentResult("selection", rows=[(1, "a", 2.5), (2, None, -1.0)],
                                  sort_keys=[(2.5,), (-1.0,)], num_docs_scanned=2,
                                  served=[], stats=stats)
    dense = mod.SegmentResult("groups", dense=_dense(mod), num_docs_scanned=44,
                              served=["s0", "s1"], stats=stats)
    return {"groups": (groups, None), "scalar": (scalar, spans),
            "selection": (selection, spans), "dense": (dense, None)}


def _result_equal(a, b) -> bool:
    same = (a.kind == b.kind and a.num_docs_scanned == b.num_docs_scanned
            and a.served == b.served and a.rows == b.rows and a.sort_keys == b.sort_keys
            and (a.stats or None) == (b.stats or None))
    sketch = lambda v: v.to_bytes() if hasattr(v, "to_bytes") else v  # noqa: E731
    same &= ({k: [sketch(x) for x in v] for k, v in a.groups.items()}
             == {k: [sketch(x) for x in v] for k, v in b.groups.items()})
    same &= [sketch(x) for x in (a.scalar or [])] == [sketch(x) for x in (b.scalar or [])]
    if (a.dense is None) != (b.dense is None):
        return False
    if a.dense is not None:
        da, db = a.dense, b.dense
        same &= (da.token == db.token and da.cards == db.cards and da.strides == db.strides
                 and da.num_keys_real == db.num_keys_real
                 and np.array_equal(da.counts, db.counts)
                 and da.outs.keys() == db.outs.keys()
                 and all(np.array_equal(da.outs[k], db.outs[k]) for k in da.outs)
                 and all(np.array_equal(x, y) for x, y in zip(da.group_values,
                                                              db.group_values)))
    return same


@pytest.mark.parametrize("kind", ["groups", "scalar", "selection", "dense"])
def test_segment_results_encode_to_the_reference_bytes(kind):
    port, spans = _results(port_reduce, "port")[kind]
    ref, _ = _results(jax_reduce, "ref")[kind]
    port_bytes = port_wire.encode_segment_result(port, trace_spans=spans)
    ref_bytes = jax_wire.encode_segment_result(ref, trace_spans=spans)
    assert port_bytes == ref_bytes
    assert b"".join(bytes(p) for p in port_wire.encode_segment_result_parts(
        port, trace_spans=spans)) == port_bytes
    back = port_wire.decode_segment_result(ref_bytes)
    assert _result_equal(back, port)
    assert getattr(back, "trace_spans", None) == spans
    fwd = jax_wire.decode_segment_result(port_bytes)
    assert _result_equal(fwd, ref)


def test_an_exact_top_k_partial_keeps_its_mark_and_the_reference_reads_it():
    """This package's `topkExact` key rides the partial; the JAX package's
    decoder skips it and reads the rest."""
    port, _ = _results(port_reduce, "port")["selection"]
    port.topk_exact = True
    data = port_wire.encode_segment_result(port)
    assert port_wire.decode_segment_result(data).topk_exact is True
    ref, _ = _results(jax_reduce, "ref")["selection"]
    assert _result_equal(jax_wire.decode_segment_result(data), ref)


def test_query_requests_encode_to_the_reference_bytes():
    args = ("lineorder_OFFLINE", "SELECT COUNT(*) FROM lineorder", ["s0", "s1"],
            "lo_orderdate <= 19950101")
    kw = dict(trace=True, trace_id="abcd", sampled=True)
    port_bytes = port_wire.encode_query_request(*args, **kw)
    assert port_bytes == jax_wire.encode_query_request(*args, **kw)
    want = {"table": args[0], "sql": args[1], "segments": args[2], "timeFilter": args[3],
            "trace": True, "traceId": "abcd", "sampled": True}
    assert port_wire.decode_query_request(memoryview(port_bytes)) == want
    assert jax_wire.decode_query_request(port_bytes) == want


# -- zero copy ---------------------------------------------------------------------

def test_decoded_arrays_alias_the_frame_both_ways():
    arr = np.arange(1_000_000, dtype=np.float64)
    for data in (port_wire.encode_value(arr), jax_wire.encode_value(arr)):
        out = port_wire.decode_value(memoryview(data))
        assert np.array_equal(out, arr)
        assert np.shares_memory(out, np.frombuffer(data, dtype=np.uint8))
        assert not out.flags.writeable   # immutable bytes: a read-only view


def test_a_dense_partial_rides_as_gathered_parts_and_decodes_as_views():
    r = port_reduce.SegmentResult("groups", dense=_dense(port_reduce, keys=1_000_000))
    parts = port_wire.encode_segment_result_parts(r)
    # the large arrays are parts of their own, aliasing the source arrays
    assert any(isinstance(p, memoryview) and np.shares_memory(
        np.frombuffer(p, dtype=np.uint8), r.dense.outs["0.sum"]) for p in parts)
    frame = b"".join(bytes(p) for p in parts)
    got = port_wire.decode_segment_result(memoryview(frame)).dense
    base = np.frombuffer(frame, dtype=np.uint8)
    assert np.array_equal(got.outs["0.sum"], r.dense.outs["0.sum"])
    for payload in (got.counts, got.outs["0.sum"], got.outs["1.min"]):
        assert np.shares_memory(payload, base)


def test_the_reduce_takes_read_only_partials(tmp_path):
    """Two servers' dense partials of a high-cardinality GROUP BY and their
    dict-form copies, decoded read-only off immutable frames, reduce to the
    answer of the partials as the servers made them, and stay unchanged."""
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.segment.reader import load_segment
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    from pinot_tpu_torch.ssb import make_columns, ssb_schema
    dirs = build_aligned_segments(ssb_schema(), make_columns(24_000, 3), str(tmp_path),
                                  "lineorder", 4,
                                  SegmentGeneratorConfig(raw_cardinality_fraction=1.0))
    segs = [load_segment(d) for d in dirs]
    sql = ("SELECT lo_suppkey, SUM(lo_revenue), MIN(lo_quantity), COUNT(*) FROM lineorder "
           "GROUP BY lo_suppkey ORDER BY lo_suppkey LIMIT 100000")
    ctx = compile_query(sql, segs[0].schema)
    aggs = [make_agg(f) for f in ctx.aggregations]
    pipeline = DeviceQueryPipeline(MeshQueryExecutor("cpu"))
    try:
        partials = [pipeline.execute_partial(ctx, segs[:2]), pipeline.execute_partial(ctx, segs[2:])]
    finally:
        pipeline.stop()
    assert all(p.dense is not None for p in partials)
    frames = [port_wire.encode_segment_result(p) for p in partials]
    want = port_reduce.reduce_to_result(
        ctx, port_reduce.merge_segment_results(partials, aggs), aggs, list(ctx.group_by))
    decoded = [port_wire.decode_segment_result(f) for f in frames]
    assert not decoded[0].dense.counts.flags.writeable
    got = port_reduce.reduce_to_result(
        ctx, port_reduce.merge_segment_results(decoded, aggs), aggs, list(ctx.group_by))
    assert len(got.rows) > 4096 and got.rows == want.rows
    # a dense partial beside a dict one: the merge materializes copies (the
    # dict form sums in another order: floats at tests/test_torch_cluster.py's
    # tolerances)
    mixed = [port_wire.decode_segment_result(f) for f in frames]
    mixed[1].materialize_dense(aggs)
    got = port_reduce.reduce_to_result(
        ctx, port_reduce.merge_segment_results(mixed, aggs), aggs, list(ctx.group_by))
    assert len(got.rows) == len(want.rows)
    assert np.allclose(np.asarray(got.rows, dtype=np.float64),
                       np.asarray(want.rows, dtype=np.float64), rtol=1e-5, atol=0.05)
    for f, d in zip(frames, decoded):   # the frames' arrays did not change
        again = port_wire.decode_segment_result(f).dense
        assert np.array_equal(again.counts, d.dense.counts)


# -- mux interop ---------------------------------------------------------------------

PACKAGES = {"port": (port_http, port_mux, port_wire, port_reduce, port_registry),
            "ref": (jax_http, jax_mux, jax_wire, jax_reduce, jax_registry)}
DIRECTIONS = [("ref", "port"), ("port", "ref")]   # (client, server)


@pytest.fixture(params=DIRECTIONS, ids=lambda d: f"{d[0]}_client_{d[1]}_server")
def echo_mux(request):
    """A bare /mux endpoint of one package whose execute answers the request's
    value as `num_docs_scanned` (a tag mismatch is a wrong answer); requests
    with `hold` wait for the gate. The client is the other package's."""
    client_pkg, server_pkg = request.param
    http, mux, wire, reduce_mod, _ = PACKAGES[server_pkg]
    pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="mux-echo")
    gate = threading.Event()
    gate.set()

    def execute(payload, flow_wait_ms):
        d = json.loads(bytes(payload).decode())
        if d.get("hold"):
            gate.wait(timeout=30.0)
        r = reduce_mod.SegmentResult("groups")
        r.num_docs_scanned = d["v"]
        return 200, wire.encode_segment_result_parts(r)

    svc = http.HttpService()
    svc.route("POST", "mux", lambda parts, params, body: (
        200, "application/octet-stream",
        mux.serve_mux_stream(body, execute, executor=pool, max_inflight=32)), duplex=True)
    svc.start()
    client_mux, registry = PACKAGES[client_pkg][1], PACKAGES[client_pkg][4]
    mc = client_mux.MuxClient(svc.url, streams=1, timeout_s=30.0)
    try:
        yield {"client": mc, "gate": gate, "registry": registry}
    finally:
        gate.set()
        mc.close()
        svc.stop()
        pool.shutdown(wait=False)


def _payload(v, hold=False):
    return json.dumps({"v": v, **({"hold": True} if hold else {})}).encode()


def test_mux_interop_concurrent_tag_matching(echo_mux):
    """8 threads x 25 interleaved queries over one stream: every response
    lands on the future whose tag asked for it."""
    mc, mismatches = echo_mux["client"], []

    def worker(t):
        futs = [(t * 1000 + j, mc.submit(_payload(t * 1000 + j))) for j in range(25)]
        for want, fut in futs:
            got = fut.result(timeout=30.0).num_docs_scanned
            if got != want:
                mismatches.append((want, got))
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads)
    assert mismatches == []


def test_mux_interop_out_of_order_completion(echo_mux):
    """Responses match by tag, not arrival: fast queries complete while
    earlier held ones are still in flight on the same stream."""
    mc, gate = echo_mux["client"], echo_mux["gate"]
    gate.clear()
    held = [mc.submit(_payload(100 + i, hold=True)) for i in range(3)]
    fast = [mc.submit(_payload(200 + i)) for i in range(3)]
    for i, fut in enumerate(fast):
        assert fut.result(timeout=15.0).num_docs_scanned == 200 + i
    assert not any(f.done() for f in held)
    gate.set()
    for i, fut in enumerate(held):
        assert fut.result(timeout=15.0).num_docs_scanned == 100 + i


def test_mux_interop_disconnect_fails_inflight_then_recovers(echo_mux):
    """A disconnect mid-stream fails exactly the tags in flight with
    ConnectionError; the next submit opens a new stream that works."""
    from conftest import wait_until
    mc, gate = echo_mux["client"], echo_mux["gate"]
    assert mc.submit(_payload(7)).result(timeout=15.0).num_docs_scanned == 7
    gate.clear()
    held = [mc.submit(_payload(100 + i, hold=True)) for i in range(4)]
    conn = mc._slots[0]
    assert wait_until(lambda: len(conn._pending) == 4, timeout=15.0, interval=0.05)
    counter = echo_mux["registry"]().counter("pinot_broker_mux_reconnects")
    before = counter.value
    conn._conn.sock.shutdown(socket.SHUT_RDWR)   # sever the stream
    for fut in held:
        with pytest.raises(ConnectionError):
            fut.result(timeout=15.0)
    assert wait_until(lambda: conn.closed, timeout=15.0, interval=0.05)
    gate.set()   # the held executions answer into the dead stream
    assert mc.submit(_payload(42)).result(timeout=15.0).num_docs_scanned == 42
    assert counter.value == before + 1


def test_pooled_client_and_chunked_routes():
    """`http_call` over the keep-alive pool reuses its connection; a route
    that returns an iterator answers chunked, which `http_stream` reads
    incrementally; an error status raises HttpError with the status."""
    svc = port_http.HttpService()
    svc.route("GET", "ping", lambda p, q, b: port_http.json_response({"parts": p, **q}))
    svc.route("POST", "chunks", lambda p, q, b: (
        200, "application/octet-stream", (bytes([i]) * 1000 for i in range(5))))
    svc.route("GET", "teapot", lambda p, q, b: port_http.error_response("no", 418))
    svc.start()
    try:
        for _ in range(3):
            assert port_http.get_json(f"{svc.url}/ping/a/b?x=1") == {"parts": ["a", "b"],
                                                                    "x": "1"}
        key = ("http", svc.host, svc.port)
        assert len(port_http._POOL._idle[key]) == 1   # one connection, reused
        with port_http.http_stream("POST", f"{svc.url}/chunks", b"") as resp:
            got = b"".join(iter(lambda: resp.read(700), b""))
        assert got == b"".join(bytes([i]) * 1000 for i in range(5))
        with pytest.raises(port_http.HttpError) as e:
            port_http.http_call("GET", f"{svc.url}/teapot")
        assert e.value.status == 418
    finally:
        svc.stop()


# -- configuration and plugins -------------------------------------------------------

@pytest.mark.parametrize("fmt", ["properties", "json"])
def test_configuration_layers_match_the_reference(tmp_path, fmt):
    path = str(tmp_path / f"pinot.{fmt}")
    if fmt == "json":
        with open(path, "w") as f:
            json.dump({"server": {"port": 8098, "device": {"enabled": True}},
                       "broker.mux.enabled": "false", "Auth.Tokens": "t=a:*:ADMIN"}, f)
    else:
        with open(path, "w") as f:
            f.write("# comment\nserver.port=8098\nserver.device.enabled = true\n"
                    "broker.mux.enabled=false\n! another\nAuth.Tokens=t=a:*:ADMIN\n"
                    "server.tenant.tags=a, b,,c\n")
    env = {"PINOT_TPU_SERVER_PORT": "9000", "PINOT_TPU_SERVER_SCHEDULER_ENABLED": "1",
           "PINOT_TPU_SOME__DASHED_KEY": "x", "OTHER": "y"}
    kw = dict(defaults={"server.port": 1, "controller.port": 9000},
              overrides={"broker.scatter.threads": 4}, env=env)
    port = port_config.Configuration.load(path, **kw)
    ref = jax_config.Configuration.load(path, **kw)
    assert port.to_dict() == ref.to_dict() and port.keys() == ref.keys()
    assert port.subset("server").to_dict() == ref.subset("server").to_dict()
    for getter, key in (("get_int", "server.port"), ("get_bool", "server.device.enabled"),
                        ("get_bool", "broker.mux.enabled"), ("get_list", "server.tenant.tags"),
                        ("get_str", "auth.tokens"), ("get_float", "controller.port"),
                        ("get_bool", "server.scheduler.enabled")):
        assert getattr(port, getter)(key) == getattr(ref, getter)(key), key
    assert port_config.read_config_file(path) == jax_config.read_config_file(path)


def test_plugins_match_the_reference_registries():
    """Each registry this package has names a subset of the JAX package's
    (which also holds decoders this package does not register); a
    configuration's modules load alike; the stream registry holds the JAX
    package's four stream types."""
    for kind in ("stream", "decoder", "fs", "reader"):
        names = port_plugins.available(kind)
        assert names and set(names) <= set(jax_plugins.available(kind)), kind
        assert callable(port_plugins.get(kind, names[0]))
    assert port_plugins.available("stream") == jax_plugins.available("stream") == \
        ["kafkalite", "kinesis", "memory", "pulsar"]
    with pytest.raises(KeyError):
        port_plugins.get("decoder", "no-such-decoder")
    with pytest.raises(KeyError):
        port_plugins.get("stream", "kafka")
    cfg = port_config.Configuration({"plugins.modules": "json, textwrap"})
    jcfg = jax_config.Configuration({"plugins.modules": "json, textwrap"})
    assert port_plugins.load_from_config(cfg) == jax_plugins.load_from_config(jcfg) == \
        ["json", "textwrap"]


def test_auth_tokens_parse_as_the_reference():
    from pinot_tpu.auth import StaticTokenAccessControl as JaxAccess
    from pinot_tpu_torch.auth import StaticTokenAccessControl
    spec = {"auth.tokens": "tok1=admin:*:ADMIN, tok2=bob:lineorder|t2:READ"}
    port = StaticTokenAccessControl.from_config(port_config.Configuration(spec))
    ref = JaxAccess.from_config(jax_config.Configuration(spec))
    for tok in ("tok1", "tok2", "nope", None):
        p, r = port.authenticate(tok), ref.authenticate(tok)
        assert (p is None) == (r is None)
        if p is not None:
            for action, table in (("READ", "lineorder_OFFLINE"), ("WRITE", None),
                                  ("READ", "other")):
                assert p.allows(action, table) == r.allows(action, table)
