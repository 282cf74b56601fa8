"""pinot_tpu_torch's CUDA scan kernels against their plain PyTorch versions.

Row counts at and around the vector width, the 16-row group and one pipeline
stage, the widest shape (8 mask columns, 8 sums), bitwise-equal answers over
repeated calls, two streams and CUDA-graph replays, and the alignment check.
Needs a CUDA card (`gpu` marker): the kernels have no CPU mode, so without a
card every test here skips. Imports no JAX, so it runs on a machine without it:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pinot_tpu_torch.engine import scan

I32_MIN, I32_MAX = scan.INT32_MIN, scan.INT32_MAX
Q11_BANDS = [(336, 671), (1, 3), (0, 23)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _data(n, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "od": rng.integers(0, 2353, n).astype(np.int32),
        "disc": rng.integers(0, 11, n).astype(np.int32),
        "qty": rng.integers(0, 50, n).astype(np.int32),
        "price": rng.uniform(1, 10000, n).astype(np.float32),
        "rev": rng.uniform(-100, 60000, n).astype(np.float32),
        "d8": rng.integers(0, 256, n).astype(np.uint8),
        "d16": rng.integers(0, 1 << 16, n).astype(np.uint16),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("n", [(1 << 20) + 77, 1, 300])
def test_cuda_kernels_match_plain_versions(cuda, n):
    d = _data(n)
    dev = cuda
    before = (scan.masked_sums.launches, scan.masked_sums_fused.launches)
    cols = [torch.from_numpy(d[k]).to(dev) for k in ("od", "disc", "qty")]
    rows = [torch.from_numpy(d[k]).to(dev) for k in ("price", "rev")]
    for bands in (Q11_BANDS, [(I32_MIN, 671), (1, I32_MAX), (I32_MIN, 23)], [(1, 0)] * 3):
        ks, kc = scan.masked_sums(cols, bands, rows)
        ps, pc = scan.masked_sums_plain(cols, bands, rows)
        assert int(kc) == int(pc)
        torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-3)
    for delta in ("d8", "d16"):
        for_rows = [(-3.0, torch.from_numpy(d[delta]).to(dev))]
        ks, kc = scan.masked_sums_fused(cols[:2], Q11_BANDS[:2], for_rows)
        ps, pc = scan.masked_sums_fused_plain(cols[:2], Q11_BANDS[:2], for_rows)
        assert int(kc) == int(pc)
        torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-3)
    assert (scan.masked_sums.launches - before[0],
            scan.masked_sums_fused.launches - before[1]) == (3, 2)


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs(cuda):
    ids = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        scan.masked_sums([ids.to(torch.int64)], [(0, 1)], [])
    with pytest.raises(ValueError, match="shape"):
        scan.masked_sums([ids], [(0, 1)], [torch.zeros(9, device=cuda)])
    with pytest.raises(ValueError, match="uint8 or all uint16"):
        scan.masked_sums_fused([ids], [(0, 1)], [(0.0, ids)])
    with pytest.raises(ValueError, match="at most"):
        scan.masked_sums([ids] * 9, [(0, 1)] * 9, [])


def _rows_for(token, n_mask, n_sums, itemsize):
    """A row count, or one pipeline stage of that shape (+/- 1) at 2,097,152 rows."""
    if isinstance(token, int):
        return token
    stage = scan.scan_plan(1 << 21, n_mask, n_sums, itemsize, 132,
                           scan.kernel_shape()).rows_per_stage
    return stage + {"stage-1": -1, "stage": 0, "stage+1": 1}[token]


EDGE_ROWS = [0, 1, 3, 4, 15, 16, 17, 33, "stage-1", "stage", "stage+1", (1 << 21) - 3]


def _assert_same(got, want):
    ks, kc = got
    ps, pc = want
    assert int(kc) == int(pc)
    torch.testing.assert_close(ks.cpu(), ps.cpu(), rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("token", EDGE_ROWS, ids=str)
def test_cuda_kernels_at_edge_row_counts(cuda, token):
    n = _rows_for(token, 3, 2, 4)
    d = _data(max(n, 1), seed=7)
    cols = [torch.from_numpy(d[k][:n]).to(cuda) for k in ("od", "disc", "qty")]
    rows = [torch.from_numpy(d[k][:n]).to(cuda) for k in ("price", "rev")]
    _assert_same(scan.masked_sums(cols, Q11_BANDS, rows),
                 scan.masked_sums_plain(cols, Q11_BANDS, rows))
    for delta, itemsize in (("d8", 1), ("d16", 2)):
        m = _rows_for(token, 2, 1, itemsize)
        dd = _data(max(m, 1), seed=8)
        ids = [torch.from_numpy(dd[k][:m]).to(cuda) for k in ("od", "disc")]
        for_rows = [(-3.0, torch.from_numpy(dd[delta][:m]).to(cuda))]
        _assert_same(scan.masked_sums_fused(ids, Q11_BANDS[:2], for_rows),
                     scan.masked_sums_fused_plain(ids, Q11_BANDS[:2], for_rows))


@pytest.mark.gpu
@pytest.mark.parametrize("token", [17, "stage+1", (1 << 21) - 3], ids=str)
@pytest.mark.parametrize("operand", ["f32", "d8", "d16"])
def test_cuda_kernels_eight_columns_eight_sums(cuda, token, operand):
    itemsize = {"f32": 4, "d8": 1, "d16": 2}[operand]
    n = _rows_for(token, 8, 8, itemsize)
    rng = np.random.default_rng(n)
    cards = [2353, 11, 50, 7, 25, 50, 250, 1000]
    cols = [torch.from_numpy(rng.integers(0, c, n).astype(np.int32)).to(cuda) for c in cards]
    bands = Q11_BANDS + [(0, 5), (3, 20), (0, 40), (10, 240), (0, 900)]
    if operand == "f32":
        rows = [torch.from_numpy(rng.uniform(-50, 500, n).astype(np.float32)).to(cuda)
                for _ in range(8)]
        _assert_same(scan.masked_sums(cols, bands, rows),
                     scan.masked_sums_plain(cols, bands, rows))
    else:
        dt, hi = (np.uint8, 256) if operand == "d8" else (np.uint16, 1 << 16)
        for_rows = [(float(j) - 4.0, torch.from_numpy(rng.integers(0, hi, n).astype(dt))
                     .to(cuda)) for j in range(8)]
        _assert_same(scan.masked_sums_fused(cols, bands, for_rows),
                     scan.masked_sums_fused_plain(cols, bands, for_rows))


def _bits(answer):
    sums, count = answer
    return sums.cpu().numpy().tobytes(), int(count)


@pytest.mark.gpu
def test_cuda_answers_are_bitwise_stable_over_calls_streams_and_graph_replays(cuda):
    n = (1 << 21) - 3
    d = _data(n, seed=5)
    cols = [torch.from_numpy(d[k]).to(cuda) for k in ("od", "disc", "qty")]
    rows = [torch.from_numpy(d[k]).to(cuda) for k in ("price", "rev")]
    for_rows = [(1.0, torch.from_numpy(d["d8"]).to(cuda))]
    calls = [lambda: scan.masked_sums(cols, Q11_BANDS, rows),
             lambda: scan.masked_sums_fused(cols[:2], Q11_BANDS[:2], for_rows)]
    for call in calls:
        want = _bits(call())
        assert all(_bits(call()) == want for _ in range(10))
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        answers = []
        for i in range(6):   # the two streams in turn, each call on its own stream
            with torch.cuda.stream(streams[i % 2]):
                answers.append(call())
        torch.cuda.synchronize()
        assert all(_bits(a) == want for a in answers)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert _bits(captured) == want
        assert _bits(call()) == want   # eager calls after the graph still start clean


@pytest.mark.gpu
def test_cuda_wrappers_reject_misaligned_views(cuda):
    ids = torch.zeros(64, dtype=torch.int32, device=cuda)
    row = torch.zeros(64, dtype=torch.float32, device=cuda)
    d8 = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        scan.masked_sums([ids[1:]], [(0, 1)], [row[1:]])
    with pytest.raises(ValueError, match="aligned"):
        scan.masked_sums([ids[4:]], [(0, 1)], [row[1:61]])
    with pytest.raises(ValueError, match="aligned"):
        scan.masked_sums_fused([ids[:63]], [(0, 1)], [(0.0, d8[1:])])
    # views at a 16-byte offset are taken
    sums, count = scan.masked_sums([ids[4:]], [(0, 1)], [row[4:]])
    assert int(count) == 60 and float(sums[0]) == 0.0


@pytest.mark.gpu
def test_cuda_answer_reaches_the_host_in_one_copy(cuda):
    d = _data(5000, seed=3)
    cols = [torch.from_numpy(d[k]).to(cuda) for k in ("od", "disc", "qty")]
    rows = [torch.from_numpy(d[k]).to(cuda) for k in ("price", "rev", "price")]
    answer = scan.masked_sums_answer(cols, Q11_BANDS, rows)
    sums, count = scan.answer_views(answer, 3)
    host_sums, host_count = scan.answer_to_host(answer, 3)
    assert host_count == int(count)
    np.testing.assert_array_equal(host_sums, sums.cpu().numpy())
    ps, pc = scan.masked_sums_plain(cols, Q11_BANDS, rows)
    assert host_count == int(pc)


@pytest.mark.gpu
def test_cuda_graph_captures_take_no_static_ticket_slot(cuda):
    """More captures than there are static ticket slots, each graph released
    after its replay: captured launches keep their ticket in the graph's memory."""
    d = _data(4096, seed=9)
    cols = [torch.from_numpy(d[k]).to(cuda) for k in ("od", "disc", "qty")]
    rows = [torch.from_numpy(d["price"]).to(cuda)]
    want = _bits(scan.masked_sums(cols, Q11_BANDS, rows))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan.masked_sums(cols, Q11_BANDS, rows)
    torch.cuda.current_stream().wait_stream(side)
    for i in range(scan.kernel_shape().ticket_slots + 8):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = scan.masked_sums(cols, Q11_BANDS, rows)
        graph.replay()
        if i % 256 == 0:
            torch.cuda.synchronize()
            assert _bits(captured) == want
        del graph, captured
    torch.cuda.synchronize()
    assert _bits(scan.masked_sums(cols, Q11_BANDS, rows)) == want


@pytest.mark.gpu
def test_cuda_masked_sums_over_a_stacked_block_of_uneven_segments(cuda):
    """The set executor's scan shape: segments of uneven sizes stacked into one
    [S_pad, rows] block (rows = the largest segment's power of two), fill rows
    holding the out-of-dictionary id, one launch over S_pad * rows rows."""
    sizes = [(1 << 20) + 5, 300_000, 777_777, 5]
    rows_per_slot = 1 << 21
    card = (2353, 11, 50)
    d = _data(sum(sizes), seed=21)
    ids = [np.full((len(sizes), rows_per_slot), c, dtype=np.int32) for c in card]
    price = np.zeros((len(sizes), rows_per_slot), dtype=np.float32)
    start = 0
    for slot, n in enumerate(sizes):
        for block, key in zip(ids, ("od", "disc", "qty")):
            block[slot, :n] = d[key][start:start + n]
        price[slot, :n] = d["price"][start:start + n]
        start += n
    cols = [torch.from_numpy(b).to(cuda).view(-1) for b in ids]
    rows = [torch.from_numpy(price).to(cuda).view(-1)]
    before = scan.masked_sums.launches
    ks, kc = scan.masked_sums(cols, Q11_BANDS, rows)
    assert scan.masked_sums.launches - before == 1
    ps, pc = scan.masked_sums_plain(cols, Q11_BANDS, rows)
    assert int(kc) == int(pc)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-3)
    m = np.ones(sum(sizes), dtype=bool)
    for key, (lo, hi) in zip(("od", "disc", "qty"), Q11_BANDS):
        m &= (d[key] >= lo) & (d[key] <= hi)
    assert int(kc) == int(m.sum())    # the fill rows fail every band
    np.testing.assert_allclose(float(ks[0]), float(d["price"][m].astype(np.float64).sum()),
                               rtol=1e-5)


@pytest.mark.gpu
def test_cuda_pipeline_serves_a_stacked_group_on_its_streams(cuda, tmp_path):
    """Four literals of one scan shape from four threads: one stacked group of
    four launches on the dispatcher's stream, fetched on the fetcher's stream,
    each answer equal to the per-segment executor's on the CPU."""
    import threading
    import time

    from pinot_tpu_torch import execute_query, segments_from_columns
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.ssb import make_columns, ssb_schema

    segs = segments_from_columns(ssb_schema(), make_columns(300_000, 3), str(tmp_path), 3)
    sqls = [f"SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_quantity >= {q}"
            for q in (5, 15, 25, 35)]
    pipeline = DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(cuda), start=False)
    got = [None] * len(sqls)

    def run(i):
        ctx = compile_query(sqls[i], segs[0].schema)
        aggs = [make_agg(f) for f in ctx.aggregations]
        merged = merge_segment_results([pipeline.execute_partial(ctx, segs)], aggs)
        got[i] = reduce_to_result(ctx, merged, aggs, []).rows

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sqls))]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 30
        while pipeline._q.qsize() < len(sqls) and time.time() < deadline:
            time.sleep(0.005)
        pipeline.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        s = pipeline.stats()
    finally:
        pipeline.stop()
    assert (s["stackedLaunches"], s["scanLaunches"], s["errors"]) == (1, 4, 0)
    for sql, rows in zip(sqls, got):
        want = execute_query(segs, sql, device="cpu").rows
        assert rows[0][0] == want[0][0]
        np.testing.assert_allclose(rows[0][1], want[0][1], rtol=1e-5)


@pytest.mark.gpu
def test_cuda_direct_execute_beside_the_pipeline(cuda, tmp_path):
    """One executor on the card serves the pipeline (its dispatcher's stream)
    and direct `execute` callers (their current stream) at once: every answer
    equals the per-segment executor's on the CPU, and the kernel's launch
    counter is the pipeline's `scanLaunches` plus one per direct query."""
    import threading

    from pinot_tpu_torch import execute_query, segments_from_columns
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.ssb import make_columns, ssb_schema

    segs = segments_from_columns(ssb_schema(), make_columns(300_000, 5), str(tmp_path), 3)
    sqls = [f"SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_quantity >= {q}"
            for q in (5, 15, 25, 35)]
    mx = MeshQueryExecutor(cuda)
    mx.execute(segs, sqls[0])             # stages the block before the count starts
    scan.reset_launch_counts()
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    rounds = 8
    answers, errors = [], []

    def serve(i):
        try:
            for r in range(rounds):
                sql = sqls[(i + r) % len(sqls)]
                ctx = compile_query(sql, segs[0].schema)
                aggs = [make_agg(f) for f in ctx.aggregations]
                merged = merge_segment_results([pipeline.execute_partial(ctx, segs)], aggs)
                answers.append((sql, reduce_to_result(ctx, merged, aggs, []).rows))
        except Exception as e:   # the test reports what a thread saw
            errors.append(e)

    def execute(i):
        try:
            for r in range(rounds):
                sql = sqls[(i + r) % len(sqls)]
                answers.append((sql, mx.execute(segs, sql).rows))
        except Exception as e:
            errors.append(e)

    threads = ([threading.Thread(target=serve, args=(i,)) for i in range(4)]
               + [threading.Thread(target=execute, args=(i,)) for i in range(2)])
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        s = pipeline.stats()
    finally:
        pipeline.stop()
    assert not errors, errors
    assert len(answers) == 6 * rounds and s["errors"] == 0
    assert scan.masked_sums.launches == s["scanLaunches"] + 2 * rounds
    want = {sql: execute_query(segs, sql, device="cpu").rows for sql in sqls}
    for sql, rows in answers:
        assert rows[0][0] == want[sql][0][0], sql
        np.testing.assert_allclose(rows[0][1], want[sql][0][1], rtol=1e-5)


@pytest.mark.gpu
def test_cuda_topk_keeps_the_lower_row_among_ties(cuda):
    """`torch.topk` on the card promises no order among equal values; the
    top-k's key breaks every tie by row, so the candidates are the stable
    order's first k, as on the CPU, where far more rows tie than k."""
    from pinot_tpu_torch.engine import kernels

    rng = np.random.default_rng(3)
    score = rng.integers(0, 4, (1 << 22) + 13).astype(np.float32)
    score[rng.integers(0, len(score), 1000)] = -np.inf
    for k in (9 + 256, 4096):
        want = np.argsort(-score, kind="stable")[:k]
        for dev in (cuda, torch.device("cpu")):
            key = kernels._tie_broken_key(torch.from_numpy(score).to(dev))
            got = torch.topk(key, k).indices.cpu().numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_cuda_selection_ties_match_the_cpu_on_every_path(cuda, tmp_path):
    """A key with ~10,000 tied matching rows a value, far more than k + 256:
    the per-segment path, the set executor and the pipeline's stacked top-k on
    the card return the CPU's rows, in the stable order by row."""
    from pinot_tpu_torch import execute_query, segments_from_columns
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.ssb import make_columns, ssb_schema

    c = make_columns(300_000, 5)
    c["lo_suppkey"] = (c["lo_suppkey"] % 24).astype(np.int32)
    segs = segments_from_columns(ssb_schema(), c, str(tmp_path), 3)
    m = c["lo_quantity"] >= 10
    idx = np.nonzero(m)[0]
    for desc in (False, True):
        sql = ("SELECT lo_custkey, lo_orderdate, lo_revenue FROM lineorder "
               f"WHERE lo_quantity >= 10 ORDER BY lo_suppkey {'DESC' if desc else ''} LIMIT 9")
        v = c["lo_suppkey"][idx].astype(np.int64)
        top = idx[np.argsort(-v if desc else v, kind="stable")[:9]]
        want = [[int(c["lo_custkey"][i]), int(c["lo_orderdate"][i]),
                 float(c["lo_revenue"][i])] for i in top]
        assert execute_query(segs, sql, device="cpu").rows == want
        kernels.reset_topk_launches()
        assert execute_query(segs, sql).rows == want
        assert MeshQueryExecutor(cuda).execute(segs, sql).rows == want
        pipeline = DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(cuda))
        try:
            ctx = compile_query(sql, segs[0].schema)
            partial = pipeline.execute_partial(ctx, segs)
            s = pipeline.stats()
        finally:
            pipeline.stop()
        rows = reduce_to_result(ctx, merge_segment_results([partial], []), [], []).rows
        assert rows == want
        assert (s["topkLaunches"], s["topkExact"]) == (1, 0)
        assert kernels.topk_launches() == 2 * len(segs) + 1


# -- the multistage join's device programs (plain torch on the card) ----------------

def _numpy_sort_merge(build, probe):
    order = np.argsort(build.astype(np.int64), kind="stable")
    s = build.astype(np.int64)[order]
    p = probe.astype(np.int64)
    lo = np.searchsorted(s, p, "left")
    return order, lo, np.searchsorted(s, p, "right") - lo, np.bincount(p & 255, minlength=256)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1000, 1 << 20), (100_003, 4099), (1, 7)])
def test_cuda_join_sort_programs_match_numpy(cuda, m, n):
    """The sort build and the sorted probe on the card against numpy's stable
    argsort and searchsorted over the uint32 codes, with duplicate codes and
    real codes of 0xFFFFFFFF, 0x80000000 and 0x7FFFFFFF (the sign flip's
    edges), which must order as uint32 do."""
    from pinot_tpu_torch.engine import join_kernels as jk

    rng = np.random.default_rng(m)
    build = rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
    build[::5] = build[0]
    edges = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0], dtype=np.uint32)
    build[1::7] = edges[np.arange(len(build[1::7])) % 4]
    probe = np.concatenate([build[rng.integers(0, m, n // 2)], edges,
                            rng.integers(0, 1 << 32, n - n // 2, dtype=np.uint64)
                            .astype(np.uint32)])
    srt, order = jk.sort_build_program(jk.device_codes(build, cuda))
    lo, cnt, hist = jk.sorted_probe_program(srt, jk.device_codes(probe, cuda))
    torch.cuda.synchronize()
    for got, want in zip((order, lo, cnt, hist), _numpy_sort_merge(build, probe)):
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    # the host function on the card equals it on the CPU
    on_card = jk.sort_merge_probe(build, probe, device=cuda)
    on_cpu = jk.sort_merge_probe(build, probe, device="cpu")
    for got, want in zip(on_card[:3], on_cpu[:3]):
        np.testing.assert_array_equal(got, want)
    assert on_card[3] == on_cpu[3]


@pytest.mark.gpu
@pytest.mark.parametrize("size", [1000, 100_000, 1 << 20])
def test_cuda_join_scatter_programs_match_numpy(cuda, size):
    """The scatter build and probe on the card: the table of unique slots,
    out-of-range build rows dropped, max occupancy, candidates and the
    histogram against numpy; a duplicate slot makes `scatter_probe` decline."""
    from pinot_tpu_torch.engine import join_kernels as jk

    rng = np.random.default_rng(size)
    m = size // 2
    build = rng.permutation(size)[:m].astype(np.int32)
    build[:7] = size                              # null rows
    probe = rng.integers(-5, size + 5, 1 << 20).astype(np.int32)
    table, max_count = jk.scatter_build_program(torch.from_numpy(build).to(cuda), size)
    cand, hist = jk.scatter_probe_program(table, torch.from_numpy(probe).to(cuda))
    torch.cuda.synchronize()
    want = np.full(size, -1, dtype=np.int64)
    live = build < size
    want[build[live]] = np.flatnonzero(live)
    np.testing.assert_array_equal(table.cpu().numpy(), want)
    assert int(max_count) == 1
    ok = (probe >= 0) & (probe < size)
    np.testing.assert_array_equal(cand.cpu().numpy(),
                                  np.where(ok, want[np.where(ok, probe, 0)], -1))
    np.testing.assert_array_equal(hist.cpu().numpy(),
                                  np.bincount(probe[ok] & 255, minlength=256))
    build[8] = build[9]
    assert jk.scatter_probe(build, probe, size, device=cuda) is None


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
def test_cuda_hash_join_matches_the_cpu(cuda, how):
    """`hash_join` with the device route forced: the card's rows equal the
    CPU's, in order, in both regimes (unique integer keys scatter, duplicate
    and string keys sort)."""
    from pinot_tpu_torch.engine import join_kernels as jk
    from pinot_tpu_torch.multistage import configure_device_join, hash_join
    from pinot_tpu_torch.multistage.planner import JoinSpec
    from pinot_tpu_torch.multistage.runtime import _DEVICE_JOIN

    rng = np.random.default_rng(7)
    univ = np.array([f"k{i}" for i in range(300)], dtype=object)
    cases = {
        "scatter": ({"lk": rng.integers(0, 5000, 40_000).astype(np.int64)},
                    {"rk": rng.permutation(6000)[:4000].astype(np.int32),
                     "w": rng.uniform(0, 1, 4000)}),
        "sort": ({"lk": rng.integers(0, 500, 40_000).astype(np.float64)},
                 {"rk": rng.integers(0, 500, 3000).astype(np.int64),
                  "w": rng.uniform(0, 1, 3000)}),
        "sort_str": ({"lk": univ[rng.integers(0, 300, 20_000)]},
                     {"rk": univ[rng.integers(0, 300, 700)], "w": rng.uniform(0, 1, 700)}),
    }
    saved = dict(_DEVICE_JOIN)
    configure_device_join(min_rows=0)
    try:
        spec = JoinSpec("r", how, ["lk"], ["rk"])
        for name, (left, right) in cases.items():
            jk.reset_launch_counts()
            got = hash_join(left, right, spec, device=cuda)
            regime = "scatter" if name == "scatter" else "sort"
            assert jk.launch_counts()[f"{regime}_build"] >= 1
            want = hash_join(left, right, spec, device="cpu")
            assert list(got) == list(want)
            for c in want:
                np.testing.assert_array_equal(got[c], want[c])
    finally:
        configure_device_join(**saved)


@pytest.mark.gpu
def test_cuda_join_queries_match_the_cpu(cuda, tmp_path):
    """The chip smoke's four join queries over a small lineorder: the card's
    rows equal the CPU's and the numpy oracle, through execute_multistage."""
    import math

    from pinot_tpu_torch import segments_from_columns, ssb
    from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan

    lo = ssb.make_columns(400_000, 11)
    dims = {"supplier": (ssb.supplier_schema(), ssb.make_supplier(seed=11)),
            "customer": (ssb.customer_schema(), ssb.make_customer(seed=11)),
            "region": (ssb.region_schema(), ssb.make_region())}
    tables = {"lineorder": segments_from_columns(ssb.ssb_schema(), lo,
                                                 str(tmp_path / "lo"), 3)}
    schemas = {"lineorder": ssb.ssb_schema()}
    for name, (schema, cols) in dims.items():
        tables[name] = segments_from_columns(schema, cols, str(tmp_path / name), 1)
        schemas[name] = schema
    for qid, sql in ssb.JOIN_QUERIES.items():
        got = execute_multistage(sql, make_segment_scan(tables), schemas.get)
        want = execute_multistage(sql, make_segment_scan(tables, device="cpu"), schemas.get)
        assert len(got.rows) == len(want.rows), qid
        for rg, rw in zip(got.rows, want.rows):
            assert all(x == y or math.isclose(x, y, rel_tol=1e-9) for x, y in zip(rg, rw)), qid
        assert "joinBuildMs" in got.stats and "joinServedHostTier" not in got.stats, qid


@pytest.mark.gpu
def test_cuda_staged_view_block_equals_the_host_built_block(cuda):
    """A consuming segment staged on the card: its view's block (the staged
    chunks joined on the card, zero-padded) equals the block the same view
    builds from its host columns, column by column and dtype by dtype; the
    epoch-ms column stays unstaged; and both scan kernels answer over the
    view as the CPU does."""
    from pinot_tpu_torch import execute_query
    from pinot_tpu_torch.engine import datablock
    from pinot_tpu_torch.ingest.vectorized import decode_columnar_block, encode_columnar_block
    from pinot_tpu_torch.schema import DataType, Schema, date_time, dimension, metric
    from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
    schema = Schema("events", [dimension("site", DataType.STRING),
                               metric("clicks", DataType.LONG),
                               metric("cost", DataType.DOUBLE),
                               metric("score", DataType.INT),
                               date_time("ts", DataType.LONG)])
    rng = np.random.default_rng(3)
    n = 70_001
    cols = {"site": [f"s{k}" for k in rng.integers(0, 23, n)],
            "clicks": rng.integers(-500, 5000, n), "cost": rng.random(n) * 90,
            "score": rng.integers(-100, 100, n), "ts": 1700000000000 + np.arange(n)}
    stores = {dev: DeviceMutableSegment("seg0", schema, device_staging=True, device=dev)
              for dev in ("cuda", "cpu")}
    for lo in range(0, n, 16_384):
        blob = encode_columnar_block(schema, {c: v[lo:lo + 16_384] for c, v in cols.items()})
        for store in stores.values():
            store.index_arrays(decode_columnar_block(blob))
    view = stores["cuda"].query_view()
    blk = datablock.block_for(view, cuda)
    assert blk is view._device_blocks[datablock.device_key(cuda)] and set(blk._raw) == {
        "clicks", "cost", "score"}
    # a bare "cuda" and the current card's index name the same staged block
    assert datablock.block_for(view, torch.device("cuda", torch.cuda.current_device())) is blk
    host = datablock.SegmentBlock(view, cuda)
    for col in ("clicks", "cost", "score"):
        staged, built = blk.raw(col), host.raw(col)
        assert staged.is_cuda and staged.dtype == built.dtype
        assert torch.equal(staged, built), col
    before = (scan.masked_sums.launches, scan.masked_sums_fused.launches)
    for sql in ("SELECT SUM(cost), COUNT(*) FROM events WHERE site = 's3'",
                "SELECT SUM(score), COUNT(*) FROM events WHERE site = 's3'"):
        got = execute_query([view], sql).rows
        want = execute_query([stores["cpu"].query_view()], sql, device="cpu").rows
        assert got[0][1] == want[0][1]
        assert got[0][0] == pytest.approx(want[0][0], rel=1e-5)
    assert (scan.masked_sums.launches, scan.masked_sums_fused.launches) == \
        (before[0] + 1, before[1] + 1)


# -- device expressions (engine/expr.eval_device) ----------------------------------

# one expression per name of expr.DEVICE_FUNCS over the columns of
# `device_expr_columns`; tests/test_torch_expr.py holds the same cases against
# the JAX package on the CPU
DEVICE_EXPR_CASES = {
    "plus": "i + p", "minus": "f - i", "times": "i * 3000000",   # the int32 product wraps
    "divide": "i / p", "mod": "mod(i, 7)", "eq": "k = 3", "neq": "k <> 3", "gt": "i > p",
    "gte": "k >= 0", "lt": "f < i", "lte": "k <= -2",
    "and": "k > 0 AND p < 50", "or": "k > 5 OR f < 0", "not": "NOT (i > 0 OR p < 50)",
    "in": "k IN (1, 2, 3, 5)", "not_in": "k NOT IN (1, 2)", "between": "i BETWEEN -10 AND 400",
    "case": "CASE WHEN k > 0 THEN i * 2 WHEN f < 0 THEN f ELSE 0 END",
    "cast": "CAST(f * 10 AS INT)",
    # a Python-scalar divisor: true division, not a reciprocal multiply (21 / 7)
    "abs": "abs(i)", "ceil": "ceil(p / 7)", "floor": "floor(i / 100)", "exp": "exp(u)",
    "ln": "ln(p)", "log": "log(p)", "log10": "log10(p)", "log2": "log2(p)", "sqrt": "sqrt(p)",
    "power": "power(i, 2)", "round": "round(f, 1)", "least": "least(i, 3.5, p)",
    "greatest": "greatest(i, p, 10)", "sign": "sign(k)", "truncate": "truncate(f, 1)",
    "sin": "sin(f)", "cos": "cos(i)", "tan": "tan(u)", "asin": "asin(u)", "acos": "acos(u)",
    "atan": "atan(f)", "sinh": "sinh(u)", "cosh": "cosh(u)", "tanh": "tanh(f)",
    "cot": "cot(u)", "atan2": "atan2(f, i)", "degrees": "degrees(i)", "radians": "radians(f)",
}
for _fn in ("year", "quarter", "month", "monthofyear", "day", "dayofmonth", "dayofyear",
            "doy", "dayofweek", "dow", "week", "weekofyear", "yearofweek", "yow", "hour",
            "minute", "second", "millisecond", "toepochseconds", "toepochminutes",
            "toepochhours", "toepochdays"):
    DEVICE_EXPR_CASES[_fn] = f"{_fn}(ts)"
for _unit, _size in (("seconds", 10), ("minutes", 15), ("hours", 2), ("days", 7)):
    DEVICE_EXPR_CASES[f"toepoch{_unit}bucket"] = f"toepoch{_unit}bucket(ts, {_size})"


def device_expr_columns(n: int, seed: int = 17) -> dict:
    """Seeded device columns as the device holds them: int32 and float32; `ts`
    spans the whole int32 range the planner admits (negatives included)."""
    rng = np.random.default_rng(seed)
    return {"i": rng.integers(-1000, 1000, n).astype(np.int32),
            "k": rng.integers(-10, 10, n).astype(np.int32),
            "p": rng.integers(1, 100, n).astype(np.int32),
            "f": rng.normal(0, 10, n).astype(np.float32),
            "u": rng.uniform(-0.9, 0.9, n).astype(np.float32),
            "ts": rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DEVICE_EXPR_CASES))
def test_cuda_eval_device_matches_the_cpu(cuda, name):
    """Each device function on CUDA tensors against the same on CPU tensors:
    the same dtype, integers and booleans equal, floats at rel 1e-5 (CUDA's
    transcendental functions round otherwise than the CPU's)."""
    from pinot_tpu_torch.engine.expr import eval_device
    from pinot_tpu_torch.sql.parser import Parser
    cols = device_expr_columns(1 << 16)
    e = Parser(DEVICE_EXPR_CASES[name]).expression()
    got = eval_device(e, {c: torch.from_numpy(v).to(cuda) for c, v in cols.items()})
    want = eval_device(e, {c: torch.from_numpy(v) for c, v in cols.items()})
    assert got.is_cuda and got.dtype == want.dtype
    if want.dtype.is_floating_point:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6, equal_nan=True)
    else:
        assert torch.equal(got.cpu(), want)


# -- the aggregation library's device outputs (engine/kernels.run_kernel) ------------

AGG_OUTPUT_QUERIES = {
    "scalar": ("SELECT DISTINCTCOUNT(lo_suppkey), PERCENTILETDIGEST(lo_discount, 95), "
               "KURTOSIS(lo_discount), SKEWNESS(lo_quantity), DISTINCTCOUNTHLL(lo_custkey) "
               "FROM lineorder WHERE lo_quantity < 25 AND lo_region <> 'ASIA'"),
    "grouped": ("SELECT lo_region, DISTINCTCOUNT(lo_suppkey), PERCENTILETDIGEST(lo_quantity, 50), "
                "VAR_SAMP(lo_discount), KURTOSIS(lo_discount) FROM lineorder "
                "WHERE lo_discount > 2 GROUP BY lo_region ORDER BY lo_region"),
}


@pytest.fixture(scope="module")
def agg_table(tmp_path_factory):
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    paths = build_aligned_segments(ssb.ssb_schema(), ssb.make_columns(300_007, 23),
                                   str(tmp_path_factory.mktemp("gpu_aggs")), "lineorder", 3,
                                   SegmentGeneratorConfig(raw_cardinality_fraction=1.0))
    return [load_segment(p) for p in paths]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(AGG_OUTPUT_QUERIES))
def test_cuda_distinct_and_power_sum_outputs_match_the_cpu(cuda, agg_table, shape):
    """`run_kernel`'s distinct output (presence, per-id counts, per group) on
    CUDA equals the CPU's exactly, and its power sums at rel 1e-6; over one
    segment and over the stacked set; the answers through both executors
    equal the CPU's (sketches bit for bit, moments at rel 1e-6)."""
    from pinot_tpu_torch import execute_query
    from pinot_tpu_torch.engine.datablock import block_for
    from pinot_tpu_torch.engine.kernels import run_kernel
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.executor import ServerQueryExecutor, kernel_spec
    from pinot_tpu_torch.query.planner import build_device_geometry, plan_segment
    sql = AGG_OUTPUT_QUERIES[shape]
    seg = agg_table[0]
    plan = plan_segment(compile_query(sql, seg.schema), seg)
    assert plan.kind == "device"
    build_device_geometry(plan)
    spec = kernel_spec(plan)
    card, cpu = (run_kernel(spec, ServerQueryExecutor(dev)._kernel_inputs(
        plan, spec, block_for(seg, dev))) for dev in (cuda, torch.device("cpu")))
    assert set(card) == set(cpu)
    names = sorted(cpu)
    assert any(k.endswith(".distinct") for k in names) and any(k.endswith(".sum4") for k in names)
    for name in names:
        got, want = card[name], cpu[name]
        assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape, name
        if want.dtype.is_floating_point:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0.0)
        else:
            assert torch.equal(got.cpu(), want), name
    for run in (lambda d: execute_query(agg_table, sql, device=d),
                lambda d: MeshQueryExecutor(device=d).execute(agg_table, sql)):
        got, want = run(cuda).rows, run("cpu").rows
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x == pytest.approx(y, rel=1e-6) if isinstance(y, float) else x == y


@pytest.mark.gpu
@pytest.mark.parametrize("size, ids_card", [(16, 11), (32768, 20_000), (1 << 19, 500_000)])
def test_cuda_distinct_counts_equal_bincount(cuda, size, ids_card):
    """The count-only `grouped_agg` counts equal `torch.bincount` of the same
    masked ids on the card, scalar and over a combined group key."""
    from pinot_tpu_torch.engine.kernels import distinct_counts
    gen = torch.Generator(device=cuda).manual_seed(5)
    n = (1 << 21) + 13
    ids = torch.randint(0, ids_card, (n,), device=cuda, generator=gen, dtype=torch.int32)
    mask = torch.rand(n, device=cuda, generator=gen) < 0.3
    want = torch.bincount(torch.where(mask, ids.long(), size), minlength=size + 1)[:size]
    assert torch.equal(distinct_counts(mask, ids, size), want.to(torch.int32))
    num_seg = 6
    group = torch.randint(0, 5, (n,), device=cuda, generator=gen, dtype=torch.int32)
    key = torch.where(mask, group.long() * size + ids.long(), num_seg * size)
    grouped = torch.bincount(key, minlength=num_seg * size + 1)[:num_seg * size]
    assert torch.equal(distinct_counts(mask, ids, size, [group], [1], num_seg),
                       grouped.view(num_seg, size).to(torch.int32))


GROUPED_OPS = ["sum", "sum2", "sum3", "sum4", "sum", "isum", "isum", "min", "max", "min",
               "max", "min", "max"]


def _grouped_inputs(dev, n, cells, seed, one_key=False, nan=False, big=False, groups=2):
    """Group ids whose dense key covers [0, cells) (two columns, or one key
    for every row), a mask keeping ~70%, and a value row per op of
    GROUPED_OPS (f32, f64, int32 and int64; NaN and +-inf rows where asked;
    int64 values near 2^40 where asked, so that a cell of a few thousand rows
    or more sums past 2^53 without passing 2^63)."""
    rng = np.random.default_rng(seed)
    if one_key:
        ids, strides = [np.zeros(n, dtype=np.int32)] * groups, [1] * groups
    elif groups == 0:
        ids, strides = [], []
    else:
        a = max(1, int(np.sqrt(cells)))
        k = rng.integers(0, cells, n)
        ids, strides = [(k % a).astype(np.int32), (k // a).astype(np.int32)], [1, a]
    f = rng.normal(0, 100, n).astype(np.float32)
    d = rng.normal(0, 1e6, n)
    i32 = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    i64 = (rng.integers((1 << 40) - 1000, (1 << 40), n) if big
           else rng.integers(-(1 << 40), 1 << 40, n)).astype(np.int64)
    if nan and n:
        f[::97], f[5::89], f[11::83] = np.nan, np.inf, -np.inf
        d[::101] = np.nan
    vals = [f, f, f, f, d, i32, i64, f, f, d, d, i32, i64]
    to = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    mask = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    return [to(t) for t in ids], strides, mask, [to(v) for v in vals]


def _assert_grouped_equal(got, want, ops):
    """Counts, int sums, min and max exactly (NaN where the plain version has
    NaN); f64-accumulated sums rounded to f32 within rel 2.5e-7, one f32 ulp:
    the atomics add the f64 partials in an order of their own."""
    assert len(got) == len(want) == len(ops) + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape, i
        g, w = g.cpu(), w.cpu()
        if i and ops[i - 1] in ("sum", "sum2", "sum3", "sum4"):
            torch.testing.assert_close(g, w, rtol=2.5e-7, atol=0.0, equal_nan=True)
        else:
            assert torch.equal(g, w) or torch.equal(g.isnan(), w.isnan()) and torch.equal(
                g[~g.isnan()], w[~w.isnan()]), i


# (cells, rung that one f64 sum takes): every rung at both of its edges (the
# thread rung from one cell to GROUP_QUERY's 9; the warp rung from 10 to
# 256; the block rung from 257, GROUP BY lo_orderdate's 4,097, to 19,370;
# the cluster rung from 19,371 to 38,740; the global rung past it to
# lo_custkey's 503,809)
GROUPED_RUNG_CASES = [(1, "thread"), (9, "thread"), (10, "warp"), (256, "warp"),
                      (257, "block"), (4097, "block"), (19_370, "block"), (19_371, "cluster"),
                      (38_740, "cluster"), (38_741, "global"), (503_809, "global")]


@pytest.mark.gpu
@pytest.mark.parametrize("cells, rung", GROUPED_RUNG_CASES)
@pytest.mark.parametrize("n", [0, 1, 3, 5, (1 << 20) - 1, (1 << 20) + 1, 8 * (1 << 21)],
                         ids=["0", "1", "3", "5", "2^20-1", "2^20+1", "stacked"])
def test_cuda_grouped_agg_matches_its_plain_version(cuda, cells, rung, n):
    """Every op of GROUPED_OPS at each rung and row count: one launch, the
    plain version's cells. The rung is the one `choose_rung` gives for one
    f64 sum (the widths of the launch's own outputs may move it: checked)."""
    from pinot_tpu_torch.engine import grouped
    assert grouped.choose_rung(cells, [8], grouped.device_caps(cuda)[1])[0] == rung
    ids, strides, mask, vals = _grouped_inputs(cuda, n, cells, seed=cells + n % 97)
    before = grouped.grouped_agg.launches
    got = grouped.grouped_agg(ids, strides, mask, vals, GROUPED_OPS, cells)
    torch.cuda.synchronize()
    assert grouped.grouped_agg.launches == before + 1
    want = grouped.grouped_agg_plain(ids, strides, mask, vals, GROUPED_OPS, cells)
    _assert_grouped_equal(got, want, GROUPED_OPS)
    # one f64 sum alone takes the case's rung
    got = grouped.grouped_agg(ids, strides, mask, vals[:1], ["sum"], cells)
    _assert_grouped_equal(got, grouped.grouped_agg_plain(ids, strides, mask, vals[:1],
                                                         ["sum"], cells), ["sum"])


@pytest.mark.gpu
@pytest.mark.parametrize("cells", [1, 9, 200, 4097, 503_809])
@pytest.mark.parametrize("what", ["one_key", "nan", "past_2_53", "no_groups"])
def test_cuda_grouped_agg_at_its_trouble_spots(cuda, cells, what):
    """One key holding every row (the most contention), NaN and +-inf rows,
    int64 sums past 2^53, and no group column (every kept row on key 0)."""
    from pinot_tpu_torch.engine import grouped
    n = (1 << 21) + 5
    ids, strides, mask, vals = _grouped_inputs(
        cuda, n, cells, seed=cells, one_key=what == "one_key", nan=what == "nan",
        big=what == "past_2_53", groups=0 if what == "no_groups" else 2)
    got = grouped.grouped_agg(ids, strides, mask, vals, GROUPED_OPS, cells)
    want = grouped.grouped_agg_plain(ids, strides, mask, vals, GROUPED_OPS, cells)
    _assert_grouped_equal(got, want, GROUPED_OPS)
    if what == "past_2_53" and cells <= 9:   # ~160,000 rows a cell and more
        assert int(got[7].max()) > (1 << 53)
    if what == "nan":
        assert bool(got[8].isnan().any()) and bool(got[10].isnan().any())


# (rung, cells, outputs of GROUPED_OPS) that `choose_rung` puts a launch on:
# every rung with every kind of cell it holds (one cell with the power sums,
# the scalar pass's shape; two cells of seven outputs, one of each kind, on
# the thread rung; all 13 outputs on the warp, block and global rungs; all
# but the 64-bit min and max, which it refuses, on the cluster rung), the
# block and cluster rungs below and above the cells their last block
# decodes alone
_ALL = tuple(range(len(GROUPED_OPS)))
_NO_MAX64 = tuple(i for i in _ALL if i not in (9, 10, 12))
GROUPED_EVERY_RUNG = [
    pytest.param("thread", 1, (1, 2, 3), id="thread_one_cell"),
    pytest.param("thread", 2, (0, 3, 4, 5, 7, 10, 11), id="thread"),
    pytest.param("warp", 32, _ALL, id="warp"),
    pytest.param("block", 2000, _ALL, id="block"),
    pytest.param("block", 9000, (0, 7, 12), id="block_9000"),
    pytest.param("cluster", 4097, _NO_MAX64, id="cluster"),
    pytest.param("cluster", 10_000, (0, 4, 5, 6, 7, 11), id="cluster_10000"),
    pytest.param("global", 30_000, _ALL, id="global")]


def _rung_inputs(dev, rung, picks, n, cells, seed, offset=0, mask_offset=0, one_key=False):
    """`_grouped_inputs` of n + 3 rows cut to n from row `offset` (the mask
    from `mask_offset`): columns whose data pointers start 4-24 bytes past
    an aligned address, so the kernel reads a head row by row, or, with the
    mask offset alone, every row by scalar loads; the value rows and ops of
    GROUPED_OPS at `picks`. Asserts that they take `rung`."""
    ids, strides, mask, vals = _grouped_inputs(dev, n + 3, cells, seed, one_key=one_key)
    cut = lambda t, k: t[k:k + n]   # noqa: E731
    vals, ops = [cut(vals[i], offset) for i in picks], [GROUPED_OPS[i] for i in picks]
    from pinot_tpu_torch.engine import grouped
    assert grouped.rung_for(dev, vals, ops, cells)[0] == rung
    return [cut(t, offset) for t in ids], strides, cut(mask, mask_offset), vals, ops


@pytest.mark.gpu
@pytest.mark.parametrize("rung, cells, picks", GROUPED_EVERY_RUNG)
@pytest.mark.parametrize("what", ["offset1", "offset2", "offset3", "mask_offset", "one_key",
                                  "n3", "n5", "2^20-1", "2^20+1"])
def test_cuda_grouped_agg_on_every_rung(cuda, rung, cells, picks, what):
    """Each rung, reached by its cell count, at its trouble spots: inputs offset by 1-3 rows
    (misaligned pointers: a head read row by row), the mask alone offset (no
    common head: scalar loads), one key holding every row, and row counts
    3, 5 and 2^20 +- 1 (a tail read row by row)."""
    from pinot_tpu_torch.engine import grouped
    n = {"n3": 3, "n5": 5, "2^20-1": (1 << 20) - 1}.get(what, (1 << 20) + 1)
    offset = int(what[-1]) if what.startswith("offset") else 0
    ids, strides, mask, vals, ops = _rung_inputs(
        cuda, rung, picks, n, cells, seed=cells + n % 89, offset=offset,
        mask_offset=1 if what == "mask_offset" else offset, one_key=what == "one_key")
    if offset:
        assert all(t.data_ptr() % 16 for t in ids) and mask.data_ptr() % 8
    got = grouped.grouped_agg(ids, strides, mask, vals, ops, cells)
    torch.cuda.synchronize()
    _assert_grouped_equal(got, grouped.grouped_agg_plain(ids, strides, mask, vals, ops, cells),
                          ops)
    # the same rows aligned, for the rung's answer on its other path
    aligned = [t.clone() for t in ids], strides, mask.clone(), [v.clone() for v in vals]
    _assert_grouped_equal(grouped.grouped_agg(*aligned, ops, cells), got, ops)


@pytest.mark.gpu
@pytest.mark.parametrize("rung, cells, picks", GROUPED_EVERY_RUNG + [
    pytest.param("global", 503_809, (0,), id="custkey")])
def test_cuda_grouped_agg_is_stable_under_graph_replay(cuda, rung, cells, picks):
    """Captured into a CUDA graph (the launch with its workspace's memset),
    every replay gives the eager call's counts, int sums, min and max bit for
    bit, and f32 sums within one ulp, on every rung and at lo_custkey's
    cells; eager calls between replays, on the stream's own workspace, agree
    too, and the launch counter counts the eager calls alone."""
    from pinot_tpu_torch.engine import grouped
    ids, strides, mask, vals, ops = _rung_inputs(cuda, rung, picks, 1 << 21, cells, seed=3)

    def call():
        return grouped.grouped_agg(ids, strides, mask, vals, ops, cells)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()   # warm
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    before = grouped.grouped_agg.launches
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        _assert_grouped_equal(out, eager, ops)
        _assert_grouped_equal(call(), eager, ops)
    assert grouped.grouped_agg.launches == before + 3


@pytest.mark.gpu
def test_cuda_grouped_agg_takes_one_kernel_a_call(cuda):
    """GROUP_QUERY's shape at one segment's size (9 cells, one f64 sum, the
    thread rung) and the scalar power sums (one cell) run as one kernel and
    nothing else on the card; the global rung as two beside the memset of
    its accumulators."""
    from torch.profiler import ProfilerActivity, profile
    from pinot_tpu_torch.engine import grouped
    for cells, ops, kernels in ((9, ["sum"], 1), (1, ["sum2", "sum3", "sum4"], 1),
                                (503_809, ["sum"], 2)):
        ids, strides, mask, vals = _grouped_inputs(cuda, 1 << 21, cells, seed=7)
        vals = vals[:len(ops)]
        grouped.grouped_agg(ids, strides, mask, vals, ops, cells)   # the workspace exists
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grouped.grouped_agg(ids, strides, mask, vals, ops, cells)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        others = [n for n in names if "grouped_" not in n]
        assert len(names) - len(others) == kernels, names
        assert others == ([] if kernels == 1 else [n for n in others if "emset" in n]), names


@pytest.mark.gpu
def test_cuda_grouped_agg_refuses_what_it_does_not_take(cuda):
    from pinot_tpu_torch.engine import grouped
    ids, strides, mask, vals = _grouped_inputs(cuda, 1000, 9, seed=1)
    before = grouped.grouped_agg.launches
    with pytest.raises(ValueError, match="int32"):
        grouped.grouped_agg([ids[0].long(), ids[1]], strides, mask, vals[:1], ["sum"], 9)
    with pytest.raises(ValueError, match="bool"):
        grouped.grouped_agg(ids, strides, mask.int(), vals[:1], ["sum"], 9)
    with pytest.raises(ValueError, match="isum"):
        grouped.grouped_agg(ids, strides, mask, vals[:1], ["isum"], 9)
    with pytest.raises(ValueError, match="contiguous"):
        grouped.grouped_agg(ids, strides, mask, [vals[0].cpu()], ["sum"], 9)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.stack([vals[0], vals[0]], 1)[:, 0]
        grouped.grouped_agg(ids, strides, mask, [strided], ["sum"], 9)
    with pytest.raises(ValueError, match="cells"):
        grouped.grouped_agg(ids, strides, mask, vals[:1], ["sum"], 0)
    with pytest.raises(ValueError, match="at most"):
        grouped.grouped_agg(ids * 9, strides * 9, mask, vals[:1], ["sum"], 9)
    with pytest.raises(ValueError, match="f32, f64"):
        grouped.grouped_agg(ids, strides, mask, [vals[0].half()], ["sum"], 9)
    assert grouped.grouped_agg.launches == before


@pytest.mark.gpu
def test_cuda_group_by_runs_through_grouped_agg_on_every_path(cuda, tmp_path):
    """GROUP BY, grouped and scalar DISTINCTCOUNT and the scalar power sums
    launch `grouped_agg` (one call for a GROUP BY's outputs, one per
    distinct, one for a plan's power sums) per segment and over the set; a
    6,000-key server partial through the pipeline is dense and reduces to
    the set's answer. Floats at rel 1e-5: each f32 sum is within one ulp of
    the CPU's (the atomics add the f64 partials in an order of their own),
    and KURTOSIS's fourth central moment cancels ~40x of that (a run gave
    -1.2196853 against the CPU's -1.2196866), as the CPU tests hold the
    moments against the reference at rel 1e-5."""
    from pinot_tpu_torch import execute_query, load_segment, ssb
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.engine import grouped
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    segs = [load_segment(p) for p in build_aligned_segments(
        ssb.ssb_schema(), ssb.make_columns(200_003, 29), str(tmp_path), "lineorder", 4,
        SegmentGeneratorConfig(raw_cardinality_fraction=1.0))]
    mx = MeshQueryExecutor(device=cuda)
    for sql, per_pass in ((ssb.GROUP_QUERY, 1),
                          ("SELECT lo_region, DISTINCTCOUNT(lo_discount), VAR_POP(lo_quantity) "
                           "FROM lineorder GROUP BY lo_region ORDER BY lo_region", 2),
                          ("SELECT DISTINCTCOUNT(lo_discount), KURTOSIS(lo_discount) "
                           "FROM lineorder WHERE lo_quantity < 25", 2)):
        want = execute_query(segs, sql, device="cpu").rows
        for run, passes in ((lambda: execute_query(segs, sql, device=cuda), len(segs)),
                            (lambda: mx.execute(segs, sql), 1)):
            before = grouped.grouped_agg.launches
            got = run().rows
            assert grouped.grouped_agg.launches - before == per_pass * passes, sql
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for x, y in zip(g, w):
                    assert x == pytest.approx(y, rel=1e-5) if isinstance(y, float) \
                        else x == y, (sql, g, w)
    sql = ("SELECT lo_suppkey, SUM(lo_revenue), COUNT(*), MAX(lo_quantity) FROM lineorder "
           "GROUP BY lo_suppkey ORDER BY lo_suppkey LIMIT 100000")
    ctx = compile_query(sql, segs[0].schema)
    aggs = [make_agg(f) for f in ctx.aggregations]
    p = DeviceQueryPipeline(mesh_exec=mx)
    try:
        parts = [p.execute_partial(ctx, half) for half in (segs[:2], segs[2:])]
    finally:
        p.stop()
    assert all(part.dense is not None for part in parts)
    got = reduce_to_result(ctx, merge_segment_results(parts, aggs), aggs,
                           list(ctx.group_by)).rows
    want = mx.execute(segs, sql).rows
    assert len(got) == len(want) > 4096
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2:] == w[2:] and g[1] == pytest.approx(w[1], rel=1e-6)


def _bitmap_case(dev, segments: int, words: int, cards, ks, seed: int, density: int = 1):
    """Random word matrices ([S, card, W] per leaf) with k selected rows each,
    and valid words whose last segment ends 1,000 rows early. `density` ANDs
    that many random words into each, so a bit is set with odds 2^-density."""
    from pinot_tpu_torch.engine.bitmap import BitmapLeaf, pack_valid
    rng = np.random.default_rng(seed)
    leaves = []
    for card, k in zip(cards, ks):
        w = np.full((segments, card, words), 0xFFFFFFFF, dtype=np.uint32)
        for _ in range(density):
            w &= rng.integers(0, 1 << 32, w.shape, dtype=np.uint64).astype(np.uint32)
        rows = tuple(sorted(rng.choice(card, k, replace=False).tolist()))
        leaves.append(BitmapLeaf(torch.from_numpy(w.view(np.int32)).to(dev)
                                 if segments > 1 else
                                 torch.from_numpy(w[0].view(np.int32)).to(dev), rows))
    valid = np.ones(segments * words * 32, dtype=bool)
    valid[-1000:] = False
    return leaves, pack_valid(torch.from_numpy(valid).to(dev))


def _assert_bitmap_modes(program, leaves, valid_words):
    """Each mode's kernel output equals the plain version's; one launch a call."""
    from pinot_tpu_torch.engine import bitmap
    for mode in ("words", "mask", "count"):
        before = bitmap.bitmap_filter.launches
        got = bitmap.bitmap_filter(program, leaves, valid_words, mode)
        torch.cuda.synchronize()
        assert bitmap.bitmap_filter.launches == before + 1
        want = bitmap.bitmap_filter_plain(program, leaves, valid_words, mode)
        assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), (program, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("segments, words", [(1, 65_536), (8, 65_536), (1, 1_001), (3, 4_099),
                                             (2, 7), (1, 65_540), (3, 65_540), (8, 65_540)],
                         ids=["segment", "stacked", "odd_words", "odd_stacked", "tiny",
                              "segment_plus_4", "stacked_plus_4", "stacked8_plus_4"])
def test_cuda_bitmap_filter_matches_its_plain_version(cuda, segments, words):
    """`bitmap_filter` on the card equals `bitmap_filter_plain` in all three
    modes, on one segment and on stacked sets, with W a multiple of 4 (16-byte
    copies and loads) or not (4-byte loads), W a multiple of the 256-word tile
    or not (a short last tile in every segment), for an all-bitmap tree with
    NOT; over one leaf of one row and over the bitmap query's 1 + 3 rows
    (loaded into registers where each block takes one tile, else through the
    ring: the 8-segment sets), and over leaves that pass a ring stage (3 + 12
    + an empty leaf + 64 rows); one launch per call, counted."""
    from pinot_tpu_torch.engine import bitmap
    programs = [[0], [0, 1, bitmap.AND], [0, 1, bitmap.NOT, bitmap.OR, 2, bitmap.OR, 3,
                                          bitmap.AND, bitmap.NOT]]
    one = _bitmap_case(cuda, segments, words, (11,), (1,), seed=segments * 3 + words)
    few = _bitmap_case(cuda, segments, words, (11, 50, 5, 64), (1, 3, 0, 0),
                       seed=segments * 5 + words)
    many = _bitmap_case(cuda, segments, words, (11, 50, 5, 64), (3, 12, 0, 64),
                        seed=segments * 7 + words)
    for program in ([0], [0, bitmap.NOT]):
        _assert_bitmap_modes(program, *one)
    for leaves, valid_words in (few, many):
        for program in programs:
            _assert_bitmap_modes(program, leaves, valid_words)


@pytest.mark.gpu
@pytest.mark.parametrize("segments, words", [(2, 4_100), (1, 1_001)], ids=["bulk", "plain"])
def test_cuda_bitmap_filter_at_its_limits(cuda, segments, words):
    """A program at every limit equals the plain version: 16 leaves of 64
    selected rows (1,024 rows, 65 ring stages a tile), 64 codes, a stack 16
    deep (all 16 leaves pushed before the first AND / OR), NOTs between;
    sparse words (a bit in 64), so that each leaf's OR is neither empty nor
    full."""
    from pinot_tpu_torch.engine import bitmap
    leaves, valid_words = _bitmap_case(cuda, segments, words, (200,) * 16, (64,) * 16,
                                       seed=words, density=6)
    program = []
    for leaf in range(16):
        program += [leaf] + [bitmap.NOT] * (leaf % 2)
    for j in range(15):
        program += [(bitmap.AND, bitmap.OR)[j % 3 == 0]] + [bitmap.NOT] * (1 + (j < 10))
    assert len(program) == bitmap.MAX_PROGRAM and bitmap._depth(program) == bitmap.MAX_STACK
    _assert_bitmap_modes(program, leaves, valid_words)


@pytest.mark.gpu
def test_cuda_bitmap_count_carries_nothing_between_calls(cuda):
    """Count mode twice in a row, and replayed twice from a CUDA graph, gives
    the same count each time: the finishing ticket and the blocks' counts are
    not carried from one launch to the next."""
    from pinot_tpu_torch.engine import bitmap
    leaves, valid_words = _bitmap_case(cuda, 8, 65_536, (11, 50), (1, 3), seed=5)
    program = [0, 1, bitmap.AND]
    want = bitmap.bitmap_filter_plain(program, leaves, valid_words, "count")
    assert int(want) > 0
    for _ in range(2):
        assert torch.equal(bitmap.bitmap_filter(program, leaves, valid_words, "count"), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bitmap.bitmap_filter(program, leaves, valid_words, "count")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = bitmap.bitmap_filter(program, leaves, valid_words, "count")
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(bitmap.bitmap_filter(program, leaves, valid_words, "count"), want)


@pytest.mark.gpu
def test_cuda_bitmap_filter_refuses_what_it_does_not_take(cuda):
    from pinot_tpu_torch.engine import bitmap
    leaves, valid_words = _bitmap_case(cuda, 1, 64, (11,), (3,), seed=3)
    with pytest.raises(ValueError):
        bitmap.bitmap_filter([0], leaves, valid_words[:-1], "mask")
    with pytest.raises(ValueError):
        bitmap.bitmap_filter([0], [bitmap.BitmapLeaf(leaves[0].words, (11,))], valid_words,
                             "mask")
    with pytest.raises(ValueError):
        bitmap.bitmap_filter([0] * 17 + [bitmap.AND] * 16, leaves * 17, valid_words, "count")


@pytest.fixture(scope="module")
def index_table(tmp_path_factory):
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    config = SegmentGeneratorConfig(
        inverted_index_columns=["lo_region", "lo_discount", "lo_quantity"],
        range_index_columns=["lo_orderdate"], bloom_filter_columns=["lo_custkey"],
        star_tree_configs=[
            {"dimensionsSplitOrder": ["lo_region", "lo_discount"],
             "functionColumnPairs": ["SUM__lo_revenue"]},
            {"dimensionsSplitOrder": ["lo_orderdate", "lo_discount"],
             "functionColumnPairs": ["SUM__lo_revenue"]}])
    paths = build_aligned_segments(ssb.ssb_schema(), ssb.make_columns(400_003, 29),
                                   str(tmp_path_factory.mktemp("gpu_index")), "lineorder", 4,
                                   config)
    return [load_segment(p) for p in paths]


INDEX_QUERIES = {
    "star_query": ("SELECT lo_region, SUM(lo_revenue) FROM lineorder "
                   "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY lo_region ORDER BY lo_region"),
    "star_hc": ("SELECT lo_orderdate, SUM(lo_revenue), COUNT(*), AVG(lo_revenue) FROM lineorder "
                "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY lo_orderdate "
                "ORDER BY lo_orderdate LIMIT 10"),
    "all_bitmap": ("SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
                   "WHERE lo_discount = 2 AND lo_quantity IN (1, 7, 13) GROUP BY lo_region "
                   "ORDER BY lo_region"),
    "mixed": ("SELECT COUNT(*), SUM(lo_extendedprice) FROM lineorder "
              "WHERE lo_discount = 2 AND lo_revenue > 30000"),
    "not_bitmap": ("SELECT lo_discount, COUNT(*) FROM lineorder "
                   "WHERE NOT lo_quantity IN (3, 4, 5) AND lo_region = 'ASIA' "
                   "GROUP BY lo_discount ORDER BY lo_discount"),
    "bitmap_topk": ("SELECT lo_custkey, lo_revenue FROM lineorder "
                    "WHERE lo_quantity = 7 AND lo_discount = 3 ORDER BY lo_revenue DESC LIMIT 5"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(INDEX_QUERIES))
def test_cuda_star_tree_and_bitmap_queries_match_the_cpu(cuda, index_table, name):
    """Star-tree and bitmap-filter queries on the card, per segment and over
    the set (the stacked device star path for the star queries), equal the
    same calls on the CPU (counts exactly, sums rel 1e-6)."""
    from pinot_tpu_torch import execute_query
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    sql = INDEX_QUERIES[name]
    for run in (lambda d: execute_query(index_table, sql, device=d),
                lambda d: MeshQueryExecutor(device=d).execute(index_table, sql)):
        got, want = run(cuda).rows, run("cpu").rows
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x == pytest.approx(y, rel=1e-6) if isinstance(y, float) else x == y


@pytest.fixture(scope="module")
def search_table(tmp_path_factory):
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    cols = ssb.make_search_columns(100_003, 31)
    config = SegmentGeneratorConfig(
        json_index_columns=["lo_payload"], text_index_columns=["lo_comment"],
        fst_index_columns=["lo_custname"], geo_index_pairs=["lo_lng,lo_lat"],
        inverted_index_columns=["lo_discount"], raw_compression="zlib",
        no_dictionary_columns=["lo_extendedprice", "lo_revenue", "lo_lng", "lo_lat"])
    paths = build_aligned_segments(ssb.search_schema(), cols,
                                   str(tmp_path_factory.mktemp("gpu_search")), "lineorder", 4,
                                   config)
    return cols, [load_segment(p) for p in paths]


def _search_sql(name, cols):
    from pinot_tpu_torch import ssb
    if not name.startswith("geo_"):
        return ssb.SEARCH_QUERIES[name]
    i = next(i for i, v in enumerate(cols["lo_lng"]) if v is not None)
    return ssb.SEARCH_QUERIES["geo_distance"].format(
        lng=repr(float(cols["lo_lng"][i])), lat=repr(float(cols["lo_lat"][i])),
        r=float(name.split("_")[1]))


SEARCH_SHAPES = ["json_type", "json_array_range", "json_presence", "text_or", "text_prefix",
                 "text_regex", "text_not", "text_mixed", "text_select", "regexp_fst",
                 "geo_10000", "geo_100000", "q1_1", "for_sum"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", SEARCH_SHAPES)
def test_cuda_search_queries_match_the_cpu(cuda, search_table, name):
    """The search phase's query shapes on the card, per segment, over the set
    and over a staged consuming view, equal the same calls on the CPU (counts
    exactly, sums rel 1e-6; a distance count by at most 2 rows: a distance
    within metres of the radius may compare either way in f32)."""
    from pinot_tpu_torch import execute_query, ssb
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
    cols, table = search_table
    sql = {"q1_1": ssb.QUERY, "for_sum": ssb.FOR_QUERY}.get(name) or _search_sql(name, cols)
    views = {}
    for dev in (cuda, torch.device("cpu")):
        store = DeviceMutableSegment("lineorder__0__0__20261019T0000Z", ssb.search_schema(),
                                     device_staging=True, device=dev)
        store.index_batch({c: list(v[:20_000]) for c, v in cols.items()})
        views[dev.type] = store.query_view()
    runs = (lambda d: execute_query(table, sql, device=d),
            lambda d: MeshQueryExecutor(device=d).execute(table, sql),
            lambda d: execute_query([views[torch.device(d).type]], sql, device=d))
    for run in runs:
        got, want = run(cuda).rows, run("cpu").rows
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                if name.startswith("geo_"):
                    assert abs(x - y) <= 2
                elif isinstance(y, float):
                    assert x == pytest.approx(y, rel=1e-6)
                else:
                    assert x == y


@pytest.fixture(scope="module")
def mv_table(tmp_path_factory):
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    cols = ssb.make_mv_columns(60_000, 13)
    paths = build_aligned_segments(ssb.mv_schema(), cols, str(tmp_path_factory.mktemp("mv")),
                                   "lineorder", 3, SegmentGeneratorConfig(
                                       inverted_index_columns=["lo_tags", "lo_discount"]))
    return cols, [load_segment(p) for p in paths]


MV_SHAPES = ["tags_eq", "codes_band_tags_in", "not_eq", "mixed", "q1_1", "selection"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", MV_SHAPES)
def test_cuda_mv_queries_match_the_cpu(cuda, mv_table, name):
    """The mv phase's device-routed shapes on the card (the any-value mask
    over the [P, W] id matrix, stacked `[S, rows, W]` over the set, and over
    a staged consuming view) equal the same calls on the CPU (counts and
    cells exactly, sums rel 1e-6)."""
    from pinot_tpu_torch import execute_query, ssb
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.segment.mutable_device import DeviceMutableSegment
    cols, table = mv_table
    sql = ssb.MV_QUERIES[name]
    views = {}
    for dev in (cuda, torch.device("cpu")):
        store = DeviceMutableSegment("lineorder__0__0__20261101T0000Z", ssb.mv_schema(),
                                     device_staging=True, device=dev)
        store.index_batch({c: list(v[:20_000]) for c, v in cols.items()})
        views[dev.type] = store.query_view()
    runs = (lambda d: execute_query(table, sql, device=d),
            lambda d: MeshQueryExecutor(device=d).execute(table, sql),
            lambda d: execute_query([views[torch.device(d).type]], sql, device=d))
    for run in runs:
        got, want = run(cuda).rows, run("cpu").rows
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x == pytest.approx(y, rel=1e-6) if isinstance(y, float) else x == y


@pytest.mark.gpu
@pytest.mark.parametrize("n", [524_288, (1 << 20) + 77, 1, 300])
def test_cuda_kernels_with_a_valid_band_match_plain_versions(cuda, n):
    """An upsert valid-doc mask rides both scans as one more int32 0/1 column
    with the band (1, 1), beside the id bands (Q1.1's three, the FOR sum's
    one): the kernels against their plain versions on the same inputs."""
    d = _data(n, seed=21)
    live = torch.from_numpy((np.random.default_rng(5).random(n) < 0.2).astype(np.int32))
    before = (scan.masked_sums.launches, scan.masked_sums_fused.launches)
    cols = [torch.from_numpy(d[k]).to(cuda) for k in ("od", "disc", "qty")] + [live.to(cuda)]
    rows = [torch.from_numpy(d["price"]).to(cuda)]
    bands = Q11_BANDS + [(1, 1)]
    _assert_same(scan.masked_sums(cols, bands, rows), scan.masked_sums_plain(cols, bands, rows))
    ids = [cols[1], cols[3]]
    for delta in ("d8", "d16"):
        for_rows = [(0.0, torch.from_numpy(d[delta]).to(cuda))]
        _assert_same(scan.masked_sums_fused(ids, [(1, 3), (1, 1)], for_rows),
                     scan.masked_sums_fused_plain(ids, [(1, 3), (1, 1)], for_rows))
    assert (scan.masked_sums.launches - before[0],
            scan.masked_sums_fused.launches - before[1]) == (1, 2)


@pytest.mark.gpu
def test_cuda_upsert_queries_take_the_banded_scan(cuda, tmp_path):
    """Committed upsert segments answer Q1.1's shape and the FOR sum through
    the scans with the valid band (one launch a segment), equal to the CPU;
    an update restages the band of the segments it touched."""
    from pinot_tpu_torch import execute_query, ssb, upsert
    from pinot_tpu_torch.engine.datablock import block_for
    from pinot_tpu_torch.segment import segments_from_columns
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig
    schema = ssb.upsert_schema()
    cols = ssb.make_upsert_events(40_000, 9_000, 3)
    segs = segments_from_columns(schema, cols, str(tmp_path), 2, SegmentGeneratorConfig(
        no_dictionary_columns=["lo_tax"], inverted_index_columns=["lo_region", "lo_discount"]))
    mgr = upsert.TableUpsertMetadataManager()
    for s in segs:
        keys = np.asarray(s.column("lo_orderkey").values())
        ts = np.asarray(s.column("lo_ts").values())
        for d in range(s.num_docs):
            mgr.partition(0).add_record(s.name, d, (int(keys[d]),), int(ts[d]))
    band_q = ("SELECT SUM(lo_extendedprice * lo_discount), COUNT(*) FROM lineorder "
              "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25")
    for sql, kernel in ((band_q, scan.masked_sums), (ssb.UPSERT_QUERIES["for_sum"],
                                                    scan.masked_sums_fused)):
        before = kernel.launches
        got = execute_query(segs, sql, device=cuda, upsert=mgr).rows
        assert kernel.launches - before == len(segs)
        want = execute_query(segs, sql, device="cpu", upsert=mgr).rows
        assert got[0][1] == want[0][1] and got[0][0] == pytest.approx(want[0][0], rel=1e-5)
    key = block_for(segs[0], cuda)._valid_band[0]
    mgr.partition(0).add_record(segs[0].name, 0, (int(cols["lo_orderkey"][0]),), 1 << 62)
    execute_query(segs, band_q, device=cuda, upsert=mgr)
    assert block_for(segs[0], cuda)._valid_band[0] != key


@pytest.mark.gpu
def test_cuda_explain_analyze_launches_one_scan_a_segment(cuda, tmp_path):
    """EXPLAIN ANALYZE of Q1.1 on CUDA segments runs the query: one
    `masked_sums` launch a segment, the same Rows as on the CPU and a Ms on
    each annotated row; a plain EXPLAIN launches nothing."""
    from pinot_tpu_torch import execute_query, ssb
    from pinot_tpu_torch.segment import segments_from_columns
    segs = segments_from_columns(ssb.ssb_schema(), ssb.make_columns(60_000, 13),
                                 str(tmp_path), 3)
    before = scan.masked_sums.launches
    execute_query(segs, "EXPLAIN PLAN FOR " + ssb.QUERY, device=cuda)
    assert scan.masked_sums.launches == before
    got = execute_query(segs, "EXPLAIN ANALYZE " + ssb.QUERY, device=cuda)
    assert scan.masked_sums.launches - before == len(segs)
    want = execute_query(segs, "EXPLAIN ANALYZE " + ssb.QUERY, device="cpu")
    assert [r[:4] for r in got.rows] == [r[:4] for r in want.rows]
    assert got.rows[0][3] == 1
    assert all(ms is not None and ms >= 0 for _, _, _, rows, ms in got.rows if rows is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("pipelines", [False, True])
def test_cuda_broker_answers_match_the_cpu(cuda, tmp_path, pipelines):
    """Q1.1 and GROUP_QUERY through the broker of a QuickCluster on the card
    (per-segment servers, or servers on the serving pipeline) equal the CPU
    cluster's answers; the scan runs one launch a segment, or one a server
    the route gives segments."""
    from pinot_tpu_torch import QuickCluster, ssb
    from pinot_tpu_torch.cluster import DeviceQueryPipeline, ServerNode
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.table import TableConfig
    cols = ssb.make_columns(120_000, 23)
    answers = {}
    for name, device in (("cuda", cuda), ("cpu", "cpu")):
        cluster = QuickCluster(num_servers=0 if pipelines and name == "cuda" else 2,
                               work_dir=str(tmp_path / name), device=device)
        for i in range(2 - len(cluster.servers)):
            # servers on the serving pipeline, wired as a server process wires them
            server = ServerNode(f"server_{i}", cluster.catalog, cluster.deepstore,
                                str(tmp_path / name / f"server_{i}"), device=device,
                                device_pipeline=DeviceQueryPipeline(MeshQueryExecutor(device)))
            cluster.servers.append(server)
            cluster.broker.register_server_handle(server.instance_id, server.execute_partial)
        cfg = cluster.create_table(ssb.ssb_schema(), TableConfig("lineorder", replication=2))
        for i in range(4):
            cluster.ingest_columns(cfg, {k: v[i * 30_000:(i + 1) * 30_000]
                                         for k, v in cols.items()})
        before = scan.masked_sums.launches
        q11 = cluster.query(ssb.QUERY)
        launched = scan.masked_sums.launches - before
        if name == "cuda":
            assert launched == (q11.stats["numServersQueried"] if pipelines else 4)
        answers[name] = (q11.rows, cluster.query(ssb.GROUP_QUERY).rows)
        assert q11.stats["partialResult"] is False and q11.stats["numSegmentsQueried"] == 4
        cluster.shutdown()
    (gq, gg), (wq, wg) = answers["cuda"], answers["cpu"]
    assert np.isclose(gq[0][0], wq[0][0], rtol=1e-5, atol=0.05)
    assert [r[0] for r in gg] == [r[0] for r in wg] and [r[2] for r in gg] == [r[2] for r in wg]
    assert np.allclose([r[1] for r in gg], [r[1] for r in wg], rtol=1e-5, atol=0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("pipelines", [False, True])
def test_cuda_capped_cluster_answers_as_the_cpu_within_its_capacity(cuda, tmp_path, pipelines):
    """A server whose `server.hbm.capacity.bytes` holds two of its 6 segments'
    predicted blocks (a table three times its target): Q1.1, GROUP_QUERY and
    a COUNT through the broker equal the uncapped CPU cluster's,
    some segments answer on the host tier, the memory ledger stays at or
    under the capacity after every query, and the scan launches once an
    admitted segment (once a query on the pipeline)."""
    from pinot_tpu_torch import QuickCluster, ssb
    from pinot_tpu_torch.cluster import DeviceQueryPipeline, ServerNode
    from pinot_tpu_torch.engine.datablock import predicted_block_bytes
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.segment.writer import build_aligned_segments
    from pinot_tpu_torch.table import TableConfig
    from pinot_tpu_torch.utils.memledger import get_ledger, reset_ledger
    cols = ssb.make_columns(6 * 65_536, 29)
    dirs = build_aligned_segments(ssb.ssb_schema(), cols, str(tmp_path / "segs"), "lineorder", 6)
    queries = (ssb.QUERY, ssb.GROUP_QUERY,
               "SELECT COUNT(*) FROM lineorder WHERE lo_quantity < 10")
    answers = {}
    for name, device in (("cuda", cuda), ("cpu", "cpu")):
        reset_ledger()
        cluster = QuickCluster(num_servers=0, work_dir=str(tmp_path / name), device=device)
        capacity = None
        if name == "cuda":
            from pinot_tpu_torch.segment import load_segment
            capacity = int(2 * predicted_block_bytes(load_segment(dirs[0])) / 0.9) + 2
            cluster.catalog.put_property("clusterConfig/server.hbm.capacity.bytes", capacity)
        server = ServerNode("server_0", cluster.catalog, cluster.deepstore,
                            str(tmp_path / name / "server_0"), device=device,
                            device_pipeline=DeviceQueryPipeline(MeshQueryExecutor(device))
                            if pipelines else None)
        cluster.servers.append(server)
        cluster.broker.register_server_handle(server.instance_id, server.execute_partial)
        cluster.create_table(ssb.ssb_schema(), TableConfig("lineorder"))
        for d in dirs:
            cluster.controller.upload_segment("lineorder_OFFLINE", d)
        got = []
        for _ in range(2):
            for sql in queries:
                before = scan.masked_sums.launches
                res = cluster.query(sql)
                assert not res.stats["partialResult"] and res.stats["numSegmentsQueried"] == 6
                got.append(res.rows)
                if name == "cuda":
                    host = res.stats["segmentsServedHostTier"]
                    assert host > 0
                    assert get_ledger().resident_bytes() <= capacity
                    if sql != ssb.GROUP_QUERY:
                        want = 1 if pipelines else 6 - host
                        assert scan.masked_sums.launches - before == want
        answers[name] = got
        cluster.shutdown()
        reset_ledger()
    for g, w in zip(answers["cuda"], answers["cpu"]):
        assert len(g) == len(w)
        for rg, rw in zip(g, w):
            for x, y in zip(rg, rw):
                assert (np.isclose(x, y, rtol=1e-5, atol=0.05) if isinstance(y, float)
                        else x == y)


def _realtime_cluster_run(root, device, cols, rounds=5, block_rows=4_096, round_blocks=2):
    """A REALTIME lineorder table (2 partitions, replication 2, PCB1 blocks
    staged on `device`, commits of 16,384 rows) on a QuickCluster of two
    servers on `device`, fed `cols[p]` a round at a time. Returns the
    catalog (LLC names without their creation time) and each round's
    answers to Q1.1, GROUP_QUERY and the COUNT, checking on the card that
    Q1.1 launches `masked_sums` once a committed segment and GROUP_QUERY
    `grouped_agg` once a segment queried."""
    from pinot_tpu_torch import QuickCluster, ssb
    from pinot_tpu_torch.engine import grouped
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
    MemoryStream.reset_all()
    cluster = QuickCluster(num_servers=2, work_dir=root, device=device)
    cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=2,
                      time_column="lo_orderdate",
                      stream=StreamConfig(topic="rt", decoder="columnar",
                                          flush_threshold_rows=16_384,
                                          properties={"realtime.ingest.device.staging": "true"}))
    table = cfg.table_name_with_type
    cluster.create_realtime_table(ssb.ssb_schema(), cfg, 2)
    answers = []
    step = block_rows * round_blocks
    for r in range(rounds):
        for p in range(2):
            for lo in range(r * step, (r + 1) * step, block_rows):
                MemoryStream.get("rt").produce(encode_columnar_block(
                    ssb.ssb_schema(), {k: v[lo:lo + block_rows] for k, v in cols[p].items()}),
                    partition=p)
        cluster.pump_realtime(table)
        done = sum(m.status == "DONE" for m in cluster.catalog.segments[table].values())
        before = scan.masked_sums.launches
        q11 = cluster.query(ssb.QUERY)
        if device != "cpu":
            assert scan.masked_sums.launches - before == done
        before = grouped.grouped_agg.launches
        group = cluster.query(ssb.GROUP_QUERY)
        if device != "cpu":
            assert grouped.grouped_agg.launches - before == group.stats["numSegmentsQueried"]
        count = cluster.query("SELECT COUNT(*) FROM lineorder")
        assert count.rows == [[2 * (r + 1) * step]]
        assert not (q11.stats["partialResult"] or group.stats["partialResult"])
        answers.append((q11.rows, group.rows, count.rows))
    with cluster.catalog._lock:
        view = ({"__".join(n.split("__")[:3]): (m.status, m.start_offset, m.end_offset,
                                                m.num_docs, m.start_time_ms, m.end_time_ms)
                 for n, m in cluster.catalog.segments[table].items()},
                {"__".join(n.split("__")[:3]): dict(a)
                 for n, a in cluster.catalog.external_view[table].items()})
    cluster.shutdown()
    MemoryStream.reset_all()
    return view, answers


@pytest.mark.gpu
def test_cuda_realtime_cluster_matches_the_cpu(cuda, tmp_path):
    """A REALTIME table on two servers on the card, consumed past its flush
    threshold (each partition commits twice): the same catalog and, round by
    round, the same broker answers as on the CPU; the scans launch once a
    committed segment, the GROUP BY once a segment queried."""
    from pinot_tpu_torch import ssb
    cols = [ssb.make_columns(40_960, 29 + p) for p in range(2)]
    got = _realtime_cluster_run(str(tmp_path / "cuda"), cuda, cols)
    want = _realtime_cluster_run(str(tmp_path / "cpu"), "cpu", cols)
    assert got[0] == want[0]
    assert sum(st == "DONE" for st, *_ in got[0][0].values()) == 4
    for (gq, gg, gc), (wq, wg, wc) in zip(got[1], want[1]):
        assert gc == wc
        assert np.isclose(gq[0][0], wq[0][0], rtol=1e-5, atol=0.05)
        assert [r[0] for r in gg] == [r[0] for r in wg]
        assert [r[2] for r in gg] == [r[2] for r in wg]
        assert np.allclose([r[1] for r in gg], [r[1] for r in wg], rtol=1e-5, atol=0.05)


@pytest.mark.gpu
def test_cuda_queries_racing_commits_count_each_row_once(cuda, tmp_path):
    """A reader thread queries COUNT and SUM through the broker while the
    servers on the card pump one block a round and commit every fourth:
    each answer counts a prefix of each partition's blocks, never a partial
    result; the retired consumers hold no device memory."""
    import threading

    from pinot_tpu_torch import QuickCluster, ssb
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
    block, nblocks = 8_192, 12
    MemoryStream.reset_all()
    cluster = QuickCluster(num_servers=2, work_dir=str(tmp_path), device=cuda)
    cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=2,
                      stream=StreamConfig(topic="race", decoder="columnar",
                                          flush_threshold_rows=4 * block,
                                          properties={"realtime.ingest.device.staging": "true"}))
    cluster.create_realtime_table(ssb.ssb_schema(), cfg, 2)
    cols = [ssb.make_columns(nblocks * block, 41 + p) for p in range(2)]
    for p in range(2):
        for lo in range(0, nblocks * block, block):
            MemoryStream.get("race").produce(encode_columnar_block(
                ssb.ssb_schema(), {k: v[lo:lo + block] for k, v in cols[p].items()}),
                partition=p)
    prefix = [np.concatenate([[0], np.cumsum([int(cols[p]["lo_quantity"][i:i + block].sum())
                                              for i in range(0, nblocks * block, block)])])
              for p in range(2)]
    valid = {((a + b) * block, int(prefix[0][a] + prefix[1][b]))
             for a in range(nblocks + 1) for b in range(nblocks + 1)}
    sql = "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder"
    stop, answers, errors = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            try:
                res = cluster.query(sql)
            except Exception as e:   # recorded; the test fails below
                errors.append(e)
                return
            count, total = res.rows[0]   # SUM over no rows is null
            answers.append((count, int(total or 0), res.stats["partialResult"],
                            res.stats.get("segmentsUnavailable")))

    seen = {}
    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(nblocks + 2):
            for s in cluster.servers:
                mgr = s.realtime_manager(cfg.table_name_with_type)
                seen.update((id(c), c) for c in mgr.consumers.values())
                mgr.pump_all(max_messages=1)
                mgr.complete_all()
    finally:
        stop.set()
        t.join(timeout=120)
    assert not errors and not t.is_alive() and answers
    bad = [a for a in answers if a[2] or a[:2] not in valid]
    assert not bad, bad[:3]
    assert cluster.query(sql).rows == [[2 * nblocks * block,
                                        float(prefix[0][-1] + prefix[1][-1])]]
    live = {id(c) for s in cluster.servers
            for c in s.realtime_manager(cfg.table_name_with_type).consumers.values()}
    retired = [c for k, c in seen.items() if k not in live]
    assert len(retired) == 12
    for c in retired:
        assert all(chunks is None for chunks in c.mutable._dev_chunks.values())
        assert c.mutable._view is None or not c.mutable._view._device_blocks
    cluster.shutdown()
    MemoryStream.reset_all()


@pytest.mark.gpu
def test_cuda_process_cluster_answers_and_counts_its_servers_launches(cuda, tmp_path):
    """A ProcessCluster whose two server processes own the card through their
    serving pipelines answers Q1.1 and GROUP_QUERY over HTTP as the CPU
    cluster does; the servers' /debug counts show masked_sums and grouped_agg
    launched in the server processes, one a server the route gave segments."""
    from pinot_tpu_torch import QuickCluster, ssb
    from pinot_tpu_torch.cluster.http_service import get_json, post_json
    from pinot_tpu_torch.cluster.process import ProcessCluster
    from pinot_tpu_torch.engine import cuda_lib
    from pinot_tpu_torch.segment.writer import SegmentBuilder
    from pinot_tpu_torch.table import TableConfig
    cuda_lib.build(["masked_sums", "bitmap_filter", "grouped_agg"])   # before any child
    cols = ssb.make_columns(120_000, 23)
    dirs = [SegmentBuilder(ssb.ssb_schema()).build(
        {k: v[i * 30_000:(i + 1) * 30_000] for k, v in cols.items()},
        str(tmp_path / "segs"), f"lineorder_{i}") for i in range(4)]
    cpu = QuickCluster(num_servers=2, work_dir=str(tmp_path / "cpu"), device="cpu")
    cpu.create_table(ssb.ssb_schema(), TableConfig("lineorder", replication=2))
    for d in dirs:
        cpu.controller.upload_segment("lineorder_OFFLINE", d)
    with ProcessCluster(num_servers=2, device="cuda", work_dir=str(tmp_path / "proc"),
                        server_config={"server.device.enabled": "true"},
                        startup_timeout_s=180.0) as pc:
        pc.controller.add_schema(ssb.ssb_schema())
        pc.controller.add_table(TableConfig("lineorder", replication=2))
        for d in dirs:
            pc.controller.upload_segment("lineorder_OFFLINE", d)
        from conftest import wait_until
        assert wait_until(lambda: pc.query("SELECT COUNT(*) FROM lineorder")
                          ["resultTable"]["rows"] == [[120_000]], timeout=120.0)
        urls = [pc.server_url(f"server_{i}") for i in range(2)]
        for sql, kernel in ((ssb.QUERY, "masked_sums"), (ssb.GROUP_QUERY, "grouped_agg")):
            for u in urls:
                post_json(f"{u}/debug/launches/reset", {})
            got = pc.query(sql)
            counts = [get_json(f"{u}/debug")["kernelLaunches"] for u in urls]
            assert sum(c[kernel] for c in counts) == got["numServersQueried"] >= 1
            assert got["partialResult"] is False and got["numSegmentsQueried"] == 4
            want = cpu.query(sql).rows
            rows = got["resultTable"]["rows"]
            if kernel == "grouped_agg":   # lo_region, SUM, COUNT: keys and counts exact
                assert [(r[0], r[2]) for r in rows] == [(r[0], r[2]) for r in want]
                rows, want = [r[1:2] for r in rows], [r[1:2] for r in want]
            assert np.allclose(np.asarray(rows, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=1e-5, atol=0.05)
        debug = get_json(f"{urls[0]}/debug")
        assert debug["device"].startswith("cuda") and debug["deviceMemory"]["stagedBytes"] > 0
    cpu.shutdown()


@pytest.mark.gpu
def test_cuda_realtime_table_over_processes_matches_the_cpu(cuda, tmp_path):
    """A REALTIME lineorder table on a kafkalite broker, consumed by two
    server processes that stage their consuming segments on the card
    (replication 2, two partitions of PCB1 blocks, a flush threshold crossed
    once a partition), answers COUNT(*), Q1.1 and GROUP_QUERY over HTTP as a
    CPU cluster holding the same rows offline does; the servers' /debug counts
    show the kernels launched in the server processes."""
    from pinot_tpu_torch import QuickCluster, ssb
    from pinot_tpu_torch.cluster.http_service import get_json, post_json
    from pinot_tpu_torch.cluster.process import ProcessCluster
    from pinot_tpu_torch.engine import cuda_lib
    from pinot_tpu_torch.ingest.kafkalite import LogBrokerClient, LogBrokerServer
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
    from conftest import wait_until
    cuda_lib.build(["masked_sums", "bitmap_filter", "grouped_agg"])   # before any child
    schema, n, block = ssb.ssb_schema(), 96_000, 8_000
    cols = ssb.make_columns(n, 29)
    cpu = QuickCluster(num_servers=1, work_dir=str(tmp_path / "cpu"), device="cpu")
    cpu_cfg = cpu.create_table(schema, TableConfig("lineorder"))
    cpu.ingest_columns(cpu_cfg, cols)
    srv = LogBrokerServer()
    try:
        client = LogBrokerClient(srv.bootstrap)
        client.create_topic("lo_gpu", 2)
        for i, lo in enumerate(range(0, n, block)):
            client.produce("lo_gpu", encode_columnar_block(
                schema, {k: v[lo:lo + block] for k, v in cols.items()}), partition=i % 2)
        cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=2,
                          time_column="lo_orderdate", stream=StreamConfig(
                              stream_type="kafkalite", topic="lo_gpu", decoder="columnar",
                              flush_threshold_rows=32_000,
                              properties={"bootstrap": srv.bootstrap,
                                          "realtime.ingest.device.staging": "true"}))
        with ProcessCluster(num_servers=2, device="cuda", work_dir=str(tmp_path / "proc"),
                            server_config={"server.device.enabled": "true"},
                            startup_timeout_s=180.0) as pc:
            pc.controller.add_schema(schema)
            pc.controller.add_table(cfg, num_partitions=2)
            assert wait_until(lambda: pc.query("SELECT COUNT(*) FROM lineorder")
                              ["resultTable"]["rows"] == [[n]], timeout=180.0)
            # each partition's first flush commits after its rows are counted
            assert wait_until(lambda: sum(
                m["status"] == "DONE" for m in pc.controller.segments_meta(
                    "lineorder_REALTIME")["segments"].values()) == 2, timeout=180.0)
            urls = [pc.server_url(f"server_{i}") for i in range(2)]
            # both replicas at the end of both partitions (the broker reads one)
            blocks_a_partition = n // block // 2
            assert wait_until(lambda: sorted(
                c["offset"] for u in urls
                for c in get_json(f"{u}/debug")["consumers"]["lineorder_REALTIME"].values()) ==
                [blocks_a_partition] * 4, timeout=180.0)
            launched = {k: 0 for k in ("masked_sums", "grouped_agg")}
            for sql in (ssb.QUERY, ssb.GROUP_QUERY):
                for u in urls:
                    post_json(f"{u}/debug/launches/reset", {})
                got = pc.query(sql)
                for u in urls:
                    for k, v in get_json(f"{u}/debug")["kernelLaunches"].items():
                        launched[k] = launched.get(k, 0) + v
                rows, want = got["resultTable"]["rows"], cpu.query(sql).rows
                assert got["partialResult"] is False and len(rows) == len(want)
                assert np.allclose(np.asarray([[x for x in r if not isinstance(x, str)]
                                               for r in rows], dtype=np.float64),
                                   np.asarray([[x for x in r if not isinstance(x, str)]
                                               for r in want], dtype=np.float64),
                                   rtol=1e-5, atol=0.05)
            assert launched["masked_sums"] > 0 and launched["grouped_agg"] > 0, launched
            debug = get_json(f"{urls[0]}/debug")
            assert debug["device"].startswith("cuda")
            assert debug["importedPackages"] == {"jax": False, "pinot_tpu": False}
    finally:
        srv.stop()
        cpu.shutdown()


@pytest.mark.gpu
def test_cuda_pulsar_table_over_processes_matches_the_cpu_and_is_healthy(cuda, tmp_path):
    """A REALTIME lineorder table on the Pulsar-protocol broker, consumed by
    two server processes that stage their consuming segments on the card
    (replication 2, two partitions of PCB1 blocks, a flush threshold crossed
    once a partition, rows left on the staged views), answers the smoke's
    five realtime queries over HTTP as a CPU cluster holding the same rows
    offline does, with each kernel launched in the server processes (the FOR
    scan on the views), and its ingestionStatus is HEALTHY at offset lag 0."""
    import chip_smoke
    from pinot_tpu_torch import QuickCluster, ssb
    from pinot_tpu_torch.cluster.http_service import get_json, post_json
    from pinot_tpu_torch.cluster.process import ProcessCluster
    from pinot_tpu_torch.engine import cuda_lib
    from pinot_tpu_torch.ingest.pulsarlite import PulsarLiteBroker, PulsarLiteProducer
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
    from conftest import wait_until
    cuda_lib.build(["masked_sums", "bitmap_filter", "grouped_agg"])   # before any child
    schema, n, block = ssb.ssb_schema(), 96_000, 8_000
    cols = ssb.make_columns(n, 31)
    cpu = QuickCluster(num_servers=1, work_dir=str(tmp_path / "cpu"), device="cpu")
    cpu.ingest_columns(cpu.create_table(schema, TableConfig("lineorder")), cols)
    broker = PulsarLiteBroker()
    try:
        producers = [PulsarLiteProducer(broker.service_url, "lo_pulsar_gpu", p) for p in range(2)]
        for i, lo in enumerate(range(0, n, block)):
            producers[i % 2].send(encode_columnar_block(
                schema, {k: v[lo:lo + block] for k, v in cols.items()}))
        cfg = TableConfig("lineorder", table_type=TableType.REALTIME, replication=2,
                          time_column="lo_orderdate", stream=StreamConfig(
                              stream_type="pulsar", topic="lo_pulsar_gpu", decoder="columnar",
                              flush_threshold_rows=32_000,
                              # a block a pump: each partition commits at 4 of
                              # its 6 blocks and keeps 2 on its staged view
                              properties={"serviceUrl": broker.service_url,
                                          "realtime.ingest.batch.size": "1",
                                          "realtime.ingest.device.staging": "true"}))
        with ProcessCluster(num_servers=2, device="cuda", work_dir=str(tmp_path / "proc"),
                            server_config={"server.device.enabled": "true"},
                            startup_timeout_s=180.0) as pc:
            pc.controller.add_schema(schema)
            pc.controller.add_table(cfg, num_partitions=2)
            assert wait_until(lambda: pc.query("SELECT COUNT(*) FROM lineorder")
                              ["resultTable"]["rows"] == [[n]], timeout=180.0)
            assert wait_until(lambda: sum(
                m["status"] == "DONE" for m in pc.controller.segments_meta(
                    "lineorder_REALTIME")["segments"].values()) == 2, timeout=180.0)
            urls = [pc.server_url(f"server_{i}") for i in range(2)]
            assert wait_until(lambda: sorted(
                c["offset"] for u in urls
                for c in get_json(f"{u}/debug")["consumers"]["lineorder_REALTIME"].values()) ==
                [n // block // 2] * 4, timeout=180.0)
            launched = {}
            for qid, sql, _, _, _ in chip_smoke.realtime_cluster_queries():
                for u in urls:
                    post_json(f"{u}/debug/launches/reset", {})
                got = pc.query(sql)
                for u in urls:
                    for k, v in get_json(f"{u}/debug")["kernelLaunches"].items():
                        launched[k] = launched.get(k, 0) + v
                rows, want = got["resultTable"]["rows"], cpu.query(sql).rows
                assert got["partialResult"] is False, qid
                assert chip_smoke.rows_match(rows, want), (qid, rows, want)
            assert launched["masked_sums"] > 0 and launched["masked_sums_fused"] > 0 \
                and launched["grouped_agg"] > 0, launched
            status = pc.controller.ingestion_status("lineorder_REALTIME")
            assert status["ingestionState"] == "HEALTHY", status["reasons"]
            assert status["maxOffsetLag"] == 0 and status["numConsumingSegments"] == 2
            assert get_json(f"{urls[0]}/debug")["importedPackages"] == \
                {"jax": False, "pinot_tpu": False}
        for p in producers:
            p.close()
    finally:
        broker.stop()
        cpu.shutdown()
