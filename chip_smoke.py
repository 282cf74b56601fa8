#!/usr/bin/env python3
"""Chip smoke test: pinot_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py [--seed 20260729] [--rows 16777216] [--trace]

Phases, each printing its own lines; any failed check raises and the script
exits non-zero:

1. device  — the card's name and `nvidia-smi` name/power limit;
2. build   — compiles the CUDA kernels from `pinot_tpu_torch/csrc/` (nvcc) and
   logs each kernel instance's registers, shared memory and spills (ptxas);
3. kernels — each kernel against its plain PyTorch version on the card at the
   main paths' shapes (one segment of each table, and the whole stacked table
   the set executor scans in one launch: rel 1e-5 on sums, equal counts),
   timed with CUDA events with the L2 cache flushed before every timed run, and
   under torch.profiler: `kernel_ms` is the kernel alone, and
   `device_ops_per_call` the ops one eager call puts on the card, which must be
   the design's one launch. The flush overwrites a 256 MiB buffer, so the
   inputs come from HBM, behind dirty lines as on the path, whose operand
   product writes its row just before the scan;
4. path    — SSB lineorder generated from --seed, built with the package's writer,
   loaded, and queried through `execute_query` on the card: Q1.1, the dictionary
   GROUP BY, and a SUM over a frame-of-reference column. Each answer is held
   against a numpy float64 oracle (rel 1e-5, abs 0.05), and the kernels' launch
   counters must show that Q1.1 and the FOR query ran through the kernels, once
   per segment;
5. serve   — the same table through the stacked segment-set executor
   (`parallel.MeshQueryExecutor`) and the serving pipeline
   (`cluster.DeviceQueryPipeline`): Q1.1, the GROUP BY and a COUNT over one id
   band, each held against the oracle with its warm median, min and max over
   20 runs (a stacked Q1.1 or COUNT must be one `masked_sums` launch for the
   whole table); `execute_many` over 64 copies of Q1.1 (rows/s); then 32
   client threads x 12 queries through the pipeline, twice: cycling the three
   (the mix of bench.py's e2e_device_bench), and cycling 32 literals of the
   COUNT (which stack). Every answer is held against the oracle; each run
   prints QPS, p50 latency and the pipeline's stats (its scan launches must
   equal the kernel's launch counter). Under --trace, the stacked Q1.1's
   device busy ms, idle share and top device ops;
6. select  — selections and ORDER BY ... LIMIT over the same table, through
   `execute_query` and the set executor: three device top-k queries (a double
   key under an id band, match-all ascending, and an integer key with ~690
   matching ties a value, more than the 265 candidates), a LIMIT without ORDER
   BY, an ORDER BY on a key wider than 2^24 (the exact path) and a GROUP BY
   over 500,000 keys trimmed to its top 10. Each answer is held against a
   numpy oracle that orders ties by row; each prints its warm times, phases,
   top-k launches (one per segment, none for the others) and `topkExact`. Then
   32 client threads x 12 queries cycling the three top-k queries through the
   pipeline (one stacked top-k launch per distinct query of a drain), and a
   `select_case` line: the stacked top-k of the first query over the whole
   table, its candidates held against numpy for the three top-k queries,
   timed with L2 flushed, against the bound of the bytes it reads. Under
   --trace, each query's device busy ms and idle share (not the per-segment
   GROUP BY, whose runs take tens of seconds).

It prints a `{"kernels": [...]}` line, the nvidia-smi line, and as its last line
`{"ok": true, "device": {...}}`. Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SUM_RTOL = 1e-5
ORACLE_RTOL, ORACLE_ATOL = 1e-5, 0.05   # the reference's device tolerance
TIMED_RUNS = 25
SEGMENTS = 8                                  # bench.py's table: 8 segments
FOR_ROWS, FOR_SEGMENTS = 4 * 1024 * 1024, 2   # the FOR query's table
QUERY_RUNS = 20                               # warm runs per query
SERVE_COUNT_QUERY = "SELECT COUNT(*) FROM lineorder WHERE lo_quantity < 10 LIMIT 5"
MANY_COPIES = 64                              # queries in one execute_many
SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT = 32, 12   # bench.py's e2e_device_bench
L2_FLUSH_BYTES = 256 << 20   # written before each timed run: > the H100's 50 MB L2
SELECT_QUERIES = [
    # (id, sql, top-k launches per segment, answered by the exact path)
    ("topk_desc", "SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
     "ORDER BY lo_revenue DESC LIMIT 7", 1, False),
    ("topk_all", "SELECT lo_suppkey, lo_extendedprice FROM lineorder "
     "ORDER BY lo_extendedprice LIMIT 12", 1, False),
    ("topk_ties", "SELECT lo_custkey, lo_orderdate, lo_revenue FROM lineorder "
     "WHERE lo_quantity >= 10 ORDER BY lo_suppkey LIMIT 9", 1, False),
    ("select_limit", "SELECT lo_region, lo_revenue FROM lineorder WHERE lo_quantity < 3 "
     "LIMIT 10", 0, False),
    ("order_exact", "SELECT lo_custkey, lo_orderdate FROM lineorder WHERE lo_quantity = 1 "
     "AND lo_discount = 0 ORDER BY lo_orderdate DESC LIMIT 5", 0, True),
    ("group_trim", "SELECT lo_custkey, SUM(lo_revenue) FROM lineorder GROUP BY lo_custkey "
     "ORDER BY SUM(lo_revenue) DESC LIMIT 10", 0, None),
]
# the per-segment GROUP BY over 500,000 keys decodes every segment's ~490,000
# groups in Python (tens of seconds a run): two warm runs, not QUERY_RUNS
GROUP_TRIM_PER_SEGMENT_RUNS = 2
LIBRARY_NOTE = ("library_ms is null: no single PyTorch call computes a masked "
                "multi-sum with its count")
KERNEL_SYMBOL = "masked_sums_kernel"
DEVICE_OPS_PER_CALL = 1   # the design: one launch, no torch op after it
PROFILED_CALLS = 10
PROFILER_MARGIN_S = 0.005   # idle time at each edge of a profiled window
TRACED_RUNS = 10            # warm runs of a query in one --trace window
_OPERAND = {"f": "float", "h": "uint8", "t": "uint16"}   # Itanium codes


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def segment_rows(rows: int, segments: int) -> int:
    """Rows of the first segment `build_aligned_segments` cuts from `rows`: the
    `n` the executor hands the scan kernels for that table."""
    return int(np.linspace(0, rows, segments + 1, dtype=np.int64)[1])


def stacked_rows(rows: int, segments: int) -> int:
    """Rows of the set executor's stacked block for that table: one slot per
    segment, each padded to the largest segment's padded size."""
    from pinot_tpu_torch.engine.datablock import padded_rows
    sizes = np.diff(np.linspace(0, rows, segments + 1, dtype=np.int64))
    return segments * padded_rows(int(sizes.max()))


def time_ms(fn, flush: torch.Tensor, runs: int = TIMED_RUNS) -> float:
    """Median of `runs` timings of `fn()` with CUDA events, after two warm-up
    calls. Before each timed run `flush` is overwritten outside the events, so
    the inputs come from HBM, as each segment's columns do on the path. For an
    eager call this includes the host's launch overhead when the host is slower
    than the device."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, flush: torch.Tensor, runs: int = TIMED_RUNS) -> float:
    """Device time of `fn`'s launched work: `fn` captured once into a CUDA graph,
    and the graph's replays timed with CUDA events (median of `runs`). Replay
    launches the whole captured sequence at once, so host overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream before capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, flush, runs)


def _profiled(step, calls: int) -> tuple:
    """The card's ops of `calls` runs of `step()` under torch.profiler, as
    (name, start us, end us), and the host wall seconds of those runs. One
    warm-up cycle runs first, so that the counted cycle starts with the
    profiler's device tracing already running, and each cycle idles
    PROFILER_MARGIN_S at both edges, so that no op lies on the window's
    boundary. The profiler's own step annotations are not ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    ops = []

    def ready(prof):
        ops.extend((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and not e.name.startswith("ProfilerStep"))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            time.sleep(PROFILER_MARGIN_S)
            t0 = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILER_MARGIN_S)
            prof.step()
    return ops, wall


def profile_call(fn, flush: torch.Tensor, calls: int = PROFILED_CALLS) -> tuple:
    """(device ops per call, kernel ms) from torch.profiler: `calls` eager calls
    back to back give every op a call puts on the card; a second window, with
    L2 flushed before each call, gives the median time of the kernel alone with
    its inputs in HBM. Raises unless one call is the design's count of ops."""

    def flushed():
        flush.zero_()
        fn()

    ops, _ = _profiled(fn, calls)
    if len(ops) != DEVICE_OPS_PER_CALL * calls:
        raise AssertionError(f"one call puts {len(ops) / calls} ops on the card, "
                             f"expected {DEVICE_OPS_PER_CALL}: "
                             f"{sorted({name for name, _, _ in ops})}")
    times = [end - start for name, start, end in _profiled(flushed, calls)[0]
             if KERNEL_SYMBOL in name]
    if len(times) != calls:
        raise AssertionError(f"the profiler saw {len(times)} {KERNEL_SYMBOL} launches "
                             f"for {calls} calls")
    return len(ops) / calls, statistics.median(times) / 1e3


def kernel_usage(log: str) -> dict:
    """ptxas's registers, shared memory and spills per kernel instance."""
    from pinot_tpu_torch.engine import cuda_lib
    named = {}
    for mangled, use in cuda_lib.ptxas_usage(log).items():
        at = mangled.find(KERNEL_SYMBOL + "I")
        if at >= 0:
            code = mangled[at + len(KERNEL_SYMBOL) + 1]
            named[f"{KERNEL_SYMBOL}<{_OPERAND.get(code, code)}>"] = use
    if not named:
        raise AssertionError(f"no {KERNEL_SYMBOL} instance in the ptxas log:\n{log}")
    return named


# -- phase 3: kernels against their plain versions ----------------------------

def kernel_cases(n: int, n_for: int, n_stacked: int, gen: torch.Generator):
    """The main paths' shapes: one SSB segment of n rows with Q1.1's three id
    bands (lo_orderdate in 1993, lo_discount 1..3, lo_quantity < 25), one
    segment of the FOR table (n_for rows) with that query's two, over dict ids
    with SSB's cardinalities, and the whole stacked table (n_stacked rows),
    which the set executor scans in one launch for Q1.1 (three bands, one
    sum) and for the COUNT query (one band, no sum)."""
    from pinot_tpu_torch.engine import scan

    def ids(card, rows=n):
        return torch.randint(0, card, (rows,), generator=gen, dtype=torch.int32).cuda()

    od, disc, qty = ids(2352), ids(11), ids(50)
    price = (torch.rand(n, generator=gen, dtype=torch.float64) * 9999 + 1).float().cuda()
    row = price * disc.float()       # Q1.1's operand: lo_extendedprice * lo_discount
    revenue = (torch.rand(n, generator=gen) * 60000).cuda()
    fod, fdisc = ids(2352, n_for), ids(11, n_for)
    d8 = torch.randint(0, 50, (n_for,), generator=gen,
                       dtype=torch.int32).to(torch.uint8).cuda()
    d16 = torch.randint(0, 60000, (n_for,), generator=gen,
                        dtype=torch.int32).to(torch.uint16).cuda()
    q11 = [(336, 671), (1, 3), (0, 23)]
    lo, hi = scan.INT32_MIN, scan.INT32_MAX
    r, rf = n - n // 8 - 3, n_for - n_for // 8 - 3   # ragged: no multiple of a block
    wide_cols = (od, disc, qty, ids(7), ids(25), ids(50), ids(250), ids(1000))
    wide_bands = q11 + [(0, 5), (3, 20), (0, 40), (10, 240), (0, 900)]
    wide_rows = [row, revenue] + [(torch.rand(n, generator=gen) * 100).cuda()
                                  for _ in range(6)]
    sod, sdisc, sqty = ids(2352, n_stacked), ids(11, n_stacked), ids(50, n_stacked)
    srow = ((torch.rand(n_stacked, generator=gen, dtype=torch.float64) * 9999 + 1).float()
            .cuda() * sdisc.float())
    return [
        # (case, kernel name, args, main-path shape?)
        ("q11_1sum", "masked_sums", ((od, disc, qty), q11, [row]), True),
        ("q11_stacked", "masked_sums", ((sod, sdisc, sqty), q11, [srow]), True),
        # the set path's COUNT (lo_quantity < 10): one band, no sum, 4 B/row
        ("count_stacked", "masked_sums", ((sqty,), [(0, 8)], []), True),
        ("q11_2sums", "masked_sums", ((od, disc, qty), q11, [row, revenue]), False),
        ("ragged_n", "masked_sums",
         ((od[:r], disc[:r], qty[:r]), q11, [row[:r]]), False),
        ("empty_mask", "masked_sums", ((od, disc, qty), [(1, 0)] * 3, [row]), False),
        ("one_sided", "masked_sums", ((od, disc, qty), [(lo, 671), (1, hi), (lo, 23)],
                                      [row]), False),
        ("c8_k8", "masked_sums", (wide_cols, wide_bands, wide_rows), False),
        ("for_u8", "masked_sums_fused", ((fod, fdisc), q11[:2], [(1.0, d8)]), True),
        ("for_u16", "masked_sums_fused", ((fod, fdisc), q11[:2], [(-5.0, d16)]), False),
        ("for_u8_ragged", "masked_sums_fused",
         ((fod[:rf], fdisc[:rf]), q11[:2], [(1.0, d8[:rf])]), False),
    ]


def bound(name: str, args) -> tuple:
    """(bound_ms, bound_by): each input read once and each output written once
    over the memory rate, against ~2 compares + 1 AND per band and a multiply and
    add per sum and per row (plus the FOR decode add) over the f32 rate."""
    cols, bands, rows = args
    operands = [d for _, d in rows] if name == "masked_sums_fused" else list(rows)
    n = int((list(cols) + operands)[0].shape[0])
    nbytes = sum(t.numel() * t.element_size() for t in list(cols) + operands)
    nbytes += 4 * len(operands) + 8
    ops_per_row = 3 * len(cols) + 2 * len(operands) + 1
    if name == "masked_sums_fused":
        ops_per_row += 2 * len(operands)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n * ops_per_row / PEAK_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_kernels(n: int, n_for: int, n_stacked: int, seed: int):
    from pinot_tpu_torch.engine import scan
    fns = {"masked_sums": (scan.masked_sums, scan.masked_sums_plain),
           "masked_sums_fused": (scan.masked_sums_fused, scan.masked_sums_fused_plain)}
    gen = torch.Generator().manual_seed(seed)
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    results = {}
    for case, name, args, main in kernel_cases(n, n_for, n_stacked, gen):
        kernel, plain = fns[name]
        ks, kc = kernel(*args)
        ps, pc = plain(*args)
        torch.cuda.synchronize()
        ks, ps = ks.double().cpu(), ps.double().cpu()
        kc, pc = int(kc), int(pc)
        abs_err = float((ks - ps).abs().max()) if ks.numel() else 0.0
        rel_err = float(((ks - ps).abs() / ps.abs().clamp_min(1e-30)).max()) \
            if ks.numel() else 0.0
        rel_err = 0.0 if abs_err == 0.0 else rel_err
        if kc != pc or rel_err > SUM_RTOL:
            raise AssertionError(f"{case}: kernel {ks.tolist()} count {kc} vs plain "
                                 f"{ps.tolist()} count {pc} (rel {rel_err:.3g})")
        # device time (graph replay) is the kernel's; the eager call's time adds
        # the wrapper's host overhead, which is what one query pays per segment
        ms = graph_ms(lambda: kernel(*args), flush)
        plain_ms = graph_ms(lambda: plain(*args), flush)
        call_ms = time_ms(lambda: kernel(*args), flush)
        plain_call_ms = time_ms(lambda: plain(*args), flush)
        ops_per_call, kernel_ms = profile_call(lambda: kernel(*args), flush)
        bms, by = bound(name, args)
        log("kernel_case", case=case, kernel=name, rows=int(args[0][0].shape[0]),
            count=kc, max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, plain_ms=plain_ms, kernel_ms=kernel_ms,
            device_ops_per_call=ops_per_call, call_ms=call_ms,
            plain_call_ms=plain_call_ms, bound_ms=bms, bound_by=by,
            pct_of_bound=100.0 * bms / ms)
        agg = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                        "cases": {}})
        agg["max_abs_err"] = max(agg["max_abs_err"], abs_err)
        agg["max_rel_err"] = max(agg["max_rel_err"], rel_err)
        if main:
            # the first main case (one segment) gives the kernel's headline
            # numbers, as in earlier runs; every main case is kept under "cases"
            numbers = dict(rows=int(args[0][0].shape[0]), ms=ms, plain_ms=plain_ms,
                           kernel_ms=kernel_ms, call_ms=call_ms,
                           plain_call_ms=plain_call_ms, bound_ms=bms, bound_by=by)
            agg["cases"][case] = numbers
            if "case" not in agg:
                agg.update(case=case, **{k: v for k, v in numbers.items() if k != "rows"})
    return results


# -- phase 4: the path -------------------------------------------------------------

def oracle_q11(c):
    m = ((c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19931231)
         & (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3) & (c["lo_quantity"] < 25))
    return [[float((c["lo_extendedprice"][m] * c["lo_discount"][m]).sum())]]


def oracle_group(c):
    from pinot_tpu_torch.ssb import REGIONS
    m = ((c["lo_discount"] >= 1) & (c["lo_discount"] <= 3) & (c["lo_quantity"] < 25))
    rows = []
    for region in sorted(REGIONS):
        g = m & (c["lo_region"] == region)
        if g.any():
            rows.append([region, float(c["lo_revenue"][g].sum()), int(g.sum())])
    return rows[:10]


def oracle_for(c):
    m = ((c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19931231)
         & (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3))
    return [[float(c["lo_quantity"][m].astype(np.float64).sum()), int(m.sum())]]


def rows_match(got, want) -> bool:
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for x, y in zip(rg, rw):
            if isinstance(y, float):
                if not math.isclose(float(x), y, rel_tol=ORACLE_RTOL, abs_tol=ORACLE_ATOL):
                    return False
            elif x != y:
                return False
    return True


def run_path(args, work: str):
    from pinot_tpu_torch import execute_query, load_segment
    from pinot_tpu_torch.engine import scan
    from pinot_tpu_torch.segment.writer import (SegmentGeneratorConfig,
                                                build_aligned_segments)
    from pinot_tpu_torch.ssb import (FOR_QUERY, GROUP_QUERY, QUERY, make_columns,
                                     ssb_schema)

    t0 = time.perf_counter()
    cols = make_columns(args.rows, args.seed)
    gen_s = time.perf_counter() - t0
    schema = ssb_schema()
    t0 = time.perf_counter()
    paths = build_aligned_segments(schema, cols, os.path.join(work, "main"), "lineorder",
                                   SEGMENTS)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = [load_segment(p) for p in paths]
    load_s = time.perf_counter() - t0
    for_rows = min(FOR_ROWS, args.rows)
    for_cols = {k: v[:for_rows] for k, v in cols.items()}
    t0 = time.perf_counter()
    for_paths = build_aligned_segments(
        schema, for_cols, os.path.join(work, "for"), "lineorder", FOR_SEGMENTS,
        SegmentGeneratorConfig(no_dictionary_columns=["lo_quantity"]))
    for_build_s = time.perf_counter() - t0
    for_table = [load_segment(p) for p in for_paths]
    log("data", rows=args.rows, segments=SEGMENTS, seed=args.seed,
        generate_s=gen_s, build_s=build_s, load_s=load_s, for_rows=for_rows,
        for_segments=FOR_SEGMENTS, for_build_s=for_build_s)

    queries = [
        ("q1_1", QUERY, table, cols, oracle_q11, {"masked_sums": len(table),
                                                  "masked_sums_fused": 0}),
        ("group_by", GROUP_QUERY, table, cols, oracle_group,
         {"masked_sums": 0, "masked_sums_fused": 0}),
        ("for_sum", FOR_QUERY, for_table, for_cols, oracle_for,
         {"masked_sums": 0, "masked_sums_fused": len(for_table)}),
    ]
    launches = {"masked_sums": 0, "masked_sums_fused": 0}
    for name, sql, segs, c, oracle, want_launches in queries:
        rows = sum(s.num_docs for s in segs)
        # the path: counts set to 0 just before, read just after
        scan.reset_launch_counts()
        t0 = time.perf_counter()
        result = execute_query(segs, sql)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = launch_counts()
        if counts != want_launches:
            raise AssertionError(f"{name}: kernel launches {counts}, expected {want_launches}")
        for k, v in counts.items():
            launches[k] += v
        want = oracle(c)
        if not rows_match(result.rows, want):
            raise AssertionError(f"{name}: got {result.rows}, oracle {want}")
        times, phases = [], []
        for _ in range(QUERY_RUNS):
            t0 = time.perf_counter()
            res = execute_query(segs, sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            phases.append(res.stats["phaseTimesMs"])
        med = statistics.median(times)
        fields = dict(query=name, rows=rows, segments=len(segs), answer=result.rows,
                      oracle=want, launches=counts, cold_s=cold_s,
                      warm_median_ms=med * 1e3, warm_min_ms=min(times) * 1e3,
                      warm_max_ms=max(times) * 1e3, warm_runs=len(times),
                      rows_per_s=rows / med,
                      phase_median_ms={k: statistics.median(p[k] for p in phases)
                                       for k in phases[0]})
        if args.trace:
            fields["trace"] = trace_query(lambda: execute_query(segs, sql))
        log("query", **fields)
    return launches, table, cols


# -- phase 5: serve --------------------------------------------------------------

def oracle_count(c):
    return [[int((c["lo_quantity"] < 10).sum())]]


def warm_times(fn, runs: int = QUERY_RUNS) -> tuple:
    """Host-clock times of `runs` calls of `fn`, each ending in a synchronize,
    and the calls' results."""
    times, results = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        results.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"warm_median_ms": statistics.median(times) * 1e3,
            "warm_min_ms": min(times) * 1e3, "warm_max_ms": max(times) * 1e3,
            "warm_runs": runs, "median_s": statistics.median(times)}, results


def launch_counts() -> dict:
    from pinot_tpu_torch.engine import scan
    return {"masked_sums": scan.masked_sums.launches,
            "masked_sums_fused": scan.masked_sums_fused.launches}


def run_serve(args, table, cols) -> dict:
    """The stacked set executor and the serving pipeline over the path's table.
    Returns the kernels' launches in the runs that were checked."""
    from pinot_tpu_torch.engine import scan
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY

    rows = sum(s.num_docs for s in table)
    mx = MeshQueryExecutor()
    launches = {"masked_sums": 0, "masked_sums_fused": 0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    queries = [("q1_1", QUERY, oracle_q11, {"masked_sums": 1, "masked_sums_fused": 0}),
               ("group_by", GROUP_QUERY, oracle_group,
                {"masked_sums": 0, "masked_sums_fused": 0}),
               ("count_quantity", SERVE_COUNT_QUERY, oracle_count,
                {"masked_sums": 1, "masked_sums_fused": 0})]
    for name, sql, oracle, want_launches in queries:
        scan.reset_launch_counts()
        t0 = time.perf_counter()
        result = mx.execute(table, sql)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = launch_counts()
        if counts != want_launches:
            raise AssertionError(f"serve {name}: kernel launches {counts}, "
                                 f"expected {want_launches} for the whole set")
        add(counts)
        want = oracle(cols)
        if not rows_match(result.rows, want):
            raise AssertionError(f"serve {name}: got {result.rows}, oracle {want}")
        warm, results = warm_times(lambda: mx.execute(table, sql))
        phases = [r.stats["phaseTimesMs"] for r in results]
        fields = dict(query=name, rows=rows, segments=len(table), answer=result.rows,
                      oracle=want, launches=counts, cold_s=cold_s,
                      rows_per_s=rows / warm.pop("median_s"), **warm,
                      phase_median_ms={k: statistics.median(p[k] for p in phases)
                                       for k in phases[0]})
        if args.trace and name == "q1_1":
            fields["trace"] = trace_query(lambda: mx.execute(table, sql))
        log("serve_query", **fields)
    block = next(iter(mx._set_blocks.values()))
    log("serve_block", s_pad=block.s_pad, rows_per_slot=block.rows,
        pad_waste_pct=block.pad_waste_pct, stacked_columns=sorted(map(list, block._cache)))

    # execute_many: every copy dispatched, then one fetch
    want = oracle_q11(cols)
    scan.reset_launch_counts()
    results = mx.execute_many(table, [QUERY] * MANY_COPIES)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["masked_sums"] != MANY_COPIES:
        raise AssertionError(f"execute_many: {counts} launches for {MANY_COPIES} queries")
    add(counts)
    bad = [r.rows for r in results if not rows_match(r.rows, want)]
    if bad:
        raise AssertionError(f"execute_many: {len(bad)} answers off the oracle: {bad[:3]}")
    warm, _ = warm_times(lambda: mx.execute_many(table, [QUERY] * MANY_COPIES), runs=5)
    med = warm.pop("median_s")
    log("serve_many", copies=MANY_COPIES, launches=counts, queries_per_s=MANY_COPIES / med,
        rows_per_s=MANY_COPIES * rows / med, **warm)

    # the pipeline: client threads cycling the three queries, as e2e_device_bench
    # does; then the COUNT with a literal per client and query, which stacks
    quantity_counts = np.cumsum(np.bincount(cols["lo_quantity"], minlength=52))
    mixes = {
        "e2e_mix": [(QUERY, oracle_q11(cols)), (GROUP_QUERY, oracle_group(cols)),
                    (SERVE_COUNT_QUERY, oracle_count(cols))],
        "literals": [(f"SELECT COUNT(*) FROM lineorder WHERE lo_quantity < {q}",
                      [[int(quantity_counts[q - 1])]]) for q in range(2, 2 + SERVE_CLIENTS)],
    }
    for mix, queries in mixes.items():
        counts = serve_pipeline(mx, table, mix, queries)
        add(counts)
    return launches


def serve_pipeline(mx, table, mix: str, queries) -> dict:
    """SERVE_CLIENTS threads, each sending SERVE_QUERIES_PER_CLIENT queries
    through one DeviceQueryPipeline, client c's query i being queries[(c + i) %
    len(queries)], every answer held against its oracle rows. Logs QPS, the
    latency p50/p95 and the pipeline's stats, and returns the kernels' launches."""
    import threading

    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.engine import kernels, scan
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result

    ctxs = [compile_query(sql, table[0].schema) for sql, _ in queries]
    aggs = [[make_agg(f) for f in ctx.aggregations] for ctx in ctxs]

    def answer(pipeline, q):
        partial = pipeline.execute_partial(ctxs[q], table)
        merged = merge_segment_results([partial], aggs[q])
        return reduce_to_result(ctxs[q], merged, aggs[q], list(ctxs[q].group_by)).rows

    solo_pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        solo = []
        for qi in range(9):
            t0 = time.perf_counter()
            answer(solo_pipeline, qi % len(queries))
            solo.append(time.perf_counter() - t0)
    finally:
        solo_pipeline.stop()

    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    lat, failures = [], []
    lock = threading.Lock()

    def client(ci: int) -> None:
        mine, wrong = [], []
        for qi in range(SERVE_QUERIES_PER_CLIENT):
            q = (ci + qi) % len(queries)
            t0 = time.perf_counter()
            try:
                got = answer(pipeline, q)
            except Exception as e:   # recorded, and the phase fails below
                wrong.append(f"{queries[q][0][:48]}: {e!r}")
                continue
            mine.append(time.perf_counter() - t0)
            if not rows_match(got, queries[q][1]):
                wrong.append(f"{queries[q][0][:48]}: {got} vs {queries[q][1]}")
        with lock:
            lat.extend(mine)
            failures.extend(wrong)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(SERVE_CLIENTS)]
    scan.reset_launch_counts()
    kernels.reset_topk_launches()
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        stats = pipeline.stats()
    finally:
        pipeline.stop()
    counts = launch_counts()
    topk_launches = kernels.topk_launches()
    n_queries = SERVE_CLIENTS * SERVE_QUERIES_PER_CLIENT
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"pipeline {mix}: clients still running after 600 s")
    if failures:
        raise AssertionError(f"pipeline {mix}: {len(failures)} bad answers: {failures[:3]}")
    if len(lat) != n_queries or stats["errors"] or stats["timeouts"]:
        raise AssertionError(f"pipeline {mix}: {len(lat)} of {n_queries} answered, {stats}")
    if counts["masked_sums"] != stats["scanLaunches"]:
        raise AssertionError(f"pipeline {mix} reports {stats['scanLaunches']} scan "
                             f"launches, the kernel counted {counts['masked_sums']}")
    if topk_launches != stats["topkLaunches"] or stats["topkExact"]:
        raise AssertionError(f"pipeline {mix}: {topk_launches} top-k launches counted, "
                             f"stats {stats['topkLaunches']}, {stats['topkExact']} exact")
    lat.sort()
    log("serve_pipeline", mix=mix, distinct_queries=len(queries), clients=SERVE_CLIENTS,
        queries=n_queries, wall_s=wall, qps=n_queries / wall,
        p50_ms=statistics.median(lat) * 1e3, p95_ms=lat[int(0.95 * (len(lat) - 1))] * 1e3,
        solo_p50_ms=statistics.median(solo) * 1e3, launches=counts,
        topk_launches=topk_launches, stats=stats)
    return counts


# -- phase 6: select ----------------------------------------------------------------

def oracle_rows(c, mask, select, key=None, desc=False, limit=10):
    """The first `limit` matching rows by `key` (ties by row index), as lists
    of the `select` columns' values; without a key, in row order."""
    idx = np.flatnonzero(mask)
    if key is not None:
        s = c[key][idx].astype(np.float64)
        s = -s if desc else s
        if len(s) > limit:   # keep every row that ties the limit-th key
            keep = s <= np.partition(s, limit - 1)[limit - 1]
            idx, s = idx[keep], s[keep]
        idx = idx[np.argsort(s, kind="stable")]
    return [[c[col][i] if c[col].dtype == object else c[col][i].item() for col in select]
            for i in idx[:limit]]


def oracle_group_trim(c):
    sums = np.bincount(c["lo_custkey"], weights=c["lo_revenue"])
    keys = np.flatnonzero(np.bincount(c["lo_custkey"]))
    top = keys[np.argsort(-sums[keys], kind="stable")[:10]]
    return [[int(k), float(sums[k])] for k in top]


def select_oracles(c) -> dict:
    everything = np.ones(len(c["lo_quantity"]), dtype=bool)
    return {
        "topk_desc": oracle_rows(c, c["lo_quantity"] >= 10, ["lo_custkey", "lo_revenue"],
                                 "lo_revenue", True, 7),
        "topk_all": oracle_rows(c, everything, ["lo_suppkey", "lo_extendedprice"],
                                "lo_extendedprice", False, 12),
        "topk_ties": oracle_rows(c, c["lo_quantity"] >= 10,
                                 ["lo_custkey", "lo_orderdate", "lo_revenue"],
                                 "lo_suppkey", False, 9),
        "select_limit": oracle_rows(c, c["lo_quantity"] < 3, ["lo_region", "lo_revenue"]),
        "order_exact": oracle_rows(c, (c["lo_quantity"] == 1) & (c["lo_discount"] == 0),
                                   ["lo_custkey", "lo_orderdate"], "lo_orderdate", True, 5),
        "group_trim": oracle_group_trim(c),
    }


def run_select(args, table, cols) -> None:
    """Selections and top-k over the path's table: both entry points, the
    pipeline's `topk` mix, and the stacked top-k timed alone."""
    from pinot_tpu_torch import execute_query
    from pinot_tpu_torch.engine import kernels, scan
    from pinot_tpu_torch.parallel import MeshQueryExecutor

    rows = sum(s.num_docs for s in table)
    mx = MeshQueryExecutor()
    t0 = time.perf_counter()
    oracles = select_oracles(cols)
    log("select_oracle", seconds=time.perf_counter() - t0)
    for qid, sql, topk_per_segment, exact in SELECT_QUERIES:
        want = oracles[qid]
        for path, run in (("per_segment", lambda sql=sql: execute_query(table, sql)),
                          ("set", lambda sql=sql: mx.execute(table, sql))):
            # the path: counts set to 0 just before, read just after
            scan.reset_launch_counts()
            kernels.reset_topk_launches()
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            topk_launches, scans = kernels.topk_launches(), launch_counts()
            if not rows_match(result.rows, want):
                raise AssertionError(f"select {qid} ({path}): got {result.rows}, "
                                     f"oracle {want}")
            if topk_launches != topk_per_segment * len(table) or any(scans.values()):
                raise AssertionError(f"select {qid} ({path}): {topk_launches} top-k "
                                     f"launches, scans {scans}")
            if result.stats.get("topkExact") != exact:
                raise AssertionError(f"select {qid} ({path}): topkExact "
                                     f"{result.stats.get('topkExact')}, expected {exact}")
            runs = (GROUP_TRIM_PER_SEGMENT_RUNS
                    if (qid, path) == ("group_trim", "per_segment") else QUERY_RUNS)
            warm, results = warm_times(run, runs=runs)
            bad = [r.rows for r in results if not rows_match(r.rows, want)]
            if bad:
                raise AssertionError(f"select {qid} ({path}): warm answers {bad[:2]}")
            phases = [r.stats["phaseTimesMs"] for r in results]
            warm.pop("median_s")
            fields = dict(query=qid, path=path, rows=rows, segments=len(table),
                          answer=result.rows, topk_launches=topk_launches,
                          topk_exact=result.stats.get("topkExact"), cold_s=cold_s, **warm,
                          phase_median_ms={k: statistics.median(p[k] for p in phases)
                                           for k in phases[0]})
            if args.trace and runs == QUERY_RUNS:
                fields["trace"] = trace_query(run)
            log("select_query", **fields)

    # the pipeline: client threads cycling the three top-k queries
    topk_queries = [(sql, oracles[qid]) for qid, sql, _, _ in SELECT_QUERIES
                    if qid.startswith("topk_")]
    serve_pipeline(mx, table, "topk", topk_queries)
    select_case(mx, table, cols)


def select_case(mx, table, cols) -> None:
    """The stacked top-k of each top-k query over the whole table: its
    candidates against numpy's stable order, then the first query's program
    timed (L2 flushed, CUDA events), profiled, and held against its bound."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.query.context import compile_query

    prepared = {}
    for qid, sql, _, _ in SELECT_QUERIES:
        if not qid.startswith("topk_"):
            continue
        p = prepared[qid] = mx.prepare_partial(compile_query(sql, table[0].schema), table)
        if p.kind != "topk":
            raise AssertionError(f"select_case {qid}: prepared {p.kind}, not topk")
        order_expr, desc, kk = p.topk
        outs = kernels.topk(p.spec, p.inputs, order_expr, desc, kk)
        got = outs["idx"].cpu().numpy()
        # numpy's stable order of the same f32 scores over the block's mask
        mask = kernels.filter_mask(p.spec, p.inputs).cpu().numpy()
        v = p.inputs.vals[order_expr.name].cpu().numpy().astype(np.float32)
        score = np.where(mask, v if desc else -v, -np.inf).astype(np.float32)
        want = np.argsort(-score.astype(np.float64), kind="stable")[:kk]
        if not np.array_equal(got, want):
            raise AssertionError(f"select_case {qid}: the card's candidates differ from "
                                 f"numpy's stable order at {np.flatnonzero(got != want)[:5]}")
    qid = "topk_desc"
    p = prepared[qid]
    kk = p.topk[2]
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def call():
        return kernels.topk(p.spec, p.inputs, *p.topk)

    ms = time_ms(call, flush)
    ops, wall = _profiled(call, PROFILED_CALLS)
    busy_ms = sum(b - a for _, a, b in ops) / 1e3 / PROFILED_CALLS
    by_name = {}
    for name, a, b in ops:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a) / 1e3 / PROFILED_CALLS
    n = p.inputs.valid.numel()
    read = [*p.inputs.ids.values(), p.inputs.vals[p.topk[0].name], p.inputs.valid]
    nbytes = sum(t.numel() * t.element_size() for t in read) + kk * (8 + 1) + 8
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # per row: two band compares and their AND, the valid AND, isnan, its
    # complement and AND, the sign and the select: ~9 f32-rate operations
    ops_ms = n * 9 / PEAK_F32_OPS_PER_S * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    log("select_case", query=qid, program="kernels.topk (plain torch: filter_mask, "
        "torch.where, torch.topk over tie-broken int64 keys)",
        replaces="pinot_tpu/engine/kernels.py:1123 (topk_kernel)", rows=n, candidates=kk,
        ms=ms, device_busy_ms=busy_ms, device_ops_per_call=len(ops) / PROFILED_CALLS,
        profiled_wall_ms=wall * 1e3 / PROFILED_CALLS,
        launches_per_query={"per_segment": len(table), "stacked": 1},
        bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
        pct_of_bound=100.0 * bound_ms / ms,
        pct_of_bound_device_busy=100.0 * bound_ms / busy_ms if busy_ms else None,
        top_device_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))


def trace_query(fn, runs: int = TRACED_RUNS) -> dict:
    """`runs` warm runs under torch.profiler (`_profiled`), per run: wall ms,
    device-busy ms (the union of the card's kernel and copy intervals), the
    idle share, and the ops that took the most device time. The profiler was
    seen to drop ops from a window of one short run, so a trace covers several,
    and the count of scan kernel events it saw is given, to be held against
    the launches those runs made."""
    spans, wall_s = _profiled(fn, runs)
    wall_us = wall_s * 1e6 / runs
    busy_us, cur_start, cur_end = 0.0, None, None
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if cur_end is None or a > cur_end:
            busy_us += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    busy_us += 0.0 if cur_end is None else cur_end - cur_start
    by_name = {}
    for name, a, b in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy_us /= runs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"runs": runs, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if spans else None,
            "device_events": len(spans),
            "scan_kernel_events": sum(KERNEL_SYMBOL in name for name, _, _ in spans),
            "top_device_ms": {k[:60]: v / 1e3 / runs for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--rows", type=int, default=16 * 1024 * 1024)
    ap.add_argument("--trace", action="store_true",
                    help="also profile warm runs of each query (device idle share)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from pinot_tpu_torch.engine import cuda_lib

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    # phase 2: build
    t0 = time.perf_counter()
    build_log = cuda_lib.build_log("masked_sums")
    log("build", seconds=time.perf_counter() - t0, ptxas=kernel_usage(build_log))

    # phase 3: kernels against their plain versions, at the shapes of phases 4 and 5
    kstats = check_kernels(segment_rows(args.rows, SEGMENTS),
                           segment_rows(min(FOR_ROWS, args.rows), FOR_SEGMENTS),
                           stacked_rows(args.rows, SEGMENTS), args.seed)

    # phase 4: the path; phase 5: the set executor and the pipeline over its table
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_data_", dir=cuda_lib.BUILD_DIR)
    try:
        path_launches, table, cols = run_path(args, work)
        serve_launches = run_serve(args, table, cols)
        run_select(args, table, cols)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sources = {"masked_sums": ("pinot_tpu_torch/csrc/masked_sums.cu",
                               "pinot_tpu/engine/pallas_scan.py:37"),
               "masked_sums_fused": ("pinot_tpu_torch/csrc/masked_sums.cu",
                                     "pinot_tpu/engine/pallas_scan.py:94")}
    kernels = []
    for name in ("masked_sums", "masked_sums_fused"):
        s = kstats[name]
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1],
                        "launches": path_launches[name] + serve_launches[name],
                        "launches_by_path": {"per_segment": path_launches[name],
                                             "serve": serve_launches[name]},
                        "max_abs_err": s["max_abs_err"], "max_rel_err": s["max_rel_err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": None,
                        "kernel_ms": s["kernel_ms"],
                        "call_ms": s["call_ms"], "plain_call_ms": s["plain_call_ms"],
                        "shape_case": s["case"], "cases": s["cases"]})
    print(json.dumps({"kernels": kernels, "note": LIBRARY_NOTE}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
