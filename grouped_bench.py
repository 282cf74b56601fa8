#!/usr/bin/env python3
"""Times `grouped_agg` at `chip_smoke.py`'s `group_case` shapes for one
checkout of pinot_tpu_torch, on one CUDA card.

    python3 grouped_bench.py [--root DIR] [--seed 20260729] [--rows 16777216] [--sweep]

Draws SSB-like columns with numpy from --seed (lo_region's 5 ids, lo_discount's
11, lo_quantity 1-50, lo_orderdate's 2,352 ids, 20,000 suppliers, 500,000
customers, f32 revenue and price) and the masks of GROUP_QUERY (lo_discount
1-3 and lo_quantity < 25, ~13% of the rows), of Q1.1 (that and one year of
the order dates, ~1.9%) and of every row; then runs `chip_smoke.group_cases`
over the smoke's calls at its cell counts (9, 4,097, 20,481, 503,809, 144,
16, 32,768 and 1 cells), on one segment's rows (--rows / 8) and on the
stacked set's (--rows): each output held equal to the plain version's, then
`ms` (graph replay, L2 flushed), `plain_ms`, `call_ms`, `library_ms` and the
bound, one `group_case` line each (and one more, GROUP BY lo_region,
lo_discount's 144 cells with an f64 sum: the warp rung's 64-bit cells).
`--root` names the checkout whose
`pinot_tpu_torch` runs (default: this one), so two commits compare on one
card in one call: run the script for each, in turns (A, B, B, A). `--sweep`
(a checkout with `grouped._launch(..., rung=, grid=)`) also times each case,
and GROUP_QUERY's mask over 10 to 64 drawn keys with one f64 sum (the thread
rung's edge), on every rung that takes it, at the grids that give each
thread 8 to 256 rows and at 1, 2, 3, 4 and 8 blocks an SM (`group_sweep`
lines): the sweep that sets `choose_rung`'s and `launch_grid`'s thresholds. Without a CUDA
card it exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import chip_smoke
from chip_smoke import L2_FLUSH_BYTES, SEGMENTS, log

CELLS = {"region": 9, "orderdate": 4097, "suppkey": 20_481, "custkey": 503_809,
         "discount": 16, "presence": 32_768}
SWEEP_ROWS_PER_THREAD = (8, 16, 32, 64, 128, 256)
# drawn keys between the thread rung's and the warp rung's shapes (9 and 144)
SWEEP_KEYS = (10, 16, 24, 32, 48, 64)


def columns(rows: int, seed: int, device: torch.device) -> dict:
    """The drawn columns (int32 ids and values, f32 rows) and the three masks
    on `device`."""
    rng = np.random.default_rng(seed)
    c = {"region": rng.integers(0, 5, rows), "discount": rng.integers(0, 11, rows),
         "quantity": rng.integers(1, 51, rows), "orderdate": rng.integers(0, 2352, rows),
         "suppkey": rng.integers(0, 20_000, rows), "custkey": rng.integers(0, 500_000, rows)}
    out = {k: torch.from_numpy(v.astype(np.int32)).to(device) for k, v in c.items()}
    for k, hi in (("revenue", 60_000.0), ("price", 10_000.0)):
        out[k] = torch.from_numpy(rng.uniform(1.0, hi, rows).astype(np.float32)).to(device)
    group = (c["discount"] >= 1) & (c["discount"] <= 3) & (c["quantity"] < 25)
    year = (c["orderdate"] >= 336) & (c["orderdate"] < 672)   # one of the 7 years
    out["group_mask"] = torch.from_numpy(group).to(device)
    out["q11_mask"] = torch.from_numpy(group & year).to(device)
    out["all_rows"] = torch.ones(rows, dtype=torch.bool, device=device)
    # drawn last, so that the columns above are the same for every --sweep
    for k in SWEEP_KEYS:
        out[f"keys{k}"] = torch.from_numpy(rng.integers(0, k, rows).astype(np.int32)).to(device)
    return out


def cases(c: dict, segment: int) -> list:
    """(case, group ids, strides, mask, value rows, ops, cells) of the smoke's
    `group_case` and timed `aggs_case` calls; one segment is the first
    `segment` rows."""
    one = {k: v[:segment] for k, v in c.items()}
    rev, disc = c["revenue"], c["discount"]
    return [
        ("region, one segment", [one["region"]], [1], one["group_mask"], [one["revenue"]],
         ["sum"], CELLS["region"]),
        ("region, stacked set", [c["region"]], [1], c["group_mask"], [rev], ["sum"],
         CELLS["region"]),
        ("orderdate, stacked set", [c["orderdate"]], [1], c["all_rows"],
         [rev, c["quantity"], c["price"]], ["sum", "min", "max"], CELLS["orderdate"]),
        ("suppkey var_pop, stacked set", [c["suppkey"]], [1], c["all_rows"], [disc, disc],
         ["isum", "sum2"], CELLS["suppkey"]),
        ("custkey, stacked set", [c["custkey"]], [1], c["all_rows"], [rev], ["sum"],
         CELLS["custkey"]),
        ("region distinct, stacked set", [c["region"], disc], [CELLS["discount"], 1],
         c["all_rows"], [], [], CELLS["region"] * CELLS["discount"]),
        ("q11 distinct, stacked set", [disc], [1], c["q11_mask"], [], [], CELLS["discount"]),
        ("region x discount revenue, stacked set", [c["region"], disc], [CELLS["discount"], 1],
         c["group_mask"], [rev], ["sum"], CELLS["region"] * CELLS["discount"]),
        ("presence lo_suppkey, Q1.1 filter, one segment", [one["suppkey"]], [1],
         one["q11_mask"], [], [], CELLS["presence"]),
        ("presence lo_suppkey, Q1.1 filter, stacked set", [c["suppkey"]], [1], c["q11_mask"],
         [], [], CELLS["presence"]),
        ("power sums 2-4 lo_discount, one segment", [], [], one["all_rows"],
         [one["discount"]] * 3, ["sum2", "sum3", "sum4"], 1),
        ("power sums 2-4 lo_discount, stacked set", [], [], c["all_rows"], [disc] * 3,
         ["sum2", "sum3", "sum4"], 1),
    ]


def sweep_cases(c: dict, segment: int) -> list:
    """GROUP_QUERY's mask and revenue sum over SWEEP_KEYS drawn keys, on one
    segment and, at 16 and 64 keys, on the stacked set."""
    out = []
    for k in SWEEP_KEYS:
        for rows, where in ((segment, "one segment"), (None, "stacked set")):
            if rows is None and k not in (16, 64):
                continue
            cut = slice(0, rows)
            out.append((f"{k} keys revenue, {where}", [c[f"keys{k}"][cut]], [1],
                        c["group_mask"][cut], [c["revenue"][cut]], ["sum"], k))
    return out


def sweep(grouped, all_cases: list) -> None:
    """Each case on every rung whose copies fit a block (not the cluster
    rung for a 64-bit min or max), at the grids that give a thread
    SWEEP_ROWS_PER_THREAD rows and at 1, 2, 3, 4 and 8 blocks an SM (capped
    at the blocks the card holds at once, whole clusters on the cluster
    rung, which the kernel caps at the clusters the card holds): one
    `group_sweep` line a case."""
    dev = all_cases[0][3].device
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    sms, optin, per_sm = grouped.device_caps(dev)
    for case, gids, strides, mask, vrows, ops, cells in all_cases:
        widths = [grouped.cell_bytes(op, v.dtype) for v, op in zip(vrows, ops)]
        max64 = any(grouped.is_max64(op, v.dtype) for v, op in zip(vrows, ops))
        n = mask.numel()
        times = {}
        for rung in grouped.RUNGS:
            nbytes = grouped.rung_bytes(rung, cells, widths)
            if nbytes > optin or rung == "cluster" and max64:
                continue
            size = grouped.CLUSTER_BLOCKS if rung == "cluster" else 1
            threads = grouped.block_threads(rung)
            fit = 2048 // threads if nbytes == 0 else \
                per_sm // (nbytes + grouped.BLOCK_RESERVED_BYTES)
            resident = sms * max(1, min(2048 // threads, fit))
            grids = sorted({max(size, min(resident, -(-n // (threads * r)))) // size * size
                            for r in SWEEP_ROWS_PER_THREAD}
                           | {sms * k // size * size for k in (1, 2, 3, 4, 8)
                              if sms * k <= resident})
            for grid in grids:
                def fn(rung=rung, grid=grid):
                    return grouped._launch(gids, strides, mask, vrows, ops, cells, rung=rung,
                                           grid=grid)
                times[f"{rung}/{grid}"] = chip_smoke.graph_ms(fn, flush)
        best = min(times, key=times.get)
        log("group_sweep", case=case, rows=n, cells=cells, ops=list(ops),
            chosen=grouped.rung_for(dev, vrows, ops, cells)[0], best=best, ms=times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose pinot_tpu_torch package runs")
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--rows", type=int, default=16 * 1024 * 1024)
    ap.add_argument("--sweep", action="store_true",
                    help="also time each case on every rung and at several grids")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grouped_bench: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from pinot_tpu_torch.engine import grouped
    if not os.path.abspath(grouped.__file__).startswith(os.path.abspath(args.root) + os.sep):
        raise RuntimeError(f"imported {grouped.__file__}, not the package under {args.root}")

    device = torch.device("cuda")
    segment = args.rows // SEGMENTS
    cols = columns(args.rows, args.seed, device)
    all_cases = cases(cols, segment)
    log("grouped_bench", root=os.path.abspath(args.root), package=grouped.__file__,
        nvidia_smi=chip_smoke.nvidia_smi_line(), rows=args.rows, segment_rows=segment)
    chip_smoke.group_cases(all_cases)
    if args.sweep:
        sweep(grouped, all_cases + sweep_cases(cols, segment))
    return 0


if __name__ == "__main__":
    sys.exit(main())
