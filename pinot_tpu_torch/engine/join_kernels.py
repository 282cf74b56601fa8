"""Device hash-join build and probe programs, in plain PyTorch.

Counterpart of `pinot_tpu/engine/join_kernels.py`. The multistage hash join
moves the heavy part of an equi-join, ordering the build side and locating
each probe row's match range, onto the device, in two regimes:

* **scatter regime**: one integer key whose build-side value span fits under
  `SCATTER_TABLE_CAP` direct-address slots. The build program counts slot
  occupancy and scatters row ids into a dense table (a duplicate key sends the
  join to sort-merge); the probe program is one gather, at most one candidate
  per probe row. This is the dimension-table shape: small unique keys.
* **sort-merge regime**: anything else. The build codes (the 64-bit stable
  exchange hashes folded to 32 bits, `fold_codes32`) are sorted on the device;
  the probe program's two `searchsorted` give each probe row its [lo, lo+cnt)
  candidate range in the sorted build order.

Both probe programs also count a 256-bucket histogram of the probe keys, the
skew detector behind `joinSkewPct`.

The JAX package's programs are `jax.jit` functions, not Pallas kernels, so
these are torch code (no hand kernel until a card run shows one hot). What
differs from the reference:

* Codes are uint32. The device carries them as int32 with the sign bit
  flipped (`device_codes`), which keeps their order, since torch's uint32 has
  few CUDA ops; the low 8 bits, the histogram's bucket, are unchanged.
* No pow2 padding: the reference pads shapes only to bound retraces, which
  eager torch does not have. So `order` spans the build side exactly, and a
  probe code of 0xFFFFFFFF counts only real build rows (the reference's
  count also takes in the pads that sort after them, which its caller drops).
* `mode="drop"` scatters become a scatter into one extra dump slot, sliced
  off, so that no host sync is needed to drop out-of-range rows.

`launch_counts()` counts each program's calls, so that a run can show which
regime a join took.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..query import stats as qstats
from ..query.executor import resolve_device

#: probe-hash histogram width for the skew detector (bucket = code & 255)
SKEW_BUCKETS = 256

#: direct-address slot budget of the scatter regime (the JAX package's
#: `scatter_table_cap()`): its default `join_scatter_cap`
#: (`pinot_tpu/engine/calibrate.py`), until calibration on the H100 sets it
SCATTER_TABLE_CAP = 1 << 20

PROGRAMS = ("sort_build", "sorted_probe", "scatter_build", "scatter_probe")
_launches = dict.fromkeys(PROGRAMS, 0)
_launch_lock = threading.Lock()


def _count(program: str) -> None:
    with _launch_lock:
        _launches[program] += 1


def launch_counts() -> Dict[str, int]:
    """Calls of each device program since the last `reset_launch_counts`,
    on every thread."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0


def fold_codes32(codes: np.ndarray) -> np.ndarray:
    """64-bit stable exchange hashes -> well-mixed uint32 device codes.

    The murmur-style finalizer keeps the fold collision rate at the birthday
    bound. Callers verify candidates on the full 64-bit codes."""
    x = np.ascontiguousarray(codes, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(29)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(32)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def skew_pct_from_hist(hist: np.ndarray) -> float:
    """Excess mass of the hottest probe-hash bucket over uniform, as a
    percentage: 0 for a flat histogram, approaching 100 when one bucket (one
    hot key, typically) carries everything."""
    total = float(np.sum(hist))
    if total <= 0.0:
        return 0.0
    uniform = 1.0 / len(hist)
    top = float(np.max(hist)) / total
    return max(0.0, 100.0 * (top - uniform) / (1.0 - uniform))


def device_codes(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 codes as order-preserving int32 on `device` (sign bit flipped)."""
    flipped = np.ascontiguousarray(codes, dtype=np.uint32) ^ np.uint32(0x80000000)
    return torch.from_numpy(flipped.view(np.int32)).to(device)


# -- sort-merge regime ------------------------------------------------------------

def sort_build_program(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The build side in code order: (sorted codes, int64 row order). Stable,
    as `jnp.argsort`, so equal codes keep their row order."""
    _count("sort_build")
    return torch.sort(codes, stable=True)


def sorted_probe_program(sorted_codes: torch.Tensor, probe: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each probe code's candidate range in the sorted build codes: (lo, cnt,
    hist), int64 lo and cnt per probe row, and the probe codes' 256-bucket
    histogram."""
    _count("sorted_probe")
    lo = torch.searchsorted(sorted_codes, probe, right=False)
    hi = torch.searchsorted(sorted_codes, probe, right=True)
    hist = torch.bincount((probe & (SKEW_BUCKETS - 1)).long(), minlength=SKEW_BUCKETS)
    return lo, hi - lo, hist


def sort_merge_probe(build_codes: np.ndarray, probe_codes: np.ndarray, device=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Sort the build codes on the device, probe with two searchsorted.

    Returns `(lo, cnt, order, skew_pct)`: probe row i's candidate build rows
    are `order[lo[i] : lo[i] + cnt[i]]` in the device sort order; `order`
    holds every build row once; `skew_pct` is the probe-hash histogram's
    hot-bucket excess. Records `joinBuildMs` (sort and the order's copy) and
    `joinProbeMs` (probe and one copy of its outputs)."""
    dev = resolve_device(device)
    n = len(probe_codes)
    t0 = time.perf_counter()
    sorted_dev, order_dev = sort_build_program(device_codes(build_codes, dev))
    order = order_dev.cpu().numpy()
    t1 = time.perf_counter()
    qstats.record(qstats.JOIN_BUILD_MS, (t1 - t0) * 1000)

    lo, cnt, hist = sorted_probe_program(sorted_dev, device_codes(probe_codes, dev))
    host = torch.cat([lo, cnt, hist]).cpu().numpy()
    qstats.record(qstats.JOIN_PROBE_MS, (time.perf_counter() - t1) * 1000)
    return host[:n], host[n:2 * n], order, skew_pct_from_hist(host[2 * n:])


# -- scatter (direct-address) regime ----------------------------------------------

def scatter_build_program(slots: torch.Tensor, size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-address table of the build rows: (int32[size] row id per slot,
    -1 where empty; the largest slot occupancy). Rows whose slot lies outside
    [0, size) go to a dump slot past the end, sliced off. With duplicate slots
    the table keeps an arbitrary one of their rows: the caller reads the
    occupancy first and does not use such a table."""
    _count("scatter_build")
    slots = slots.long()
    dump = torch.where((slots >= 0) & (slots < size), slots, size)
    counts = torch.bincount(dump, minlength=size + 1)[:size]
    table = torch.full((size + 1,), -1, dtype=torch.int32, device=slots.device)
    table[dump] = torch.arange(len(slots), dtype=torch.int32, device=slots.device)
    return table[:size], counts.max()


def scatter_probe_program(table: torch.Tensor, slots: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gather per probe row: (int32 build row or -1, the 256-bucket
    histogram of the in-range probe slots)."""
    _count("scatter_probe")
    size = table.numel()
    slots = slots.long()
    valid = (slots >= 0) & (slots < size)
    safe = torch.where(valid, slots, 0)
    cand = torch.where(valid, table[safe], -1)
    bucket = torch.where(valid, safe & (SKEW_BUCKETS - 1), SKEW_BUCKETS)
    hist = torch.bincount(bucket, minlength=SKEW_BUCKETS + 1)[:SKEW_BUCKETS]
    return cand, hist


def scatter_probe(build_slots: np.ndarray, probe_slots: np.ndarray, size: int,
                  device=None) -> Optional[Tuple[np.ndarray, float]]:
    """Direct-address probe: build slots (key - min, in [0, size) for live
    rows, >= size for null rows) scatter into a dense table; each probe row
    gathers at most one candidate. Returns `(cand, skew_pct)` with cand[i] the
    matching build row or -1, or None when the build side has duplicate keys
    (the caller takes sort-merge). Records `joinBuildMs` (build and the
    occupancy read) and `joinProbeMs`."""
    dev = resolve_device(device)
    n = len(probe_slots)
    t0 = time.perf_counter()
    table, max_count = scatter_build_program(
        torch.from_numpy(np.ascontiguousarray(build_slots, dtype=np.int32)).to(dev),
        int(size))
    max_count = int(max_count)
    t1 = time.perf_counter()
    qstats.record(qstats.JOIN_BUILD_MS, (t1 - t0) * 1000)
    if max_count > 1:
        return None   # duplicate build keys: the table cannot hold the chain

    cand, hist = scatter_probe_program(
        table, torch.from_numpy(np.ascontiguousarray(probe_slots, dtype=np.int32)).to(dev))
    host = torch.cat([cand.long(), hist]).cpu().numpy()
    qstats.record(qstats.JOIN_PROBE_MS, (time.perf_counter() - t1) * 1000)
    return host[:n], skew_pct_from_hist(host[n:])
