"""Grouped aggregation: per-key count, sums, power sums, min and max.

Counterpart of the JAX package's GROUP BY regime ladder (`_make_body` in
`pinot_tpu/engine/kernels.py`: the one-hot matmul, `_grouped_chunk64`, the
`segment_sum` escape, the sort rungs `_grouped_sorted` /
`_grouped_partitioned`, the MIN/MAX broadcast-reduce and `segment_min` /
`segment_max`, the grouped `distinct` and the scalar `_presence_2d`), which
XLA compiled from jnp ops. Here it is one hand-written CUDA kernel for Hopper
(`csrc/grouped_agg.cu`) with five rungs, chosen by the cells' bytes
(`choose_rung`, a pure function of the cell count, the cells' bytes, whether
an output is a 64-bit min or max, and the device's opt-in shared memory per
block):

    key       = sum_g ids_g * strides_g            (0 without group columns)
    counts[k] = rows the mask keeps with key k      (int32)
    cell_o[k] = op_o over those rows of value_o     for each output o

with the ops "sum" (f64 sums of the value, rounded to f32), "isum" (exact
int64 sums of an integer value), "sum2" / "sum3" / "sum4" (f64 sums of the
f32 value's powers, taken in f64 by multiplications, rounded to f32), "min"
and "max" (in the value's dtype; a NaN wins, as torch's amin / amax
propagate it). A row the mask drops adds nothing to any cell: a cell no kept
row reaches stays 0, or the identity (+inf / -inf for floats; the int32
ends for int32 values; the int64 ends for int64 values).

The rungs: "thread" (each thread keeps its own copy of the cells in shared
memory: one to a few dozen cells), "warp" (each warp a copy: a few hundred),
"block" (one copy a block of 1024 threads, up to the opt-in shared memory),
"cluster" (one copy a thread-block cluster of two blocks of 512 threads,
each block half the cells, updated through distributed shared memory; no
64-bit min or max), "global" (the cells in
device memory). A shared rung of at most 8,192 cells takes one launch a
call: the last block to finish decodes the cells, from accumulators in a
workspace that the launch leaves zeroed (one per stream; a captured launch
zeroes its own). A larger one decodes in a second kernel, as the global
rung does, which zeroes a fresh scratch with a memset first. The
JAX package's caps (a 512-key matmul, a 131,072-key chunked matmul) are
TPU facts and are not carried over.

`grouped_agg` runs its plain PyTorch version (`grouped_agg_plain`:
`index_add_` and `scatter_reduce_`, the masked rows' contributions 0 or the
identity) only for tensors on the CPU. For CUDA tensors it launches the
kernel or raises. `grouped_agg.launches` counts kernel launches, and nothing
else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from . import cuda_lib

OPS = {"sum": 0, "isum": 1, "sum2": 2, "sum3": 3, "sum4": 4, "min": 5, "max": 6}
DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3}
RUNGS = {"global": 0, "block": 1, "warp": 2, "thread": 3, "cluster": 4}
POWERS = {"sum2": 2, "sum3": 3, "sum4": 4}
# the kernel's limits (csrc/grouped_agg.cu), checked before a launch
MAX_GROUPS = 16
MAX_OUTS = 16
THREADS = 256       # a block's threads, but the block and cluster rungs'
WARPS = THREADS // 32
BLOCK_THREADS = 1024   # the block rung's: one copy shared by 32 warps
CLUSTER_THREADS = 512  # the cluster rung's (86 registers a thread)
# the cluster rung's blocks a cluster, each holding half the cells: clusters
# of 4 and 8 ran slower than the global rung (grouped_bench.py --sweep)
CLUSTER_BLOCKS = 2
ROWS = 8            # consecutive rows a thread takes at a time
TICKET_BYTES = 16   # the workspace's head
# the thread rung: every thread's copy together in at most this many bytes
# (8 such blocks fit an H100 SM's 233,472 bytes). grouped_bench.py --sweep:
# at GROUP_QUERY's 9 cells of one f64 sum (27,648 bytes) level with the
# warp rung over a segment and ahead over the stacked set; from 10 cells
# (30,720) to 64 the warp or block rung is ahead; at one cell, 5x and more
THREAD_COPIES_BYTES = 28_160
# the warp rung: every warp's copy together in at most this many bytes; at
# 144 cells it ties the block rung counting and leads it summing f64, far
# ahead of the thread rung; from 24 to 64 cells over one segment the block
# rung leads it by up to 16% (the chooser does not see the rows)
WARP_COPIES_BYTES = 24 * 1024
BLOCK_RESERVED_BYTES = 1024   # shared memory the runtime keeps per block
# blocks an SM at most: as many as the kernel's registers let stay resident
# (3 of the thread rung at 80 a thread, 4 of the warp rung at 64, 1 of the
# block rung's 1024 threads at 64, 1 of the cluster rung's 512 at 86): each
# block merges its copies into the same few accumulators, so a second wave
# costs more than it gains;
# the global rung's L2 atomics were fastest at 2 an SM (grouped_bench.py
# --sweep: lo_custkey and lo_suppkey)
BLOCKS_PER_SM = {"thread": 3, "warp": 4, "block": 1, "cluster": 1, "global": 2}
ROWS_PER_THREAD = 16   # rows each thread takes before the grid grows by a block

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)
_lock = threading.Lock()
_devices: Dict[int, Tuple[int, int, int]] = {}   # device -> (SMs, opt-in smem, smem per SM)
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}   # (device, stream) -> zeroed bytes
_loaded: Dict[str, ctypes.CDLL] = {}   # the library, once its limits are checked


def cell_bytes(op: str, dtype: torch.dtype) -> int:
    """Bytes of one accumulator cell: 4 for the min / max of an f32 or int32
    value, else 8 (f64 and int64 sums, 64-bit min / max)."""
    return 4 if op in ("min", "max") and dtype in (torch.float32, torch.int32) else 8


def region_bytes(num_cells: int, widths: Sequence[int]) -> int:
    """Bytes of one copy of the cells (a warp's or a block's) and of the
    accumulators: the counts (4 bytes a cell) and each output's cells
    (`widths`), rounded up to 8 (`cells_of` in the kernel, which checks that
    the two agree)."""
    return -(-num_cells * (4 + sum(widths)) // 8) * 8


def thread_copies_bytes(num_cells: int, widths: Sequence[int]) -> int:
    """Shared bytes of the thread rung: every thread's copy, unrounded."""
    return num_cells * (4 + sum(widths)) * THREADS


def workspace_bytes(num_cells: int, widths: Sequence[int]) -> int:
    """Bytes of a launch's workspace: the ticket, then the accumulators."""
    return TICKET_BYTES + region_bytes(num_cells, widths)


def choose_rung(num_cells: int, widths: Sequence[int], smem_per_block: int,
                max64: bool = False) -> Tuple[str, int]:
    """(rung, shared bytes a block) for `num_cells` cells of outputs whose
    cells take `widths` bytes, on a device whose blocks may opt into
    `smem_per_block` bytes of shared memory: "thread" where every thread's
    copy fits THREAD_COPIES_BYTES, "warp" where every warp's fits
    WARP_COPIES_BYTES, "block" where one copy fits the block, "cluster"
    where half of it does and no output is a 64-bit min or max (`max64`),
    else "global" (0 bytes)."""
    rungs = [("thread", THREAD_COPIES_BYTES), ("warp", WARP_COPIES_BYTES),
             ("block", smem_per_block)] + ([] if max64 else [("cluster", smem_per_block)])
    for rung, most in rungs:
        nbytes = rung_bytes(rung, num_cells, widths)
        if nbytes <= most:
            return rung, nbytes
    return "global", 0


def block_threads(rung: str) -> int:
    """Threads a block of `rung`."""
    return {"block": BLOCK_THREADS, "cluster": CLUSTER_THREADS}.get(rung, THREADS)


def rung_bytes(rung: str, num_cells: int, widths: Sequence[int]) -> int:
    """Shared bytes a block of `rung` takes for these cells: its copies, or
    on the cluster rung its slice."""
    if rung == "cluster":
        return region_bytes(-(-num_cells // CLUSTER_BLOCKS), widths)
    region = region_bytes(num_cells, widths)
    return {"thread": thread_copies_bytes(num_cells, widths), "warp": region * WARPS,
            "block": region}.get(rung, 0)


def launch_grid(rung: str, n_rows: int, smem: int, sms: int, smem_per_sm: int) -> int:
    """Blocks of a launch: BLOCKS_PER_SM[rung] an SM, fewer where their shared
    copies do not fit beside each other, fewer where the rows would give a
    thread fewer than ROWS_PER_THREAD; on the cluster rung whole clusters
    (the kernel cuts them further, to the clusters the card holds at
    once)."""
    fit = smem_per_sm // (smem + BLOCK_RESERVED_BYTES) if smem else BLOCKS_PER_SM[rung]
    per_sm = max(1, min(BLOCKS_PER_SM[rung], fit))
    grid = max(1, min(sms * per_sm, -(-n_rows // (block_threads(rung) * ROWS_PER_THREAD))))
    size = CLUSTER_BLOCKS if rung == "cluster" else 1
    return max(size, grid // size * size)


def row_tiling(columns: Sequence[Tuple[int, int, int]]) -> Tuple[int, bool]:
    """(head, vec) for columns given as (address, bytes a row, alignment the
    vector loads need): the fewest rows before which every column is
    aligned, read row by row, and whether one exists below ROWS (else every
    row is read by scalar loads, from row 0)."""
    for head in range(ROWS):
        if all((addr + head * size) % align == 0 for addr, size, align in columns):
            return head, True
    return 0, False


def out_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype of an output: f32 for the f64 sums, int64 for "isum", the
    value's dtype for min / max."""
    return torch.int64 if op == "isum" else dtype if op in ("min", "max") else torch.float32


def identity(op: str, dtype: torch.dtype):
    """A cell's value where no kept row reaches it."""
    if op in ("min", "max"):
        if dtype.is_floating_point:
            return float("inf") if op == "min" else float("-inf")
        info = torch.iinfo(dtype)
        return info.max if op == "min" else info.min
    return 0


def _check(ids: Sequence[torch.Tensor], strides: Sequence[int], mask: torch.Tensor,
           vals: Sequence[torch.Tensor], ops: Sequence[str], num_cells: int) -> None:
    """Raise on what neither version takes."""
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError(f"the mask is bool [rows], got {mask.dtype} {tuple(mask.shape)}")
    n = mask.shape[0]
    if len(ids) != len(strides) or len(ids) > MAX_GROUPS:
        raise ValueError(f"{len(ids)} group id columns and {len(strides)} strides "
                         f"(at most {MAX_GROUPS})")
    if len(vals) != len(ops) or len(ops) > MAX_OUTS:
        raise ValueError(f"{len(vals)} value rows and {len(ops)} ops (at most {MAX_OUTS})")
    if not 1 <= num_cells <= (1 << 31) - 1:
        raise ValueError(f"{num_cells} cells: the kernel takes 1 to 2^31 - 1")
    for t in ids:
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"group ids are int32 [{n}], got {t.dtype} {tuple(t.shape)}")
    for v, op in zip(vals, ops):
        if op not in OPS:
            raise ValueError(f"op {op!r} is not one of {sorted(OPS)}")
        if v.dtype not in DTYPES or v.shape != (n,):
            raise ValueError(f"a value row is f32, f64, int32 or int64 [{n}], got "
                             f"{v.dtype} {tuple(v.shape)}")
        if op == "isum" and v.dtype.is_floating_point:
            raise ValueError(f"isum takes an integer row, got {v.dtype}")
    for t in (mask, *ids, *vals):
        if t.device != mask.device or not t.is_contiguous():
            raise ValueError(f"every input must be a contiguous tensor on {mask.device}")


def grouped_agg_plain(ids: Sequence[torch.Tensor], strides: Sequence[int],
                      mask: torch.Tensor, vals: Sequence[torch.Tensor], ops: Sequence[str],
                      num_cells: int) -> List[torch.Tensor]:
    """The kernel's function in plain PyTorch (any device): [counts, out_0,
    ...]. A dropped row (masked, or a key outside [0, num_cells)) adds 0 or
    the identity at cell 0, so no cell changes and nothing waits for the card."""
    _check(ids, strides, mask, vals, ops, num_cells)
    device = mask.device
    key = torch.zeros(mask.shape[0], dtype=torch.int64, device=device)
    for t, s in zip(ids, strides):
        key = key + t.to(torch.int64) * int(s)
    keep = mask & (key >= 0) & (key < num_cells)
    key = torch.where(keep, key, 0)
    counts = torch.zeros(num_cells, dtype=torch.int32, device=device)
    res = [counts.index_add_(0, key, keep.to(torch.int32))]
    for v, op in zip(vals, ops):
        if op == "isum":
            acc = torch.zeros(num_cells, dtype=torch.int64, device=device)
            res.append(acc.index_add_(0, key, torch.where(keep, v.to(torch.int64), 0)))
        elif op in ("min", "max"):
            cells = torch.full((num_cells,), identity(op, v.dtype), dtype=v.dtype, device=device)
            rows = torch.where(keep, v, identity(op, v.dtype))
            res.append(cells.scatter_reduce_(0, key, rows, reduce="amin" if op == "min"
                                             else "amax"))
        else:
            rows = v.to(torch.float64) if op == "sum" else power_rows(v, POWERS[op])
            acc = torch.zeros(num_cells, dtype=torch.float64, device=device)
            acc.index_add_(0, key, torch.where(keep, rows, 0.0))
            res.append(acc.to(torch.float32))
    return res


def power_rows(v: torch.Tensor, p: int) -> torch.Tensor:
    """The f32 value raised to `p`, in float64 by multiplications (each
    rounded once, as IEEE requires), so that the card and the CPU build the
    same rows."""
    x = v.to(torch.float32).to(torch.float64)
    x2 = x * x
    return {2: x2, 3: x2 * x, 4: x2 * x2}[p]


def _lib() -> ctypes.CDLL:
    lib = _loaded.get("lib")
    if lib is not None:   # checked once; a call reads it without the lock
        return lib
    lib = cuda_lib.load("grouped_agg")
    with _lock:
        if not getattr(lib, "pinot_checked", False):
            lib.pinot_grouped_agg.argtypes = _ARGTYPES
            lib.pinot_grouped_agg.restype = ctypes.c_int
            lib.pinot_grouped_agg_limits.argtypes = (ctypes.c_void_p,)
            lib.pinot_grouped_agg_limits.restype = None
            lib.pinot_grouped_agg_setup.argtypes = (ctypes.c_void_p,)
            lib.pinot_grouped_agg_setup.restype = ctypes.c_int
            limits = (ctypes.c_int32 * 9)()
            lib.pinot_grouped_agg_limits(limits)
            if tuple(limits) != (MAX_GROUPS, MAX_OUTS, THREADS, WARPS, ROWS, TICKET_BYTES,
                                 BLOCK_THREADS, CLUSTER_THREADS, CLUSTER_BLOCKS):
                raise RuntimeError(f"grouped_agg.cu limits {tuple(limits)} differ from "
                                   "engine/grouped.py's")
            lib.pinot_checked = True
        _loaded["lib"] = lib
    return lib


def device_caps(device: torch.device) -> Tuple[int, int, int]:
    """(SMs, opt-in shared memory bytes per block, shared memory bytes per SM)
    of `device`, read once: the rung and the grid come from them."""
    caps = _devices.get(device.index)
    if caps is not None:
        return caps
    lib = _lib()
    with _lock:
        caps = _devices.get(device.index)
        if caps is None:
            out = (ctypes.c_int32 * 3)()
            with torch.cuda.device(device):
                err = lib.pinot_grouped_agg_setup(out)
            if err != 0:
                raise RuntimeError(f"pinot_grouped_agg_setup failed: CUDA error {err}")
            caps = _devices[device.index] = (int(out[0]), int(out[1]), int(out[2]))
    return caps


def is_max64(op: str, dtype: torch.dtype) -> bool:
    """Whether an output is a 64-bit min or max (an 8-byte max cell)."""
    return op in ("min", "max") and cell_bytes(op, dtype) == 8


def rung_for(device: torch.device, vals: Sequence[torch.Tensor], ops: Sequence[str],
             num_cells: int) -> Tuple[str, int]:
    """The rung and shared bytes a launch of these outputs takes on `device`."""
    return choose_rung(num_cells, [cell_bytes(op, v.dtype) for v, op in zip(vals, ops)],
                       device_caps(device)[1],
                       any(is_max64(op, v.dtype) for v, op in zip(vals, ops)))


def _workspace(device: torch.device, stream: torch.cuda.Stream,
               nbytes: int) -> Tuple[torch.Tensor, bool]:
    """(workspace, zero it first?) of a shared rung's launch on `stream`.
    Eager launches on one stream run in order, so they share one, zeroed
    once and left zeroed by every launch; it grows where a launch needs
    more. A launch captured into a graph takes one of its own, which the
    graph owns and zeroes with a captured memset: two graphs may replay at
    once."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(nbytes, dtype=torch.uint8, device=device), True
    key = (device.index, stream.cuda_stream)
    with _lock:
        ws = _workspaces.get(key)
        if ws is None or ws.numel() < nbytes:
            ws = _workspaces[key] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    return ws, False


def _launch(ids, strides, mask, vals, ops, num_cells, rung=None,
            grid=None) -> List[torch.Tensor]:
    """One kernel call. `rung` and `grid` override the choice: the hook of
    grouped_bench.py's sweep, which times every rung and grid (the
    thresholds' source); nothing else passes them."""
    device = mask.device
    sms, optin, smem_per_sm = device_caps(device)
    widths = [cell_bytes(op, v.dtype) for v, op in zip(vals, ops)]
    if rung is None:
        rung = rung_for(device, vals, ops, num_cells)[0]
    smem = rung_bytes(rung, num_cells, widths)
    n = mask.shape[0]
    if n > (1 << 31) - 1:
        raise ValueError(f"{n} rows: the kernel takes at most 2^31 - 1")
    if grid is None:
        grid = launch_grid(rung, n, smem, sms, smem_per_sm)
    counts = torch.empty(num_cells, dtype=torch.int32, device=device)
    outs = [torch.empty(num_cells, dtype=out_dtype(op, v.dtype), device=device)
            for v, op in zip(vals, ops)]
    head, vec = row_tiling([(mask.data_ptr(), 1, 8)] + [(t.data_ptr(), 4, 16) for t in ids]
                           + [(v.data_ptr(), v.element_size(), 16) for v in vals])
    stream = torch.cuda.current_stream(device)
    ws_bytes = workspace_bytes(num_cells, widths)
    if rung == "global":
        # accumulators as large as the cells: a fresh scratch zeroed by a
        # memset, whose lines the atomics then find in L2, not a stream's
        # workspace that the flush of other work has evicted
        ws, zero = torch.empty(ws_bytes, dtype=torch.uint8, device=device), True
    else:
        ws, zero = _workspace(device, stream, ws_bytes)
    k = max(len(ops), 1)
    c_ids = (ctypes.c_void_p * max(len(ids), 1))(*[t.data_ptr() for t in ids])
    c_strides = (ctypes.c_longlong * max(len(ids), 1))(*[int(s) for s in strides])
    c_vals = (ctypes.c_void_p * k)(*[v.data_ptr() for v in vals])
    c_dtypes = (ctypes.c_int * k)(*[DTYPES[v.dtype] for v in vals])
    c_ops = (ctypes.c_int * k)(*[OPS[op] for op in ops])
    c_outs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    args = (c_ids, c_strides, len(ids), mask.data_ptr(), n, c_vals, c_dtypes, c_ops, c_outs,
            len(ops), counts.data_ptr(), num_cells, RUNGS[rung], grid, smem, head, int(vec),
            ws.data_ptr(), ws_bytes, int(zero), stream.cuda_stream)
    if torch.cuda.current_device() == device.index:
        err = _lib().pinot_grouped_agg(*args)
    else:
        with torch.cuda.device(device):
            err = _lib().pinot_grouped_agg(*args)
    if err != 0:
        raise RuntimeError(f"pinot_grouped_agg launch failed: CUDA error {err}")
    return [counts, *outs]


def grouped_agg(ids: Sequence[torch.Tensor], strides: Sequence[int], mask: torch.Tensor,
                vals: Sequence[torch.Tensor] = (), ops: Sequence[str] = (),
                num_cells: int = 1) -> List[torch.Tensor]:
    """[counts int32[num_cells], one tensor per output] of the rows `mask`
    keeps, grouped by `sum(ids[g] * strides[g])`: the kernel on a card, the
    plain version on the CPU."""
    _check(ids, strides, mask, vals, ops, num_cells)
    if mask.device.type == "cpu":
        return grouped_agg_plain(ids, strides, mask, vals, ops, num_cells)
    out = _launch(ids, strides, mask, vals, ops, num_cells)
    with _lock:
        grouped_agg.launches += 1
    return out


grouped_agg.launches = 0


def reset_launch_counts() -> None:
    with _lock:
        grouped_agg.launches = 0
