"""Masked multi-sum scans: the filter + SUM/COUNT kernels of a scalar aggregation.

Counterpart of `pinot_tpu/engine/pallas_scan.py`. The two Pallas TPU kernels
there become one hand-written CUDA kernel for Hopper (`csrc/masked_sums.cu`),
templated on the operand type:

* `masked_sums(mask_cols, bands, rows)` replaces `masked_sums_pallas`: the mask
  is the AND of inclusive int32 bands `(lo, hi)` over `mask_cols`, and each f32
  row in `rows` is summed under it;
* `masked_sums_fused(id_cols, id_bands, for_rows)` replaces
  `masked_sums_pallas_fused`: the same mask over dict-id columns, with each sum
  operand a frame-of-reference pair `(base, deltas)` (uint8 or uint16 deltas)
  decoded in registers as `float(delta) + base`.

Both return `(sums f32[n_sums], count int64)`. The count is exact, unlike the
Pallas kernels' f32 count. Columns may have any length `n`; the kernel handles
the ragged edge itself. `masked_sums_packed` and `masked_sums_fused_packed`
give the Pallas contract's `f32[n_sums + 1]` (sums, then the count).

On a card one call is one kernel launch and nothing else: the kernel finishes
its own cross-block reduction and writes the answer into one small buffer
(`masked_sums_answer`, `masked_sums_fused_answer`), of which `sums` and `count`
are views and which `answer_to_host` reads with one copy. The columns must
start 16-byte aligned (a view at offset 0 of an allocation is); `scan_plan`
sets the kernel's rows per pipeline stage and its grid from the shape the
library reports (`kernel_shape`).

Each wrapper runs its plain PyTorch version (`masked_sums_plain`,
`masked_sums_fused_plain`) only for tensors on the CPU. For CUDA tensors it
launches the kernel or raises. `masked_sums.launches` and
`masked_sums_fused.launches` count kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_lib

MAX_MASK_COLS = 8
MAX_SUMS = 8
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1
MIN_BLOCK_ROWS = 2048        # fewer blocks than the card holds below this per block
ALIGN = 16                   # bytes: column starts, for the bulk copies

_ENTRY = {torch.float32: "pinot_masked_sums_f32", torch.uint8: "pinot_masked_sums_u8",
          torch.uint16: "pinot_masked_sums_u16"}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)
_lock = threading.Lock()
_max_blocks: Dict[Tuple[int, int], int] = {}       # (device, itemsize) -> grid cap
_slots: Dict[Tuple[int, int], int] = {}            # (device, stream) -> ticket slot


@dataclass(frozen=True)
class KernelShape:
    """The kernel's compile-time shape, as `csrc/masked_sums.cu` reports it."""

    stages: int          # shared-memory ring depth
    ring_bytes: int      # the ring's dynamic shared memory, at most
    group_rows: int      # rows per stage and per block range are multiples of it
    ticket_slots: int    # static finishing tickets: one per stream


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared and its shape read."""
    lib = cuda_lib.load("masked_sums")
    with _lock:
        if not hasattr(lib, "pinot_shape"):
            for entry in _ENTRY.values():
                fn = getattr(lib, entry)
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
            lib.pinot_masked_sums_setup.argtypes = (ctypes.c_int,)
            lib.pinot_masked_sums_setup.restype = ctypes.c_int
            lib.pinot_masked_sums_config.argtypes = (ctypes.c_void_p,)
            lib.pinot_masked_sums_config.restype = None
            config = (ctypes.c_int32 * 4)()
            lib.pinot_masked_sums_config(config)
            lib.pinot_shape = KernelShape(*config)
    return lib


def kernel_shape() -> KernelShape:
    """The shape of the built kernel (builds it at first use)."""
    return _lib().pinot_shape


@dataclass(frozen=True)
class ScanPlan:
    """One launch's geometry: rows per ring stage and blocks."""

    rows_per_stage: int
    grid: int


def scan_plan(n: int, n_mask: int, n_sums: int, itemsize: int, max_blocks: int,
              shape: KernelShape) -> ScanPlan:
    """The launch for `n` rows of `n_mask` int32 columns and `n_sums` operands of
    `itemsize` bytes. The grid is `max_blocks` (the card's resident blocks), or
    fewer so that each block's range of whole groups holds `MIN_BLOCK_ROWS`
    rows. A stage holds as many rows as fit `shape.ring_bytes / shape.stages`,
    or fewer so that a block's range spans `shape.stages` tiles and the whole
    ring is in flight; always a multiple of `shape.group_rows`."""
    bytes_per_row = 4 * n_mask + itemsize * n_sums
    if bytes_per_row <= 0:
        raise ValueError("masked sums need at least one mask column or sum row")
    g = shape.group_rows
    groups = n // g
    grid = max(1, min(max_blocks, groups * g // MIN_BLOCK_ROWS))
    block_groups = -(-groups // grid)
    ring_groups = shape.ring_bytes // (shape.stages * bytes_per_row) // g
    rows = g * max(1, min(ring_groups, -(-block_groups // shape.stages)))
    return ScanPlan(rows, grid)


# -- plain PyTorch versions ------------------------------------------------------

def _band_mask(mask_cols: Sequence[torch.Tensor], bands, n: int,
               device) -> torch.Tensor:
    m = torch.ones(n, dtype=torch.bool, device=device)
    for col, (lo, hi) in zip(mask_cols, bands):
        m &= (col >= int(lo)) & (col <= int(hi))
    return m


def _rows_len(mask_cols, rows) -> Tuple[int, torch.device]:
    first = next(iter(list(mask_cols) + list(rows)), None)
    if first is None:
        raise ValueError("masked sums need at least one mask column or sum row")
    return int(first.shape[0]), first.device


def masked_sums_plain(mask_cols: Sequence[torch.Tensor], bands,
                      rows: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `masked_sums`: same contract, same arithmetic."""
    n, device = _rows_len(mask_cols, rows)
    m = _band_mask(mask_cols, bands, n, device)
    fm = m.to(torch.float32)
    sums = [(r.to(torch.float32) * fm).sum() for r in rows]
    out = (torch.stack(sums) if sums
           else torch.zeros(0, dtype=torch.float32, device=device))
    return out, m.sum(dtype=torch.int64)


def masked_sums_fused_plain(id_cols: Sequence[torch.Tensor], id_bands,
                            for_rows: Sequence[Tuple[float, torch.Tensor]]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `masked_sums_fused`. Deltas upcast through
    int32 first: uint16 tensors lack comparisons and shifts in PyTorch."""
    rows = [d.to(torch.int32).to(torch.float32) + float(base) for base, d in for_rows]
    return masked_sums_plain(id_cols, id_bands, rows)


# -- the kernel wrappers ------------------------------------------------------

def _check(t: torch.Tensor, dtype, n: int, device, what: str) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or int(t.shape[0]) != n:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")
    if t.data_ptr() % ALIGN:
        raise ValueError(f"{what} starts at {t.data_ptr():#x}, not {ALIGN}-byte aligned: "
                         "pass a view at offset 0 of its allocation")


def _grid_cap(lib, device: torch.device, itemsize: int) -> int:
    key = (device.index, itemsize)
    cap = _max_blocks.get(key)
    if cap is None:
        with torch.cuda.device(device):
            cap = lib.pinot_masked_sums_setup(itemsize)
        if cap <= 0:
            raise RuntimeError(f"masked_sums setup failed: CUDA error {-cap}")
        _max_blocks[key] = cap
    return cap


def _ticket_slot(lib, device: torch.device, stream: torch.cuda.Stream) -> int:
    """The static finishing-ticket slot of eager launches on `stream`. Launches on
    one stream run in order, so they share a slot. A slot stays with its stream:
    torch hands out streams from a fixed pool per device, so few are taken."""
    with _lock:
        key = (device.index, stream.cuda_stream)
        slot = _slots.get(key)
        if slot is None:
            slot = sum(1 for d, _ in _slots if d == device.index)
            if slot >= lib.pinot_shape.ticket_slots:
                raise RuntimeError(f"all {lib.pinot_shape.ticket_slots} scan ticket slots "
                                   f"of {device} are taken: one per stream")
            _slots[key] = slot
        return slot


def answer_views(answer: torch.Tensor, n_sums: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(sums f32[n_sums], count int64)` as views of an answer buffer: int64
    count, then the f32 sums."""
    return answer[1:].view(torch.float32)[:n_sums], answer[0]


def answer_to_host(answer: torch.Tensor, n_sums: int) -> Tuple[np.ndarray, int]:
    """An answer buffer's `(sums float32[n_sums], count)` on the host: one copy."""
    return read_answer(answer.cpu().numpy(), n_sums)


def read_answer(raw: np.ndarray, n_sums: int) -> Tuple[np.ndarray, int]:
    """`(sums float32[n_sums], count)` of an answer buffer already on the host
    (int64 words: the count, then the f32 sums)."""
    return raw[1:].view(np.float32)[:n_sums].copy(), int(raw[0])


def _plain_answer(sums: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """A plain version's answer in the kernel's answer layout."""
    answer = torch.zeros(1 + (sums.numel() + 1) // 2, dtype=torch.int64, device=sums.device)
    views = answer_views(answer, sums.numel())
    views[0].copy_(sums)
    views[1].copy_(count)
    return answer


def _launch(mask_cols, bands, operands: List[torch.Tensor], bases: List[float],
            dtype) -> torch.Tensor:
    n, device = _rows_len(mask_cols, operands)
    if len(mask_cols) > MAX_MASK_COLS or len(operands) > MAX_SUMS:
        raise ValueError(f"masked sums take at most {MAX_MASK_COLS} mask columns and "
                         f"{MAX_SUMS} sum rows, got {len(mask_cols)} and {len(operands)}")
    if len(bands) != len(mask_cols):
        raise ValueError(f"{len(bands)} bands for {len(mask_cols)} mask columns")
    if n > INT32_MAX:
        raise ValueError(f"{n} rows: the kernel takes at most {INT32_MAX} (one segment)")
    for c, col in enumerate(mask_cols):
        _check(col, torch.int32, n, device, f"mask column {c}")
    for j, row in enumerate(operands):
        _check(row, dtype, n, device, f"sum operand {j}")
    flat_bands = [int(v) for lo_hi in bands for v in lo_hi]
    for v in flat_bands:
        if not INT32_MIN <= v <= INT32_MAX:
            raise ValueError(f"band bound {v} outside int32")
    lib = _lib()
    k = len(operands)
    itemsize = dtype.itemsize
    plan = scan_plan(n, len(mask_cols), k, itemsize, _grid_cap(lib, device, itemsize),
                     lib.pinot_shape)
    stream = torch.cuda.current_stream(device)
    # a launch captured into a graph keeps its ticket in the buffer, which the
    # graph owns; an eager one takes its stream's static slot
    captured = torch.cuda.is_current_stream_capturing()
    slot = -1 if captured else _ticket_slot(lib, device, stream)
    # the answer (int64 count, f32 sums), the ticket word, the blocks' partials
    answer_words = 1 + (k + 1) // 2
    buf = torch.empty(answer_words + 1 + (plan.grid * (k + 1) + 1) // 2, dtype=torch.int64,
                      device=device)
    ticket = buf[answer_words].data_ptr() if captured else None
    ptrs_mask = (ctypes.c_void_p * max(len(mask_cols), 1))(
        *[c.data_ptr() for c in mask_cols])
    c_bands = (ctypes.c_int32 * max(len(flat_bands), 1))(*flat_bands)
    ptrs_sum = (ctypes.c_void_p * max(k, 1))(*[r.data_ptr() for r in operands])
    c_bases = (ctypes.c_float * max(len(bases), 1))(*bases)
    fn = getattr(lib, _ENTRY[dtype])
    with torch.cuda.device(device):
        err = fn(ptrs_mask, c_bands, len(mask_cols), ptrs_sum, c_bases, k, n,
                 plan.rows_per_stage, plan.grid, slot, ticket,
                 buf[answer_words + 1:].data_ptr(), buf.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[dtype]} launch failed: CUDA error {err}")
    return buf[:answer_words]


def masked_sums_answer(mask_cols: Sequence[torch.Tensor], bands,
                       rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """`masked_sums` as one answer buffer (int64 count, then f32 sums): on a card
    the kernel's own, on the CPU the plain version's, packed the same way."""
    n, device = _rows_len(mask_cols, rows)
    if device.type == "cpu":
        return _plain_answer(*masked_sums_plain(mask_cols, bands, rows))
    answer = _launch(list(mask_cols), list(bands), list(rows), [0.0] * len(rows),
                     torch.float32)
    _count_launch(masked_sums)
    return answer


def masked_sums_fused_answer(id_cols: Sequence[torch.Tensor], id_bands,
                             for_rows: Sequence[Tuple[float, torch.Tensor]]) -> torch.Tensor:
    """`masked_sums_fused` as one answer buffer, as `masked_sums_answer`."""
    deltas = [d for _, d in for_rows]
    n, device = _rows_len(id_cols, deltas)
    if device.type == "cpu":
        return _plain_answer(*masked_sums_fused_plain(id_cols, id_bands, for_rows))
    dtypes = {d.dtype for d in deltas}
    if len(dtypes) != 1 or next(iter(dtypes)) not in (torch.uint8, torch.uint16):
        raise ValueError(f"fused operands must all be uint8 or all uint16, got {dtypes}")
    answer = _launch(list(id_cols), list(id_bands), deltas,
                     [float(b) for b, _ in for_rows], next(iter(dtypes)))
    _count_launch(masked_sums_fused)
    return answer


def masked_sums(mask_cols: Sequence[torch.Tensor], bands,
                rows: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(sums f32[len(rows)], count int64)` of the f32 `rows` under the mask
    AND_c (mask_cols[c] in [bands[c][0], bands[c][1]]). Use INT32_MIN/INT32_MAX
    for a one-sided band."""
    n, device = _rows_len(mask_cols, rows)
    if device.type == "cpu":
        return masked_sums_plain(mask_cols, bands, rows)
    return answer_views(masked_sums_answer(mask_cols, bands, rows), len(rows))


def masked_sums_fused(id_cols: Sequence[torch.Tensor], id_bands,
                      for_rows: Sequence[Tuple[float, torch.Tensor]]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`masked_sums` over frame-of-reference operands `(base, deltas)`, decoded
    in registers as float(delta) + base. All deltas share one dtype, uint8 or
    uint16. Id padding must lie outside every band, or `n` must stop before it."""
    n, device = _rows_len(id_cols, [d for _, d in for_rows])
    if device.type == "cpu":
        return masked_sums_fused_plain(id_cols, id_bands, for_rows)
    return answer_views(masked_sums_fused_answer(id_cols, id_bands, for_rows), len(for_rows))


masked_sums.launches = 0
masked_sums_fused.launches = 0


def _count_launch(wrapper) -> None:
    """One launch more of `wrapper`'s kernel. Launches come from several
    threads at once (a serving pipeline's dispatcher beside direct callers),
    so the count is kept under the lock."""
    with _lock:
        wrapper.launches += 1


def reset_launch_counts() -> None:
    with _lock:
        masked_sums.launches = 0
        masked_sums_fused.launches = 0


def _packed(sums: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.cat([sums, count.to(torch.float32).reshape(1)])


def masked_sums_packed(mask_cols, bands, rows) -> torch.Tensor:
    """`masked_sums` in the Pallas contract: f32[len(rows) + 1], sums then count."""
    return _packed(*masked_sums(mask_cols, bands, rows))


def masked_sums_fused_packed(id_cols, id_bands, for_rows) -> torch.Tensor:
    """`masked_sums_fused` in the Pallas contract: f32[len(for_rows) + 1]."""
    return _packed(*masked_sums_fused(id_cols, id_bands, for_rows))
