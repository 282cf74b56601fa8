"""The word-domain bitmap filter: a filter tree over packed row bitmaps.

Counterpart of the JAX package's word-domain filter
(`pinot_tpu/engine/kernels.py`: `_bitmap_leaf_words`, `_make_word_fn`,
`_unpack_words`, `_pack_valid` and the popcount of `compute_filter_count`),
which XLA compiled from jnp ops. Here it is one hand-written CUDA kernel for
Hopper (`csrc/bitmap_filter.cu`: tiles of 256 words with all of a tile's
rows in flight at once, as 16-byte loads into registers at segment size or
bulk copies through a shared-memory ring over a stacked set; the tree's
stack in shared memory; one launch per call in every mode):

    leaf_l = OR over the leaf's selected dict ids r of words_l[s, r, :]
    result = program(leaf_0, leaf_1, ...) & valid_words

over packed words (32 rows a word, row r at word r >> 5, bit r & 31; int32
tensors holding uint32 bit patterns). `words_l` is a dictionary column's
bitmap index (`SegmentBlock.bitmap_words`, `[card, W]`, or the set block's
`[S, card, W]`); the program is the filter tree in postfix (`word_program`):
a code >= 0 is a leaf, then `AND`, `OR`, `NOT`. Three modes: "words" (the
result words, int32[S * W]), "mask" (the rows they pack, bool[32 * S * W]),
"count" (the set bits, an int64 scalar tensor).

`bitmap_filter` runs its plain PyTorch version (`bitmap_filter_plain`: a
loop of `|` over gathered rows, shifts to unpack, a sum of the bits) only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises.
`bitmap_filter.launches` counts kernel launches, and nothing else. torch has
no popcount and no bitwise-OR reduction, so the plain version pays one op per
selected row and an unpack to count.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import cuda_lib

AND, OR, NOT = -1, -2, -3
MODES = {"words": 0, "mask": 1, "count": 2}
# the kernel's limits (csrc/bitmap_filter.cu), checked before a launch
MAX_LEAVES = 16
MAX_ROWS = 1024
MAX_PROGRAM = 64
MAX_STACK = 16

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_lock = threading.Lock()
_devices: Dict[int, Tuple[int, int]] = {}          # device -> (SMs, shared bytes per SM)
_slots: Dict[Tuple[int, int], int] = {}            # (device, stream) -> ticket slot
_captured: Dict[int, int] = {}                     # device -> captured launches' tickets taken


@dataclass(frozen=True)
class BitmapLeaf:
    """One leaf's input: its column's word matrix (int32 `[card, W]` or
    `[S, card, W]`) and the dict ids the leaf selects (rows of the matrix)."""

    words: torch.Tensor
    rows: Tuple[int, ...]


def word_program(tree, slot) -> Optional[List[int]]:
    """The filter tree (`predicate.FilterTree`) in postfix for the kernel:
    `slot[leaf index]` is the leaf's position in the kernel's leaf list; an
    n-ary AND or OR becomes n - 1 binary codes. None when the tree has a
    constant or a leaf without a slot, or passes the kernel's limits."""
    out: List[int] = []

    def emit(node) -> bool:
        kind = node[0]
        if kind == "leaf":
            if node[1] not in slot:
                return False
            out.append(slot[node[1]])
            return True
        if kind == "not":
            if not emit(node[1]):
                return False
            out.append(NOT)
            return True
        if kind in ("and", "or"):
            for j, child in enumerate(node[1]):
                if not emit(child):
                    return False
                if j:
                    out.append(AND if kind == "and" else OR)
            return True
        return False

    if not emit(tree) or len(out) > MAX_PROGRAM or _depth(out) > MAX_STACK:
        return None
    return out


def _depth(program: Sequence[int]) -> int:
    depth = peak = 0
    for op in program:
        depth += 1 if op >= 0 else (0 if op == NOT else -1)
        peak = max(peak, depth)
    return peak


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """int32[W] packed words -> bool[32 * W] rows (shifts, no gather)."""
    return ((words.reshape(-1, 1) >> _shifts(words.device)) & 1).reshape(-1).bool()


def pack_valid(valid: torch.Tensor) -> torch.Tensor:
    """bool[P] rows -> int32[P // 32] packed words (P a multiple of 32)."""
    v = (valid.reshape(-1, 32).to(torch.int64) << _shifts(valid.device).to(torch.int64)).sum(1)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _geometry(leaves: Sequence[BitmapLeaf], valid_words: torch.Tensor) -> Tuple[int, int]:
    """(S, W) shared by every leaf's word matrix and the valid words."""
    shapes = set()
    for leaf in leaves:
        w = leaf.words
        if w.dim() not in (2, 3) or w.dtype != torch.int32:
            raise ValueError(f"bitmap words are int32 [card, W] or [S, card, W], "
                             f"got {w.dtype} {tuple(w.shape)}")
        shapes.add((1 if w.dim() == 2 else int(w.shape[0]), int(w.shape[-1])))
    if len(shapes) != 1:
        raise ValueError(f"bitmap leaves disagree on (segments, words): {sorted(shapes)}")
    s, w = shapes.pop()
    if valid_words.dtype != torch.int32 or valid_words.shape != (s * w,):
        raise ValueError(f"valid words are int32 [{s * w}], got {valid_words.dtype} "
                         f"{tuple(valid_words.shape)}")
    return s, w


def bitmap_filter_plain(program: Sequence[int], leaves: Sequence[BitmapLeaf],
                        valid_words: torch.Tensor, mode: str) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device)."""
    s, w = _geometry(leaves, valid_words)

    def fold(leaf: BitmapLeaf) -> torch.Tensor:
        m = leaf.words.reshape(s, -1, w)
        acc = torch.zeros((s, w), dtype=torch.int32, device=valid_words.device)
        for r in leaf.rows:
            acc = acc | m[:, r]
        return acc.reshape(-1)

    stack: List[torch.Tensor] = []
    for op in program:
        if op >= 0:
            stack.append(fold(leaves[op]))
        elif op == NOT:
            stack[-1] = ~stack[-1]
        else:
            b = stack.pop()
            stack[-1] = (stack[-1] & b) if op == AND else (stack[-1] | b)
    words = stack[0] & valid_words
    if mode == "words":
        return words
    bits = unpack_words(words)
    return bits if mode == "mask" else bits.sum(dtype=torch.int64)


@dataclass(frozen=True)
class KernelShape:
    """Count mode's static tickets, as `csrc/bitmap_filter.cu` reports them:
    slots [0, stream_slots) one per stream, [stream_slots, ticket_slots) one
    per launch captured into a CUDA graph."""

    stream_slots: int
    ticket_slots: int


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load("bitmap_filter")
    with _lock:
        if not getattr(lib, "pinot_checked", False):
            lib.pinot_bitmap_filter.argtypes = _ARGTYPES
            lib.pinot_bitmap_filter.restype = ctypes.c_int
            for fn in (lib.pinot_bitmap_filter_limits, lib.pinot_bitmap_filter_config):
                fn.argtypes = (ctypes.c_void_p,)
                fn.restype = None
            lib.pinot_bitmap_filter_setup.argtypes = (ctypes.c_void_p,)
            lib.pinot_bitmap_filter_setup.restype = ctypes.c_int
            limits = (ctypes.c_int32 * 4)()
            lib.pinot_bitmap_filter_limits(limits)
            if tuple(limits) != (MAX_LEAVES, MAX_ROWS, MAX_PROGRAM, MAX_STACK):
                raise RuntimeError(f"bitmap_filter.cu limits {tuple(limits)} differ from "
                                   "engine/bitmap.py's")
            config = (ctypes.c_int32 * 2)()
            lib.pinot_bitmap_filter_config(config)
            lib.pinot_shape = KernelShape(*config)
            lib.pinot_checked = True
    return lib


def _device_caps(lib, device: torch.device) -> Tuple[int, int]:
    """(SMs, shared memory bytes per SM) of `device`, read once: the launch
    sizes its persistent grid from them."""
    caps = _devices.get(device.index)
    if caps is None:
        out = (ctypes.c_int32 * 2)()
        with torch.cuda.device(device):
            err = lib.pinot_bitmap_filter_setup(out)
        if err != 0:
            raise RuntimeError(f"pinot_bitmap_filter_setup failed: CUDA error {err}")
        caps = _devices[device.index] = (int(out[0]), int(out[1]))
    return caps


def _ticket_slot(lib, device: torch.device, stream: torch.cuda.Stream) -> int:
    """The static count-mode ticket of a launch on `stream`. Eager launches on
    one stream run in order, so they share a slot, which stays with its
    stream (torch hands out streams from a fixed pool per device). A launch
    captured into a graph takes a slot no other launch takes: the graph's
    replays run in order, and two graphs may replay at once."""
    shape = lib.pinot_shape
    with _lock:
        if torch.cuda.is_current_stream_capturing():
            slot = shape.stream_slots + _captured.get(device.index, 0)
            if slot >= shape.ticket_slots:
                raise RuntimeError(f"all {shape.ticket_slots - shape.stream_slots} bitmap "
                                   f"tickets of captured launches on {device} are taken")
            _captured[device.index] = slot - shape.stream_slots + 1
            return slot
        key = (device.index, stream.cuda_stream)
        slot = _slots.get(key)
        if slot is None:
            slot = sum(1 for d, _ in _slots if d == device.index)
            if slot >= shape.stream_slots:
                raise RuntimeError(f"all {shape.stream_slots} bitmap ticket slots of {device} "
                                   "are taken: one per stream")
            _slots[key] = slot
        return slot


def _launch(program: Sequence[int], leaves: Sequence[BitmapLeaf],
            valid_words: torch.Tensor, mode: str) -> torch.Tensor:
    s, w = _geometry(leaves, valid_words)
    device = valid_words.device
    n_words = s * w
    if 32 * n_words > (1 << 31) - 1:
        raise ValueError(f"{n_words} words: the kernel takes at most 2^31 rows")
    rows = [int(r) for leaf in leaves for r in leaf.rows]
    if len(leaves) > MAX_LEAVES or len(rows) > MAX_ROWS or len(program) > MAX_PROGRAM \
            or _depth(program) > MAX_STACK:
        raise ValueError(f"a bitmap filter of {len(leaves)} leaves, {len(rows)} rows and "
                         f"{len(program)} codes passes the kernel's limits")
    for leaf in leaves:
        card = int(leaf.words.shape[-2])
        if leaf.words.device != device or not leaf.words.is_contiguous():
            raise ValueError("bitmap words must be contiguous tensors on the valid "
                             f"words' device {device}")
        if any(not 0 <= r < min(card, 256) for r in leaf.rows):
            raise ValueError(f"selected rows {leaf.rows} outside the {card} word rows")
    if not valid_words.is_contiguous():
        raise ValueError("valid words must be contiguous")
    lib = _lib()
    sms, smem_per_sm = _device_caps(lib, device)
    stream = torch.cuda.current_stream(device)
    slot = -1
    if mode == "words":
        out = torch.empty(n_words, dtype=torch.int32, device=device)
    elif mode == "mask":
        out = torch.empty(32 * n_words, dtype=torch.bool, device=device)
    else:
        out = torch.empty((), dtype=torch.int64, device=device)   # the kernel writes it
        slot = _ticket_slot(lib, device, stream)
    ptrs = [leaf.words.data_ptr() for leaf in leaves] + [valid_words.data_ptr(),
                                                          out.data_ptr()]
    # 16-byte copies and loads where every row starts 16-byte aligned
    vec = int(w % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    offsets = [0]
    for leaf in leaves:
        offsets.append(offsets[-1] + len(leaf.rows))
    c_words = (ctypes.c_void_p * len(leaves))(*ptrs[:len(leaves)])
    c_strides = (ctypes.c_ulonglong * len(leaves))(
        *[int(leaf.words.shape[-2]) * w for leaf in leaves])
    c_off = (ctypes.c_int * len(offsets))(*offsets)
    c_rows = (ctypes.c_int * max(len(rows), 1))(*rows)
    c_prog = (ctypes.c_int * len(program))(*[int(op) for op in program])
    with torch.cuda.device(device):
        err = lib.pinot_bitmap_filter(c_words, c_strides, len(leaves), c_off, c_rows,
                                      c_prog, len(program), valid_words.data_ptr(), w,
                                      n_words, vec, MODES[mode], sms, smem_per_sm, slot,
                                      out.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"pinot_bitmap_filter launch failed: CUDA error {err}")
    return out


def bitmap_filter(program: Sequence[int], leaves: Sequence[BitmapLeaf],
                  valid_words: torch.Tensor, mode: str) -> torch.Tensor:
    """The filter `program` over `leaves`, ANDed with `valid_words`, in `mode`
    ("words", "mask" or "count"): the kernel on a card, the plain version on
    the CPU."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(MODES)}")
    if valid_words.device.type == "cpu":
        return bitmap_filter_plain(program, leaves, valid_words, mode)
    out = _launch(program, leaves, valid_words, mode)
    with _lock:
        bitmap_filter.launches += 1
    return out


bitmap_filter.launches = 0


def reset_launch_counts() -> None:
    with _lock:
        bitmap_filter.launches = 0
