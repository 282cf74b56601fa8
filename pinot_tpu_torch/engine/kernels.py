"""The aggregation body: filter mask + group key + partial aggregates.

Counterpart of the scalar and group-by branches of `_make_body` in
`pinot_tpu/engine/kernels.py`, with its count, sum, power-sum, min, max and
distinct outputs:

    mask     = filter_tree(id-interval compares | LUT lookups | value compares
                           | bitmap leaves | null bitmaps | doc sets) & valid
    key      = sum(group_ids * strides)     (dense dict-id keys, in the kernel's
                                             registers; masked rows add nothing)
    partials = grouped_agg over key          (group-by: count, sums, power sums,
                                              min, max in one call)
             | masked reductions             (scalar count, f32 sum, min, max)
             | grouped_agg with one key      (scalar power sums, one call)
    distinct = grouped_agg, count only      (scalar: over the dict ids; grouped:
                                             over key * size + ids)

`grouped_agg` (`engine/grouped.py`, `csrc/grouped_agg.cu` on a card) is the
JAX package's GROUP BY regime ladder on the H100. Its rungs map so: the
one-hot matmul (up to `matmul_cap`) and most of `_grouped_chunk64` become
the shared rung (each block keeps private cells in shared memory, one copy
per warp at a few dozen keys, then merges them once); `_grouped_chunk64`
past shared memory, the `segment_sum` escape and the sort rungs
`_grouped_sorted` / `_grouped_partitioned` become the global rung
(warp-aggregated atomics into cells in device memory); the MIN/MAX
broadcast-reduce and `segment_min`/`segment_max` are ops of the same call;
`_presence_2d` and the grouped presence are its count-only form. The rung
follows from whether a block's copy of the cells fits in shared memory, not
from calibrated TPU caps. This is the JAX package's `run_kernel_staged`
shape: the mask is its own pass (`filter_mask`: torch ops or
`bitmap_filter`), and the aggregation reads it; the fused rung (an
in-register dict decode) is not ported.

A dictionary leaf over a multi-value column (`KernelSpec.mv_cols`) reads the
column's [rows, W] id matrix and ORs its per-value mask across each row
(`any(-1)`), the JAX body's multi-value branch.

Bitmap leaves (`KernelSpec.bitmap_leaves`, chosen by
`planner.select_bitmap_leaves`) read a dictionary column's packed bitmap
index instead of its ids, through the CUDA kernel of `engine/bitmap.py`:
when every leaf of the tree is one, the kernel evaluates the whole tree in
the word domain and writes the row mask ("mask" mode); in a mixed tree each
bitmap leaf is a one-leaf program whose row mask the kernel writes ("mask"
mode again), combined with the other leaves in torch. `compute_filter_count`
counts an all-bitmap tree's rows without a row mask ("count" mode). Null
leaves read the column's null bitmap, doc-set leaves a host-resolved bool row.

Output names and dtypes are the ones the executor's decoders read: "count"
int32, "{i}.sum" float32 (float64 for an integer argument: an exact int64
sum, so that a star-tree's COUNT(*) slot, SUM($count), stays exact at any
row count) and "{i}.sum2".."{i}.sum4" float32 (masked sums of the
f32 argument's powers, accumulated in float64), "{i}.min" / "{i}.max" in the
argument's dtype, and "{i}.distinct" int32 for aggregation i. Group-by
outputs hold `num_keys_pad + 1` entries; the cells past the real keys, the
overflow cell `num_keys_pad` among them, stay 0 or the identity. A grouped
distinct is `[num_keys_pad + 1, size]` per-dict-id row counts. The scalar
distinct is `[size]`: the counts where the aggregation `wants_id_counts`
(the t-digest), 0/1 presence otherwise. `size` is
`KernelSpec.distinct_lut_sizes[i]`, the padded LUT size of the argument's
dictionary (`datablock.lut_size`), so that fill rows, whose id is the
cardinality, land inside it. Integer counts are exact at any row count, so
the JAX body's f32 guard and its scatter branch have no counterpart here.

Compare leaves and aggregate arguments are any device expression
(`expr.eval_device`): CASE values mixing int32 and float32, math, trig and
calendar functions. A boolean argument (`SUM(a > b)`) aggregates as float32
0/1, as the JAX body's does, and a constant one is broadcast to the rows.

The scalar shapes that reduce to masked sums over id bands do not come here:
the executor sends them to the CUDA scan kernels of `engine/scan.py`.

`topk` is the fused filter + top-k of a selection's `ORDER BY <column> LIMIT
k`, the counterpart of `topk_kernel`: it picks candidate rows on the device so
that only k row indices cross to the host. Among equal scores it keeps the
lower row index, as `lax.top_k` does, so that the candidates and the host's
stable sort agree on ties.

`fetch_outputs` copies a launch's outputs to the host and records the bytes
in the memory ledger's transient peak (`utils/memledger.py`), as the JAX
package's fetch does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..query.aggregates import AggFunc
from ..query.predicate import CmpLeaf, DocSetLeaf, FilterProgram, LutLeaf, NullLeaf
from ..sql.ast import Identifier
from ..utils.memledger import get_ledger
from .bitmap import BitmapLeaf, bitmap_filter, pack_valid, word_program
from .expr import eval_device
from .grouped import grouped_agg

_INT_MIN_IDENT = (1 << 31) - 1   # identity for a masked-out min over int32
_INT_MAX_IDENT = -(1 << 31)      # identity for a masked-out max over int32



@dataclass
class KernelSpec:
    """Static description of one aggregation: filter structure, group geometry,
    outputs. Literal operands are not part of it; they arrive in KernelInputs."""

    filter: FilterProgram
    group_cols: Tuple[str, ...]            # dict-encoded group-by columns
    num_keys_pad: int   # >= product of real cardinalities
    aggs: Tuple[Tuple[AggFunc, Tuple[str, ...]], ...]  # (func, device outputs)
    distinct_lut_sizes: Dict[int, int] = field(default_factory=dict)  # agg idx -> lut size
    # LutLeaf indices evaluated over the bitmap index (KernelInputs.bitmaps)
    bitmap_leaves: Tuple[int, ...] = ()
    # LUT-leaf columns that are multi-value: their ids are [rows, W] matrices
    # and a leaf's per-value mask reduces with any(-1). Named, not read from
    # the shape: nothing else on the device is 2-D per row.
    mv_cols: Tuple[str, ...] = ()

    # per-leaf input routing, computed in __post_init__
    lut_index: Dict[int, int] = field(default_factory=dict)        # scattered LUTs
    lut_interval: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # (ioff, n)
    cmp_offset: Dict[int, Tuple[str, int]] = field(default_factory=dict)
    bitmap_index: Dict[int, int] = field(default_factory=dict)     # -> KernelInputs.bitmaps
    docset_index: Dict[int, int] = field(default_factory=dict)     # -> KernelInputs.docsets

    def __post_init__(self):
        luts = ioff = foff = 0
        for i, leaf in enumerate(self.filter.leaves):
            if i in self.bitmap_leaves:
                self.bitmap_index[i] = len(self.bitmap_index)
            elif isinstance(leaf, DocSetLeaf):
                self.docset_index[i] = len(self.docset_index)
            elif isinstance(leaf, LutLeaf):
                if leaf.intervals is not None:
                    # interval bounds ride the int scalar list: [lo0, hi0, lo1, hi1, ...]
                    self.lut_interval[i] = (ioff, len(leaf.intervals))
                    ioff += 2 * len(leaf.intervals)
                else:
                    self.lut_index[i] = luts
                    luts += 1
            elif isinstance(leaf, CmpLeaf):
                if leaf.is_int:
                    self.cmp_offset[i] = ("iscal", ioff)
                    ioff += len(leaf.operands)
                else:
                    self.cmp_offset[i] = ("fscal", foff)
                    foff += len(leaf.operands)

    def signature(self) -> Tuple:
        """What decides the work the body does, without the runtime scalars:
        two specs with one signature differ only in literals."""
        return (self.filter.signature(), self.group_cols, self.num_keys_pad,
                tuple((a.name, repr(a.arg), outs) for a, outs in self.aggs),
                tuple(sorted(self.distinct_lut_sizes.items())), self.bitmap_leaves,
                self.mv_cols)

    def word_program(self) -> Optional[List[int]]:
        """The whole filter tree as a bitmap program (`bitmap.word_program`)
        when every leaf it reads is a bitmap leaf; None otherwise."""
        if self.filter.tree[0] == "const" or not self.bitmap_index:
            return None
        return word_program(self.filter.tree, self.bitmap_index)


@dataclass
class KernelInputs:
    """Runtime inputs for one segment execution (device tensors + scalars)."""

    ids: Dict[str, torch.Tensor]     # padded int32 dict ids
    vals: Dict[str, torch.Tensor]    # decoded value columns
    luts: Tuple[torch.Tensor, ...]   # bool LUT per scattered LutLeaf, leaf order
    iscal: List[int]                 # interval bounds + int compare operands
    fscal: List[float]               # float compare operands
    valid: torch.Tensor              # bool[padded]
    strides: List[int]               # dense-key strides (empty for scalar aggregation)
    nulls: Dict[str, torch.Tensor] = field(default_factory=dict)   # bool[padded] per column
    docsets: Tuple[torch.Tensor, ...] = ()   # bool[padded] per DocSetLeaf, leaf order
    bitmaps: Tuple[BitmapLeaf, ...] = ()     # per bitmap leaf, leaf order
    # `valid` packed (bitmap.pack_valid); None: packed from `valid` when needed
    valid_words: Optional[torch.Tensor] = None

    def packed_valid(self) -> torch.Tensor:
        return self.valid_words if self.valid_words is not None else pack_valid(self.valid)


def _compare(v, op: str, sc: Sequence, off: int, n_operands: int):
    if op == "eq":
        return v == sc[off]
    if op == "gte":
        return v >= sc[off]
    if op == "lte":
        return v <= sc[off]
    if op == "gt":
        return v > sc[off]
    if op == "lt":
        return v < sc[off]
    if op == "between":
        return (v >= sc[off]) & (v <= sc[off + 1])
    if op == "in":
        m = v == sc[off]
        for j in range(1, n_operands):
            m = m | (v == sc[off + j])
        return m
    raise AssertionError(f"bad cmp op {op}")


def filter_mask(spec: KernelSpec, inputs: KernelInputs) -> torch.Tensor:
    """bool[padded]: the filter tree evaluated over the block, ANDed with valid."""
    leaves = spec.filter.leaves

    def leaf_mask(i: int) -> torch.Tensor:
        leaf = leaves[i]
        if i in spec.bitmap_index:
            # a mixed tree: this leaf alone, its rows written by the kernel
            return bitmap_filter([0], [inputs.bitmaps[spec.bitmap_index[i]]],
                                 inputs.packed_valid(), "mask")
        if isinstance(leaf, NullLeaf):
            m = inputs.nulls[leaf.col]
            return ~m if leaf.negated else m
        if isinstance(leaf, DocSetLeaf):
            return inputs.docsets[spec.docset_index[i]]
        if isinstance(leaf, LutLeaf):
            col_ids = inputs.ids[leaf.col]
            if i in spec.lut_interval:
                off, n = spec.lut_interval[i]
                m = torch.zeros_like(col_ids, dtype=torch.bool)
                for j in range(n):
                    lo, hi = inputs.iscal[off + 2 * j], inputs.iscal[off + 2 * j + 1]
                    m |= (col_ids >= lo) & (col_ids <= hi)
            else:
                m = inputs.luts[spec.lut_index[i]][col_ids]
            # a multi-value row matches if any of its values does; its fill
            # id, the cardinality, lies past every interval and is False in
            # every LUT, so that it never matches
            return m.any(-1) if leaf.col in spec.mv_cols else m
        assert isinstance(leaf, CmpLeaf)
        v = eval_device(leaf.expr, inputs.vals)
        arr_name, off = spec.cmp_offset[i]
        sc = inputs.iscal if arr_name == "iscal" else inputs.fscal
        m = _compare(v, leaf.op, sc, off, len(leaf.operands))
        return m.expand_as(inputs.valid) if isinstance(m, torch.Tensor) \
            else torch.full_like(inputs.valid, bool(m))

    if spec.filter.is_match_all:
        return inputs.valid
    program = spec.word_program()
    if program is not None:
        # every leaf is a bitmap leaf: the whole tree in the word domain
        return bitmap_filter(program, inputs.bitmaps, inputs.packed_valid(), "mask")
    return _tree_mask(spec.filter.tree, leaf_mask, inputs.valid) & inputs.valid


def _tree_mask(node, leaf_mask, valid: torch.Tensor) -> torch.Tensor:
    """A filter tree's mask from its leaves' masks. A module function, not a
    closure: a recursive closure is a reference cycle that would keep the
    block's tensors alive past their release until the next garbage
    collection."""
    kind = node[0]
    if kind == "const":
        return valid if node[1] else torch.zeros_like(valid)
    if kind == "leaf":
        return leaf_mask(node[1])
    if kind == "not":
        return ~_tree_mask(node[1], leaf_mask, valid)
    masks = [_tree_mask(c, leaf_mask, valid) for c in node[1]]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if kind == "and" else (out | m)
    return out


def compute_filter_count(spec: KernelSpec, inputs: KernelInputs) -> Optional[int]:
    """The rows an all-bitmap filter keeps, counted in the word domain (the
    kernel's "count" mode: no row mask is written), or None when the tree
    reads a leaf that is not a bitmap leaf. The JAX package's popcount path;
    as there, the served COUNT route does not call it."""
    program = spec.word_program()
    if program is None:
        return None
    return int(bitmap_filter(program, inputs.bitmaps, inputs.packed_valid(), "count"))


def _agg_rows(agg: AggFunc, vals, n: int, device):
    """The aggregation argument as a length-n tensor (None for COUNT(*)); a
    boolean one as float32 0/1."""
    if agg.arg is None or (isinstance(agg.arg, Identifier) and agg.arg.name == "*"):
        return None
    return as_rows(eval_device(agg.arg, vals), n, device)


def as_rows(v, n: int, device) -> torch.Tensor:
    """A device expression's value as n rows: a constant broadcast, a boolean
    as float32 0/1."""
    if not isinstance(v, torch.Tensor):
        v = torch.full((n,), v, device=device)
    elif v.dim() == 0:
        v = v.to(device).expand(n)
    return v.to(torch.float32) if v.dtype == torch.bool else v


def _kernel_rows(v: torch.Tensor) -> torch.Tensor:
    """An argument's rows as `grouped_agg` takes them: contiguous, in one of
    f32, f64, int32 or int64 (narrower integers widen to int32, half floats
    to f32)."""
    if v.dtype not in (torch.float32, torch.float64, torch.int32, torch.int64):
        v = v.to(torch.float32 if v.dtype.is_floating_point else torch.int32)
    return v.contiguous()


def _group_op(o: str, v: torch.Tensor) -> Optional[str]:
    """`grouped_agg`'s op for device output `o` of an argument `v` (None for
    the count, which every call gives)."""
    if o == "sum":
        return "sum" if v.dtype.is_floating_point else "isum"
    return o if o in ("sum2", "sum3", "sum4", "min", "max") else None


def distinct_counts(mask: torch.Tensor, ids: torch.Tensor, size: int,
                    group_ids: Sequence[torch.Tensor] = (), strides: Sequence[int] = (),
                    num_seg: int = 1) -> torch.Tensor:
    """int32 row counts per dict id of the rows `mask` keeps: `[size]`, or
    with group columns (`group_ids`, `strides`: the dense key) `[num_seg,
    size]` over the combined space `key * size + ids`: one count-only
    `grouped_agg` call, whose key is computed in the kernel's registers.
    Dropped rows add nothing, so that the filtered-out rows, most rows under
    a selective filter, meet in no bin; nothing waits for the card."""
    cells = grouped_agg(list(group_ids) + [ids.contiguous()],
                        [int(s) * size for s in strides] + [1], mask.contiguous(), [], [],
                        num_seg * size)[0]
    return cells.view(num_seg, size) if group_ids else cells


def run_kernel(spec: KernelSpec, inputs: KernelInputs) -> Dict[str, torch.Tensor]:
    """Filter + aggregate one segment (or a flattened stacked set); returns
    the named device outputs. This is the JAX package's `run_kernel_staged`
    shape: the mask is its own pass (`filter_mask`), which `grouped_agg`
    then reads."""
    mask = filter_mask(spec, inputs).contiguous()
    n, device = mask.shape[0], mask.device
    out: Dict[str, torch.Tensor] = {}
    if spec.group_cols:
        num_seg = spec.num_keys_pad + 1
        group_ids = [inputs.ids[gc].contiguous() for gc in spec.group_cols]
        strides = [int(s) for s in inputs.strides]
        names, vals, ops = [], [], []
        for ai, (agg, outs) in enumerate(spec.aggs):
            if "distinct" in outs:
                out[f"{ai}.distinct"] = distinct_counts(
                    mask, inputs.ids[agg.arg.name], spec.distinct_lut_sizes[ai],
                    group_ids, strides, num_seg)
                continue
            v = _agg_rows(agg, inputs.vals, n, device)
            for o in outs:
                op = None if v is None else _group_op(o, v)
                if op is not None:
                    names.append(f"{ai}.{o}")
                    vals.append(_kernel_rows(v))
                    ops.append(op)
        # one call for the count and every sum, power sum, min and max
        res = grouped_agg(group_ids, strides, mask, vals, ops, num_seg)
        out["count"] = res[0]
        for name, op, r in zip(names, ops, res[1:]):
            out[name] = r.to(torch.float64) if op == "isum" else r
    else:
        fmask = mask.to(torch.float32)
        out["count"] = mask.sum(dtype=torch.int32)
        names, vals, ops = [], [], []
        for ai, (agg, outs) in enumerate(spec.aggs):
            if "distinct" in outs:
                counts = distinct_counts(mask, inputs.ids[agg.arg.name],
                                         spec.distinct_lut_sizes[ai])
                out[f"{ai}.distinct"] = counts if agg.wants_id_counts \
                    else (counts > 0).to(torch.int32)
                continue
            if outs == ("count",):
                continue
            v = _agg_rows(agg, inputs.vals, n, device)
            for o in outs:
                if o == "sum" and not v.dtype.is_floating_point:
                    out[f"{ai}.sum"] = torch.where(mask, v, 0).sum(dtype=torch.int64).to(
                        torch.float64)
                elif o == "sum":
                    out[f"{ai}.sum"] = (v.to(torch.float32) * fmask).sum()
                elif o in ("sum2", "sum3", "sum4"):
                    names.append(f"{ai}.{o}")
                    vals.append(_kernel_rows(v))
                    ops.append(o)
                elif o == "min":
                    ident = float("inf") if v.dtype.is_floating_point else _INT_MIN_IDENT
                    out[f"{ai}.min"] = torch.where(mask, v, ident).min()
                elif o == "max":
                    ident = float("-inf") if v.dtype.is_floating_point else _INT_MAX_IDENT
                    out[f"{ai}.max"] = torch.where(mask, v, ident).max()
        if ops:
            # every power sum of the plan in one call, all rows on one key
            res = grouped_agg([], [], mask, vals, ops, 1)
            for name, r in zip(names, res[1:]):
                out[name] = r[0]
    return out


def fetch_outputs(outs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A launch's named outputs on the host. The bytes fetched feed the memory
    ledger's transient peak (the JAX package's `fetch_outputs`)."""
    host = {k: v.cpu().numpy() for k, v in outs.items()}
    get_ledger().note_transient(sum(a.nbytes for a in host.values()))
    return host


_topk_lock = threading.Lock()
_topk_launches = 0
_LOW_WORD = (1 << 32) - 1


def _tie_broken_key(score: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the f32 scores' order, ties going to the lower
    row index: the score's order-preserving bits in the high word, the
    inverted row index in the low word. Every key is distinct, so `torch.topk`
    has no tie left to order."""
    bits = (score + 0.0).view(torch.int32)   # + 0.0 turns -0.0 into +0.0
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    rows = torch.arange(score.numel(), device=score.device, dtype=torch.int64)
    return ordered * (1 << 32) + (_LOW_WORD - rows)


def topk(spec: KernelSpec, inputs: KernelInputs, order_expr, desc: bool,
         k: int) -> Dict[str, torch.Tensor]:
    """The filter mask and the top k rows by `order_expr`, on the device.

    Returns {"idx": int64[k'] row indices, best first; "count": int32 matching
    rows; "ok": bool[k'] candidate usable (it matches and its key is not NaN);
    "nanMatches": int32 matching rows whose key is NaN}, where k' = min(k,
    rows). The score is `where(mask & ~isnan(v), v or -v, -inf)` in f32, so
    only the candidate set is decided in f32: the caller re-sorts candidates
    exactly on the host. `topk_launches()` counts calls."""
    global _topk_launches
    mask = filter_mask(spec, inputs).reshape(-1)
    v = eval_device(order_expr, inputs.vals).reshape(-1).to(torch.float32)
    nan = torch.isnan(v)
    usable = mask & ~nan
    score = torch.where(usable, v if desc else -v, float("-inf"))
    _, idx = torch.topk(_tie_broken_key(score), min(k, score.numel()))
    with _topk_lock:
        _topk_launches += 1
    return {"idx": idx, "count": mask.sum(dtype=torch.int32), "ok": usable[idx],
            "nanMatches": (mask & nan).sum(dtype=torch.int32)}


def topk_launches() -> int:
    """Calls of `topk` since the last `reset_topk_launches`, on every thread."""
    with _topk_lock:
        return _topk_launches


def reset_topk_launches() -> None:
    global _topk_launches
    with _topk_lock:
        _topk_launches = 0


def compute_topk(spec: KernelSpec, inputs: KernelInputs, order_expr, desc: bool,
                 k: int) -> Tuple[np.ndarray, int, np.ndarray, int]:
    """`topk` read back with one copy: (row indices, match count, usable flag
    per index, NaN matches)."""
    outs = topk(spec, inputs, order_expr, desc, k)
    n = outs["idx"].numel()
    host = torch.cat([outs["idx"], outs["ok"].to(torch.int64),
                      torch.stack([outs["count"], outs["nanMatches"]]).to(torch.int64)]
                     ).cpu().numpy()
    return host[:n], int(host[2 * n]), host[n:2 * n].astype(bool), int(host[2 * n + 1])
