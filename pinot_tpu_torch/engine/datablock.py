"""Device-resident segment blocks: padded device columns + valid mask.

Counterpart of `pinot_tpu/engine/datablock.py` (the analog of the reference's
`DataFetcher`): columns move to the device once per segment, are cached, and
every query against the segment reuses them.

Padding contract (the same as the JAX package's):
* rows pad to a power of two, at least `format.ROW_TILE`;
* dict-encoded columns pad with id = cardinality ("invalid id"), and every
  decode table is sized `lut_size(cardinality) = pow2(cardinality + 1)`, so the
  invalid id lands on a defined slot (value 0);
* raw columns pad with 0; the block's `valid` mask excludes padding rows;
* 64-bit columns narrow to 32 bits (int64 -> int32, float64 -> float32): device
  arithmetic is 32-bit, and the planner keeps columns outside int32 off the device.

Packed words (`valid_words`, `bitmap_words`) hold 32 rows each, row r in word
r >> 5 at bit r & 31, as uint32 bit patterns in int32 tensors (torch has no
bitwise ops on uint32); the bitmap filter kernel reads them as uint32.

Every tensor a block stages registers with the memory ledger
(`utils/memledger.staged`) under the segment's name and the JAX package's
kinds: `valid`, `valid_words`, `ids`, `raw`, `dict`, `bitmap`, `null`, and
`for` for a frame-of-reference form; a consuming view's block registers all of
its tensors as `consuming`. `predicted_block_bytes` prices this layout from
metadata before anything stages (the tiering gate's price), `has_block` says
whether a segment is resident (its own block, or a member's rows in a stacked
set block) and `release_block` drops both and their ledger entries.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..segment.format import ROW_TILE
from ..segment.reader import ColumnReader, ImmutableSegment
from ..utils.memledger import get_ledger, staged


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _narrow(arr: np.ndarray) -> np.ndarray:
    """Narrow 64-bit arrays for the device (int64 -> int32, float64 -> float32)."""
    if arr.dtype == np.int64:
        return arr.astype(np.int32)
    if arr.dtype == np.float64:
        return arr.astype(np.float32)
    return arr


def padded_rows(num_docs: int) -> int:
    return max(ROW_TILE, _pow2(num_docs))


def lut_size(cardinality: int) -> int:
    return _pow2(cardinality + 1)


# Bitmap filter indexes exist only for single-value dictionary columns up to
# this cardinality (the JAX package's bound): the words take card * padded / 8
# bytes, and past a few dozen values the id compare reads fewer bytes.
BITMAP_MAX_CARD = 64


def pack_words(mask: np.ndarray, padded: int) -> np.ndarray:
    """bool rows -> int32[padded // 32] packed words (row r at word r >> 5,
    bit r & 31); rows past `len(mask)` are 0."""
    bits = np.zeros(padded, dtype=bool)
    bits[:len(mask)] = mask
    return np.packbits(bits, bitorder="little").view("<i4")


def id_bitmap_words(ids: np.ndarray, cardinality: int, padded: int) -> np.ndarray:
    """int32[cardinality, padded // 32]: row c holds the packed membership of
    dict id c. Ids outside [0, cardinality) (a star-tree record's star id)
    set no bit."""
    ids = np.asarray(ids)
    return np.stack([pack_words(ids == c, padded) for c in range(cardinality)])


def mv_id_matrix(flat: np.ndarray, offsets: np.ndarray, fill: int, rows: int,
                 width: int) -> np.ndarray:
    """int32[rows, width]: the CSR ids (`flat` split at `offsets`) one row each,
    left-justified, every other cell `fill`."""
    counts = np.diff(offsets)
    mat = np.full((rows, width), fill, dtype=np.int32)
    row = np.repeat(np.arange(len(counts)), counts)
    mat[row, np.arange(len(row)) - np.repeat(offsets[:-1] - offsets[0], counts)] = \
        flat[offsets[0]:offsets[0] + len(row)]
    return mat


def for_delta_dtype(reader: ColumnReader) -> Optional[np.dtype]:
    """The delta dtype (uint8 or uint16) of a raw integer column's
    frame-of-reference form, decided from metadata alone; None when the column
    has no such form (dict-encoded, multi-value, non-integer, unknown bounds,
    a range of 2^16 or more, or a base outside int32)."""
    if reader.has_dictionary or reader.is_multi_value:
        return None
    mn, mx = reader.min_value, reader.max_value
    if not isinstance(mn, (int, np.integer)) or not isinstance(mx, (int, np.integer)):
        return None
    if np.dtype(reader.meta["fwdDtype"]).kind != "i":
        return None
    rng = int(mx) - int(mn)
    if not 0 <= rng < (1 << 16) or not -(2 ** 31) <= int(mn) < 2 ** 31:
        return None
    return np.dtype(np.uint8 if rng < (1 << 8) else np.uint16)


class SegmentBlock:
    """Lazy per-column device cache for one immutable segment on one device."""

    def __init__(self, segment: ImmutableSegment, device: torch.device,
                 ledger_kind: Optional[str] = None):
        self.segment = segment
        self.device = device
        # the kind every staged tensor registers under instead of its own
        # (a consuming view's block: "consuming")
        self.ledger_kind = ledger_kind
        self.num_docs = segment.num_docs
        self.padded = padded_rows(self.num_docs)
        self._ids: Dict[str, torch.Tensor] = {}
        self._raw: Dict[str, torch.Tensor] = {}
        self._dict_vals: Dict[str, torch.Tensor] = {}
        self._for: Dict[str, Optional[Tuple[int, torch.Tensor]]] = {}
        self._valid: Optional[torch.Tensor] = None
        self._valid_words: Optional[torch.Tensor] = None
        self._null: Dict[str, torch.Tensor] = {}
        self._bitmaps: Dict[str, Optional[torch.Tensor]] = {}
        self._valid_band: Tuple[Optional[tuple], Optional[torch.Tensor]] = (None, None)

    def _put(self, arr: np.ndarray, kind: str, name: str = "") -> torch.Tensor:
        return self._register(torch.from_numpy(arr).to(self.device), kind, name)

    def _register(self, tensor: torch.Tensor, kind: str, name: str = "") -> torch.Tensor:
        label = f"{kind}:{name}" if name else kind
        if self.ledger_kind is not None:
            kind = self.ledger_kind
        return staged(tensor, self.segment.name, kind, name=label,
                      table=ledger_table(self.segment))

    @property
    def valid(self) -> torch.Tensor:
        """bool[padded]: True for the segment's real rows."""
        if self._valid is None:
            v = np.zeros(self.padded, dtype=bool)
            v[:self.num_docs] = True
            self._valid = self._put(v, "valid")
        return self._valid

    def valid_band(self, mask: np.ndarray) -> torch.Tensor:
        """An upsert valid-doc mask (`upsert.ValidDocs`) as the scan's band
        row: int32[num_docs], 1 at the live rows, which the band (1, 1)
        keeps. Staged once per mask key (the manager, the segment and its
        version) and reused until the key changes."""
        key, band = self._valid_band
        if band is not None and key == mask.key:
            return band
        rows = np.zeros(self.num_docs, dtype=np.int32)
        m = min(len(mask), self.num_docs)
        rows[:m] = np.asarray(mask)[:m]
        band = self._put(rows, "valid", "band")
        self._valid_band = (mask.key, band)    # one store publishes the pair
        return band

    @property
    def valid_words(self) -> torch.Tensor:
        """`valid` packed: int32[padded // 32], in the layout of `bitmap_words`.
        The bitmap filter ANDs it onto every result, so that a NOT, which sets
        the padding rows' bits, never counts them."""
        if self._valid_words is None:
            self._valid_words = self._put(pack_words(np.ones(self.num_docs, dtype=bool),
                                                     self.padded), "valid_words")
        return self._valid_words

    def bitmap_words(self, col: str) -> Optional[torch.Tensor]:
        """The column's bitmap filter index, int32[cardinality, padded // 32]
        (`id_bitmap_words`), built on the host from the forward ids once and
        kept on the device; None for a column without one (no dictionary, or
        a cardinality past BITMAP_MAX_CARD). A filter leaf reads only the
        rows of the ids it selects, so its words scale with its selectivity."""
        if col not in self._bitmaps:
            reader = self.segment.column(col)
            card = reader.cardinality
            if not reader.has_dictionary or not 0 < card <= BITMAP_MAX_CARD \
                    or reader.is_multi_value:
                self._bitmaps[col] = None
            else:
                self._bitmaps[col] = self._put(id_bitmap_words(
                    np.asarray(reader.fwd)[:self.num_docs], card, self.padded), "bitmap", col)
        return self._bitmaps[col]

    def null_mask(self, col: str) -> torch.Tensor:
        """bool[padded]: True where the stored value is a filled-in null."""
        if col not in self._null:
            nb = self.segment.column(col).null_bitmap
            padded = np.zeros(self.padded, dtype=bool)
            if nb is not None:
                padded[:self.num_docs] = nb[:self.num_docs]
            self._null[col] = self._put(padded, "null", col)
        return self._null[col]

    def ids(self, col: str) -> torch.Tensor:
        """Padded int32 dict ids of a dict-encoded column. A multi-value column's
        are an int32[padded, W] matrix, W = max(max_num_values, 1): each row's
        ids left-justified, the rest (and every padding row) the fill id
        `cardinality`, which every decode table and LUT maps to 0 / False. A
        leaf reduces its per-value mask with `any(-1)`: a row matches if any
        of its values does."""
        if col not in self._ids:
            reader = self.segment.column(col)
            if not reader.has_dictionary:
                raise ValueError(f"{col} has no dictionary")
            if reader.is_multi_value:
                self._ids[col] = self._put(mv_id_matrix(
                    np.asarray(reader.fwd), np.asarray(reader.mv_offsets),
                    reader.cardinality, self.padded, max(reader.max_num_values, 1)),
                    "ids", col)
            else:
                padded = np.full(self.padded, reader.cardinality, dtype=np.int32)
                padded[:self.num_docs] = np.asarray(reader.fwd)
                self._ids[col] = self._put(padded, "ids", col)
        return self._ids[col]

    def raw(self, col: str) -> torch.Tensor:
        """Padded raw values of a non-dict numeric column, narrowed to 32 bits."""
        if col not in self._raw:
            arr = _narrow(np.asarray(self.segment.column(col).fwd))
            padded = np.zeros(self.padded, dtype=arr.dtype)
            padded[:self.num_docs] = arr
            self._raw[col] = self._put(padded, "raw", col)
        return self._raw[col]

    def put_raw(self, col: str, tensor: torch.Tensor, register: bool = True) -> None:
        """Install a resident raw column, in the layout `raw` builds: padded
        to the block's rows with zeros, narrowed to 32 bits, on its device.
        `register=False` for a tensor the ledger already accounts."""
        if tensor.shape != (self.padded,) or tensor.device.type != self.device.type \
                or tensor.dtype not in (torch.int32, torch.float32):
            raise ValueError(f"{col}: a raw column is {self.padded} int32 or float32 "
                             f"rows on {self.device}, not {tuple(tensor.shape)} "
                             f"{tensor.dtype} on {tensor.device}")
        self._raw[col] = self._register(tensor, "raw", col) if register else tensor

    def dict_values(self, col: str) -> torch.Tensor:
        """Decode table: dictionary values padded to `lut_size(card)` (invalid id -> 0)."""
        if col not in self._dict_vals:
            reader = self.segment.column(col)
            vals = _narrow(np.asarray(reader.dictionary.values))
            out = np.zeros(lut_size(reader.cardinality), dtype=vals.dtype)
            out[:len(vals)] = vals
            self._dict_vals[col] = self._put(out, "dict", col)
        return self._dict_vals[col]

    def for_form(self, col: str) -> Optional[Tuple[int, torch.Tensor]]:
        """Frame-of-reference form `(base, deltas)` of a raw integer column:
        the padded column minus its metadata minimum, in uint8 or uint16
        (`for_delta_dtype`), or None when the column has no such form.
        Padding rows hold delta 0."""
        if col not in self._for:
            reader = self.segment.column(col)
            dt = for_delta_dtype(reader)
            if dt is None:
                self._for[col] = None
            else:
                base = int(reader.min_value)
                padded = np.zeros(self.padded, dtype=dt)
                padded[:self.num_docs] = (np.asarray(reader.fwd).astype(np.int64)
                                          - base).astype(dt)
                self._for[col] = (base, self._put(padded, "for", col))
        return self._for[col]

    def staged_bytes(self) -> int:
        """Bytes of every tensor the block holds."""
        parts = [self._valid, self._valid_words, self._valid_band[1]]
        for cache in (self._ids, self._raw, self._dict_vals, self._null, self._bitmaps):
            parts.extend(cache.values())
        parts.extend(f[1] for f in self._for.values() if f is not None)
        return sum(int(t.nbytes) for t in parts if t is not None)

    def values(self, col: str) -> torch.Tensor:
        """Decoded numeric values of a column, whatever its encoding: the raw
        tensor, or one gather of the decode table through the dict ids."""
        reader = self.segment.column(col)
        if not reader.has_dictionary:
            return self.raw(col)
        return self.dict_values(col)[self.ids(col)]


def device_key(device) -> str:
    """The key of a device's block in a segment's `_device_blocks`. A bare
    "cuda" names the current card, so it and that card's "cuda:<n>" share one
    key."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def block_for(segment: ImmutableSegment, device: torch.device) -> SegmentBlock:
    """The segment's cached block on `device`, created on first use."""
    blocks = segment.__dict__.setdefault("_device_blocks", {})
    key = device_key(device)
    if key not in blocks:
        blocks[key] = SegmentBlock(segment, device)
    return blocks[key]


def bind_table(segment, table: str) -> None:
    """Attribute the segment's staged bytes to `table` in the memory ledger.
    Segment names are unique only within a table, so the segment object
    carries its table (`ledger_table`), and the ledger's name binding serves
    the staging sites that know only a name."""
    segment.__dict__["_ledger_table"] = table
    get_ledger().bind_segment(table, segment.name)


def ledger_table(segment) -> Optional[str]:
    """The table `bind_table` gave the segment, or None (the ledger then
    resolves the table from the segment's name)."""
    return getattr(segment, "__dict__", {}).get("_ledger_table")


def note_set_member(segment, set_block) -> None:
    """Record that a stacked set block (`parallel.combine.SegmentSetBlock`)
    holds the segment's rows: `has_block` then sees the segment resident, and
    `release_block` releases that set block too. Weakly held: a set block the
    executor dropped leaves no trace here."""
    segment.__dict__.setdefault("_set_blocks", weakref.WeakSet()).add(set_block)


def has_block(segment) -> bool:
    """True when the segment is resident on the device: a block of its own
    that staged a tensor, or its rows in a stacked set block that holds
    columns (the tiering gate's hot-path check)."""
    d = getattr(segment, "__dict__", {})
    if any(b.staged_bytes() for b in list(d.get("_device_blocks", {}).values())):
        return True
    return any(b.holds_columns() for b in list(d.get("_set_blocks", ())))


def predicted_block_bytes(segment: ImmutableSegment) -> int:
    """An upper bound of the device bytes a fully staged `SegmentBlock` of the
    segment can hold, from its metadata alone (nothing staged, no column read):
    what the tiering gate charges before `block_for` stages anything. Every
    column is priced as if each lazy cache the block can build for it were
    built: a dictionary column's ids (a multi-value one's `[rows, W]` matrix),
    its decode table and its bitmap words; a raw column's narrowed values and
    its frame-of-reference deltas; every column's null mask; and the valid
    mask and its words. Over-pricing only sends a segment to the host tier
    early; under-pricing is how the card runs out."""
    padded = padded_rows(segment.num_docs)
    total = padded + (padded // 32) * 4            # valid (bool) + valid_words
    for meta in segment.metadata.get("columns", {}).values():
        multi = bool(meta.get("multiValue"))
        width = max(int(meta.get("maxNumValues", 1) or 1), 1) if multi else 1
        if meta.get("hasDictionary"):
            card = int(meta.get("cardinality", 0) or 0)
            total += padded * 4 * width            # int32 ids
            total += lut_size(card) * 4            # decode table, 32-bit
            if 0 < card <= BITMAP_MAX_CARD and not multi:
                total += card * (padded // 32) * 4  # bitmap words
        else:
            try:
                dt = np.dtype(meta.get("fwdDtype", "float32"))
            except TypeError:
                dt = np.dtype(np.float32)
            item = _narrow(np.zeros(0, dtype=dt)).dtype.itemsize if dt.kind in "iuf" else 4
            total += padded * item                 # raw values, narrowed
            mn, mx = meta.get("minValue"), meta.get("maxValue")
            if not multi and isinstance(mn, int) and isinstance(mx, int) \
                    and dt.kind == "i" and 0 <= mx - mn < (1 << 16):
                total += padded * (1 if mx - mn < (1 << 8) else 2)   # FOR deltas
        total += padded                            # null mask (bool)
    return total


def release_block(segment) -> None:
    """Drop the segment's cached device blocks (and its star-tree views'),
    release the stacked set blocks that hold its rows, and deregister the
    ledger entries of all of them. The segment stays loaded: its table binding
    in the ledger is kept. Without this the `_device_blocks` entry keeps every
    tensor alive as long as the segment object lives."""
    d = getattr(segment, "__dict__", {})
    name = getattr(segment, "name", str(segment))
    ledger = get_ledger()
    d.pop("_device_blocks", None)
    for tree in d.get("star_trees", ()):
        view = tree.__dict__.get("view")
        if view is not None and view.__dict__.pop("_device_blocks", None) is not None:
            ledger.release(segment=view.name, keep_binding=True)
    for set_block in list(d.get("_set_blocks", ())):
        set_block.release()
    ledger.release(table=ledger_table(segment), segment=name, keep_binding=True)

