"""Bit-sliced range index over dict ids.

A copy of `pinot_tpu/segment/indexes/range.py` (analog of the reference's
`BitSlicedRangeIndexReader`), writing and reading the same `.rng.npz` file: one
packed bitmap per bit of the dict id (`nbits = ceil(log2 card)` slices of `n`
bits each, LSB slice first). `id < T` is evaluated with bitwise ops over the
slices (the Rinfret/O'Neil bit-sliced comparison).
"""

from __future__ import annotations

import numpy as np


def create_range_index(path: str, dict_ids: np.ndarray, cardinality: int) -> None:
    nbits = max(1, int(cardinality - 1).bit_length())
    ids = np.asarray(dict_ids).astype(np.int64)
    slices = np.stack([
        np.packbits(((ids >> b) & 1).astype(np.uint8), bitorder="little")
        for b in range(nbits)
    ])
    np.savez(path, slices=slices, nbits=np.int64(nbits), num_docs=np.int64(len(ids)))


class RangeIndexReader:
    def __init__(self, path: str):
        data = np.load(path)
        self._slices = data["slices"]  # [nbits, ceil(n/8)] uint8, LSB slice first
        self._nbits = int(data["nbits"])
        self._num_docs = int(data["num_docs"])

    @property
    def num_docs(self) -> int:
        return self._num_docs

    def mask_less_than(self, threshold: int) -> np.ndarray:
        """Packed bitmap (little bit order) of docs with dict_id < threshold:
        from the MSB down, lt |= eq & ~slice_b where bit b of T is set, and eq
        keeps the docs equal to T on the bits above."""
        nbytes = self._slices.shape[1]
        if threshold <= 0:
            return np.zeros(nbytes, dtype=np.uint8)
        if threshold >= (1 << self._nbits):
            return np.full(nbytes, 0xFF, dtype=np.uint8)
        lt = np.zeros(nbytes, dtype=np.uint8)
        eq = np.full(nbytes, 0xFF, dtype=np.uint8)
        for b in range(self._nbits - 1, -1, -1):
            s = self._slices[b]
            if (threshold >> b) & 1:
                lt |= eq & ~s
                eq &= s
            else:
                eq &= ~s
        return lt

    def mask_range(self, lo: int, hi: int) -> np.ndarray:
        """Packed bitmap for dict_id in [lo, hi)."""
        return self.mask_less_than(hi) & ~self.mask_less_than(lo)
