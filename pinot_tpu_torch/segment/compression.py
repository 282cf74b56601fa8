"""Chunked compression for raw (no-dictionary) forward indexes.

A copy of `pinot_tpu/segment/compression.py` that reads and writes the same
files (the analog of the reference's `ChunkCompressionType` and its V4 chunk
forward-index writers and readers). The codecs are the standard library's:
`zlib` (the GZIP/deflate analog), `lzma` (the high-ratio ZSTANDARD analog) and
`passthrough`. A column is cut into fixed-row chunks, each compressed on its
own, with a chunk offset table so that a row range decodes without touching
the whole column.

File layout: MAGIC(4) | u32 header_len | header json | chunk blobs...
Header: dtype, rows, chunkRows, codec, chunkOffsets (into the blob region).
"""

from __future__ import annotations

import json
import lzma
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"PTPC"

# codec name -> (compress, decompress)
CODECS: Dict[str, Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]] = {
    "passthrough": (lambda b: b, lambda b: b),
    "zlib": (lambda b: zlib.compress(b, 6), zlib.decompress),
    "lzma": (lambda b: lzma.compress(b, preset=1), lzma.decompress),
}

DEFAULT_CHUNK_ROWS = 1 << 16


def write_chunked(path: str, arr: np.ndarray, codec: str = "zlib",
                  chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown compression codec {codec!r}; "
                         f"available: {sorted(CODECS)}")
    compress, _ = CODECS[codec]
    arr = np.ascontiguousarray(arr)
    rows = len(arr)
    blobs: List[bytes] = []
    offsets = [0]
    for lo in range(0, max(rows, 1), chunk_rows):
        blob = compress(arr[lo:lo + chunk_rows].tobytes())
        blobs.append(blob)
        offsets.append(offsets[-1] + len(blob))
    header = json.dumps({
        "dtype": arr.dtype.str, "rows": rows, "chunkRows": chunk_rows,
        "codec": codec, "chunkOffsets": offsets,
    }).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for blob in blobs:
            f.write(blob)


class ChunkedArrayReader:
    """The array surface of a chunk-compressed column. A row-range read
    (`read_rows`, or a unit-step slice) decodes only the covering chunks;
    `np.asarray()` (the device staging, `values()`) decodes the whole column
    once and caches it, so queries do not decompress again."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError(f"bad chunk magic in {path}")
            (hlen,) = struct.unpack("<I", f.read(4))
            h = json.loads(f.read(hlen).decode())
        self.dtype = np.dtype(h["dtype"])
        self.rows = int(h["rows"])
        self.chunk_rows = int(h["chunkRows"])
        self.codec = h["codec"]
        self._offsets = h["chunkOffsets"]
        self._blob_base = 8 + hlen
        self._full: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.rows

    def _chunk(self, i: int) -> np.ndarray:
        _, decompress = CODECS[self.codec]
        with open(self.path, "rb") as f:
            f.seek(self._blob_base + self._offsets[i])
            blob = f.read(self._offsets[i + 1] - self._offsets[i])
        return np.frombuffer(decompress(blob), dtype=self.dtype)

    def read_rows(self, lo: int, hi: int) -> np.ndarray:
        """Decode [lo, hi), touching only the covering chunks."""
        lo, hi = max(lo, 0), min(hi, self.rows)
        if lo >= hi:
            return np.empty(0, dtype=self.dtype)
        if self._full is not None:
            return self._full[lo:hi]
        c0, c1 = lo // self.chunk_rows, (hi - 1) // self.chunk_rows
        parts = [self._chunk(i) for i in range(c0, c1 + 1)]
        joined = parts[0] if len(parts) == 1 else np.concatenate(parts)
        base = c0 * self.chunk_rows
        return joined[lo - base:hi - base]

    def array(self) -> np.ndarray:
        """The whole column, decoded once: one read of the blob region, then
        each chunk decoded from memory."""
        if self._full is None:
            _, decompress = CODECS[self.codec]
            with open(self.path, "rb") as f:
                f.seek(self._blob_base)
                region = f.read(self._offsets[-1])
            parts = [np.frombuffer(
                decompress(region[self._offsets[i]:self._offsets[i + 1]]),
                dtype=self.dtype) for i in range(len(self._offsets) - 1)]
            full = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self._full = full[:self.rows]
        return self._full

    def __array__(self, dtype=None, copy=None):
        out = self.array()
        return out.astype(dtype) if dtype is not None else out

    def __getitem__(self, key):
        if isinstance(key, slice) and (key.step is None or key.step == 1) \
                and self._full is None:
            lo = 0 if key.start is None else \
                (key.start if key.start >= 0 else self.rows + key.start)
            hi = self.rows if key.stop is None else \
                (key.stop if key.stop >= 0 else self.rows + key.stop)
            return self.read_rows(lo, hi)
        return self.array()[key]
