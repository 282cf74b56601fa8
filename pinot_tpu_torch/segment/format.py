"""On-disk segment format constants and low-level helpers.

A trimmed copy of `pinot_tpu/segment/format.py`: both packages read and write
the same directory layout, so a segment built by either loads in the other.

Layout (one directory per segment):

    <segment>/
        metadata.json        # segment + per-column metadata
        creation.meta.json   # creation time, crc
        cols/<col>.fwd.npy   # forward index: minimal-width dict ids, or raw values
                             # (a multi-value column: every row's ids, concatenated)
        cols/<col>.mvoff.npy # a multi-value column's int64 row offsets (num_docs + 1)
        cols/<col>.fwdc.bin  # chunk-compressed raw forward index (compression.py)
        cols/<col>.dict.npy  # numeric dictionary (sorted values)
        cols/<col>.dict.blob / .dictoff.npy   # string dictionary: utf-8 blob + int64 offsets
        cols/<col>.nulls.npy # packed null bitmap (np.packbits)
        cols/<col>.inv.npz   # inverted index (CSR posting lists per dict id)
        cols/<col>.rng.npz   # bit-sliced range index
        cols/<col>.bloom.npy # bloom filter bit array
        cols/<col>.json.npz  # JSON index: flattened path/value keys, CSR postings
        cols/<col>.text.npz  # text index: token postings with positions
        cols/<col>.fst.npz   # trigram regex prefilter over the dictionary
        cols/<lng>__<lat>.geo.npz   # geo grid-cell index of a coordinate pair
        startree/*           # star-tree pre-aggregated record tables and node arrays

Dict ids are stored byte-aligned at minimal width (uint8/uint16/int32), and every
file is little-endian numpy, mmap-able via `np.load(..., mmap_mode='r')`.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List

import numpy as np

SEGMENT_METADATA_FILE = "metadata.json"
CREATION_META_FILE = "creation.meta.json"
COLS_DIR = "cols"
STARTREE_DIR = "startree"

FWD_SUFFIX = ".fwd.npy"
FWD_COMPRESSED_SUFFIX = ".fwdc.bin"  # chunk-compressed raw forward index
DICT_NUMERIC_SUFFIX = ".dict.npy"
DICT_BLOB_SUFFIX = ".dict.blob"
DICT_OFFSETS_SUFFIX = ".dictoff.npy"
NULLS_SUFFIX = ".nulls.npy"
INVERTED_SUFFIX = ".inv.npz"
RANGE_SUFFIX = ".rng.npz"
BLOOM_SUFFIX = ".bloom.npy"
JSON_SUFFIX = ".json.npz"
TEXT_SUFFIX = ".text.npz"
FST_SUFFIX = ".fst.npz"  # trigram regex prefilter over the dictionary
MV_OFFSETS_SUFFIX = ".mvoff.npy"  # int64 row offsets of a multi-value column (CSR)

FORMAT_VERSION = 1

# Device blocks hold at least this many rows (padded to a power of two above it). The
# value is the JAX package's, so both packages pad a segment to the same row count.
ROW_TILE = 1024


def minimal_dtype_for_cardinality(cardinality: int) -> np.dtype:
    """Smallest byte-aligned unsigned dtype that can hold dict ids [0, cardinality)."""
    if cardinality <= 1 << 8:
        return np.dtype(np.uint8)
    if cardinality <= 1 << 16:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)  # dictionaries beyond 2^31 ids are not supported


def write_json(path: str, obj: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=_json_default)
    os.replace(tmp, path)


def _json_default(o: Any) -> Any:
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not json-serializable: {type(o)}")


def read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def write_string_dictionary(path_prefix: str, values: List[str]) -> None:
    """Sorted string dictionary as utf-8 blob + int64 offsets (n+1)."""
    encoded = [v.encode("utf-8") for v in values]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    with open(path_prefix + DICT_BLOB_SUFFIX, "wb") as f:
        f.write(b"".join(encoded))
    np.save(path_prefix + DICT_OFFSETS_SUFFIX, offsets)


def read_string_dictionary(path_prefix: str) -> List[str]:
    offsets = np.load(path_prefix + DICT_OFFSETS_SUFFIX)
    with open(path_prefix + DICT_BLOB_SUFFIX, "rb") as f:
        blob = f.read()
    return [blob[offsets[i]:offsets[i + 1]].decode("utf-8") for i in range(len(offsets) - 1)]


def pack_bitmap(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> packed uint8 bitmap (np.packbits, little-bit-order for simplicity)."""
    return np.packbits(mask.astype(np.uint8), bitorder="little")


def unpack_bitmap(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(packed, count=n, bitorder="little").astype(bool)


def segment_crc(segment_dir: str) -> int:
    """CRC over all column files, mirroring the reference's creation.meta crc."""
    crc = 0
    cols_dir = os.path.join(segment_dir, COLS_DIR)
    if os.path.isdir(cols_dir):
        for name in sorted(os.listdir(cols_dir)):
            with open(os.path.join(cols_dir, name), "rb") as f:
                crc = zlib.crc32(f.read(), crc)
    return crc
