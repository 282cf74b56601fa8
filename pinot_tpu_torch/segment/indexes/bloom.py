"""Per-column bloom filter for equality-predicate segment pruning.

A copy of `pinot_tpu/segment/indexes/bloom.py` (analog of the reference's
Guava-backed bloom filter, used by `ColumnValueSegmentPruner`): double hashing
over blake2b digests at ~1% false positives, in the same layout on disk
(`.bloom.npy`) and in the hex payload that rides segment metadata
(`bloomHex`): a little-endian int64 header [k, m] then the m-bit array.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Iterable, Tuple

import numpy as np

_DEFAULT_FPP = 0.01


def _hash_pair(value: Any) -> Tuple[int, int]:
    if isinstance(value, bytes):
        data = value
    elif isinstance(value, (float, np.floating)) and math.isfinite(value) \
            and value == int(value):
        data = str(int(value)).encode()  # 3.0 and 3 hash alike across column types
    elif isinstance(value, (int, np.integer)):
        data = str(int(value)).encode()
    else:
        data = str(value).encode()
    d = hashlib.blake2b(data, digest_size=16).digest()
    return int.from_bytes(d[:8], "little"), int.from_bytes(d[8:], "little")


def _build_bloom_bytes(values: Iterable[Any], fpp: float) -> np.ndarray:
    """The [k, m] int64 header (as uint8) and the bit array. `m` is sized for
    every value given, repeats included, as the JAX package sizes it; each
    distinct value is hashed once, and its k positions are set in one numpy
    pass ((h1 + i * h2) mod m taken as (h1 mod m + i * (h2 mod m)) mod m,
    which fits int64)."""
    vals = values if isinstance(values, np.ndarray) else list(values)
    n = max(1, len(vals))
    m = max(64, int(-n * math.log(fpp) / (math.log(2) ** 2)))
    m = (m + 7) // 8 * 8
    k = max(1, round(m / n * math.log(2)))
    if isinstance(vals, np.ndarray) and vals.dtype.kind in "iuf":
        distinct = np.unique(vals).tolist()
    else:
        distinct = list(dict.fromkeys(vals.tolist() if isinstance(vals, np.ndarray) else vals))
    bitset = np.zeros(m, dtype=bool)
    if distinct:
        if isinstance(vals, np.ndarray) and vals.dtype.kind in "iu":
            # integers hash their decimal text (`_hash_pair`'s int case), here
            # without its per-value type dispatch
            digests = b"".join(hashlib.blake2b(str(v).encode(), digest_size=16).digest()
                               for v in distinct)
            halves = np.frombuffer(digests, dtype="<u8").reshape(-1, 2)
            h1 = (halves[:, 0] % m).astype(np.int64)
            h2 = (halves[:, 1] % m).astype(np.int64)
        else:
            pairs = [_hash_pair(v) for v in distinct]
            h1 = np.fromiter((a % m for a, _ in pairs), dtype=np.int64, count=len(pairs))
            h2 = np.fromiter((b % m for _, b in pairs), dtype=np.int64, count=len(pairs))
        bitset[(h1[:, None] + np.arange(k, dtype=np.int64)[None, :] * h2[:, None]) % m] = True
    bits = np.packbits(bitset, bitorder="little")
    return np.concatenate([np.array([k, m], dtype=np.int64).view(np.uint8), bits])


def create_bloom_filter(path: str, values: Iterable[Any], fpp: float = _DEFAULT_FPP) -> None:
    np.save(path, _build_bloom_bytes(values, fpp))


def bloom_hex(values: Iterable[Any], fpp: float = _DEFAULT_FPP) -> str:
    """A bloom filter over `values` as a hex string small enough to ride in
    segment metadata."""
    return _build_bloom_bytes(values, fpp).tobytes().hex()


def bloom_hex_might_contain(hex_str: str, value: Any) -> bool:
    """Membership probe against a `bloom_hex` payload."""
    raw = bytes.fromhex(hex_str)
    k = int.from_bytes(raw[0:8], "little")
    m = int.from_bytes(raw[8:16], "little")
    bits = raw[16:]
    h1, h2 = _hash_pair(value)
    for i in range(k):
        pos = (h1 + i * h2) % m
        if not (bits[pos >> 3] >> (pos & 7)) & 1:
            return False
    return True


class BloomFilterReader:
    def __init__(self, path: str):
        raw = np.load(path)
        header = raw[:16].view(np.int64)
        self._k = int(header[0])
        self._m = int(header[1])
        self._bits = raw[16:]

    def might_contain(self, value: Any) -> bool:
        h1, h2 = _hash_pair(value)
        for i in range(self._k):
            pos = (h1 + i * h2) % self._m
            if not (self._bits[pos >> 3] >> (pos & 7)) & 1:
                return False
        return True
