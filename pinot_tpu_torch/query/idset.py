"""IdSet: a serializable value-set filter that travels between queries.

A copy of `pinot_tpu/query/idset.py` (analog of the reference's id-set
subsystem: `IDSET(col)` builds a compact set of a column's values,
`IdSetAggregationFunction`, and `IN_ID_SET(col, 'base64')` filters against
one, `InIdSetTransformFunction`). The set's domain is values (int64, float64
or strings), since dict ids are segment-local. On a dictionary-encoded column
membership is resolved once against the sorted dictionary (O(cardinality),
not O(rows)) into the same boolean-LUT filter leaf as IN/EQ, so an id-set
filter runs on the device as any other dictionary predicate does. The
serialized bytes are the JAX package's, so that a literal from either package
filters in the other.
"""

from __future__ import annotations

import base64
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Any, List, Union

import numpy as np

# Exact sets only: beyond this the serialized form stops being a sane query literal.
# (The reference switches to a Bloom filter past a threshold; exact-with-cap keeps
# differential correctness — revisit if a workload needs approximate id-sets.)
MAX_IDSET_VALUES = 4_000_000

_MAGIC = b"PIDS"


class IdSetError(ValueError):
    pass


class IdSet:
    """Sorted-unique value set. `kind` is "i8" (int64), "f8" (float64) or "str"."""

    def __init__(self, kind: str, values: np.ndarray):
        assert kind in ("i8", "f8", "str"), kind
        self.kind = kind
        self.values = values  # sorted unique; dtype int64/float64/object(str)
        self._str_set = None  # lazy python set for string membership
        self._i8_view = None  # lazy int64 view of an f8 set (int-probe path)
        self._u8_view = None  # lazy uint64 view (probes >= 2**63)

    def _int_view(self) -> np.ndarray:
        """Sorted int64 view of an f8 set: the integral, exactly-representable
        members (cached — contains() runs once per segment)."""
        if self._i8_view is None:
            sv = self.values
            ok = (np.isfinite(sv) & (np.floor(sv) == sv)
                  & (sv >= -9.223372036854776e18) & (sv < 9.223372036854776e18))
            vi = sv[ok].astype(np.int64)
            self._i8_view = np.unique(vi[vi.astype(np.float64) == sv[ok]])
        return self._i8_view

    def _uint_view(self) -> np.ndarray:
        """Sorted uint64 view of an f8 set for the [2**63, 2**64) range —
        unsigned probes up there would WRAP in an int64 cast."""
        if self._u8_view is None:
            sv = self.values
            ok = (np.isfinite(sv) & (np.floor(sv) == sv)
                  & (sv >= 9.223372036854776e18) & (sv < 1.8446744073709552e19))
            vu = sv[ok].astype(np.uint64)
            self._u8_view = np.unique(vu[vu.astype(np.float64) == sv[ok]])
        return self._u8_view

    def __len__(self) -> int:
        return len(self.values)

    def __eq__(self, other) -> bool:
        return (isinstance(other, IdSet) and self.kind == other.kind
                and len(self.values) == len(other.values)
                and bool(np.all(self.values == other.values)))

    # -- construction ------------------------------------------------------

    @classmethod
    def empty(cls) -> "IdSet":
        return cls("i8", np.empty(0, dtype=np.int64))

    @classmethod
    def from_values(cls, values: Union[np.ndarray, List[Any]]) -> "IdSet":
        arr = np.asarray(values)
        if arr.size > MAX_IDSET_VALUES:
            raise IdSetError(
                f"id-set over {arr.size} values exceeds the {MAX_IDSET_VALUES} cap")
        if arr.size == 0:
            return cls.empty()
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            vals = np.array(sorted({str(x) for x in arr.reshape(-1)
                                    if x is not None}), dtype=object)
            return cls("str", vals)
        if arr.dtype.kind in ("i", "u", "b"):
            return cls("i8", np.unique(arr.astype(np.int64)))
        if arr.dtype.kind == "f":
            vals = arr.astype(np.float64)
            vals = vals[~np.isnan(vals)]
            return cls("f8", np.unique(vals))
        raise IdSetError(f"unsupported id-set value dtype {arr.dtype}")

    # -- set algebra -------------------------------------------------------

    def union(self, other: "IdSet") -> "IdSet":
        if len(other) == 0:
            return self
        if len(self) == 0:
            return other
        if self.kind != other.kind:
            # int/float mixes promote to float (same value-equality the engine uses
            # for numeric compares); anything-with-str is a type error
            if {self.kind, other.kind} == {"i8", "f8"}:
                a = self.values.astype(np.float64)
                b = other.values.astype(np.float64)
                out = np.unique(np.concatenate((a, b)))
                if out.size > MAX_IDSET_VALUES:
                    raise IdSetError("id-set union exceeds value cap")
                return IdSet("f8", out)
            raise IdSetError(f"cannot union id-sets of kind {self.kind}/{other.kind}")
        if self.kind == "str":
            merged = np.array(sorted(set(self.values) | set(other.values)),
                              dtype=object)
        else:
            merged = np.unique(np.concatenate((self.values, other.values)))
        if merged.size > MAX_IDSET_VALUES:
            raise IdSetError("id-set union exceeds value cap")
        return IdSet(self.kind, merged)

    # -- membership --------------------------------------------------------

    def contains(self, probe: np.ndarray) -> np.ndarray:
        """Vectorized membership: bool mask over `probe` (any shape, flattened)."""
        probe = np.asarray(probe)
        flat = probe.reshape(-1)
        if len(self.values) == 0:
            return np.zeros(flat.shape, dtype=bool)
        if self.kind == "str":
            if self._str_set is None:
                self._str_set = set(self.values)
            s = self._str_set
            return np.fromiter((x is not None and str(x) in s for x in flat),
                               dtype=bool, count=len(flat))
        if probe.dtype == object or probe.dtype.kind in ("U", "S"):
            return np.zeros(flat.shape, dtype=bool)  # numeric set vs string column
        vals = self.values
        # cross-kind numeric probes compare in the INT64 domain when both
        # sides are integral-valued: casting int64<->float64 loses precision
        # above 2^53 (the same hazard the theta path's _canonical guards
        # against) and would produce false membership matches/misses
        if self.kind == "i8" and flat.dtype.kind == "f":
            out = np.zeros(flat.shape, dtype=bool)
            f = flat.astype(np.float64)
            ok = (np.isfinite(f) & (np.floor(f) == f)
                  & (f >= -9.223372036854776e18) & (f < 9.223372036854776e18))
            probe_i = f[ok].astype(np.int64)
            # above 2^53 one float spans many ints — require the exact
            # round-trip so only truly representable members match
            exact = probe_i.astype(np.float64) == f[ok]
            idx_c = np.minimum(np.searchsorted(vals, probe_i), len(vals) - 1)
            out[np.flatnonzero(ok)] = exact & (vals[idx_c] == probe_i)
            return out
        if self.kind == "f8" and flat.dtype.kind in ("i", "u", "b"):
            out = np.zeros(flat.shape, dtype=bool)
            lo = np.ones(flat.shape, dtype=bool)
            if flat.dtype.kind == "u" and flat.dtype.itemsize == 8:
                # uint64 probes >= 2**63 would WRAP in the int64 cast —
                # compare that range in the uint64 domain instead
                hi = flat >= np.uint64(1) << np.uint64(63)
                lo = ~hi
                vu = self._uint_view()
                if vu.size and hi.any():
                    fh = flat[hi]
                    idx_c = np.minimum(np.searchsorted(vu, fh), len(vu) - 1)
                    out[np.flatnonzero(hi)] = vu[idx_c] == fh
            vi = self._int_view()
            if vi.size and lo.any():
                fl = flat[lo].astype(np.int64)
                idx_c = np.minimum(np.searchsorted(vi, fl), len(vi) - 1)
                out[np.flatnonzero(lo)] = vi[idx_c] == fl
            return out
        if self.kind == "i8" and (flat.dtype.kind == "i" or
                                  (flat.dtype.kind == "u" and flat.dtype.itemsize < 8)):
            # integer probes: exact in int64, and np.isin's table or sort pass
            # beats a searchsorted of random probes (cache misses) ~10x
            return np.isin(flat, vals)
        # sorted-set membership via searchsorted: O(n log card), no hash build
        idx = np.searchsorted(vals, flat)
        idx_c = np.minimum(idx, len(vals) - 1)
        return vals[idx_c] == flat

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        if self.kind == "str":
            parts = []
            for v in self.values:
                raw = str(v).encode("utf-8")
                parts.append(struct.pack("<I", len(raw)))
                parts.append(raw)
            body = b"".join(parts)
        else:
            body = self.values.tobytes()
        return (_MAGIC + self.kind.ljust(3).encode()
                + struct.pack("<I", len(self.values)) + body)

    @classmethod
    def from_bytes(cls, data: bytes) -> "IdSet":
        if data[:4] != _MAGIC:
            raise IdSetError("bad id-set header")
        kind = data[4:7].decode().strip()
        (n,) = struct.unpack("<I", data[7:11])
        body = data[11:]
        if n == 0:
            return cls.empty()
        if kind == "str":
            out: List[str] = []
            pos = 0
            for _ in range(n):
                if pos + 4 > len(body):
                    raise IdSetError("truncated id-set string body")
                (ln,) = struct.unpack_from("<I", body, pos)
                pos += 4
                out.append(body[pos:pos + ln].decode("utf-8"))
                pos += ln
            vals = np.array(out, dtype=object)
        else:
            vals = np.frombuffer(body, dtype=np.int64 if kind == "i8" else np.float64)
        if len(vals) != n:
            raise IdSetError("id-set length mismatch")
        return cls(kind, vals)

    def serialize(self) -> str:
        return base64.b64encode(zlib.compress(self.to_bytes())).decode("ascii")

    @classmethod
    def deserialize(cls, s: str) -> "IdSet":
        # memoized: filter compilation runs per segment, and the same (often large)
        # literal is decoded by every segment of every query using it
        with _CACHE_LOCK:
            hit = _CACHE.get(s)
            if hit is not None:
                _CACHE.move_to_end(s)
                return hit
        out = _deserialize_uncached(s)
        with _CACHE_LOCK:
            _CACHE[s] = out
            _CACHE.move_to_end(s)
            # size-weighted eviction: bound resident decoded values, not entry
            # count — 64 near-cap sets would otherwise pin GBs forever
            total = sum(len(v) for v in _CACHE.values())
            while total > _CACHE_MAX_TOTAL_VALUES and len(_CACHE) > 1:
                _, evicted = _CACHE.popitem(last=False)
                total -= len(evicted)
        return out


# literal-string -> decoded IdSet, LRU by total decoded values
_CACHE: "OrderedDict[str, IdSet]" = OrderedDict()
_CACHE_LOCK = threading.Lock()
_CACHE_MAX_TOTAL_VALUES = 8_000_000


def _deserialize_uncached(s: str) -> IdSet:
    try:
        return IdSet.from_bytes(zlib.decompress(base64.b64decode(s.encode("ascii"))))
    except (ValueError, zlib.error, struct.error) as exc:
        raise IdSetError(f"malformed id-set literal: {exc}") from exc
