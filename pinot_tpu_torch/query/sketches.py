"""Mergeable sketch states: theta sketch (approx distinct) and t-digest (approx quantiles).

A copy of `pinot_tpu/query/sketches.py`, in numpy (analog of the reference's
DataSketches-backed aggregations, `DistinctCountThetaSketchAggregationFunction`,
`PercentileTDigestAggregationFunction`, `PercentileEstAggregationFunction`):
the KMV theta sketch and Dunning's merging t-digest. Their states merge
associatively, so that they flow through segment combine and the reduce
unchanged. The hashes and the compression are the JAX package's, so that a
sketch built here from the same values has the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional

import numpy as np

_MAX64 = np.float64(2 ** 64)


def hash64(values: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit mix hash (splitmix64 finalizer) over arbitrary values.

    Strings/bytes hash via a per-element FNV-1a pass (python loop — the scan path only
    hashes *dictionary values*, cardinality-sized, not row-sized)."""
    arr = np.asarray(values)
    if arr.dtype.kind in "iuf b":
        x = np.ascontiguousarray(arr).view(np.uint8).reshape(len(arr), -1)
        h = np.zeros(len(arr), dtype=np.uint64)
        FNV_PRIME = np.uint64(0x100000001B3)
        for byte_col in x.T:
            h = (h ^ byte_col.astype(np.uint64)) * FNV_PRIME
    else:
        h = np.fromiter((_fnv1a(v) for v in arr), dtype=np.uint64, count=len(arr))
    # splitmix64 finalizer for avalanche
    h = h.copy()
    h ^= h >> np.uint64(30)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(27)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(31)
    return h


def _fnv1a(v: Any) -> int:
    data = v if isinstance(v, bytes) else str(v).encode("utf-8")
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class ThetaSketch:
    """KMV theta sketch: keep the k smallest 64-bit hashes; theta = sampling threshold.

    Union (merge) is the only set operation the aggregation path needs; intersection /
    a-not-b are provided for the reference's SET_UNION/SET_INTERSECT/SET_DIFF post-ops
    (DistinctCountThetaSketchAggregationFunction parameters)."""

    __slots__ = ("k", "theta", "hashes")

    def __init__(self, k: int = 4096, theta: float = 1.0,
                 hashes: Optional[np.ndarray] = None):
        self.k = k
        self.theta = theta
        self.hashes = hashes if hashes is not None else np.empty(0, dtype=np.uint64)

    @classmethod
    def from_values(cls, values: np.ndarray, k: int = 4096) -> "ThetaSketch":
        if len(values) == 0:
            return cls(k)
        h = np.unique(hash64(values))
        sk = cls(k)
        sk._absorb(h)
        return sk

    def _absorb(self, sorted_hashes: np.ndarray) -> None:
        cutoff = np.uint64(self.theta * float(_MAX64)) if self.theta < 1.0 else None
        if cutoff is not None:
            sorted_hashes = sorted_hashes[sorted_hashes < cutoff]
        merged = np.union1d(self.hashes, sorted_hashes)
        if len(merged) > self.k:
            # retain the k smallest; theta becomes the (k+1)-th (all retained are < theta)
            self.theta = float(merged[self.k]) / float(_MAX64)
            merged = merged[:self.k]
        self.hashes = merged

    def union(self, other: "ThetaSketch") -> "ThetaSketch":
        out = ThetaSketch(min(self.k, other.k), min(self.theta, other.theta))
        cutoff = np.uint64(out.theta * float(_MAX64)) if out.theta < 1.0 else None
        merged = np.union1d(self.hashes, other.hashes)
        if cutoff is not None:
            merged = merged[merged < cutoff]
        out.hashes = merged
        if len(merged) > out.k:
            out.theta = float(merged[out.k]) / float(_MAX64)
            out.hashes = merged[:out.k]
        return out

    def intersect(self, other: "ThetaSketch") -> "ThetaSketch":
        theta = min(self.theta, other.theta)
        cutoff = np.uint64(theta * float(_MAX64)) if theta < 1.0 else None
        common = np.intersect1d(self.hashes, other.hashes)
        if cutoff is not None:
            common = common[common < cutoff]
        return ThetaSketch(min(self.k, other.k), theta, common)

    def a_not_b(self, other: "ThetaSketch") -> "ThetaSketch":
        theta = min(self.theta, other.theta)
        cutoff = np.uint64(theta * float(_MAX64)) if theta < 1.0 else None
        diff = np.setdiff1d(self.hashes, other.hashes)
        if cutoff is not None:
            diff = diff[diff < cutoff]
        return ThetaSketch(min(self.k, other.k), theta, diff)

    def estimate(self) -> float:
        if self.theta >= 1.0:
            return float(len(self.hashes))
        return len(self.hashes) / self.theta

    # -- serialization (compact: k, theta, hashes) --------------------------
    def to_bytes(self) -> bytes:
        return struct.pack("<id", self.k, self.theta) + self.hashes.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ThetaSketch":
        k, theta = struct.unpack_from("<id", data)
        hashes = np.frombuffer(data[12:], dtype=np.uint64).copy()
        return cls(k, theta, hashes)


class TDigest:
    """Merging t-digest (Dunning): centroids sized by the k1 scale function, accurate at
    the tails. States merge associatively: concatenate centroids + re-compress."""

    __slots__ = ("compression", "means", "weights")

    def __init__(self, compression: float = 100.0,
                 means: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None):
        self.compression = compression
        self.means = means if means is not None else np.empty(0, dtype=np.float64)
        self.weights = weights if weights is not None else np.empty(0, dtype=np.float64)

    @classmethod
    def from_values(cls, values: np.ndarray, compression: float = 100.0) -> "TDigest":
        td = cls(compression)
        v = np.asarray(values, dtype=np.float64)
        v = v[~np.isnan(v)]
        if len(v):
            td.means = np.sort(v)
            td.weights = np.ones(len(v), dtype=np.float64)
            td._compress()
        return td

    @classmethod
    def from_weighted(cls, values: np.ndarray, weights: np.ndarray,
                      compression: float = 100.0) -> "TDigest":
        """Digest from (value, multiplicity) pairs — the device path's shape:
        a dictionary's sorted values with per-id masked row counts, so the
        build cost is O(cardinality), not O(rows)."""
        td = cls(compression)
        v = np.asarray(values, dtype=np.float64)
        w = np.asarray(weights, dtype=np.float64)
        keep = (w > 0) & ~np.isnan(v)
        v, w = v[keep], w[keep]
        if len(v):
            order = np.argsort(v, kind="stable")
            td.means = v[order]
            td.weights = w[order]
            td._compress()
        return td

    def merge(self, other: "TDigest") -> "TDigest":
        out = TDigest(max(self.compression, other.compression))
        out.means = np.concatenate([self.means, other.means])
        out.weights = np.concatenate([self.weights, other.weights])
        order = np.argsort(out.means, kind="stable")
        out.means = out.means[order]
        out.weights = out.weights[order]
        out._compress()
        return out

    def _compress(self) -> None:
        n = len(self.means)
        if n <= 1:
            return
        total = self.weights.sum()
        d = self.compression
        # k1 scale: k(q) = d/(2π) asin(2q-1); centroid boundary where k advances by 1
        new_means: List[float] = []
        new_weights: List[float] = []
        w_so_far = 0.0
        cur_mean = self.means[0]
        cur_w = self.weights[0]

        def k_fn(q: float) -> float:
            return d / (2 * np.pi) * np.arcsin(max(-1.0, min(1.0, 2 * q - 1)))

        k_lo = k_fn(0.0)
        for i in range(1, n):
            q = (w_so_far + cur_w + self.weights[i] / 2) / total
            if k_fn(q) - k_lo < 1.0:
                # absorb into current centroid
                cw = cur_w + self.weights[i]
                cur_mean = (cur_mean * cur_w + self.means[i] * self.weights[i]) / cw
                cur_w = cw
            else:
                new_means.append(cur_mean)
                new_weights.append(cur_w)
                w_so_far += cur_w
                k_lo = k_fn(w_so_far / total)
                cur_mean = self.means[i]
                cur_w = self.weights[i]
        new_means.append(cur_mean)
        new_weights.append(cur_w)
        self.means = np.asarray(new_means)
        self.weights = np.asarray(new_weights)

    def quantile(self, q: float) -> Optional[float]:
        if len(self.means) == 0:
            return None
        if len(self.means) == 1:
            return float(self.means[0])
        total = self.weights.sum()
        target = q * total
        # centroid centers in cumulative-weight space
        cum = np.cumsum(self.weights) - self.weights / 2
        if target <= cum[0]:
            return float(self.means[0])
        if target >= cum[-1]:
            return float(self.means[-1])
        i = int(np.searchsorted(cum, target)) - 1
        frac = (target - cum[i]) / (cum[i + 1] - cum[i])
        return float(self.means[i] + frac * (self.means[i + 1] - self.means[i]))

    def to_bytes(self) -> bytes:
        return struct.pack("<di", self.compression, len(self.means)) \
            + self.means.tobytes() + self.weights.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "TDigest":
        compression, n = struct.unpack_from("<di", data)
        off = 12
        means = np.frombuffer(data[off:off + 8 * n], dtype=np.float64).copy()
        weights = np.frombuffer(data[off + 8 * n:off + 16 * n], dtype=np.float64).copy()
        return cls(compression, means, weights)
