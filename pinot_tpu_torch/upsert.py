"""Upsert and dedup metadata managers.

A copy of `pinot_tpu/upsert.py` (the analog of the reference's
`ConcurrentMapPartitionUpsertMetadataManager` and
`PartitionDedupMetadataManager`): a per-partition primary-key map ->
(segment, doc id, comparison value). When a newer row of a key arrives, the
older location's valid-doc bit is cleared and the new one set, so queries
that AND a segment's valid-doc mask into their filter see exactly one (the
latest) row per key. Dedup is the ingest-time drop variant of the same map.
Partial upsert merges each column of a new row into the key's previous row by
its strategy: OVERWRITE, IGNORE, INCREMENT, APPEND, UNION, MAX, MIN.

`valid_mask` returns a `ValidDocs`: the copied bool mask, which also names
the state it was copied from (`key`: the manager, the segment and its
version). The query executor stages one device copy of a mask per key and
reuses it until the segment's version moves (`engine.datablock`); a star-tree's
record mask, a plain array, never matches such a key.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

_managers = itertools.count()   # one id per manager, never reused


class ValidDocs(np.ndarray):
    """A valid-doc mask as a manager copied it. `key` is (manager id, the
    manager's rename/remove epoch, segment, version, rows); an array derived
    from this one (a slice, an AND) has `key` None."""

    key: Optional[tuple] = None


class PartitionUpsertMetadataManager:
    """PK -> location map + per-segment valid-doc bitmaps for one partition group."""

    def __init__(self, comparison_enabled: bool = True):
        self._lock = threading.RLock()
        self._primary_keys: Dict[Tuple, Tuple[str, int, Any]] = {}
        self._valid: Dict[str, np.ndarray] = {}
        self._versions: Dict[str, int] = {}
        self.comparison_enabled = comparison_enabled
        self._id = next(_managers)
        # bumped by rename_segment and remove_segment, which can bring a
        # segment name back to a version it had before
        self._epoch = 0

    def _bitmap(self, segment: str, min_size: int) -> np.ndarray:
        with self._lock:
            cur = self._valid.get(segment)
            if cur is None:
                cur = np.zeros(max(min_size, 64), dtype=bool)
                self._valid[segment] = cur
            elif len(cur) < min_size:
                grown = np.zeros(max(min_size, len(cur) * 2), dtype=bool)
                grown[:len(cur)] = cur
                self._valid[segment] = grown
                cur = grown
            return cur

    def add_record(self, segment: str, doc_id: int, pk: Tuple,
                   comparison_value: Any = None) -> bool:
        """Register a row; True if it became the live row of its key. A row
        whose comparison value is below the live row's is rejected (an
        out-of-order event); a tie replaces it."""
        with self._lock:
            bitmap = self._bitmap(segment, doc_id + 1)
            existing = self._primary_keys.get(pk)
            if existing is not None:
                old_seg, old_doc, old_cmp = existing
                if (self.comparison_enabled and comparison_value is not None
                        and old_cmp is not None and comparison_value < old_cmp):
                    return False
                old_bitmap = self._valid.get(old_seg)
                if old_bitmap is not None and old_doc < len(old_bitmap):
                    old_bitmap[old_doc] = False
                self._bump(old_seg)
            bitmap[doc_id] = True
            self._primary_keys[pk] = (segment, doc_id, comparison_value)
            self._bump(segment)
            return True

    def rename_segment(self, old: str, new: str) -> None:
        """A consuming segment committed under another name keeps its doc
        ids: its bitmap, version and keys move to the new name."""
        with self._lock:
            if old == new:
                return
            self._epoch += 1
            if old in self._valid:
                self._valid[new] = self._valid.pop(old)
                self._versions[new] = self._versions.pop(old, 0)
            for pk, (seg, doc, cmp_val) in list(self._primary_keys.items()):
                if seg == old:
                    self._primary_keys[pk] = (new, doc, cmp_val)

    def remove_segment(self, segment: str) -> None:
        with self._lock:
            self._epoch += 1
            self._valid.pop(segment, None)
            self._versions.pop(segment, None)
            for pk, (seg, _, _) in list(self._primary_keys.items()):
                if seg == segment:
                    del self._primary_keys[pk]

    def valid_mask(self, segment: str, num_docs: int) -> Optional[ValidDocs]:
        """bool[num_docs] of live rows, or None if the segment is untracked.
        The copy and its key are taken under one lock."""
        with self._lock:
            cur = self._valid.get(segment)
            if cur is None:
                return None
            out = np.zeros(num_docs, dtype=bool).view(ValidDocs)
            n = min(num_docs, len(cur))
            out[:n] = cur[:n]
            out.key = (self._id, self._epoch, segment, self._versions.get(segment, 0),
                       num_docs)
            return out

    def version(self, segment: str) -> int:
        with self._lock:
            return self._versions.get(segment, 0)

    def _bump(self, segment: str) -> None:
        with self._lock:
            self._versions[segment] = self._versions.get(segment, 0) + 1

    @property
    def num_primary_keys(self) -> int:
        with self._lock:
            return len(self._primary_keys)


class TableUpsertMetadataManager:
    """Per table: partition group -> partition manager (the reference's
    TableUpsertMetadataManager)."""

    def __init__(self, comparison_enabled: bool = True):
        self._partitions: Dict[int, PartitionUpsertMetadataManager] = {}
        self._lock = threading.RLock()
        self.comparison_enabled = comparison_enabled

    def partition(self, partition_group: int) -> PartitionUpsertMetadataManager:
        with self._lock:
            if partition_group not in self._partitions:
                self._partitions[partition_group] = PartitionUpsertMetadataManager(
                    self.comparison_enabled)
            return self._partitions[partition_group]

    def valid_mask(self, segment: str, num_docs: int) -> Optional[ValidDocs]:
        for pm in list(self._partitions.values()):
            mask = pm.valid_mask(segment, num_docs)
            if mask is not None:
                return mask
        return None

    def version(self, segment: str) -> int:
        """The segment's version in the partition that tracks it (0 if none does)."""
        for pm in list(self._partitions.values()):
            v = pm.version(segment)
            if v:
                return v
        return 0


class PartitionDedupMetadataManager:
    """Exact ingest-time dedup: drop rows whose PK was already seen (the
    reference's PartitionDedupMetadataManager)."""

    def __init__(self):
        self._seen: set = set()
        self._lock = threading.RLock()

    def check_and_add(self, pk: Tuple) -> bool:
        """True if the PK is new (the row is to be ingested)."""
        with self._lock:
            if pk in self._seen:
                return False
            self._seen.add(pk)
            return True

    def remove_segment_keys(self, pks) -> None:
        with self._lock:
            self._seen.difference_update(pks)


def merge_partial(strategy: str, old: Any, new: Any) -> Any:
    """One column of a partial upsert: the key's previous value `old` and the
    new row's `new` merged by `strategy` (the reference's upsert/merger/). A
    null on either side keeps the other."""
    if new is None:
        return old
    if old is None:
        return new
    s = strategy.upper()
    if s == "OVERWRITE":
        return new
    if s == "IGNORE":
        return old
    if s == "INCREMENT":
        return old + new
    if s == "MAX":
        return max(old, new)
    if s == "MIN":
        return min(old, new)
    if s == "APPEND":
        return (old if isinstance(old, list) else [old]) + \
            (new if isinstance(new, list) else [new])
    if s == "UNION":
        merged = (old if isinstance(old, list) else [old])
        for v in (new if isinstance(new, list) else [new]):
            if v not in merged:
                merged.append(v)
        return merged
    raise ValueError(f"unknown partial upsert strategy {strategy!r}")
