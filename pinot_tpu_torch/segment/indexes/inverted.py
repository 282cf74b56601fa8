"""Inverted index: dict id -> sorted posting list of doc ids.

A copy of `pinot_tpu/segment/indexes/inverted.py` (analog of the
reference's `BitmapInvertedIndexReader`), writing and reading the same
`.inv.npz` file: CSR posting lists (one `argsort` builds all of them), int32
doc ids grouped by dict id, and int64 offsets per id. The filter uses the
postings in two ways: `match_count_for_ids` estimates a leaf's selectivity
from the offsets alone (`planner.select_bitmap_leaves`), and a selective leaf's
host mask is built from its postings instead of a forward-index gather
(`executor.host_filter_mask`).

`MutableInvertedIndex` is the consuming segment's realtime index (the
reference's `RealtimeInvertedIndex`), kept by the row-append
`segment.mutable.MutableSegment`; its view has the reader's surface.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np


def create_inverted_index(path: str, dict_ids: np.ndarray, cardinality: int,
                          doc_ids: np.ndarray = None) -> None:
    """Write the postings of a column's dict ids. `doc_ids` maps each entry to
    its document (a multi-value column passes each row repeated once per
    value); omitted, the entry's position is the doc id (single-value)."""
    dict_ids = np.asarray(dict_ids)
    if doc_ids is not None:
        # one posting per (dict id, doc): a row that repeats a value posts its
        # doc once, as the reference's bitmaps do
        pairs = np.unique(np.stack([dict_ids.astype(np.int64),
                                    np.asarray(doc_ids, dtype=np.int64)]), axis=1)
        dict_ids, doc_ids = pairs[0], pairs[1]
    order = np.argsort(dict_ids, kind="stable")   # entries grouped by dict id, ascending
    counts = np.bincount(dict_ids.astype(np.int64), minlength=cardinality)
    offsets = np.zeros(cardinality + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    postings = order if doc_ids is None else np.asarray(doc_ids)[order]
    np.savez(path, doc_ids=postings.astype(np.int32), offsets=offsets)


class InvertedIndexReader:
    def __init__(self, path: str):
        data = np.load(path)
        self._doc_ids = data["doc_ids"]
        self._offsets = data["offsets"]

    @property
    def cardinality(self) -> int:
        return len(self._offsets) - 1

    def doc_ids_for(self, dict_id: int) -> np.ndarray:
        return self._doc_ids[self._offsets[dict_id]:self._offsets[dict_id + 1]]

    def doc_ids_for_ids(self, dict_ids: Sequence[int]) -> np.ndarray:
        """Union of the posting lists of an id set, sorted."""
        parts = [self.doc_ids_for(i) for i in dict_ids]
        if not parts:
            return np.empty(0, dtype=np.int32)
        return np.sort(np.concatenate(parts))

    def doc_ids_for_range(self, lo: int, hi: int) -> np.ndarray:
        """Union for dict ids in [lo, hi): one contiguous slice of the CSR layout."""
        if lo >= hi:
            return np.empty(0, dtype=np.int32)
        return np.sort(self._doc_ids[self._offsets[lo]:self._offsets[hi]])

    def match_count_for_range(self, lo: int, hi: int) -> int:
        """Docs matching ids in [lo, hi), from the offsets alone."""
        if lo >= hi:
            return 0
        return int(self._offsets[hi] - self._offsets[lo])

    def match_count_for_ids(self, dict_ids: Sequence[int]) -> int:
        ids = np.asarray(dict_ids, dtype=np.int64)
        return int(np.sum(self._offsets[ids + 1] - self._offsets[ids]))


class MutableInvertedIndex:
    """Incrementally maintained realtime inverted index.

    Postings are keyed by value, not dict id: the consuming segment's
    dictionary is re-sorted at every query snapshot, so value keys stay
    stable while ids do not. One writer appends; `view()` binds a
    point-in-time (sorted dictionary, row count) pair, mapping sorted dict
    ids back to value-keyed postings and trimming them to the snapshot's row
    count (append-order postings ascend, so the trim is one bisect)."""

    def __init__(self):
        self._postings: dict = {}

    def add_doc(self, value, doc_id: int) -> None:
        vals = value if isinstance(value, (list, tuple)) else (value,)
        for v in vals:
            self._postings.setdefault(v, []).append(doc_id)

    def view(self, dictionary, n_docs: int) -> "MutableInvertedView":
        return MutableInvertedView(self._postings, dictionary, n_docs)


class MutableInvertedView:
    """A point-in-time reader with the surface the filter reads from the
    immutable reader (`cardinality`, `doc_ids_for`, `doc_ids_for_ids`,
    `match_count_for_ids`)."""

    def __init__(self, postings: dict, dictionary, n_docs: int):
        self._postings = postings
        self._dictionary = dictionary
        self._n = n_docs

    @property
    def cardinality(self) -> int:
        return len(self._dictionary)

    def _list_for(self, dict_id: int) -> list:
        lst = self._postings.get(self._dictionary.get(dict_id), ())
        return lst[:bisect.bisect_left(lst, self._n)]

    def doc_ids_for(self, dict_id: int) -> np.ndarray:
        return np.asarray(self._list_for(dict_id), dtype=np.int32)

    def doc_ids_for_ids(self, dict_ids: Sequence[int]) -> np.ndarray:
        flat = [d for i in dict_ids for d in self._list_for(i)]
        return np.sort(np.asarray(flat, dtype=np.int32))

    def match_count_for_ids(self, dict_ids: Sequence[int]) -> int:
        return sum(len(self._list_for(i)) for i in dict_ids)
