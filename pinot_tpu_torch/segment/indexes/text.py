"""Text index: tokenized inverted index with positions, powering TEXT_MATCH.

A copy of `pinot_tpu/segment/indexes/text.py` that writes and reads the same
file (the analog of the reference's Lucene text index,
`LuceneTextIndexReader.java` and `LuceneTextIndexCreator.java`). Documents are
tokenized (lowercase alphanumeric runs, Lucene StandardAnalyzer's common case)
into CSR posting lists with token positions, enough for the TEXT_MATCH
surface: terms, boolean AND/OR/NOT, grouping, quoted phrases, trailing-*
prefix queries, /regex/ term queries against the token dictionary and `~`
fuzzy terms.

A query resolves on the host into one doc mask, which the device filter reads
as a `DocSetLeaf`, as the reference's TextMatchFilterOperator produces a
Lucene doc bitmap before the scan. `_TextMaskOps` holds the mask algebra once,
over two postings primitives; the immutable reader and the realtime index's
view (`MutableTextIndex`, kept by the row-append consuming segment
`segment.mutable.MutableSegment`) each supply them.
"""

from __future__ import annotations

import bisect
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

_TOKEN_RX = re.compile(r"[A-Za-z0-9_]+")


def _edit_distance_at_most(a: str, b: str, k: int) -> bool:
    """Levenshtein(a, b) <= k, banded DP (cells beyond the +-k diagonal can
    never come back under k) with row-minimum early exit."""
    if a == b:
        return True
    if k == 0:
        return False
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return False
    if lb == 0:
        return la <= k   # empty band below would crash min()
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        lo = max(1, i - k)
        hi = min(lb, i + k)
        cur = [i] + [k + 1] * lb
        for j in range(lo, hi + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        if min(cur[lo:hi + 1]) > k:
            return False
        prev = cur
    return prev[lb] <= k


def tokenize_text(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN_RX.findall(str(text))]


def _build_postings(raw_values: Iterable[Any]):
    """Shared by the on-disk creator and the scan fallback (semantics cannot drift).
    Returns (sorted tokens, doc_ids CSR, positions CSR, offsets, num_docs)."""
    postings: Dict[str, List[Tuple[int, int]]] = {}
    num_docs = 0
    for doc_id, raw in enumerate(raw_values):
        num_docs += 1
        if raw is None:
            continue
        for pos, tok in enumerate(tokenize_text(raw)):
            postings.setdefault(tok, []).append((doc_id, pos))
    tokens = sorted(postings)
    offsets = np.zeros(len(tokens) + 1, dtype=np.int64)
    doc_chunks, pos_chunks = [], []
    for i, t in enumerate(tokens):
        pairs = postings[t]
        offsets[i + 1] = offsets[i] + len(pairs)
        doc_chunks.append(np.asarray([d for d, _ in pairs], dtype=np.int32))
        pos_chunks.append(np.asarray([p for _, p in pairs], dtype=np.int32))
    doc_ids = np.concatenate(doc_chunks) if doc_chunks else np.empty(0, dtype=np.int32)
    positions = np.concatenate(pos_chunks) if pos_chunks else np.empty(0, dtype=np.int32)
    return tokens, doc_ids, positions, offsets, num_docs


def create_text_index(path: str, raw_values: Iterable[Any]) -> None:
    tokens, doc_ids, positions, offsets, _ = _build_postings(raw_values)
    # tokens are lowercase [A-Za-z0-9_]+ runs, so a \x00 join cannot collide
    blob = "\x00".join(tokens).encode("utf-8")
    np.savez(path, doc_ids=doc_ids, positions=positions, offsets=offsets,
             token_blob=np.frombuffer(blob, dtype=np.uint8))


class _TextMaskOps:
    """The TEXT_MATCH mask algebra over two primitives: `_term_pairs(token)`
    -> (doc ids, positions), in ascending (doc, position) order, and
    `_iter_token_docs()` -> (token, doc id array) pairs. One copy of the
    term, prefix, regex, fuzzy and phrase semantics for the immutable reader
    and the realtime view."""

    num_docs: int

    def _term_pairs(self, token: str) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _iter_token_docs(self):
        raise NotImplementedError

    def mask_for_term(self, token: str) -> np.ndarray:
        m = np.zeros(self.num_docs, dtype=bool)
        docs, _ = self._term_pairs(token.lower())
        m[docs] = True
        return m

    def mask_for_prefix(self, prefix: str) -> np.ndarray:
        prefix = prefix.lower()
        m = np.zeros(self.num_docs, dtype=bool)
        for tok, docs in self._iter_token_docs():
            if tok.startswith(prefix):
                m[docs[docs < self.num_docs]] = True
        return m

    def mask_for_regex(self, pattern: str) -> np.ndarray:
        rx = re.compile(pattern)
        m = np.zeros(self.num_docs, dtype=bool)
        for tok, docs in self._iter_token_docs():
            if rx.fullmatch(tok):
                m[docs[docs < self.num_docs]] = True
        return m

    def mask_for_fuzzy(self, term: str, max_edits: int = 2) -> np.ndarray:
        """Docs containing a token within `max_edits` Levenshtein edits of
        `term` — Lucene fuzzy query semantics (`roam~1` matches foam/roams).
        The reference runs a Lucene FuzzyQuery (Levenshtein automaton);
        here a banded edit-distance scan over the token dictionary — the
        dictionaries are memory-resident and the band prunes each
        comparison to O(len * max_edits)."""
        term = term.lower()
        k = max(0, int(max_edits))
        m = np.zeros(self.num_docs, dtype=bool)
        tl = len(term)
        for tok, docs in self._iter_token_docs():
            if abs(len(tok) - tl) > k:
                continue
            if _edit_distance_at_most(term, tok, k):
                m[docs[docs < self.num_docs]] = True
        return m

    def mask_for_phrase(self, tokens: List[str]) -> np.ndarray:
        """Docs containing the tokens at consecutive positions: the k-th
        token's (doc, position - k) pairs intersected as int64 keys. A
        token's pairs come in ascending (doc, position) order (as
        `_build_postings` writes them and as the realtime index appends
        them), so the keys are sorted and unique and a binary search
        intersects them (the JAX package intersects Python sets of the pairs;
        the answer is the same)."""
        if not tokens:
            return np.ones(self.num_docs, dtype=bool)
        if len(tokens) == 1:
            return self.mask_for_term(tokens[0])
        base: Optional[np.ndarray] = None
        for k, tok in enumerate(tokens):
            docs, poss = self._term_pairs(tok.lower())
            start = poss.astype(np.int64) - k
            keep = start >= 0   # the phrase cannot start before the document
            cur = (docs[keep].astype(np.int64) << 32) | start[keep]
            if base is None:
                base = cur
            elif len(cur):
                at = np.minimum(np.searchsorted(cur, base), len(cur) - 1)
                base = base[cur[at] == base]
            else:
                base = cur
            if not len(base):
                break
        m = np.zeros(self.num_docs, dtype=bool)
        m[base >> 32] = True
        return m

    # -- TEXT_MATCH query ---------------------------------------------------
    def match(self, query: str) -> np.ndarray:
        """Lucene-ish boolean query: terms, "phrases", prefix*, /regex/, AND/OR/NOT, parens.
        Bare whitespace between terms means OR (Lucene default operator)."""
        return _QueryParser(query, self).parse()


class TextIndexReader(_TextMaskOps):
    """TEXT_MATCH over one column's text index file."""

    def __init__(self, path: str, num_docs: int):
        data = np.load(path)
        self._doc_ids = data["doc_ids"]
        self._positions = data["positions"]
        self._offsets = data["offsets"]
        blob = data["token_blob"].tobytes().decode("utf-8")
        self._tokens: List[str] = blob.split("\x00") if blob else []
        self.num_docs = num_docs

    # -- primitives ---------------------------------------------------------
    def _token_index(self, token: str) -> int:
        i = bisect.bisect_left(self._tokens, token)
        return i if i < len(self._tokens) and self._tokens[i] == token else -1

    def _term_pairs(self, token: str) -> Tuple[np.ndarray, np.ndarray]:
        i = self._token_index(token)
        if i < 0:
            return np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int32)
        lo, hi = self._offsets[i], self._offsets[i + 1]
        return self._doc_ids[lo:hi], self._positions[lo:hi]

    def _iter_token_docs(self):
        for i, t in enumerate(self._tokens):
            yield t, self._doc_ids[self._offsets[i]:self._offsets[i + 1]]

    def mask_for_prefix(self, prefix: str) -> np.ndarray:
        # the token array is sorted: a prefix's tokens are one contiguous run
        prefix = prefix.lower()
        lo = bisect.bisect_left(self._tokens, prefix)
        hi = bisect.bisect_left(self._tokens, prefix + "\uffff")
        m = np.zeros(self.num_docs, dtype=bool)
        if lo < hi:
            m[self._doc_ids[self._offsets[lo]:self._offsets[hi]]] = True
        return m


class _QueryParser:
    def __init__(self, q: str, index: _TextMaskOps):
        self.toks = self._lex(q)
        self.i = 0
        self.index = index

    @staticmethod
    def _lex(q: str) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        i = 0
        while i < len(q):
            c = q[i]
            if c.isspace():
                i += 1
            elif c == '"':
                j = q.find('"', i + 1)
                if j < 0:
                    raise ValueError(f"TEXT_MATCH: unterminated phrase quote in {q!r}")
                out.append(("phrase", q[i + 1:j]))
                i = j + 1
            elif c == "/":
                j = q.find("/", i + 1)
                if j < 0:
                    raise ValueError(f"TEXT_MATCH: unterminated /regex/ in {q!r}")
                out.append(("regex", q[i + 1:j]))
                i = j + 1
            elif c in "()":
                out.append((c, c))
                i += 1
            else:
                m = re.match(r"[^\s()]+", q[i:])
                word = m.group(0)
                i += len(word)
                up = word.upper()
                fz = re.fullmatch(r"(.+?)~(\d*)", word)
                if up in ("AND", "OR", "NOT"):
                    out.append((up, up))
                elif word.endswith("*"):
                    out.append(("prefix", word[:-1]))
                elif fz:
                    # Lucene fuzzy: term~ (2 edits) or term~N
                    out.append(("fuzzy", (fz.group(1),
                                          int(fz.group(2) or 2))))
                else:
                    out.append(("term", word))
        return out

    def _peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def parse(self) -> np.ndarray:
        if not self.toks:
            return np.zeros(self.index.num_docs, dtype=bool)
        return self._or()

    def _or(self) -> np.ndarray:
        # Lucene boolean-clause semantics: SHOULD clauses union (implicit or explicit
        # OR), and every bare NOT clause is a must_not on the whole enclosing query —
        # 'a NOT b c' means (a OR c) AND NOT b, regardless of clause order.
        pos: Optional[np.ndarray] = None
        neg: Optional[np.ndarray] = None
        while True:
            t = self._peek()
            if t is None or t[0] == ")":
                break
            if t[0] in ("OR", "AND"):
                # AND binds inside _and(); a stray leading AND degrades to OR
                self.i += 1
                continue
            if t[0] == "NOT":
                self.i += 1
                c = self._unary()
                neg = c if neg is None else (neg | c)
                continue
            c = self._and()
            pos = c if pos is None else (pos | c)
        if pos is None:
            # pure must_not ('NOT b'): everything except the excluded docs
            pos = np.ones(self.index.num_docs, dtype=bool) if neg is not None \
                else np.zeros(self.index.num_docs, dtype=bool)
        return pos & ~neg if neg is not None else pos

    def _and(self) -> np.ndarray:
        left = self._unary()
        while True:
            t = self._peek()
            if t and t[0] == "AND":
                self.i += 1
                left = left & self._unary()
            else:
                return left

    def _unary(self) -> np.ndarray:
        t = self._peek()
        if t and t[0] == "NOT":
            self.i += 1
            return ~self._unary()
        return self._primary()

    def _primary(self) -> np.ndarray:
        t = self._peek()
        if t is None:
            return np.zeros(self.index.num_docs, dtype=bool)
        self.i += 1
        kind, val = t
        if kind == "(":
            inner = self._or()
            if self._peek() and self._peek()[0] == ")":
                self.i += 1
            return inner
        if kind == "phrase":
            return self.index.mask_for_phrase(tokenize_text(val))
        if kind == "prefix":
            return self.index.mask_for_prefix(val)
        if kind == "regex":
            return self.index.mask_for_regex(val)
        if kind == "fuzzy":
            return self.index.mask_for_fuzzy(val[0], val[1])
        return self.index.mask_for_term(val)


class InMemoryTextIndex(TextIndexReader):
    """The text postings of a list of values, built in memory by the same code
    as the index file: the scan resolution of a column without the index."""

    def __init__(self, raw_values: List[Any]):
        (self._tokens, self._doc_ids, self._positions, self._offsets,
         self.num_docs) = _build_postings(raw_values)


class MutableTextIndex:
    """Incrementally maintained text index of a consuming column (the
    reference's realtime Lucene index): TEXT_MATCH over a consuming segment
    does not re-tokenize the whole column per query. A single writer appends
    each document's postings; a query's `view()` freezes the document count,
    so a concurrent append is simply not visible yet."""

    def __init__(self):
        self._postings: Dict[str, List[Tuple[int, int]]] = {}
        self._num_docs = 0

    def add_doc(self, text: Any) -> None:
        d = self._num_docs
        if text is not None:
            for pos, tok in enumerate(tokenize_text(text)):
                self._postings.setdefault(tok, []).append((d, pos))
        # the doc is published after its postings: a concurrent view() sees
        # all of it or none of it
        self._num_docs = d + 1

    def view(self) -> "_MutableTextView":
        return _MutableTextView(self._postings, self._num_docs)


class _MutableTextView(_TextMaskOps):
    """A point-in-time reader over `MutableTextIndex` postings: the mask
    algebra of `_TextMaskOps` over the live postings, cut at `num_docs`."""

    def __init__(self, postings: Dict[str, List[Tuple[int, int]]], num_docs: int):
        self._postings = postings
        self.num_docs = num_docs

    def _term_pairs(self, token: str) -> Tuple[np.ndarray, np.ndarray]:
        # the pairs list only grows; entries past the snapshot are dropped
        pairs = [pr for pr in self._postings.get(token, ()) if pr[0] < self.num_docs]
        docs = np.asarray([d for d, _ in pairs], dtype=np.int32)
        poss = np.asarray([p for _, p in pairs], dtype=np.int32)
        return docs, poss

    def _iter_token_docs(self):
        # list() the live dict: the writer may insert a first-seen token
        # meanwhile, and a dict resized during iteration raises
        for tok, pairs in list(self._postings.items()):
            yield tok, np.asarray([d for d, _ in pairs], dtype=np.int32)


def text_match_scan(raw_values: Iterable[Any], query: str) -> np.ndarray:
    """Index-free fallback: tokenize every row on the fly (slow exact path)."""
    return InMemoryTextIndex(list(raw_values)).match(query)
