"""FST-analog regex index: trigram posting lists over a column's dictionary.

A copy of `pinot_tpu/segment/indexes/fst.py` that writes and reads the same
file. The reference accelerates REGEXP_LIKE with an FST over the sorted
dictionary (`FSTBasedRegexpPredicateEvaluatorFactory`); the same job, "narrow
the dict-id candidates cheaply before running the real regex", is done with
trigram posting lists (the technique of Google Code Search and pg_trgm):
extract the literal substrings a regex requires, intersect their trigram
posting lists into a candidate id set, and run the exact regex only on the
survivors. The filter LUT is the same either way, so the device path is
untouched.

False positives are fine (the exact regex runs on the candidates); false
negatives are not, so the extraction is conservative: when the pattern has no
unconditionally required literal of 3 or more characters, `candidate_ids`
returns None and the caller scans the whole dictionary.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence

import numpy as np

_N = 3  # trigrams


def _grams(s: str) -> List[str]:
    return [s[i:i + _N] for i in range(len(s) - _N + 1)]


def create_fst_index(path: str, dict_values: Sequence[Any]) -> None:
    """Build trigram -> sorted-dict-id CSR postings over the dictionary values.

    Numeric dictionaries index the decimal string form (REGEXP_LIKE on numeric
    columns matches against str(value), same as Dictionary.ids_matching_regex)."""
    postings = {}
    for i, v in enumerate(dict_values):
        if v is None:
            continue
        for g in set(_grams(str(v))):
            postings.setdefault(g, []).append(i)
    grams = sorted(postings)
    offsets = np.zeros(len(grams) + 1, dtype=np.int64)
    chunks = []
    for j, g in enumerate(grams):
        ids = np.asarray(postings[g], dtype=np.int32)
        offsets[j + 1] = offsets[j] + len(ids)
        chunks.append(ids)
    ids = np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int32)
    # grams are length-prefixed (byte lengths alongside one blob): dictionary
    # values are arbitrary strings, so a separator-joined blob would corrupt
    # on values containing the separator
    encoded = [g.encode("utf-8") for g in grams]
    blob = b"".join(encoded)
    gram_lens = np.asarray([len(e) for e in encoded], dtype=np.int32)
    np.savez(path, ids=ids, offsets=offsets, gram_lens=gram_lens,
             gram_blob=np.frombuffer(blob, dtype=np.uint8))


class FstIndexReader:
    def __init__(self, path: str):
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        self._ids = z["ids"]
        self._offsets = z["offsets"]
        blob = z["gram_blob"].tobytes()
        self._grams = []
        pos = 0
        for ln in z["gram_lens"]:
            self._grams.append(blob[pos:pos + int(ln)].decode("utf-8"))
            pos += int(ln)
        self._gram_pos = {g: j for j, g in enumerate(self._grams)}

    def _postings(self, gram: str) -> Optional[np.ndarray]:
        j = self._gram_pos.get(gram)
        if j is None:
            return np.empty(0, dtype=np.int32)  # gram absent -> no value has it
        return self._ids[self._offsets[j]:self._offsets[j + 1]]

    def candidate_ids(self, pattern: str) -> Optional[np.ndarray]:
        """Sorted dict-id candidates for a regex, or None when the pattern has
        no required literal long enough to index (caller falls back to a full
        dictionary scan)."""
        literals = required_literals(pattern)
        best: Optional[np.ndarray] = None
        for lit in literals:
            gs = _grams(lit)
            if not gs:
                continue
            acc: Optional[np.ndarray] = None
            for g in gs:
                p = self._postings(g)
                acc = p if acc is None else _intersect(acc, p)
                if len(acc) == 0:
                    return acc
            if acc is not None and (best is None or len(acc) < len(best)):
                best = acc
        return best


def _intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.intersect1d(a, b, assume_unique=True)


def ids_matching_regex_indexed(index: FstIndexReader, dict_values,
                               pattern: str) -> Optional[np.ndarray]:
    """Exact REGEXP_LIKE dict-id set using the index to prefilter; None when the
    pattern is not indexable (caller does the full scan)."""
    cands = index.candidate_ids(pattern)
    if cands is None:
        return None
    rx = re.compile(pattern)
    out = [int(i) for i in cands
           if rx.search(str(dict_values[int(i)])) is not None]
    return np.asarray(out, dtype=np.int64)


# -- conservative required-literal extraction --------------------------------

_SPECIAL = set(".^$*+?{}[]|()\\")


def required_literals(pattern: str) -> List[str]:
    """Literal substrings every match MUST contain, each >= 3 chars.

    Conservative subset of regex syntax: walks the top level of the pattern,
    collecting runs of plain characters. A run is cut (and its last char
    dropped) when followed by `*`, `?`, `{0,...}` (char optional), or `|`
    anywhere at top level voids everything (either branch may match). Groups,
    classes, anchors and escapes end the current run but keep what was
    collected. Returns [] when nothing >= 3 chars survives — never a literal
    that some match could avoid."""
    if not pattern:
        return []
    if re.search(r"\(\?[aiLmsux-]", pattern):
        # inline flags (e.g. (?i) case-insensitive) change matching semantics
        # the trigram index can't honor — fall back to the full scan
        return []
    out: List[str] = []
    run: List[str] = []
    i, n = 0, len(pattern)

    def flush():
        if len(run) >= _N:
            out.append("".join(run))
        run.clear()

    while i < n:
        c = pattern[i]
        if c == "|":
            return []  # top-level alternation: no literal is required
        if c == "\\":
            # escaped char: \. is a literal dot, but \d etc. are classes —
            # treat all escapes as run breaks (conservative)
            flush()
            i += 2
            continue
        if c in "([":
            flush()
            # skip the whole group/class (nested for groups)
            if c == "[":
                j = i + 1
                if j < n and pattern[j] == "^":
                    j += 1
                if j < n and pattern[j] == "]":
                    j += 1
                while j < n and pattern[j] != "]":
                    j += 2 if pattern[j] == "\\" else 1
                i = j + 1
            else:
                d = 1
                j = i + 1
                while j < n and d:
                    if pattern[j] == "\\":
                        j += 1
                    elif pattern[j] == "(":
                        d += 1
                    elif pattern[j] == ")":
                        d -= 1
                    j += 1
                i = j
            # a quantifier on the group makes it optional either way; skip it
            if i < n and pattern[i] in "*+?{":
                i = _skip_quantifier(pattern, i)
            continue
        if c in "*?":
            if run:
                run.pop()  # previous char is optional/repeatable-from-zero
            flush()
            i += 1
            continue
        if c == "+":
            # previous char required at least once; keep it, but the run can't
            # extend through the repetition
            flush()
            i += 1
            continue
        if c == "{":
            j = _skip_quantifier(pattern, i)
            body = pattern[i + 1:j - 1] if j > i + 1 else ""
            min_rep = body.split(",")[0]
            if run and (not min_rep.isdigit() or int(min_rep) == 0):
                run.pop()
            flush()
            i = j
            continue
        if c in _SPECIAL:  # . ^ $ ) ] } — break the run
            flush()
            i += 1
            continue
        run.append(c)
        i += 1
    flush()
    return out


def _skip_quantifier(pattern: str, i: int) -> int:
    if pattern[i] in "*+?":
        return i + 1
    j = pattern.find("}", i)
    return (j + 1) if j != -1 else i + 1
