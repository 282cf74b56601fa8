"""JSON index: flattened json-paths -> doc-id posting lists, powering JSON_MATCH.

A copy of `pinot_tpu/segment/indexes/jsonidx.py` that writes and reads the
same file (the analog of the reference's json index,
`ImmutableJsonIndexReader.java` and `OffHeapJsonIndexCreator.java`): every
document's JSON is flattened into `path=value` keys (arrays under
`path[*]`), each key holding a sorted posting list of doc ids. A JSON_MATCH
filter is parsed into a predicate tree over paths and resolved against the
posting lists into one doc mask on the host; the device filter reads it as a
`DocSetLeaf`, one bool row, as the reference's JsonMatchFilterOperator
produces a bitmap before the scan.

Key layout: keys are `"<path>\\x00<value>"` strings plus `"<path>\\x01"`
presence keys, sorted, with CSR postings: a range predicate over a path
binary-searches the contiguous key run of that path. Keys persist as one
utf-8 blob with an offsets array (key text may hold any code point).
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np

from ...sql.ast import Expr, Function, Identifier
from ...sql.parser import Parser

SEP = "\x00"          # path/value separator inside a key
PRESENCE = "\x01"     # marks a path-presence key (sorts before any SEP key of same path)


def flatten_json(obj: Any, prefix: str = "$") -> Iterable[Tuple[str, str]]:
    """Yield (path, value-string) pairs; arrays flatten under `path[*]` like the reference
    (`jsonIndexConfig` default: arrays indexed element-wise)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from flatten_json(v, f"{prefix}.{k}")
    elif isinstance(obj, list):
        for v in obj:
            yield from flatten_json(v, f"{prefix}[*]")
    elif obj is None:
        return
    else:
        if isinstance(obj, bool):
            obj = "true" if obj else "false"
        yield prefix, str(obj)


def _build_postings(raw_values: Iterable[Any]) -> Tuple[List[str], np.ndarray, np.ndarray, int]:
    """Shared by the on-disk creator and the index-free scan fallback, so their match
    semantics cannot drift. Returns (sorted keys, doc_ids CSR, offsets, num_docs)."""
    postings: Dict[str, List[int]] = {}
    num_docs = 0
    for doc_id, raw in enumerate(raw_values):
        num_docs += 1
        if raw is None or raw == "":
            continue
        try:
            obj = json.loads(raw) if isinstance(raw, (str, bytes)) else raw
        except (json.JSONDecodeError, TypeError):
            continue
        seen_paths = set()
        for p, v in flatten_json(obj):
            postings.setdefault(p + SEP + v, []).append(doc_id)
            if p not in seen_paths:
                seen_paths.add(p)
                postings.setdefault(p + PRESENCE, []).append(doc_id)
    keys = sorted(postings)
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    chunks = []
    for i, k in enumerate(keys):
        ids = postings[k]
        offsets[i + 1] = offsets[i] + len(ids)
        chunks.append(np.asarray(ids, dtype=np.int32))
    doc_ids = np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int32)
    return keys, doc_ids, offsets, num_docs


def _encode_keys(keys: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Length-delimited utf-8 blob + byte offsets (key text may contain any codepoint)."""
    encoded = [k.encode("utf-8") for k in keys]
    key_offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=key_offsets[1:])
    blob = b"".join(encoded)
    return np.frombuffer(blob, dtype=np.uint8).copy(), key_offsets


def _decode_keys(blob_arr: np.ndarray, key_offsets: np.ndarray) -> List[str]:
    blob = blob_arr.tobytes()
    return [blob[key_offsets[i]:key_offsets[i + 1]].decode("utf-8")
            for i in range(len(key_offsets) - 1)]


def create_json_index(path: str, raw_values: Iterable[Any]) -> None:
    """Build the index file from per-doc JSON strings (or already-parsed objects)."""
    keys, doc_ids, offsets, _ = _build_postings(raw_values)
    key_blob, key_offsets = _encode_keys(keys)
    np.savez(path, doc_ids=doc_ids, offsets=offsets,
             key_blob=key_blob, key_offsets=key_offsets)


class JsonIndexReader:
    def __init__(self, path: str, num_docs: int):
        data = np.load(path)
        self._doc_ids = data["doc_ids"]
        self._offsets = data["offsets"]
        self._keys = _decode_keys(data["key_blob"], data["key_offsets"])
        self.num_docs = num_docs

    # -- posting primitives -------------------------------------------------
    def _postings_at(self, i: int) -> np.ndarray:
        return self._doc_ids[self._offsets[i]:self._offsets[i + 1]]

    def _find(self, key: str) -> int:
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            return i
        return -1

    def _key_run(self, path: str) -> Tuple[int, int]:
        """[lo, hi) of value-keys for a path (contiguous in the sorted key array).

        Upper bound is the successor of the separator character so the run covers
        every value string, including code points above U+FFFF."""
        lo = bisect.bisect_left(self._keys, path + SEP)
        hi = bisect.bisect_left(self._keys, path + chr(ord(SEP) + 1))
        return lo, hi

    def mask_for_key(self, path: str, value: Any) -> np.ndarray:
        m = np.zeros(self.num_docs, dtype=bool)
        # numeric literals serialize as either 1 or 1.0 depending on the source doc; a
        # mixed corpus needs both forms unioned (_forms yields both)
        for f in self._forms(value):
            i = self._find(path + SEP + f)
            if i >= 0:
                m[self._postings_at(i)] = True
        return m

    @staticmethod
    def _forms(value: Any) -> List[str]:
        if isinstance(value, bool):
            return ["true" if value else "false"]
        forms = [str(value)]
        if isinstance(value, (int, float)):
            if isinstance(value, int):
                forms.append(str(float(value)))
            elif value == int(value):
                forms.append(str(int(value)))
        return forms

    def mask_for_not_values(self, path: str, values: List[Any]) -> np.ndarray:
        """Docs where SOME flattened record at `path` has a value outside `values` —
        the reference evaluates <> / NOT IN per flattened record, so a doc with array
        values [1, 2] matches `<> 1` (record 2 satisfies it)."""
        excluded = {f for v in values for f in self._forms(v)}
        lo, hi = self._key_run(path)
        m = np.zeros(self.num_docs, dtype=bool)
        for i in range(lo, hi):
            if self._keys[i].split(SEP, 1)[1] not in excluded:
                m[self._postings_at(i)] = True
        return m

    def mask_for_presence(self, path: str) -> np.ndarray:
        m = np.zeros(self.num_docs, dtype=bool)
        i = self._find(path + PRESENCE)
        if i >= 0:
            m[self._postings_at(i)] = True
        return m

    def mask_for_range(self, path: str, op: str, operand: Any) -> np.ndarray:
        """Range over a path: scan that path's key run, numeric-compare parsed values."""
        lo, hi = self._key_run(path)
        m = np.zeros(self.num_docs, dtype=bool)
        want = float(operand)
        for i in range(lo, hi):
            vs = self._keys[i].split(SEP, 1)[1]
            try:
                v = float(vs)
            except ValueError:
                continue
            ok = ((op == "gt" and v > want) or (op == "gte" and v >= want)
                  or (op == "lt" and v < want) or (op == "lte" and v <= want))
            if ok:
                m[self._postings_at(i)] = True
        return m

    # -- JSON_MATCH evaluation ---------------------------------------------
    def match(self, filter_sql: str) -> np.ndarray:
        """Evaluate a JSON_MATCH filter string -> doc mask.

        Grammar mirrors the reference (`JsonMatchFilterOperator`): a SQL-ish predicate
        over double-quoted json paths, e.g. `"$.a.b" = 'v' AND "$.arr[*].x" > 3`,
        with =, <>, IN, range ops, IS [NOT] NULL, AND/OR/NOT.
        """
        tree = parse_json_match(filter_sql)
        return self._eval(tree)

    def _eval(self, e: Expr) -> np.ndarray:
        if not isinstance(e, Function):
            raise ValueError(f"bad JSON_MATCH node {e!r}")
        name = e.name
        if name == "and":
            out = self._eval(e.args[0])
            for a in e.args[1:]:
                out = out & self._eval(a)
            return out
        if name == "or":
            out = self._eval(e.args[0])
            for a in e.args[1:]:
                out = out | self._eval(a)
            return out
        if name == "not":
            return ~self._eval(e.args[0])
        path = e.args[0]
        if not isinstance(path, Identifier):
            raise ValueError(f"JSON_MATCH lhs must be a path: {e!r}")
        p = path.name
        if name == "is_null":
            return ~self.mask_for_presence(p)
        if name == "is_not_null":
            return self.mask_for_presence(p)
        values = [a.value for a in e.args[1:]]
        if name == "eq":
            return self.mask_for_key(p, values[0])
        if name == "neq":
            return self.mask_for_not_values(p, values)
        if name == "not_in":
            return self.mask_for_not_values(p, values)
        if name == "in":
            m = np.zeros(self.num_docs, dtype=bool)
            for v in values:
                m |= self.mask_for_key(p, v)
            return m
        if name in ("gt", "gte", "lt", "lte"):
            return self.mask_for_range(p, name, values[0])
        if name == "between":
            return self.mask_for_range(p, "gte", values[0]) \
                & self.mask_for_range(p, "lte", values[1])
        raise ValueError(f"JSON_MATCH: unsupported predicate {name!r}")


def parse_json_match(filter_sql: str) -> Expr:
    """Parse the JSON_MATCH sub-language by mapping double-quoted paths to placeholder
    identifiers and reusing the main SQL expression parser. The substitution is
    single-quote-aware: double quotes inside SQL string literals are left alone."""
    paths: List[str] = []
    out: List[str] = []
    i = 0
    n = len(filter_sql)
    while i < n:
        c = filter_sql[i]
        if c == "'":
            # copy a single-quoted literal verbatim ('' is the escaped quote)
            j = i + 1
            while j < n:
                if filter_sql[j] == "'":
                    if j + 1 < n and filter_sql[j + 1] == "'":
                        j += 2
                        continue
                    break
                j += 1
            out.append(filter_sql[i:j + 1])
            i = j + 1
        elif c == '"':
            j = filter_sql.index('"', i + 1)
            paths.append(filter_sql[i + 1:j])
            out.append(f"__jp{len(paths) - 1}__")
            i = j + 1
        else:
            out.append(c)
            i += 1
    text = "".join(out)
    stmt = Parser(f"SELECT 1 FROM t WHERE {text}").parse()

    def rewrite(e: Expr) -> Expr:
        if isinstance(e, Identifier):
            m = re.fullmatch(r"__jp(\d+)__", e.name)
            if m:
                return Identifier(paths[int(m.group(1))])
            return e
        if isinstance(e, Function):
            return Function(e.name, tuple(rewrite(a) for a in e.args), distinct=e.distinct)
        return e

    return rewrite(stmt.where)


def json_match_scan(raw_values: Iterable[Any], filter_sql: str) -> np.ndarray:
    """Index-free exact fallback for un-indexed columns (slow path; the reference requires
    the index for JSON_MATCH — supporting the fallback keeps queries correct everywhere)."""
    return InMemoryJsonIndex(list(raw_values)).match(filter_sql)


class InMemoryJsonIndex(JsonIndexReader):
    """The JSON postings of a list of values, built in memory by the same code
    as the index file: the scan resolution of a column without the index."""

    def __init__(self, raw_values: List[Any]):
        self._keys, self._doc_ids, self._offsets, self.num_docs = _build_postings(raw_values)
