"""Filter compilation: predicate AST + segment dictionaries -> device filter program.

A subset of `pinot_tpu/query/predicate.py` (analog of the reference's predicate
evaluators, `pinot-core/.../operator/filter/predicate/`). Every predicate over
a dict-encoded column is resolved host-side against the *sorted dictionary*
into a boolean lookup table (LUT) over dict ids, usually one or a few
contiguous id intervals; REGEXP_LIKE over a column with an FST index narrows
the dictionary scan to the index's candidates first. Predicates over raw
numeric columns and expressions compile to comparisons with scalar operands.

A distance predicate over two coordinate columns is rewritten to elementwise
haversine math (`engine.geo_fns.rewrite_geo`) and compiles to a comparison
leaf like any expression; where the segment has a geo cell index over the
column pair, the index's candidate mask (a `DocSetLeaf`) is ANDed with it.
JSON_MATCH and TEXT_MATCH resolve on the host into a per-doc mask, a
`DocSetLeaf`, through the column's JSON or text index, or, over a column
without one (a consuming segment's), by scanning its values.
`IN_ID_SET(col, 'literal')` over a dictionary column resolves the serialized
`IdSet` against the sorted dictionary into a LUT leaf (`op="idset"`), and
over a raw column into a `DocSetLeaf`. Those four may be used bare or
compared to 1 or 0. The device filter reads a `DocSetLeaf` as one bool row.
IS NULL and IS NOT NULL compile to `NullLeaf`s over the column's null
bitmap.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union

import numpy as np

from ..engine.datablock import lut_size
from ..engine.geo_fns import distance_predicate_parts, rewrite_geo
from ..segment.indexes.fst import ids_matching_regex_indexed
from ..segment.indexes.jsonidx import InMemoryJsonIndex
from ..segment.indexes.text import InMemoryTextIndex
from ..segment.reader import ColumnReader, ImmutableSegment
from ..sql.ast import Expr, Function, Identifier, Literal
from .context import QueryValidationError

# filter tree: ("and"|"or", (children...)) | ("not", child) | ("leaf", index) | ("const", bool)
FilterTree = Tuple


# A LUT whose true-set decomposes into at most this many contiguous id runs is
# evaluated as interval compares over the id vector. Sorted dictionaries make
# this the common case: EQ is one run, RANGE is one run, small IN-lists are <= k runs.
MAX_LUT_INTERVALS = 8

_ID_SET_PREDICATES = {"in_id_set", "inidset"}
# boolean transform functions, used bare or as `f(...) = 1` / `= 0`
_BOOL_PREDICATES = _ID_SET_PREDICATES | {"json_match", "text_match"}


def _as_bool(v) -> Optional[bool]:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in ("true", "false"):
        return v.lower() == "true"
    return None


def _lut_intervals(lut: np.ndarray) -> Optional[List[Tuple[int, int]]]:
    """Decompose a boolean LUT into inclusive [lo, hi] runs of True, or None if the
    decomposition exceeds MAX_LUT_INTERVALS (dense scattered sets: big IN / LIKE)."""
    idx = np.flatnonzero(lut)
    if len(idx) == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    if len(breaks) + 1 > MAX_LUT_INTERVALS:
        return None
    starts = np.concatenate(([idx[0]], idx[breaks + 1]))
    ends = np.concatenate((idx[breaks], [idx[-1]]))
    return [(int(lo), int(hi)) for lo, hi in zip(starts, ends)]


@dataclass
class LutLeaf:
    """Dict-column predicate resolved to a boolean LUT over dict ids.

    `intervals` is the contiguous-run decomposition of the LUT (None when the
    true-set is too scattered for id-range compares)."""
    col: str
    lut: np.ndarray  # bool[lut_size(card)] — padding ids map to False
    intervals: Optional[List[Tuple[int, int]]] = field(default=None)
    # source predicate (op + literal values), kept so that the LUT can be
    # rebuilt against another dictionary snapshot (a consuming segment's ids
    # remap as its sorted dictionary grows). Not part of signature().
    op: Optional[str] = field(default=None)
    values: Optional[List[Any]] = field(default=None)

    def __post_init__(self):
        if self.intervals is None:
            self.intervals = _lut_intervals(self.lut)

    def rebuild_lut(self, dictionary, cardinality: int) -> np.ndarray:
        """The same predicate resolved against another dictionary snapshot."""
        return build_lut(self.op, self.values, dictionary, cardinality)

    def signature(self) -> Tuple:
        # the interval count is structural (the bounds are runtime inputs); a
        # scattered LUT keys on its size only, its contents are runtime too
        mode = len(self.intervals) if self.intervals is not None else "dense"
        return ("lut", self.col, len(self.lut), mode)


@dataclass
class CmpLeaf:
    """Comparison of a device-evaluable numeric expression against scalar operands.

    op in {eq, gt, gte, lt, lte, between, in}; `is_int` compares in int32,
    otherwise in float32."""
    expr: Expr
    op: str
    operands: List[Any]
    is_int: bool

    def signature(self) -> Tuple:
        return ("cmp", repr(self.expr), self.op, len(self.operands), self.is_int)


@dataclass
class NullLeaf:
    col: str
    negated: bool  # True for IS NOT NULL

    def signature(self) -> Tuple:
        return ("null", self.col, self.negated)


@dataclass
class DocSetLeaf:
    """A predicate resolved on the host into a per-doc mask: JSON_MATCH,
    TEXT_MATCH, a geo cell index's candidates, IN_ID_SET over a raw column.
    The mask is a runtime input of the device filter, one padded bool row.

    `cache_token` identifies the mask's contents on a given immutable segment
    (the kind and every predicate parameter); the set path caches its stacked
    masks under it. Not part of `signature()`: the mask is a runtime input."""
    col: str
    mask: np.ndarray   # bool[num_docs]
    cache_token: str = ""
    desc: str = ""     # what resolved the mask, as EXPLAIN shows it

    def signature(self) -> Tuple:
        return ("docset", self.col)


Leaf = Union[LutLeaf, CmpLeaf, NullLeaf, DocSetLeaf]


@dataclass
class FilterProgram:
    tree: FilterTree = ("const", True)
    leaves: List[Leaf] = field(default_factory=list)

    def signature(self) -> Tuple:
        """The program's structure without its literal operands."""
        return (self.tree, tuple(leaf.signature() for leaf in self.leaves))

    @property
    def is_match_all(self) -> bool:
        return self.tree == ("const", True)


_NEGATIONS = {"neq": "eq", "not_in": "in", "not_like": "like"}


def compile_filter(expr: Optional[Expr], segment: ImmutableSegment) -> FilterProgram:
    """Compile a WHERE tree for one segment (per-segment because dictionaries,
    and therefore LUT contents, are per-segment)."""
    prog = FilterProgram()
    if expr is None:
        return prog
    prog.tree = _compile_node(expr, segment, prog.leaves)
    prog.tree = _simplify(prog.tree)
    return prog


def _compile_node(e: Expr, seg: ImmutableSegment, leaves: List[Leaf]) -> FilterTree:
    if isinstance(e, Literal):
        return ("const", bool(e.value))
    if isinstance(e, Identifier):
        raise QueryValidationError(f"bare column {e.name!r} is not a boolean predicate")
    assert isinstance(e, Function)
    name = e.name
    if name == "and":
        return ("and", tuple(_compile_node(a, seg, leaves) for a in e.args))
    if name == "or":
        return ("or", tuple(_compile_node(a, seg, leaves) for a in e.args))
    if name == "not":
        return ("not", _compile_node(e.args[0], seg, leaves))
    if name in _NEGATIONS:
        return ("not", _compile_node(Function(_NEGATIONS[name], e.args), seg, leaves))
    if name == "eq" and len(e.args) == 2:
        # `TEXT_MATCH(col, '...') = 1` / `= 0`, the reference's comparison form
        # of a boolean transform function: the bare predicate or its negation
        for fn, lit in (e.args, e.args[::-1]):
            if isinstance(fn, Function) and fn.name in _BOOL_PREDICATES \
                    and isinstance(lit, Literal) and _as_bool(lit.value) is not None:
                node = _compile_node(fn, seg, leaves)
                return node if _as_bool(lit.value) else ("not", node)
    if name in ("is_null", "is_not_null"):
        col = e.args[0]
        if not isinstance(col, Identifier):
            raise QueryValidationError("IS NULL requires a plain column")
        leaves.append(NullLeaf(col.name, negated=(name == "is_not_null")))
        return ("leaf", len(leaves) - 1)
    if name in ("json_match", "text_match"):
        return _compile_search(e, seg, leaves)
    if name in _ID_SET_PREDICATES:
        return _compile_id_set(e, seg, leaves)
    geo = _try_geo_predicate(e, seg, leaves)
    if geo is not None:
        return geo
    if name in ("stwithin", "stcontains", "stequals"):
        # a boolean geo function used bare as a predicate: compare it to true
        return _compile_predicate(Function("eq", (e, Literal(1))), seg, leaves)
    return _compile_predicate(e, seg, leaves)


def _compile_id_set(e: Function, seg: ImmutableSegment, leaves: List[Leaf]) -> FilterTree:
    """Membership against a serialized IdSet literal (reference:
    InIdSetTransformFunction): a LUT over a dictionary column's sorted
    dictionary, a host doc mask over a raw column."""
    from .idset import IdSet, IdSetError
    if len(e.args) != 2 or not isinstance(e.args[0], Identifier) \
            or not isinstance(e.args[1], Literal):
        raise QueryValidationError(f"IN_ID_SET(column, 'serialized-idset') expected: {e!r}")
    col, lit = e.args[0], e.args[1]
    try:
        ids = IdSet.deserialize(str(lit.value))
    except IdSetError as exc:
        raise QueryValidationError(str(exc)) from exc
    reader = seg.column(col.name)
    if not reader.has_dictionary:
        # the serialized literal is the set: its digest addresses the mask
        digest = hashlib.sha1(str(lit.value).encode()).hexdigest()
        leaves.append(DocSetLeaf(col.name, ids.contains(reader.values()),
                                 cache_token=f"idset:{digest}", desc=f"idset[{len(ids)}]"))
        return ("leaf", len(leaves) - 1)
    lut = build_lut("idset", [ids], reader.dictionary, reader.cardinality)
    leaves.append(LutLeaf(col.name, lut, op="idset", values=[ids]))
    return ("leaf", len(leaves) - 1)


def _compile_search(e: Function, seg: ImmutableSegment, leaves: List[Leaf]) -> FilterTree:
    """JSON_MATCH / TEXT_MATCH: the column's index resolves the filter into a
    doc mask; a column without the index (a consuming segment's) is scanned."""
    name = e.name
    if len(e.args) != 2 or not isinstance(e.args[0], Identifier) \
            or not isinstance(e.args[1], Literal):
        raise QueryValidationError(f"{name.upper()}(column, 'filter') expected: {e!r}")
    col, query = e.args[0].name, str(e.args[1].value)
    reader = seg.column(col)
    idx = getattr(reader, "json_index" if name == "json_match" else "text_index", None)
    try:
        mask = (idx if idx is not None else _scan_index(reader, name)).match(query)
    except (ValueError, IndexError, KeyError) as exc:
        raise QueryValidationError(f"{name.upper()}: {exc}") from exc
    leaves.append(DocSetLeaf(col, mask, cache_token=f"{name}:{query}", desc=query))
    return ("leaf", len(leaves) - 1)


def _scan_index(reader, name: str):
    """The scan resolution of a column without a JSON or text index: the
    postings its values build (`json_match_scan` / `text_match_scan`, the JAX
    package's fallback), kept on the reader with the row count they cover, so
    that a column's later queries at that count do not scan it again (the
    JAX package scans on every query)."""
    kept = reader.__dict__.setdefault("_scan_indexes", {})
    entry = kept.get(name)
    if entry is None or entry[0] != reader.num_docs:
        build = InMemoryJsonIndex if name == "json_match" else InMemoryTextIndex
        entry = (reader.num_docs, build(list(reader.values())))
        kept[name] = entry
    return entry[1]


def _try_geo_predicate(e: Function, seg: ImmutableSegment,
                       leaves: List[Leaf]) -> Optional[FilterTree]:
    """`ST_DISTANCE(ST_POINT(lngCol, latCol), <const point>) < r` over a
    segment with a geo cell index on the column pair: the index's candidate
    mask ANDed with the exact haversine compare (the reference's H3 coarse
    cover and exact refine, H3IndexFilterOperator). None for any other
    predicate, and for a segment without the index: the predicate then
    compiles to the compare alone."""
    parts = distance_predicate_parts(e)
    if parts is None:
        return None
    lng_col, lat_col, cx, cy, radius = parts
    getter = getattr(seg, "geo_index", None)
    geo_idx = getter(lng_col, lat_col) if getter is not None else None
    if geo_idx is None:
        return None
    exact = _compile_predicate(e, seg, leaves)
    leaves.append(DocSetLeaf(f"{lng_col},{lat_col}",
                             geo_idx.candidate_mask(cx, cy, radius, seg.num_docs),
                             cache_token=f"geo:{cx!r}:{cy!r}:{radius!r}",
                             desc=f"geo cells r={radius:g}m"))
    return ("and", (("leaf", len(leaves) - 1), exact))


def _compile_predicate(e: Function, seg: ImmutableSegment, leaves: List[Leaf]) -> FilterTree:
    lhs = e.args[0]
    rhs = list(e.args[1:])
    # normalize `literal op column` to `column op' literal`
    if isinstance(lhs, Literal) and len(rhs) == 1 and not isinstance(rhs[0], Literal):
        flip = {"eq": "eq", "gt": "lt", "gte": "lte", "lt": "gt", "lte": "gte"}
        if e.name in flip:
            lhs, rhs = rhs[0], [lhs]
            e = Function(flip[e.name], (lhs, *rhs))
    # after the flip, so that `r > stdistance(...)` rewrites too: a distance
    # over coordinate columns becomes elementwise device haversine math
    lhs = rewrite_geo(lhs)
    if not all(isinstance(r, Literal) for r in rhs):
        raise QueryValidationError(f"predicate operands must be literals: {e!r}")
    values = [r.value for r in rhs]

    # dictionary-encoded single-column predicate -> LUT leaf
    if isinstance(lhs, Identifier):
        reader = seg.column(lhs.name)
        if reader.has_dictionary:
            leaves.append(LutLeaf(lhs.name, _build_lut(e.name, values, reader),
                                  op=e.name, values=values))
            return ("leaf", len(leaves) - 1)

    # raw column / expression predicate -> comparison leaf
    op, operands, is_int, const = _normalize_cmp(e.name, values, lhs, seg)
    if const is not None:
        return ("const", const)
    leaves.append(CmpLeaf(lhs, op, operands, is_int))
    return ("leaf", len(leaves) - 1)


def _build_lut(op: str, values: List[Any], reader: ColumnReader) -> np.ndarray:
    return build_lut(op, values, reader.dictionary, reader.cardinality,
                     fst_index=getattr(reader, "fst_index", None))


def build_lut(op: str, values: List[Any], d, cardinality: int,
              fst_index=None) -> np.ndarray:
    """Resolve a predicate against a sorted dictionary into a bool LUT over ids.
    REGEXP_LIKE with an `fst_index` runs the regex on the index's candidates
    only, and over the whole dictionary when the pattern has no literal the
    index can use."""
    lut = np.zeros(lut_size(cardinality), dtype=bool)
    if op == "idset":
        if cardinality:
            lut[:cardinality] = values[0].contains(d._np_values)
    elif op == "eq":
        i = d.index_of(values[0])
        if i >= 0:
            lut[i] = True
    elif op == "in":
        lut[d.ids_for_values(values)] = True
    elif op == "between":
        lo, hi = d.id_range(values[0], values[1])
        lut[lo:hi] = True
    elif op in ("gt", "gte"):
        lo, hi = d.id_range(values[0], None, lower_inclusive=(op == "gte"))
        lut[lo:hi] = True
    elif op in ("lt", "lte"):
        lo, hi = d.id_range(None, values[0], upper_inclusive=(op == "lte"))
        lut[lo:hi] = True
    elif op == "like":
        lut[d.ids_matching_like(str(values[0]))] = True
    elif op == "regexp_like":
        ids = None
        if fst_index is not None:
            ids = ids_matching_regex_indexed(fst_index, d.values, str(values[0]))
        if ids is None:
            ids = d.ids_matching_regex(str(values[0]))
        lut[ids] = True
    else:
        raise QueryValidationError(f"unsupported predicate {op} on dictionary column")
    return lut


def _normalize_cmp(op: str, values: List[Any], lhs: Expr, seg: ImmutableSegment):
    """Normalize operands for a raw/expression compare; returns (op, operands, is_int, const).

    const is a bool when the predicate folds to a constant (e.g. `int_col = 2.5` -> False).
    """
    is_int = _expr_is_integer(lhs, seg)
    if op == "like" or op == "regexp_like":
        raise QueryValidationError("LIKE/REGEXP on raw (non-dictionary) columns is unsupported")
    if not is_int:
        return op, [float(v) for v in values], False, None

    # integer expression: normalize float literals to exact integer comparisons
    if op == "eq":
        v = values[0]
        if float(v) != int(v):
            return op, [], True, False
        return op, [int(v)], True, None
    if op == "in":
        ints = [int(v) for v in values if float(v) == int(v)]
        if not ints:
            return op, [], True, False
        return op, ints, True, None
    if op == "between":
        lo, hi = math.ceil(values[0]), math.floor(values[1])
        if lo > hi:
            return op, [], True, False
        return op, [lo, hi], True, None
    if op == "gt":
        return "gte", [math.floor(values[0]) + 1], True, None
    if op == "gte":
        return "gte", [math.ceil(values[0])], True, None
    if op == "lt":
        return "lte", [math.ceil(values[0]) - 1], True, None
    if op == "lte":
        return "lte", [math.floor(values[0])], True, None
    raise QueryValidationError(f"unsupported comparison {op}")


def _expr_is_integer(e: Expr, seg: ImmutableSegment) -> bool:
    """Conservatively: integer iff all leaves are integer columns/literals and ops preserve
    integrality (no divide)."""
    if isinstance(e, Literal):
        return isinstance(e.value, int) and not isinstance(e.value, bool)
    if isinstance(e, Identifier):
        reader = seg.column(e.name)
        return np.dtype(reader.meta["fwdDtype"]).kind in "iu" and (
            not reader.has_dictionary or reader.data_type.is_numeric)
    if isinstance(e, Function):
        if e.name in ("plus", "minus", "times", "mod"):
            return all(_expr_is_integer(a, seg) for a in e.args)
        return False
    return False


def _simplify(tree: FilterTree) -> FilterTree:
    """Constant-fold and flatten (reference: filter optimizer, `core/query/optimizer/filter/`)."""
    kind = tree[0]
    if kind in ("and", "or"):
        absorb, identity = (False, True) if kind == "and" else (True, False)
        children = []
        for c in tree[1]:
            c = _simplify(c)
            if c[0] == "const":
                if c[1] == absorb:
                    return ("const", absorb)
                continue  # identity: drop
            if c[0] == kind:  # flatten nested and(and(...))
                children.extend(c[1])
            else:
                children.append(c)
        if not children:
            return ("const", identity)
        if len(children) == 1:
            return children[0]
        return (kind, tuple(children))
    if kind == "not":
        c = _simplify(tree[1])
        if c[0] == "const":
            return ("const", not c[1])
        if c[0] == "not":
            return c[1]
        return ("not", c)
    return tree
