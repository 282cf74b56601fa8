"""Star-tree index: pre-aggregated record table + split tree, built per segment.

A copy of `pinot_tpu/segment/startree.py` (the reference's star-tree:
`BaseSingleTreeBuilder`, `StarTreeIndexContainer`, `OffHeapStarTree`), writing
and reading the same files under `<segment>/startree/st<i>/`. The record table
is a miniature segment (`StarTreeView`: dict-id dimension columns sharing the
parent's dictionaries, raw pre-aggregated metric columns `$count` and
`$<func>__<col>`) that the regular executor runs a rewritten query over
(`query/startree_exec.py`). The tree walk (`StarTree.traverse`) happens on the
host and gives a record mask, which rides the executor's `valid_docs`. Star
entries hold dict id == cardinality, the out-of-dictionary id the device
padding already reserves (`engine/datablock.py`): every LUT maps it to False,
every id band excludes it, and `bitmap_words` sets no bit for it.

Record invariant (the reference builder's): within any node's record range,
records are sorted lexicographically by the remaining split-order dimensions,
and a dimension holds the star id only if the path to the node descended
through that dimension's star child. Aggregating all records of any set of
disjoint leaf ranges therefore counts each document once, provided star
children are taken exactly for the dimensions the query does not reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..schema import DataType, FieldRole, FieldSpec, Schema
from . import format as fmt

STAR_NODE_VALUE = -1          # node table: "this child aggregates over its dimension"
DEFAULT_MAX_LEAF_RECORDS = 10000

TREE_FILE = "tree.npz"
RECORDS_FILE = "records.npz"
CONFIG_FILE = "config.json"

# metric column naming inside the pre-aggregated table
COUNT_COL = "$count"


def metric_col(func: str, col: str) -> str:
    return f"${func}__{col}"


# functions that can be *stored* as mergeable pre-aggregations
_STORABLE = ("sum", "min", "max")
# expansion of requested pairs into storable pairs (reference: AggregationFunctionType
# pairs AVG -> (sum, count); MINMAXRANGE -> (min, max))
_EXPAND = {"avg": ("sum",), "minmaxrange": ("min", "max"),
           "sum": ("sum",), "min": ("min",), "max": ("max",), "count": ()}


@dataclass
class StarTreeIndexConfig:
    """Analog of `pinot-spi/.../config/table/StarTreeIndexConfig.java`."""

    dimensions_split_order: List[str]
    function_column_pairs: List[str] = field(default_factory=list)  # "SUM__colName"
    max_leaf_records: int = DEFAULT_MAX_LEAF_RECORDS
    skip_star_node_creation: List[str] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {
            "dimensionsSplitOrder": self.dimensions_split_order,
            "functionColumnPairs": self.function_column_pairs,
            "maxLeafRecords": self.max_leaf_records,
            "skipStarNodeCreationForDimensions": self.skip_star_node_creation,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "StarTreeIndexConfig":
        return cls(
            dimensions_split_order=list(d["dimensionsSplitOrder"]),
            function_column_pairs=list(d.get("functionColumnPairs", [])),
            max_leaf_records=d.get("maxLeafRecords", DEFAULT_MAX_LEAF_RECORDS),
            skip_star_node_creation=list(d.get("skipStarNodeCreationForDimensions", [])),
        )

    def storable_pairs(self) -> Set[Tuple[str, str]]:
        """(func, col) pairs to materialize, with AVG/MINMAXRANGE expanded."""
        out: Set[Tuple[str, str]] = set()
        for p in self.function_column_pairs:
            func, _, col = p.partition("__")
            func = func.lower()
            if func not in _EXPAND:
                raise ValueError(f"unsupported star-tree function pair {p!r}")
            for f in _EXPAND[func]:
                out.add((f, col))
        return out


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _reducer_for(col_name: str):
    base = col_name[1:].split("__", 1)[0]
    return {"count": np.add, "sum": np.add, "min": np.minimum, "max": np.maximum}[base]


def _merge_sorted(ids: np.ndarray, metrics: Dict[str, np.ndarray],
                  key_cols: Sequence[int]) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Merge consecutive records with equal key columns (records pre-sorted by them)."""
    n = len(ids)
    if n == 0:
        return ids, metrics
    if key_cols:
        keys = ids[:, list(key_cols)]
        change = np.any(keys[1:] != keys[:-1], axis=1)
        starts = np.concatenate([[0], np.nonzero(change)[0] + 1]).astype(np.int64)
    else:
        starts = np.zeros(1, dtype=np.int64)
    out_ids = ids[starts].copy()
    out_metrics = {name: _reducer_for(name).reduceat(arr, starts)
                   for name, arr in metrics.items()}
    return out_ids, out_metrics


class _Node:
    __slots__ = ("value", "start", "end", "children")

    def __init__(self, value: int, start: int, end: int):
        self.value = value
        self.start = start
        self.end = end
        self.children: List["_Node"] = []


def build_star_tree(segment, config: StarTreeIndexConfig, index: int = 0) -> str:
    """Build one star-tree for a loaded immutable segment; writes
    `<segment>/startree/st<index>/` and returns that path.

    Mirrors `BaseSingleTreeBuilder.build()`: sort + dedup base records, then split
    recursively along the dimension order, appending aggregated star records.
    """
    dims = config.dimensions_split_order
    ndim = len(dims)
    if ndim == 0:
        raise ValueError("star-tree needs at least one dimension")
    readers = [segment.column(d) for d in dims]
    for r in readers:
        if not r.has_dictionary:
            raise ValueError(f"star-tree dimension {r.name} must be dict-encoded")
    cards = [r.cardinality for r in readers]
    skip = set(config.skip_star_node_creation)
    n = segment.num_docs

    if n:
        ids = np.stack([np.asarray(r.fwd).astype(np.int32) for r in readers], axis=1)
    else:
        ids = np.zeros((0, ndim), dtype=np.int32)
    metrics: Dict[str, np.ndarray] = {COUNT_COL: np.ones(n, dtype=np.int64)}
    for func, col in sorted(config.storable_pairs()):
        metrics[metric_col(func, col)] = np.asarray(
            segment.column(col).values(), dtype=np.float64)

    if n:
        order = np.lexsort([ids[:, j] for j in reversed(range(ndim))])
        ids = ids[order]
        metrics = {k: v[order] for k, v in metrics.items()}
    ids, metrics = _merge_sorted(ids, metrics, range(ndim))

    id_chunks: List[np.ndarray] = [ids]
    metric_chunks: Dict[str, List[np.ndarray]] = {k: [v] for k, v in metrics.items()}
    total = [len(ids)]

    def build(blk_ids: np.ndarray, blk_metrics: Dict[str, np.ndarray],
              gstart: int, depth: int, value: int) -> _Node:
        node = _Node(value, gstart, gstart + len(blk_ids))
        if depth == ndim or len(blk_ids) <= config.max_leaf_records:
            return node
        col = blk_ids[:, depth]  # sorted ascending within this node's range
        change = np.nonzero(col[1:] != col[:-1])[0] + 1
        run_starts = np.concatenate([[0], change, [len(col)]]).astype(np.int64)
        for ri in range(len(run_starts) - 1):
            s, e = int(run_starts[ri]), int(run_starts[ri + 1])
            child = build(blk_ids[s:e], {k: v[s:e] for k, v in blk_metrics.items()},
                          gstart + s, depth + 1, int(col[s]))
            node.children.append(child)
        if dims[depth] not in skip and len(run_starts) > 2:
            star_ids = blk_ids.copy()
            star_ids[:, depth] = cards[depth]  # record STAR id == cardinality
            rest = list(range(depth + 1, ndim))
            if rest:
                order2 = np.lexsort([star_ids[:, j] for j in reversed(rest)])
                star_ids = star_ids[order2]
                star_metrics = {k: v[order2] for k, v in blk_metrics.items()}
            else:
                star_metrics = dict(blk_metrics)
            star_ids, star_metrics = _merge_sorted(star_ids, star_metrics, rest)
            sg = total[0]
            id_chunks.append(star_ids)
            for k in metric_chunks:
                metric_chunks[k].append(star_metrics[k])
            total[0] += len(star_ids)
            star_child = build(star_ids, star_metrics, sg, depth + 1, STAR_NODE_VALUE)
            node.children.append(star_child)
        return node

    root = build(ids, metrics, 0, 0, STAR_NODE_VALUE)

    all_ids = np.concatenate(id_chunks, axis=0) if id_chunks else ids
    all_metrics = {k: np.concatenate(chunks) for k, chunks in metric_chunks.items()}

    # flatten nodes breadth-first so each node's children are contiguous
    nodes: List[_Node] = [root]
    child_start = [0]
    child_end = [0]
    qi = 0
    while qi < len(nodes):
        nd = nodes[qi]
        child_start[qi] = len(nodes)
        nodes.extend(nd.children)
        child_end[qi] = len(nodes)
        child_start.extend(0 for _ in nd.children)
        child_end.extend(0 for _ in nd.children)
        qi += 1

    out_dir = os.path.join(segment.path, fmt.STARTREE_DIR, f"st{index}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, TREE_FILE),
             value=np.asarray([nd.value for nd in nodes], dtype=np.int32),
             start=np.asarray([nd.start for nd in nodes], dtype=np.int64),
             end=np.asarray([nd.end for nd in nodes], dtype=np.int64),
             child_start=np.asarray(child_start, dtype=np.int64),
             child_end=np.asarray(child_end, dtype=np.int64))
    rec_payload = {f"dim:{d}": all_ids[:, j] for j, d in enumerate(dims)}
    rec_payload.update({f"met:{k}": v for k, v in all_metrics.items()})
    np.savez(os.path.join(out_dir, RECORDS_FILE), **rec_payload)
    fmt.write_json(os.path.join(out_dir, CONFIG_FILE), {
        **config.to_json(),
        "numRecords": int(len(all_ids)),
        "cardinalities": {d: int(c) for d, c in zip(dims, cards)},
    })
    return out_dir


# ---------------------------------------------------------------------------
# load + traverse
# ---------------------------------------------------------------------------

class _ViewColumn:
    """Duck-typed ColumnReader over an in-memory array (dims share the parent
    segment's dictionary; metrics are raw pre-aggregated values)."""

    inverted_index = None
    range_index = None
    bloom_filter = None
    null_bitmap = None
    is_multi_value = False
    index_types: List[str] = []

    def __init__(self, name: str, data_type: DataType, arr: np.ndarray,
                 dictionary=None, cardinality: int = 0):
        self.name = name
        self.data_type = data_type
        self.fwd = arr
        self.num_docs = len(arr)
        self.dictionary = dictionary
        self.has_dictionary = dictionary is not None
        self.cardinality = cardinality
        if dictionary is not None:
            self.meta = {"dataType": data_type.value, "hasDictionary": True,
                         "cardinality": cardinality, "fwdDtype": str(arr.dtype)}
            self._min = self._max = None
        else:
            self.meta = {"dataType": data_type.value, "hasDictionary": False,
                         "cardinality": -1, "fwdDtype": str(arr.dtype)}
            if len(arr):
                self._min, self._max = arr.min().item(), arr.max().item()
            else:
                self._min = self._max = None

    @property
    def min_value(self):
        return self._min

    @property
    def max_value(self):
        return self._max

    def values(self) -> np.ndarray:
        if self.dictionary is None:
            return self.fwd
        # star ids clip to the last dict entry; such records are never *selected*
        # (the traversal mask excludes them for every query dimension), decode is
        # only unsafe if something reads unselected rows — clipping keeps that safe.
        clipped = np.clip(np.asarray(self.fwd).astype(np.int64), 0,
                          max(self.cardinality - 1, 0))
        return self.dictionary.take(clipped)


class StarTreeView:
    """The pre-aggregated record table exposed as a queryable mini-segment."""

    is_mutable = False
    star_trees: List[Any] = []

    def __init__(self, tree: "StarTree", parent):
        self.path = tree.path
        self.name = f"{parent.name}!st"
        self.num_docs = tree.num_records
        self._columns: Dict[str, _ViewColumn] = {}
        specs: List[FieldSpec] = []
        for d in tree.dims:
            preader = parent.column(d)
            col = _ViewColumn(d, preader.data_type, tree.dim_ids[d],
                              preader.dictionary, preader.cardinality)
            # propagate the parent's dictionary hash: aligned parents make
            # aligned views, which the stacked device star path requires
            if preader.meta.get("dictHash") is not None:
                col.meta["dictHash"] = preader.meta["dictHash"]
            self._columns[d] = col
            specs.append(FieldSpec(d, preader.data_type))
        for mname, arr in tree.metric_arrays.items():
            dt = DataType.LONG if arr.dtype.kind == "i" else DataType.DOUBLE
            self._columns[mname] = _ViewColumn(mname, dt, arr)
            specs.append(FieldSpec(mname, dt, role=FieldRole.METRIC))
        self.schema = Schema(self.name, specs)
        self.metadata = {"columns": {c: col.meta for c, col in self._columns.items()}}

    def column(self, name: str) -> _ViewColumn:
        if name not in self._columns:
            raise KeyError(f"star-tree view: no column {name!r}")
        return self._columns[name]

    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())


class StarTree:
    """A loaded star-tree: config + node arrays + record arrays."""

    def __init__(self, path: str, parent):
        self.path = path
        self.parent = parent
        cfg = fmt.read_json(os.path.join(path, CONFIG_FILE))
        self.config = StarTreeIndexConfig.from_json(cfg)
        self.dims: List[str] = self.config.dimensions_split_order
        self.num_records: int = cfg["numRecords"]
        self.cards: Dict[str, int] = {d: int(c) for d, c in cfg["cardinalities"].items()}
        tree = np.load(os.path.join(path, TREE_FILE))
        self.node_value = tree["value"]
        self.node_start = tree["start"]
        self.node_end = tree["end"]
        self.node_child_start = tree["child_start"]
        self.node_child_end = tree["child_end"]
        recs = np.load(os.path.join(path, RECORDS_FILE))
        self.dim_ids: Dict[str, np.ndarray] = {}
        self.metric_arrays: Dict[str, np.ndarray] = {}
        for key in recs.files:
            kind, _, name = key.partition(":")
            if kind == "dim":
                self.dim_ids[name] = recs[key]
            else:
                self.metric_arrays[name] = recs[key]

    @cached_property
    def view(self) -> StarTreeView:
        return StarTreeView(self, self.parent)

    def storable_pairs(self) -> Set[Tuple[str, str]]:
        return self.config.storable_pairs()

    def traverse(self, query_dims: Set[str],
                 prune_luts: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        """Select the record ranges answering a query touching `query_dims`.

        Reference: `StarTreeFilterOperator` tree walk. Descend rules per split
        dimension d:
        * d has a conjunctive predicate LUT -> matching concrete children only;
        * d otherwise referenced by the query -> all concrete children;
        * d not referenced -> the star child (or all concrete children if the star
          node was skipped at build).
        Leaves contribute their record range; remaining predicates are re-applied by
        the regular filter program over the selected records.
        """
        prune_luts = prune_luts or {}
        mask = np.zeros(self.num_records, dtype=bool)
        stack: List[Tuple[int, int]] = [(0, 0)]
        while stack:
            ni, depth = stack.pop()
            cs, ce = int(self.node_child_start[ni]), int(self.node_child_end[ni])
            if cs == ce:  # leaf
                mask[self.node_start[ni]:self.node_end[ni]] = True
                continue
            d = self.dims[depth]
            if d in prune_luts:
                lut = prune_luts[d]
                for ci in range(cs, ce):
                    v = int(self.node_value[ci])
                    if v >= 0 and bool(lut[v]):
                        stack.append((ci, depth + 1))
            elif d in query_dims:
                for ci in range(cs, ce):
                    if int(self.node_value[ci]) >= 0:
                        stack.append((ci, depth + 1))
            else:
                star = [ci for ci in range(cs, ce)
                        if int(self.node_value[ci]) == STAR_NODE_VALUE]
                if star:
                    stack.append((star[0], depth + 1))
                else:
                    stack.extend((ci, depth + 1) for ci in range(cs, ce))
        return mask


def load_star_trees(segment) -> List[StarTree]:
    base = os.path.join(segment.path, fmt.STARTREE_DIR)
    if not os.path.isdir(base):
        return []
    trees = []
    for name in sorted(os.listdir(base)):
        sub = os.path.join(base, name)
        if os.path.isfile(os.path.join(sub, CONFIG_FILE)):
            trees.append(StarTree(sub, segment))
    return trees
