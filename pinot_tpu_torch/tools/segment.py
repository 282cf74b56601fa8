"""Segment tools: dump (metadata + sample rows) and verify (integrity check).

A copy of `pinot_tpu/tools/segment.py` (the analog of the reference's
`SegmentDumpTool`, `ValidateSegmentCommand` and `CrcUtils`): inspect what a segment directory holds
and prove it loads, decodes, and matches its recorded CRC.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..segment import format as fmt
from ..segment.reader import load_segment


def dump_segment(seg_dir: str, max_rows: int = 10) -> Dict[str, Any]:
    """Human-oriented summary: metadata, per-column stats, first rows."""
    seg = load_segment(seg_dir)
    cols: Dict[str, Any] = {}
    for name in seg.column_names:
        r = seg.column(name)
        cols[name] = {
            "dataType": r.data_type.value,
            "hasDictionary": r.has_dictionary,
            "cardinality": r.cardinality,
            "sorted": bool(r.meta.get("sorted", False)),
            "multiValue": getattr(r, "is_multi_value", False),
            "indexes": r.index_types,
            "minValue": _js(r.min_value),
            "maxValue": _js(r.max_value),
            "hasNulls": bool(r.meta.get("hasNulls", False)),
        }
    n = min(max_rows, seg.num_docs)
    sample_cols = {c: _head_values(seg.column(c), n) for c in seg.column_names}
    rows = [[_js(sample_cols[c][i]) for c in seg.column_names] for i in range(n)]
    return {
        "segmentName": seg.name,
        "tableName": seg.metadata.get("tableName"),
        "totalDocs": seg.num_docs,
        "formatVersion": seg.metadata.get("formatVersion"),
        "crc": fmt.read_json(os.path.join(seg_dir, fmt.CREATION_META_FILE))["crc"],
        "columns": cols,
        "sampleColumns": seg.column_names,
        "sampleRows": rows,
        "starTrees": len(seg.star_trees),
    }


def _head_values(reader, n: int) -> List[Any]:
    """First n decoded values WITHOUT materializing the whole column — dumping
    10 sample rows of a 10M-doc segment must not decode 10M values."""
    if getattr(reader, "is_multi_value", False):
        off = np.asarray(reader.mv_offsets)[:n + 1]
        flat = reader.dictionary.take(
            np.asarray(reader.fwd[:off[-1]]).astype(np.int64))
        return [flat[off[i]:off[i + 1]] for i in range(n)]
    head = np.asarray(reader.fwd[:n])
    if not reader.has_dictionary:
        return list(head)
    return list(reader.dictionary.take(head.astype(np.int64)))


def verify_segment(seg_dir: str) -> Dict[str, Any]:
    """Integrity checks; returns {ok, checks: [{name, ok, detail}]}.

    Checks: metadata parse, CRC match, every column's forward index loads with
    the advertised row count, dictionaries decode every id, MV offsets are
    monotonic and cover the flat index, null bitmaps sized right.
    """
    checks: List[Dict[str, Any]] = []

    def check(name: str, fn) -> bool:
        try:
            detail = fn()
            checks.append({"name": name, "ok": True, "detail": detail or ""})
            return True
        except Exception as e:
            checks.append({"name": name, "ok": False,
                           "detail": f"{type(e).__name__}: {e}"})
            return False

    seg_holder: Dict[str, Any] = {}

    def load():
        seg_holder["seg"] = load_segment(seg_dir)
        return f"{seg_holder['seg'].num_docs} docs"
    if not check("load", load):
        return {"ok": False, "checks": checks}
    seg = seg_holder["seg"]

    def crc():
        recorded = fmt.read_json(
            os.path.join(seg_dir, fmt.CREATION_META_FILE))["crc"]
        actual = fmt.segment_crc(seg_dir)
        if recorded != actual:
            raise ValueError(f"recorded {recorded} != actual {actual}")
        return f"crc {actual}"
    check("crc", crc)

    for name in seg.column_names:
        def col_check(name=name):
            r = seg.column(name)
            if getattr(r, "is_multi_value", False):
                off = np.asarray(r.mv_offsets)
                if len(off) != r.num_docs + 1:
                    raise ValueError(f"mv offsets length {len(off)}")
                if (np.diff(off) < 0).any():
                    raise ValueError("mv offsets not monotonic")
                if off[-1] != len(r.fwd):
                    raise ValueError(f"mv offsets end {off[-1]} != flat {len(r.fwd)}")
            elif len(r.fwd) != r.num_docs:
                raise ValueError(f"fwd rows {len(r.fwd)} != docs {r.num_docs}")
            if r.has_dictionary:
                ids = np.asarray(r.fwd)
                if len(ids) and int(ids.max()) >= r.cardinality:
                    raise ValueError(f"dict id {int(ids.max())} out of range")
                r.dictionary.take(np.asarray([0, max(0, r.cardinality - 1)],
                                             dtype=np.int64))
            nb = r.null_bitmap
            if nb is not None and len(nb) != r.num_docs:
                raise ValueError(f"null bitmap length {len(nb)}")
            return "ok"
        check(f"column:{name}", col_check)

    return {"ok": all(c["ok"] for c in checks), "checks": checks}


def _js(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.hex()
    return v
