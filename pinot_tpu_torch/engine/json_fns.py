"""JSON transform/scalar functions (host only).

A copy of `pinot_tpu/engine/json_fns.py` (analog of the reference's
JsonExtractScalarTransformFunction / JsonFunctions,
`pinot-common/.../function/scalar/JsonFunctions.java`). Operates on decoded
JSON string columns; json-path is the `$.a.b[i]` / `$.a[*]` subset the
reference's default configuration supports. JSON never reaches the device.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional

import numpy as np

from .expr import _FUNCTIONS, register_function


class _Wildcard:
    """Sentinel for the [*] / .* path step (distinct from a key literally named '*')."""

    def __repr__(self) -> str:
        return "*"


WILDCARD = _Wildcard()


def parse_json_path(path: str) -> List[Any]:
    """'$.a.b[3][*].c' -> ['a', 'b', 3, WILDCARD, 'c']."""
    assert path.startswith("$"), f"json path must start with $: {path!r}"
    out: List[Any] = []
    i = 1
    while i < len(path):
        c = path[i]
        if c == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            seg = path[i + 1:j]
            out.append(WILDCARD if seg == "*" else seg)
            i = j
        elif c == "[":
            j = path.index("]", i)
            raw = path[i + 1:j]
            tok = raw.strip("'\"")
            if raw == "*":
                out.append(WILDCARD)  # quoted ['*'] stays a literal dict key
            elif raw != tok or not _is_int(tok):
                out.append(tok)  # quoted (or non-numeric) bracket token -> dict key
            else:
                out.append(int(tok))
            i = j + 1
        else:
            raise ValueError(f"bad json path {path!r} at {i}")
    return [p for p in out if p != ""]


def _is_int(s: str) -> bool:
    return s.lstrip("-").isdigit()


def extract_path(obj: Any, steps: List[Any]) -> Any:
    """Walk parsed JSON; WILDCARD fans out into a list of matches."""
    cur: List[Any] = [obj]
    for s in steps:
        nxt: List[Any] = []
        for o in cur:
            if s is WILDCARD:
                if isinstance(o, list):
                    nxt.extend(o)
                elif isinstance(o, dict):
                    nxt.extend(o.values())
            elif isinstance(s, int):
                if isinstance(o, list) and -len(o) <= s < len(o):
                    nxt.append(o[s])
            elif isinstance(o, dict) and s in o:
                nxt.append(o[s])
        cur = nxt
    if not cur:
        return None
    return cur if len(cur) > 1 else cur[0]


_CASTERS = {
    "INT": lambda v: int(float(v)), "LONG": lambda v: int(float(v)),
    "FLOAT": float, "DOUBLE": float, "STRING": str, "BOOL": bool, "BOOLEAN": bool,
    "INT_ARRAY": lambda v: [int(float(x)) for x in _as_list(v)],
    "LONG_ARRAY": lambda v: [int(float(x)) for x in _as_list(v)],
    "DOUBLE_ARRAY": lambda v: [float(x) for x in _as_list(v)],
    "STRING_ARRAY": lambda v: [str(x) for x in _as_list(v)],
}


def _as_list(v):
    return v if isinstance(v, list) else [v]


def _loads(raw) -> Optional[Any]:
    if raw is None or raw == "":
        return None
    if isinstance(raw, (dict, list)):
        return raw
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, TypeError):
        return None


@register_function("json_extract_scalar")
def _json_extract_scalar(xp, col, path, result_type, default=None):
    if xp is not np:
        raise ValueError("JSON_EXTRACT_SCALAR is host-side only")
    steps = parse_json_path(str(path))
    cast = _CASTERS[str(result_type).upper()]

    def one(raw):
        obj = _loads(raw)
        v = extract_path(obj, steps) if obj is not None else None
        if v is None:
            return default
        try:
            return cast(v)
        except (ValueError, TypeError):
            return default

    arr = np.asarray(col)
    if arr.ndim == 0:
        return one(arr.item())
    out = [one(x) for x in arr.ravel()]
    rt = str(result_type).upper()
    dtype = (np.int64 if rt in ("INT", "LONG") and all(v is not None for v in out)
             else np.float64 if rt in ("FLOAT", "DOUBLE") and all(v is not None for v in out)
             else object)
    return np.asarray(out, dtype=dtype).reshape(arr.shape)


@register_function("json_extract_key")
def _json_extract_key(xp, col, path):
    """Keys present under a path (reference JsonExtractKeyTransformFunction)."""
    if xp is not np:
        raise ValueError("JSON_EXTRACT_KEY is host-side only")
    steps = parse_json_path(str(path))

    def one(raw):
        obj = _loads(raw)
        v = extract_path(obj, steps) if obj is not None else None
        if isinstance(v, dict):
            return sorted(v.keys())
        return []
    arr = np.asarray(col)
    if arr.ndim == 0:
        return one(arr.item())
    return np.asarray([one(x) for x in arr.ravel()], dtype=object).reshape(arr.shape)


@register_function("json_format")
def _json_format(xp, col):
    if xp is not np:
        raise ValueError("JSON_FORMAT is host-side only")

    def one(raw):
        obj = _loads(raw)
        return json.dumps(obj, separators=(",", ":"), sort_keys=True) if obj is not None \
            else "null"
    arr = np.asarray(col)
    if arr.ndim == 0:
        return one(arr.item())
    return np.asarray([one(x) for x in arr.ravel()], dtype=object).reshape(arr.shape)


# reference jsonPath* scalar spellings (JsonFunctions.java) map onto the
# json_extract_scalar machinery: same path syntax, type pinned per name
def _register_jsonpath_aliases():
    def make(out_type, sentinel):
        def fn(xp, v, path, *default):
            # numeric sentinels keep the result arrays numeric on missing
            # paths (reference: jsonPathLong -> Long.MIN_VALUE,
            # jsonPathDouble -> NaN) — a None would poison comparisons
            args = [v, path, out_type,
                    default[0] if default else sentinel]
            return _FUNCTIONS["json_extract_scalar"](xp, *args)
        return fn
    _FUNCTIONS["jsonpathstring"] = make("STRING", None)
    _FUNCTIONS["jsonpathlong"] = make("LONG", -(1 << 63))
    _FUNCTIONS["jsonpathdouble"] = make("DOUBLE", float("nan"))
    _FUNCTIONS["jsonpath"] = make("STRING", None)


_register_jsonpath_aliases()
