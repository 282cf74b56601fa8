"""Expression evaluators and the scalar function library.

Counterpart of `pinot_tpu/engine/expr.py` (analog of the reference's
vectorized transform functions, `pinot-core/.../operator/transform/function/`,
and the scalar `FunctionRegistry`): arithmetic, comparison, logical, CASE,
CAST and a library of scalar functions over whole column batches. The JAX
package has one evaluator generic over numpy and jax.numpy; this package has
two over one registry:

* `eval_host(e, columns)`: numpy, for the host aggregation path, the host
  filter mask, the selection gather, ingestion transforms and the reduce.
  Every registered function (`_FUNCTIONS`: this module's math, array and
  packing functions, and those of `datetime_fns`, `string_fns`, `json_fns`
  and `geo_fns`) runs here.
* `eval_device(e, columns)`: torch tensors, for the device filter, aggregate
  arguments and the scan's operand rows. It takes exactly `DEVICE_FUNCS`, the
  JAX planner's `_DEVICE_FUNCS`: the constructs (CASE, CAST, IN, BETWEEN,
  AND/OR/NOT), the binary operators and comparisons, and the registered math,
  trig and calendar functions, each run with `TORCH` as its array namespace.

The device is 32-bit, as the JAX device path is: columns arrive as int32 or
float32, literals stay Python scalars so that PyTorch's promotion matches
jax.numpy's weak typing (int32 column * 2.5 is float32, int32 column + 1
stays int32), every result is narrowed to int32/float32 (`_narrow_dtype`),
CAST to LONG gives int32 and CAST to DOUBLE float32, and `//` and `%` are
floored (torch's `//` and `remainder`, never `fmod`). An int32 product that
leaves the int32 range wraps, as it does in jax.numpy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ..segment.reader import MVValues
from ..sql.ast import Expr, Function, Identifier, Literal

# Scalar/transform function registry: name -> (xp, *args) -> array, where xp is
# numpy on the host and `TORCH` on the device (reference: TransformFunctionFactory
# and the scalar @ScalarFunction registry, `FunctionRegistry.java:39`).
_FUNCTIONS: Dict[str, Callable] = {}


def register_function(name: str):
    def deco(fn):
        _FUNCTIONS[name.lower()] = fn
        return fn
    return deco


def _lookup(columns: Mapping[str, Any], name: str):
    try:
        return columns[name]
    except KeyError:
        raise KeyError(f"expression references unbound column {name!r}") from None


# -- host (numpy) evaluator ------------------------------------------------------

def eval_host(e: Expr, columns: Mapping[str, Any]):
    """Evaluate an expression with numpy over a column environment: `columns`
    maps identifier name -> array (decoded values, or whatever the caller
    wants identifiers to mean: the reduce binds aggregation results)."""
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, Identifier):
        return _lookup(columns, e.name)
    assert isinstance(e, Function)
    name, args = e.name, e.args
    if name in ("and", "or"):
        out = _as_bool(eval_host(args[0], columns))
        for a in args[1:]:
            v = _as_bool(eval_host(a, columns))
            out = (out & v) if name == "and" else (out | v)
        return out
    if name == "not":
        return ~_as_bool(eval_host(args[0], columns))
    if name == "case":
        # case(w1, t1, ..., wn, tn, default): right fold of np.where, the
        # first true WHEN winning (see _case_pairs)
        out = eval_host(args[-1], columns)
        for w, t in _case_pairs(args):
            out = np.where(_as_bool(eval_host(w, columns)), eval_host(t, columns), out)
        return out
    if name == "cast":
        return _cast(eval_host(args[0], columns), args[1].value)
    if name in ("in", "not_in"):
        needle = eval_host(args[0], columns)
        out = None
        for a in args[1:]:
            m = needle == eval_host(a, columns)
            out = m if out is None else (out | m)
        return ~out if name == "not_in" else out
    if name == "between":
        v = eval_host(args[0], columns)
        return (v >= eval_host(args[1], columns)) & (v <= eval_host(args[2], columns))
    binop = _BINOPS.get(name)
    if binop is not None:
        return binop(eval_host(args[0], columns), eval_host(args[1], columns))
    fn = _FUNCTIONS.get(name)
    if fn is not None:
        return fn(np, *[eval_host(a, columns) for a in args])
    raise KeyError(f"unknown function {name!r}")


def _case_pairs(args):
    """(WHEN, THEN) pairs of case(w1, t1, ..., wn, tn, default), last first,
    for a right fold. The JAX package's fold reads each WHEN one argument to
    the left of its place (`args[i - 1]` beside `args[i]`), so that there a
    CASE tests its default or a THEN value instead of its WHEN."""
    return [(args[i], args[i + 1]) for i in range(len(args) - 3, -1, -2)]


def _as_bool(v):
    if isinstance(v, bool):
        return v
    return v.astype(bool) if hasattr(v, "astype") else bool(v)


def _true_div(l, r):
    # SQL semantics: `/` is float division whatever the operand types
    l = l * 1.0 if not np.isscalar(l) else float(l)
    return l / r


_BINOPS = {
    "plus": lambda l, r: l + r,
    "minus": lambda l, r: l - r,
    "times": lambda l, r: l * r,
    "divide": _true_div,
    "mod": lambda l, r: l % r,   # floored on numpy and on torch (remainder)
    "eq": lambda l, r: l == r,
    "neq": lambda l, r: l != r,
    "gt": lambda l, r: l > r,
    "gte": lambda l, r: l >= r,
    "lt": lambda l, r: l < r,
    "lte": lambda l, r: l <= r,
}


def _cast(val, target: str):
    target = str(target).upper()
    if target in ("INT", "INTEGER"):
        return _astype(val, np.int32)
    if target in ("LONG", "BIGINT"):
        return _astype(val, np.int64)
    if target in ("FLOAT",):
        return _astype(val, np.float32)
    if target in ("DOUBLE",):
        return _astype(val, np.float64)
    if target in ("BOOLEAN",):
        return _astype(val, bool)
    if target in ("STRING", "VARCHAR"):
        return np.asarray(val).astype(str)
    raise ValueError(f"unsupported CAST target {target}")


def _astype(val, dtype):
    if hasattr(val, "astype"):
        return val.astype(dtype)
    return np.dtype(dtype).type(val) if dtype is not bool else bool(val)


# -- device (torch) evaluator ------------------------------------------------------

# SQL `/` is float division whatever the operand types
_DEVICE_BINOPS = dict(_BINOPS, divide=lambda l, r: _device_div(
    l * 1.0 if isinstance(l, torch.Tensor) else float(l), r))
_DEVICE_CASTS = {"INT": torch.int32, "INTEGER": torch.int32, "LONG": torch.int32,
                 "BIGINT": torch.int32, "FLOAT": torch.float32, "DOUBLE": torch.float32,
                 "BOOLEAN": torch.bool}
_SCALAR_CASTS = {torch.int32: int, torch.float32: float, torch.bool: bool}
_STRUCTURAL = frozenset({"and", "or", "not", "case", "cast", "in", "not_in", "between"})
# registered functions the device runs besides the calendar ones (the JAX
# planner's _DEVICE_FUNCS, less its constructs, operators and datetime names)
_DEVICE_MATH = frozenset({
    "abs", "ceil", "floor", "exp", "ln", "log10", "log2", "log", "sqrt", "power", "round",
    "least", "greatest", "sign", "truncate", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "cot", "atan2", "degrees", "radians"})


def _narrow_dtype(v):
    """The device's 32-bit result: int64 -> int32, float64 -> float32. Only
    small values reach int64 (a Python int meeting a bool tensor), so the
    narrowing changes no value."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.int64:
            return v.to(torch.int32)
        if v.dtype == torch.float64:
            return v.to(torch.float32)
    return v


def _weak_tensor(v, like=None) -> torch.Tensor:
    """A Python scalar as a 0-dim tensor in jax.numpy's 32-bit weak types (on
    `like`'s device), or a tensor as it is."""
    if isinstance(v, torch.Tensor):
        return v
    dtype = (torch.bool if isinstance(v, (bool, np.bool_)) else
             torch.int32 if isinstance(v, (int, np.integer)) else torch.float32)
    return torch.tensor(v, dtype=dtype,
                        device=like.device if isinstance(like, torch.Tensor) else None)


def _promoted(a, b, like=None):
    """(a, b) as tensors of one dtype on one device: torch's promotion of
    tensors and Python scalars (weak, as in jax.numpy), narrowed to 32 bits."""
    if like is None:
        like = a if isinstance(a, torch.Tensor) else b
    dtype = torch.result_type(a, b)
    dtype = {torch.int64: torch.int32, torch.float64: torch.float32}.get(dtype, dtype)
    return _weak_tensor(a, like).to(dtype), _weak_tensor(b, like).to(dtype)


def _device_div(l, r):
    """True IEEE division on the device. A Python-scalar divisor becomes a
    tensor on the dividend's device first: PyTorch's CUDA kernel multiplies
    by a scalar divisor's f32 reciprocal, an ulp off (21 / 7 gives 3.0000002,
    so ceil(21 / 7) would be 4 on the card and 3 on the host)."""
    if isinstance(l, torch.Tensor) and not isinstance(r, torch.Tensor):
        r = _weak_tensor(r, l).to(torch.promote_types(l.dtype, _weak_tensor(r).dtype))
    return l / r


def _unary(op):
    return lambda v: op(_weak_tensor(v))


def _binary(op):
    return lambda a, b: op(*_promoted(a, b))


def _transcendental(op, host_op):
    """A float function (sqrt, ln, exp, the trig family) with f32 results. On
    a CUDA tensor, torch's kernel; on a CPU tensor, numpy's float32 function
    over the whole row in the calling thread. Torch's CPU kernel splits a
    row between its intra-op threads, and at two threads the second thread's
    half of a row of ln / sqrt values came out ~2e-4 relative off in 2 of 37
    runs of the smoke's CPU rehearsals (the same call right after was exact):
    the CPU result must not depend on the thread split. An integer argument
    is promoted to f32 first, as torch promotes it."""
    def f(*vs):
        ts = _promoted(*vs) if len(vs) > 1 else (_weak_tensor(vs[0]),)
        if ts[0].device.type != "cpu":
            return op(*ts)
        xs = [t if t.is_floating_point() else t.to(torch.float32) for t in ts]
        with np.errstate(all="ignore"):
            out = host_op(*[x.numpy() for x in xs])
        return torch.from_numpy(np.asarray(out, dtype=xs[0].numpy().dtype))
    return f


class _TorchNamespace:
    """The numpy names the device functions call (`xp.where`, `xp.sin`, ...),
    over torch tensors and Python scalars, with jax.numpy's 32-bit results."""

    abs = staticmethod(_unary(torch.abs))
    ceil = staticmethod(_unary(torch.ceil))
    floor = staticmethod(_unary(torch.floor))
    exp = staticmethod(_transcendental(torch.exp, np.exp))
    log = staticmethod(_transcendental(torch.log, np.log))
    log10 = staticmethod(_transcendental(torch.log10, np.log10))
    log2 = staticmethod(_transcendental(torch.log2, np.log2))
    sqrt = staticmethod(_transcendental(torch.sqrt, np.sqrt))
    round = staticmethod(_unary(torch.round))   # half to even, as np.round
    sign = staticmethod(_unary(torch.sign))
    trunc = staticmethod(_unary(torch.trunc))
    sin = staticmethod(_transcendental(torch.sin, np.sin))
    cos = staticmethod(_transcendental(torch.cos, np.cos))
    tan = staticmethod(_transcendental(torch.tan, np.tan))
    arcsin = staticmethod(_transcendental(torch.asin, np.arcsin))
    arccos = staticmethod(_transcendental(torch.acos, np.arccos))
    arctan = staticmethod(_transcendental(torch.atan, np.arctan))
    sinh = staticmethod(_transcendental(torch.sinh, np.sinh))
    cosh = staticmethod(_transcendental(torch.cosh, np.cosh))
    tanh = staticmethod(_transcendental(torch.tanh, np.tanh))
    degrees = staticmethod(_unary(torch.rad2deg))
    radians = staticmethod(_unary(torch.deg2rad))
    minimum = staticmethod(_binary(torch.minimum))
    maximum = staticmethod(_binary(torch.maximum))
    arctan2 = staticmethod(_transcendental(torch.atan2, np.arctan2))
    divide = staticmethod(_device_div)
    ones_like = staticmethod(torch.ones_like)

    @staticmethod
    def power(v, p):
        # torch.pow keeps a Python exponent weak: int32 ** 2 is int32, ** 0.5 f32
        return torch.pow(v, p) if isinstance(v, torch.Tensor) or \
            isinstance(p, torch.Tensor) else torch.pow(_weak_tensor(v), p)

    @staticmethod
    def where(cond, a, b):
        like = next((v for v in (cond, a, b) if isinstance(v, torch.Tensor)), None)
        if not isinstance(cond, torch.Tensor):
            cond = _weak_tensor(bool(cond), like)
        return torch.where(cond, *_promoted(a, b, like))

    @staticmethod
    def asarray(v):
        return _weak_tensor(v)


TORCH = _TorchNamespace()


def _device_bool(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.bool)
    return bool(v)


def eval_device(e: Expr, columns: Mapping[str, torch.Tensor]):
    """Evaluate a device expression over decoded column tensors (int32 or
    float32). A name outside DEVICE_FUNCS raises KeyError: the planner sends
    such expressions to the host, so reaching one here is a planning bug."""
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, Identifier):
        return _lookup(columns, e.name)
    if not isinstance(e, Function) or e.name not in DEVICE_FUNCS:
        raise KeyError(f"function {getattr(e, 'name', e)!r} is not a device function")
    name, args = e.name, e.args
    if name in ("and", "or"):
        out = _device_bool(eval_device(args[0], columns))
        for a in args[1:]:
            v = _device_bool(eval_device(a, columns))
            out = (out & v) if name == "and" else (out | v)
        return out
    if name == "not":
        v = _device_bool(eval_device(args[0], columns))
        return ~v if isinstance(v, torch.Tensor) else not v
    if name == "case":
        out = eval_device(args[-1], columns)
        for w, t in _case_pairs(args):
            out = TORCH.where(_device_bool(eval_device(w, columns)),
                              eval_device(t, columns), out)
        return _narrow_dtype(out)
    if name == "cast":
        target = str(args[1].value).upper()
        dtype = _DEVICE_CASTS.get(target)
        if dtype is None:
            raise ValueError(f"CAST to {target} is host-side only")
        v = eval_device(args[0], columns)
        return v.to(dtype) if isinstance(v, torch.Tensor) else _SCALAR_CASTS[dtype](v)
    if name in ("in", "not_in"):
        needle = eval_device(args[0], columns)
        out = None
        for a in args[1:]:
            m = needle == eval_device(a, columns)
            out = m if out is None else (out | m)
        return ~out if name == "not_in" else out
    if name == "between":
        v = eval_device(args[0], columns)
        return (v >= eval_device(args[1], columns)) & (v <= eval_device(args[2], columns))
    vals = [eval_device(a, columns) for a in args]
    binop = _DEVICE_BINOPS.get(name)
    if binop is not None:
        return _narrow_dtype(binop(*vals))
    return _narrow_dtype(_FUNCTIONS[name](TORCH, *vals))


# -- scalar function library (extend over time) ------------------------------

@register_function("abs")
def _abs(xp, v):
    return xp.abs(v)


@register_function("ceil")
def _ceil(xp, v):
    return xp.ceil(v)


@register_function("floor")
def _floor(xp, v):
    return xp.floor(v)


@register_function("exp")
def _exp(xp, v):
    return xp.exp(v)


@register_function("ln")
def _ln(xp, v):
    return xp.log(v)


@register_function("log10")
def _log10(xp, v):
    return xp.log10(v)


@register_function("sqrt")
def _sqrt(xp, v):
    return xp.sqrt(v)


@register_function("power")
def _power(xp, v, p):
    return xp.power(v, p)


@register_function("round")
def _round(xp, v, digits=0):
    if digits:
        f = 10.0 ** digits
        return xp.divide(xp.round(v * f), f)
    return xp.round(v)


@register_function("least")
def _least(xp, *vs):
    out = vs[0]
    for v in vs[1:]:
        out = xp.minimum(out, v)
    return out


@register_function("greatest")
def _greatest(xp, *vs):
    out = vs[0]
    for v in vs[1:]:
        out = xp.maximum(out, v)
    return out


@register_function("sign")
def _sign(xp, v):
    return xp.sign(v)


@register_function("truncate")
def _truncate(xp, v, digits=0):
    f = 10.0 ** int(digits)
    return xp.divide(xp.trunc(v * f), f)


@register_function("log2")
def _log2(xp, v):
    return xp.log2(v)


@register_function("log")
def _log(xp, v):
    return xp.log(v)


for _trig in ("sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh"):
    _sql_name = _trig.replace("arc", "a")  # SQL: ASIN/ACOS/ATAN

    def _make(tn):
        def f(xp, v):
            return getattr(xp, tn)(v)
        return f
    register_function(_sql_name)(_make(_trig))


@register_function("atan2")
def _atan2(xp, y, x):
    return xp.arctan2(y, x)


@register_function("degrees")
def _degrees(xp, v):
    return xp.degrees(v)


@register_function("radians")
def _radians(xp, v):
    return xp.radians(v)


@register_function("coalesce")
def _coalesce(xp, *vs):
    """First non-null argument. Null = NaN for float arrays, None for scalars/objects
    (nulls surface as NaN on the decoded-value host path; see NullValueVector handling)."""
    out = vs[0]
    for v in vs[1:]:
        if out is None:
            out = v
            continue
        if hasattr(out, "dtype") and np.issubdtype(getattr(out, "dtype"), np.floating):
            out = xp.where(xp.isnan(out), v, out)
        elif hasattr(out, "dtype") and out.dtype == object:
            out = np.asarray([v_ if o is None else o
                              for o, v_ in zip(out, np.broadcast_to(np.asarray(v, dtype=object),
                                                                    out.shape))], dtype=object)
    return out


@register_function("nullif")
def _nullif(xp, a, b):
    if hasattr(a, "dtype") and np.issubdtype(getattr(a, "dtype"), np.floating):
        return xp.where(a == b, xp.nan, a)
    if hasattr(a, "dtype"):
        if a.dtype == object or (xp is np and not np.issubdtype(a.dtype, np.number)):
            arr = np.asarray(a, dtype=object).copy()
            arr[np.asarray(a == b)] = None
            return arr
        # integer path: NaN is this module's null representation, so widen to float —
        # a sentinel in-domain value would collide with legitimate data
        af = a.astype(np.float64)
        return xp.where(a == b, xp.nan, af)
    return None if a == b else a


# -- multi-value transforms (reference: ArrayLengthTransformFunction,
# ValueInTransformFunction — host path only; MV cells are object arrays of
# per-row numpy arrays and the planner keeps MV expressions off the device) ----

@register_function("arraylength")
def _arraylength(xp, v):
    if isinstance(v, MVValues):
        return v.counts
    arr = np.asarray(v)
    if arr.dtype == object:
        return np.fromiter((len(np.atleast_1d(x)) for x in arr), dtype=np.int64,
                           count=len(arr))
    return np.ones(len(arr), dtype=np.int64)  # SV column: one value per row


@register_function("cardinality")
def _cardinality(xp, v):
    return _arraylength(xp, v)


@register_function("valuein")
def _valuein(xp, v, *allowed):
    """MV -> MV: per-row intersection with the literal set, preserving row order."""
    sel = set(allowed)
    out = np.empty(len(v), dtype=object)
    for i, row in enumerate(v):
        out[i] = np.asarray([x for x in np.atleast_1d(np.asarray(row)).tolist()
                             if x in sel])
    return out


@register_function("arrayelementat")
def _arrayelementat(xp, v, idx):
    """1-based element access; out-of-range -> None (reference: arrayElementAt)."""
    i = int(idx) - 1
    out = np.empty(len(v), dtype=object)
    for r, row in enumerate(v):
        row = np.atleast_1d(np.asarray(row))
        out[r] = row[i].item() if 0 <= i < len(row) else None
    return out


@register_function("__packobj")
def _packobj(xp, *cols):
    """Internal: stack k argument columns into an [n, k] OBJECT matrix —
    like __pack but type-preserving, for aggregations whose key column may be
    strings (filtered theta sketches). Host-only."""
    arrs = [np.asarray(c, dtype=object) for c in cols]
    n = max((len(a) for a in arrs if a.ndim), default=0)
    arrs = [np.full(n, a.item(), dtype=object) if a.ndim == 0 else a
            for a in arrs]
    return np.stack(arrs, axis=1)


@register_function("__pack")
def _pack(xp, *cols):
    """Internal: stack k argument columns into an [n, k] matrix so multi-argument
    aggregations (COVAR/CORR/FIRSTWITHTIME) flow through the single-argument
    executor surface. Host-only by construction (not in planner._DEVICE_FUNCS)."""
    return np.stack([np.asarray(c, dtype=np.float64) for c in cols], axis=1)


@register_function("cot")
def _cot(xp, v):
    return 1.0 / xp.tan(v)


# -- MV reductions (reference: ArraySum/ArrayMin/ArrayMax/ArrayAverage/
# ArrayDistinct/ArraySort transform functions) --------------------------------

def _mv_reduce(v, fn, empty):
    arr = np.asarray(v, dtype=object)
    return np.asarray([fn(np.atleast_1d(np.asarray(row)).astype(np.float64))
                       if row is not None and len(np.atleast_1d(row)) else empty
                       for row in arr], dtype=np.float64)


@register_function("arraysum")
def _arraysum(xp, v):
    return _mv_reduce(v, np.sum, 0.0)


@register_function("arraymin")
def _arraymin(xp, v):
    return _mv_reduce(v, np.min, float("nan"))


@register_function("arraymax")
def _arraymax(xp, v):
    return _mv_reduce(v, np.max, float("nan"))


@register_function("arrayaverage")
def _arrayaverage(xp, v):
    return _mv_reduce(v, np.mean, float("nan"))


@register_function("arraydistinct")
def _arraydistinct(xp, v):
    out = np.empty(len(v), dtype=object)
    for i, row in enumerate(v):
        vals = np.atleast_1d(np.asarray(row))
        seen, keep = set(), []
        for x in vals.tolist():
            if x not in seen:
                seen.add(x)
                keep.append(x)
        out[i] = np.asarray(keep)
    return out


@register_function("arraysortasc")
def _arraysortasc(xp, v):
    out = np.empty(len(v), dtype=object)
    for i, row in enumerate(v):
        out[i] = np.sort(np.atleast_1d(np.asarray(row)))
    return out


@register_function("arraysortdesc")
def _arraysortdesc(xp, v):
    out = np.empty(len(v), dtype=object)
    for i, row in enumerate(v):
        out[i] = np.sort(np.atleast_1d(np.asarray(row)))[::-1]
    return out


@register_function("arrayindexof")
def _arrayindexof(xp, v, target):
    """0-based index of `target` in each row's values; -1 when absent
    (reference: arrayIndexOf)."""
    out = np.empty(len(v), dtype=np.int64)
    for i, row in enumerate(v):
        vals = np.atleast_1d(np.asarray(row)).tolist()
        out[i] = vals.index(target) if target in vals else -1
    return out


@register_function("arraycontains")
def _arraycontains(xp, v, target):
    return np.asarray([target in np.atleast_1d(np.asarray(row)).tolist()
                       for row in v], dtype=bool)


@register_function("arrayreverse")
def _arrayreverse(xp, v):
    out = np.empty(len(v), dtype=object)
    for i, row in enumerate(v):
        out[i] = np.atleast_1d(np.asarray(row))[::-1]
    return out


@register_function("arrayslice")
def _arrayslice(xp, v, start, end):
    s, e = int(start), int(end)
    out = np.empty(len(v), dtype=object)
    for i, row in enumerate(v):
        out[i] = np.atleast_1d(np.asarray(row))[s:e]
    return out


@register_function("arrayremove")
def _arrayremove(xp, v, target):
    # first occurrence only (reference: ArrayUtils.removeElement semantics)
    out = np.empty(len(v), dtype=object)
    for i, row in enumerate(v):
        vals = np.atleast_1d(np.asarray(row)).tolist()
        if target in vals:
            vals.remove(target)
        out[i] = np.asarray(vals)
    return out


@register_function("arrayunion")
def _arrayunion(xp, a, b):
    out = np.empty(len(a), dtype=object)
    for i in range(len(a)):
        seen, keep = set(), []
        for src in (a[i], b[i]):
            for x in np.atleast_1d(np.asarray(src)).tolist():
                if x not in seen:
                    seen.add(x)
                    keep.append(x)
        out[i] = np.asarray(keep)
    return out


@register_function("arrayconcat")
def _arrayconcat(xp, a, b):
    out = np.empty(len(a), dtype=object)
    for i in range(len(a)):
        out[i] = np.concatenate([np.atleast_1d(np.asarray(a[i])),
                                 np.atleast_1d(np.asarray(b[i]))])
    return out


# the reference registers type-suffixed spellings (arraySortInt/arraySortString
# etc.) — same implementations here, values are already typed
for _base in ("arrayconcat", "arraycontains", "arraydistinct", "arrayindexof",
              "arrayremove", "arrayreverse", "arrayslice", "arrayunion"):
    for _suffix in ("int", "long", "float", "double", "string"):
        if _base in _FUNCTIONS:
            _FUNCTIONS[f"{_base}{_suffix}"] = _FUNCTIONS[_base]
for _suffix in ("int", "string"):
    _FUNCTIONS[f"arraysort{_suffix}"] = _FUNCTIONS["arraysortasc"]


# the rest of the function library registers itself on import (LOOKUP over
# the dimension tables too)
from . import datetime_fns, geo_fns, json_fns, string_fns  # noqa: E402,F401
from ..query import lookup  # noqa: E402,F401

DEVICE_FUNCS = frozenset(_STRUCTURAL | set(_BINOPS) | _DEVICE_MATH
                         | datetime_fns.DEVICE_DATETIME_FUNCS)
