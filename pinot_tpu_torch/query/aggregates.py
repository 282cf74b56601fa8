"""Aggregation functions: device partial outputs + host merge/finalize.

A subset of `pinot_tpu/query/aggregates.py` (analog of the reference's
`AggregationFunction` family): COUNT, SUM, MIN, MAX and AVG. Each function
names the kernel outputs it needs (`device_outputs`), builds a partial state
from them, merges states across segments and finalizes. Every other
aggregation of the JAX package raises NotImplementedError here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..sql.ast import Expr, Function


class AggFunc:
    name: str = ""
    device_outputs: Tuple[str, ...] = ()  # subset of {count, sum, min, max}

    def __init__(self, call: Function):
        self.call = call
        self.arg: Optional[Expr] = call.args[0] if call.args else None

    def host_state(self, values: np.ndarray) -> Any:
        """A partial state from the filtered argument values of one segment."""
        raise NotImplementedError

    def state_from_device(self, outs: Dict[str, float]) -> Any:
        """The same state from the kernel's outputs for one group."""
        raise NotImplementedError

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def finalize(self, state: Any) -> Any:
        raise NotImplementedError

    def empty_result(self) -> Any:
        """Result over zero rows (no group-by), mirroring reference defaults."""
        return None

    def dense_values(self, get, counts: np.ndarray) -> np.ndarray:
        """Finalized values over all occupied groups at once (the dense group
        decode, `query/dense_reduce.py`): `get(name)` is this aggregation's
        kernel output over the occupied keys, `counts` their row counts (each
        above 0, so no state is empty)."""
        raise NotImplementedError


class CountAgg(AggFunc):
    name = "count"
    device_outputs = ("count",)

    def host_state(self, values):
        return int(len(values))

    def state_from_device(self, outs):
        return int(outs["count"])

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return int(state)

    def dense_values(self, get, counts):
        return counts.astype(np.int64)

    def empty_result(self):
        return 0


class SumAgg(AggFunc):
    name = "sum"
    device_outputs = ("sum",)

    def host_state(self, values):
        return float(np.sum(values)) if len(values) else None

    def state_from_device(self, outs):
        return float(outs["sum"]) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def finalize(self, state):
        return None if state is None else float(state)

    def dense_values(self, get, counts):
        return get("sum").astype(np.float64)


class MinAgg(AggFunc):
    name = "min"
    device_outputs = ("min",)

    def host_state(self, values):
        return float(np.min(values)) if len(values) else None

    def state_from_device(self, outs):
        return float(outs["min"]) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return min(a, b)

    def finalize(self, state):
        return None if state is None else float(state)

    def dense_values(self, get, counts):
        return get(self.device_outputs[0]).astype(np.float64)


class MaxAgg(MinAgg):
    name = "max"
    device_outputs = ("max",)

    def host_state(self, values):
        return float(np.max(values)) if len(values) else None

    def state_from_device(self, outs):
        return float(outs["max"]) if outs["count"] > 0 else None

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return max(a, b)


class AvgAgg(AggFunc):
    name = "avg"
    device_outputs = ("sum", "count")

    def host_state(self, values):
        return (float(np.sum(values)), len(values))

    def state_from_device(self, outs):
        return (float(outs["sum"]), int(outs["count"]))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def finalize(self, state):
        s, c = state
        return None if c == 0 else s / c

    def dense_values(self, get, counts):
        return get("sum").astype(np.float64) / counts


_REGISTRY = {"count": CountAgg, "sum": SumAgg, "min": MinAgg, "max": MaxAgg,
             "avg": AvgAgg}


def make_agg(call: Function) -> AggFunc:
    cls = _REGISTRY.get(call.name)
    if cls is None or call.distinct:
        name = f"{call.name.upper()}(DISTINCT)" if call.distinct else call.name.upper()
        raise NotImplementedError(
            f"aggregation {name} is not supported by pinot_tpu_torch "
            "(supported: COUNT, SUM, MIN, MAX, AVG)")
    return cls(call)
