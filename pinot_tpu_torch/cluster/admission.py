"""Broker-side adaptive admission: the overload shed-state machine.

A copy of `pinot_tpu/cluster/admission.py`; the broker brackets every request
with `begin` / `end` and gates it with `admit`.

The static per-table QPS quota (`QueryQuotaManager`) caps each tenant's rate
but says nothing about the broker's own saturation — under a zipf-hot mix the
broker can be far below every per-table quota and still drown, taking every
tenant's p99 down together. This controller closes that gap with a three-state
machine driven by live signals:

  HEALTHY   — everything admits.
  SHEDDING  — in-flight depth crossed `broker.admission.queue.high` (or the
              recent dispatch-latency p99 crossed `broker.admission.latency.ms`
              when set): expensive scans shed, cheap served-path aggregations
              still admit. The expensive work is what holds worker slots for
              whole hedge delays; shedding it first keeps the served path fast.
  SATURATED — depth crossed `broker.admission.queue.max`: everything sheds,
              with a Retry-After hint so clients back off instead of hammering.

Independent of state, a query whose remaining `deadlineEpochMs` budget is
below the predicted service time (the recent dispatch-latency p99) is shed
up front: launching device work that cannot meet its deadline only steals
capacity from queries that still can (Tailwind framing: the host must keep
the chip fed with work that is still worth finishing).

Every shed is a typed `QueryRejectedError` plus a per-table
`pinot_broker_shed_queries` counter — overload is always visible, never
silent latency. Off by default (`clusterConfig/broker.admission.enabled`),
like hedging; the knobs are `broker.admission.queue.high` (16),
`.queue.max` (64), `.latency.ms` (0: depth only) and `.expensive.limit`
(10,000 rows).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..query.scheduler import QueryRejectedError
from ..utils.events import emit_event
from ..utils.metrics import get_registry

#: a LIMIT this large stands for "no limit" (the JAX package's UNBOUNDED_LIMIT)
UNBOUNDED_LIMIT = 1 << 40

HEALTHY = "HEALTHY"
SHEDDING = "SHEDDING"
SATURATED = "SATURATED"
STATE_LEVEL = {HEALTHY: 0, SHEDDING: 1, SATURATED: 2}


class AdmissionController:
    #: dispatch-latency samples required before the p99 feeds shed decisions —
    #: an empty histogram must not reject the first queries of a quiet broker
    MIN_P99_SAMPLES = 8
    #: Retry-After fallback when the latency histogram has no samples yet
    DEFAULT_RETRY_MS = 50.0

    def __init__(self, catalog, node: str = ""):
        self.catalog = catalog
        self._node = node          # event journal label (the broker's id)
        self._lock = threading.Lock()
        self._inflight = 0
        self._state = HEALTHY
        self._admitted = 0
        self._sheds = 0
        self._shed_by_table: Dict[str, int] = {}
        self._shed_by_reason: Dict[str, int] = {}

    # -- clusterConfig knobs (all documented in README) ---------------------
    def _prop(self, key: str, default):
        v = self.catalog.get_property(f"clusterConfig/{key}", default)
        try:
            return float(v) if v not in (None, "") else float(default)
        except (TypeError, ValueError):
            return float(default)

    def enabled(self) -> bool:
        v = self.catalog.get_property("clusterConfig/broker.admission.enabled",
                                      False)
        return str(v).lower() in ("true", "1") if v is not None else False

    def _queue_high(self) -> float:
        return self._prop("broker.admission.queue.high", 16)

    def _queue_max(self) -> float:
        return self._prop("broker.admission.queue.max", 64)

    def _latency_threshold_ms(self) -> float:
        # 0 (default) = depth-driven only; latency joins the signal when set
        return self._prop("broker.admission.latency.ms", 0)

    def _expensive_limit(self) -> float:
        return self._prop("broker.admission.expensive.limit", 10000)

    # -- live signals -------------------------------------------------------
    def begin(self) -> None:
        """One query entered the broker (paired with `end` in a finally)."""
        with self._lock:
            self._inflight += 1
            n = self._inflight
        get_registry().gauge("pinot_broker_inflight_queries").set(n)

    def end(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            n = self._inflight
        get_registry().gauge("pinot_broker_inflight_queries").set(n)

    def predicted_service_ms(self) -> tuple:
        """(recent dispatch-latency p99 in ms, sample count): the per-dispatch
        service-time estimate behind the deadline check and Retry-After."""
        return get_registry().histogram(
            "pinot_broker_dispatch_latency_ms").recent_percentile(0.99)

    def _compute_state(self, inflight: int, p99: float, n: int) -> str:
        if inflight >= self._queue_max():
            return SATURATED
        high = self._queue_high()
        lat = self._latency_threshold_ms()
        if inflight >= high \
                or (lat > 0 and n >= self.MIN_P99_SAMPLES and p99 >= lat):
            return SHEDDING
        # hysteresis: once shedding, stay there until depth falls to half the
        # trigger so the state doesn't flap at the boundary
        if self._state != HEALTHY and inflight > high * 0.5:
            return SHEDDING
        return HEALTHY

    def state(self) -> str:
        with self._lock:
            return self._state

    def overloaded(self) -> bool:
        """True while the shed-state machine is past HEALTHY — consumers like
        hedging use this to stop amplifying load."""
        return self.enabled() and self.state() != HEALTHY

    # -- the decision -------------------------------------------------------
    def is_expensive(self, ctx) -> bool:
        """Expensive = a selection scan with a large (or unbounded) LIMIT:
        no aggregation to collapse rows, so it holds a worker slot and
        materializes output proportional to its limit. Served-path
        aggregations/group-bys are the cheap class that keeps admitting in
        SHEDDING."""
        if getattr(ctx, "is_aggregation_query", False) or ctx.group_by:
            return False
        lim = ctx.limit if ctx.limit is not None else UNBOUNDED_LIMIT
        return lim >= self._expensive_limit()

    def admit(self, table: str, ctx) -> None:
        """Gate one query; raises QueryRejectedError on shed. Call AFTER the
        deadline is stamped on ctx.options so the budget check sees it."""
        if not self.enabled():
            return
        p99, n = self.predicted_service_ms()
        with self._lock:
            prev = self._state
            state = self._state = self._compute_state(self._inflight, p99, n)
            inflight = self._inflight
        get_registry().gauge("pinot_broker_shed_state").set(STATE_LEVEL[state])
        if state != prev:
            # edge-triggered: one event per flip, not one per admitted query
            emit_event("admission.state", node=self._node or None,
                       severity="INFO" if state == HEALTHY else "WARN",
                       fromState=prev, toState=state, inflight=inflight)

        # a query that cannot meet its own deadline shed up front, whatever
        # the state: the predicted per-dispatch service time already exceeds
        # the remaining budget, so launching it only wastes device capacity
        deadline_ms = None
        if ctx.options:
            try:
                deadline_ms = float(ctx.options.get("deadlineEpochMs"))
            except (TypeError, ValueError):
                deadline_ms = None
        if deadline_ms is not None and n >= self.MIN_P99_SAMPLES:
            remaining_ms = deadline_ms - time.time() * 1000.0
            if remaining_ms < p99:
                self._shed(table, "deadline",
                           f"query deadline budget {remaining_ms:.1f}ms is "
                           f"below the predicted service time {p99:.1f}ms")

        if state == SATURATED:
            self._shed(table, "saturated",
                       f"broker saturated ({self._inflight} queries in "
                       f"flight)",
                       retry_after_ms=p99 if p99 > 0 else self.DEFAULT_RETRY_MS)
        if state == SHEDDING and self.is_expensive(ctx):
            self._shed(table, "expensive",
                       f"broker shedding expensive scans under load "
                       f"({self._inflight} queries in flight)",
                       retry_after_ms=p99 if p99 > 0 else self.DEFAULT_RETRY_MS)
        with self._lock:
            self._admitted += 1

    def _shed(self, table: str, reason: str, message: str,
              retry_after_ms: Optional[float] = None) -> None:
        with self._lock:
            self._sheds += 1
            self._shed_by_table[table] = self._shed_by_table.get(table, 0) + 1
            self._shed_by_reason[reason] = \
                self._shed_by_reason.get(reason, 0) + 1
        get_registry().counter("pinot_broker_shed_queries",
                               {"table": table}).inc()
        raise QueryRejectedError(f"query shed ({reason}): {message}",
                                 retry_after_ms=retry_after_ms)

    def snapshot(self) -> Dict:
        """Operator view for /debug and cluster_top's admission panel."""
        p99, samples = self.predicted_service_ms()
        with self._lock:
            return {
                "enabled": self.enabled(),
                "state": self._state,
                "inflight": self._inflight,
                "admitted": self._admitted,
                "sheds": self._sheds,
                "shedByTable": dict(self._shed_by_table),
                "shedByReason": dict(self._shed_by_reason),
                "predictedServiceMs": round(p99, 3),
                "predictionSamples": samples,
                "queueHigh": self._queue_high(),
                "queueMax": self._queue_max(),
            }
