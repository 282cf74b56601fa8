"""Query scheduling, admission and the per-table QPS quota.

A copy of `pinot_tpu/query/scheduler.py` (the analog of the reference's
`QueryScheduler` family and the broker's `QueryQuotaManager`):

* `QueryScheduler`, which a `ServerNode` may take: a bounded worker pool
  with a bounded wait queue (beyond it a submission is rejected at once),
  wall-clock timeouts, an optional per-table concurrency share and
  weighted-fair dispatch across tables (start-time fair queueing on a virtual
  clock a tenant, advanced by cost / weight);
* `QueryQuotaManager`, the broker's per-table token buckets from
  `TableConfig.quota.max_qps`, split across the live brokers;
* `QueryRejectedError` (out of capacity, over quota, shed; it may carry a
  Retry-After hint) and `QueryTimeoutError`, which the broker treats as
  backpressure: the segments retry on another replica and the server keeps
  its place in routing.

`scheduler_from_config` builds a server process's scheduler from its
`server.scheduler.*` keys.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor, TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Optional

from ..utils.metrics import get_registry


class QueryRejectedError(Exception):
    """Admission denied (queue full / quota exceeded / scheduler stopped).

    Reference: QueryScheduler returning an error DataTable with
    SERVER_SCHEDULER_DOWN/SERVER_OUT_OF_CAPACITY. Carries an optional
    `retry_after_ms` drain-rate hint that the HTTP layer surfaces on 429s."""

    def __init__(self, message: str, retry_after_ms: Optional[float] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class QueryTimeoutError(Exception):
    """Query exceeded its wall-clock budget (reference: per-query timeoutMs).

    `deadline_epoch_ms` is set when the rejection came from an absolute
    `deadlineEpochMs` so the 408 body can echo the deadline back."""

    def __init__(self, message: str, deadline_epoch_ms: Optional[float] = None):
        super().__init__(message)
        self.deadline_epoch_ms = deadline_epoch_ms


@dataclass
class SchedulerStats:
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    timed_out: int = 0
    failed: int = 0
    # live gauges
    running: int = 0
    queued: int = 0
    per_table_running: Dict[str, int] = field(default_factory=dict)
    per_table_queued: Dict[str, int] = field(default_factory=dict)
    per_table_bytes: Dict[str, float] = field(default_factory=dict)

    def snapshot(self) -> Dict[str, Any]:
        return {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.__dict__.items()}


@dataclass
class _QueuedItem:
    table: str
    fn: Callable[[], Any]
    future: Future
    cost: float
    cost_bytes: float


# one cost unit per query plus one per MiB of predicted in-flight bytes, so a
# tenant of heavy scans burns virtual time faster than a tenant of cheap aggs
_BYTES_PER_COST = float(1 << 20)


class QueryScheduler:
    """Weighted-fair bounded scheduler with per-table accounting.

    Queries run on a fixed worker pool (`max_concurrent`); at most `max_pending`
    more may wait; beyond that, submission is rejected immediately — backpressure
    instead of unbounded queue growth, exactly the BoundedFCFS behavior. A
    `per_table_share` < 1 caps how many workers a single table may hold
    concurrently (the ResourceManager's per-query-group semaphore analog).
    Waiting queries dispatch in weighted-fair order across tables rather than
    FIFO; `tenant_weights` biases the split and `max_table_bytes` bounds one
    tenant's predicted in-flight bytes (0 disables the byte budget).
    """

    def __init__(self, max_concurrent: int = 4, max_pending: int = 32,
                 default_timeout_s: float = 60.0, per_table_share: float = 1.0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 max_table_bytes: float = 0.0):
        self.max_concurrent = max_concurrent
        self.max_pending = max_pending
        self.default_timeout_s = default_timeout_s
        # share < 1 caps one table's in-flight (running+queued) queries; 1.0 means
        # no per-table cap — admission is then bounded by max_pending alone
        self.table_cap = (None if per_table_share >= 1.0
                          else max(1, int(max_concurrent * per_table_share)))
        self.tenant_weights = dict(tenant_weights or {})
        self.max_table_bytes = float(max_table_bytes)
        self._pool = ThreadPoolExecutor(max_workers=max_concurrent,
                                        thread_name_prefix="query-sched")
        self._lock = threading.Condition()
        self.stats = SchedulerStats()
        self._stopped = False
        # weighted-fair state: per-tenant wait queues and virtual clocks
        self._queues: Dict[str, Deque[_QueuedItem]] = {}
        self._vtimes: Dict[str, float] = {}
        self._vclock = 0.0
        # EWMA of observed service time, feeding the Retry-After drain hint
        self._service_ms_ewma = 25.0

    # -- fair-queue internals (call with self._lock held) -------------------
    def _weight(self, table: str) -> float:
        return max(0.1, float(self.tenant_weights.get(table, 1.0)))

    def _enqueue(self, item: _QueuedItem) -> None:
        q = self._queues.get(item.table)
        if q is None:
            q = self._queues[item.table] = deque()
        if not q:
            # a tenant going from idle to busy starts at the global clock so it
            # cannot bank credit while idle (start-time fair queueing)
            self._vtimes[item.table] = max(
                self._vtimes.get(item.table, 0.0), self._vclock)
        q.append(item)

    def _pop_next(self) -> Optional[_QueuedItem]:
        best: Optional[str] = None
        best_vt = 0.0
        for table, q in self._queues.items():
            if not q:
                continue
            vt = self._vtimes.get(table, 0.0)
            if best is None or vt < best_vt:
                best, best_vt = table, vt
        if best is None:
            return None
        q = self._queues[best]
        item = q.popleft()
        if not q:
            del self._queues[best]
        self._vclock = max(self._vclock, best_vt)
        self._vtimes[best] = best_vt + item.cost / self._weight(best)
        return item

    def _dec(self, counts: Dict[str, Any], table: str, n: float = 1) -> None:
        v = counts.get(table, 0) - n
        if v <= 0 or (isinstance(v, float) and v < 1e-6):
            counts.pop(table, None)
        else:
            counts[table] = v

    def _release_table(self, table: str, cost_bytes: float) -> None:
        self._dec(self.stats.per_table_running, table)
        if cost_bytes:
            self._dec(self.stats.per_table_bytes, table, cost_bytes)
        if table not in self.stats.per_table_running \
                and table not in self._queues:
            # tenant fully idle: drop its virtual clock so the map stays
            # bounded across hundreds of transient tenants
            self._vtimes.pop(table, None)

    def retry_after_ms(self) -> float:
        """Drain-rate hint for 429 Retry-After: how long until a freed slot,
        estimated from the queue depth and the observed service-time EWMA."""
        with self._lock:
            depth = self.stats.queued + self.stats.running
            return max(1.0, (depth + 1) * self._service_ms_ewma
                       / max(1, self.max_concurrent))

    # ------------------------------------------------------------------
    def submit(self, table: str, fn: Callable[[], Any],
               timeout_s: Optional[float] = None,
               cost_bytes: float = 0.0) -> Any:
        """Run fn under admission control; blocks the caller until done.

        Raises QueryRejectedError when the server is out of capacity and
        QueryTimeoutError when fn exceeds its budget (the worker is abandoned to
        finish in the background — same as the reference reaping the response
        future; the slot frees when it completes)."""
        timeout_s = timeout_s if timeout_s is not None else self.default_timeout_s
        cost_bytes = max(0.0, float(cost_bytes))
        with self._lock:
            if self._stopped:
                self.stats.rejected += 1
                get_registry().counter("pinot_server_queries_rejected").inc()
                raise QueryRejectedError("scheduler is shut down")
            if self.stats.queued >= self.max_pending:
                self.stats.rejected += 1
                get_registry().counter("pinot_server_queries_rejected").inc()
                raise QueryRejectedError(
                    f"server out of capacity: {self.stats.queued} queries pending",
                    retry_after_ms=(self.stats.queued + self.stats.running + 1)
                    * self._service_ms_ewma / max(1, self.max_concurrent))
            if self.table_cap is not None \
                    and self.stats.per_table_running.get(table, 0) >= self.table_cap:
                self.stats.rejected += 1
                get_registry().counter("pinot_server_queries_rejected").inc()
                raise QueryRejectedError(
                    f"table {table!r} is at its concurrency share ({self.table_cap})",
                    retry_after_ms=self._service_ms_ewma)
            if self.max_table_bytes > 0 and cost_bytes > 0 \
                    and self.stats.per_table_bytes.get(table, 0.0) > 0 \
                    and self.stats.per_table_bytes[table] + cost_bytes \
                    > self.max_table_bytes:
                # an idle tenant may always run one oversized query — the budget
                # bounds concurrent bytes, it must not wedge a table forever
                self.stats.rejected += 1
                get_registry().counter("pinot_server_queries_rejected").inc()
                raise QueryRejectedError(
                    f"table {table!r} exceeded its in-flight byte budget "
                    f"({int(self.max_table_bytes)}B)",
                    retry_after_ms=self._service_ms_ewma)
            self.stats.submitted += 1
            self.stats.queued += 1
            self.stats.per_table_running[table] = \
                self.stats.per_table_running.get(table, 0) + 1
            self.stats.per_table_queued[table] = \
                self.stats.per_table_queued.get(table, 0) + 1
            if cost_bytes:
                self.stats.per_table_bytes[table] = \
                    self.stats.per_table_bytes.get(table, 0.0) + cost_bytes
            fut: Future = Future()
            self._enqueue(_QueuedItem(
                table=table, fn=fn, future=fut,
                cost=1.0 + cost_bytes / _BYTES_PER_COST, cost_bytes=cost_bytes))

        try:
            # one ticket per queued item: each worker invocation dispatches
            # exactly the fair-queue head, so pool order no longer implies
            # execution order and a hot tenant cannot monopolize the pool
            self._pool.submit(self._run_ticket)
        except RuntimeError:
            with self._lock:
                self.stats.rejected += 1
                self.stats.queued -= 1
                self._dec(self.stats.per_table_queued, table)
                self._release_table(table, cost_bytes)
                fut.cancel()
            get_registry().counter("pinot_server_queries_rejected").inc()
            raise QueryRejectedError("scheduler is shut down") from None
        try:
            result = fut.result(timeout=timeout_s)
            with self._lock:
                self.stats.completed += 1
            return result
        except FutureTimeout:
            cancelled = fut.cancel()  # a still-queued query never needs to run
            get_registry().counter("pinot_server_queries_timed_out").inc()
            with self._lock:
                self.stats.timed_out += 1
                if cancelled:
                    # the ticket will skip it: undo the queue accounting here
                    self.stats.queued -= 1
                    self._dec(self.stats.per_table_queued, table)
                    self._release_table(table, cost_bytes)
            raise QueryTimeoutError(f"query exceeded {timeout_s}s") from None
        except Exception:
            with self._lock:
                self.stats.failed += 1
            raise

    def _run_ticket(self) -> None:
        while True:
            with self._lock:
                item = self._pop_next()
                if item is None:
                    return
                if item.future.set_running_or_notify_cancel():
                    self.stats.queued -= 1
                    self._dec(self.stats.per_table_queued, item.table)
                    self.stats.running += 1
                    break
                # cancelled while queued (caller timed out and already undid
                # the accounting): discard and dispatch the next fair head
        t0 = time.monotonic()
        try:
            item.future.set_result(item.fn())
        except BaseException as e:  # route into the caller's future, never lose it
            item.future.set_exception(e)
        finally:
            elapsed_ms = (time.monotonic() - t0) * 1000.0
            # the table slot frees when the work ACTUALLY finishes — a timed-out
            # caller abandons the worker, but the table stays at its cap until
            # the abandoned query completes (else the cap could be exceeded)
            with self._lock:
                self.stats.running -= 1
                self._release_table(item.table, item.cost_bytes)
                self._service_ms_ewma += 0.2 * (elapsed_ms - self._service_ms_ewma)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        self._pool.shutdown(wait=False)


def scheduler_from_config(cfg) -> Optional["QueryScheduler"]:
    """A QueryScheduler from a Configuration's `server.scheduler.*` keys
    (reference: the pinot.query.scheduler.* configs QuerySchedulerFactory
    reads); None when admission control is off (the default).
    `server.scheduler.fair.weights` is a JSON object of table -> weight (1.0
    each by default); `server.scheduler.fair.tenant.bytes` bounds one table's
    bytes in flight (0: no bound)."""
    if not cfg.get_bool("server.scheduler.enabled", False):
        return None
    weights: Dict[str, float] = {}
    raw = cfg.get_str("server.scheduler.fair.weights", "") or ""
    if raw.strip():
        try:
            weights = {str(k): float(v) for k, v in json.loads(raw).items()}
        except (ValueError, TypeError, AttributeError):
            weights = {}
    return QueryScheduler(
        max_concurrent=cfg.get_int("server.scheduler.max.concurrent", 4),
        max_pending=cfg.get_int("server.scheduler.max.pending", 32),
        default_timeout_s=cfg.get_float("server.scheduler.timeout.seconds", 60.0),
        per_table_share=cfg.get_float("server.scheduler.table.share", 1.0),
        tenant_weights=weights,
        max_table_bytes=cfg.get_float("server.scheduler.fair.tenant.bytes", 0.0),
    )


class TokenBucket:
    """Classic token bucket (reference: HitCounter-based QPS tracking in
    QueryQuotaManager; a bucket gives the same steady rate + burst semantics)."""

    def __init__(self, rate_per_s: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate_per_s)
        self.capacity = float(burst if burst is not None else max(1.0, rate_per_s))
        self._tokens = self.capacity
        self._last = clock()
        self._clock = clock
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.capacity, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def refund(self, n: float = 1.0) -> None:
        """Return tokens taken for an admission that was then aborted."""
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + n)


class QueryQuotaManager:
    """Broker-side per-table QPS quota (reference:
    `pinot-broker/.../queryquota/HelixExternalViewBasedQueryQuotaManager.java`).

    Quotas come from `TableConfig.quota.max_qps`; a table without a quota is
    unlimited. The per-broker rate is the table quota divided by the live broker
    count, like the reference splits quota across brokers."""

    def __init__(self, catalog, broker_count_fn: Optional[Callable[[], int]] = None):
        self.catalog = catalog
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self._broker_count_fn = broker_count_fn or (lambda: max(1, sum(
            1 for i in catalog.instances.values()
            if i.role == "broker" and i.alive)))
        self._last_broker_count = self._broker_count_fn()
        catalog.subscribe(self._on_event)

    def _on_event(self, event: str, key: str) -> None:
        if event == "table":
            with self._lock:
                self._buckets.pop(key, None)  # config changed: rebuild lazily
        elif event == "instance":
            # rebuild only when BROKER membership actually changed — server churn
            # must not refill every table's burst allowance
            count = self._broker_count_fn()
            with self._lock:
                if count != self._last_broker_count:
                    self._last_broker_count = count
                    self._buckets.clear()

    def _bucket(self, table: str) -> Optional[TokenBucket]:
        with self._lock:
            if table in self._buckets:
                return self._buckets[table]
        cfg = self.catalog.table_configs.get(table)
        max_qps = getattr(getattr(cfg, "quota", None), "max_qps", None) if cfg else None
        bucket = None
        if max_qps:
            bucket = TokenBucket(float(max_qps) / self._broker_count_fn())
        with self._lock:
            self._buckets[table] = bucket
        return bucket

    def try_acquire(self, table: str) -> bool:
        bucket = self._bucket(table)
        return bucket.try_acquire() if bucket is not None else True

    def refund(self, table: str) -> None:
        bucket = self._bucket(table)
        if bucket is not None:
            bucket.refund()

    def try_acquire_all(self, tables) -> bool:
        """All-or-nothing admission over several physical tables (hybrid split):
        a rejection refunds tokens already taken so no table's quota leaks."""
        taken = []
        for t in tables:
            if self.try_acquire(t):
                taken.append(t)
            else:
                for u in taken:
                    self.refund(u)
                return False
        return True
