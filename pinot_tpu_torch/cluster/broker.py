"""Broker role: SQL entry, routing, scatter/gather, reduce.

A trimmed copy of `pinot_tpu/cluster/broker.py` (the analog of the
reference's `BaseBrokerRequestHandler.handleRequest`, `QueryRouter` and
`BrokerReduceService`): compile, resolve the physical tables, check the
table's state and QPS quota, stamp the deadline, admit, route and prune
(`routing.py`), scatter one partial a server on a thread pool, gather with
hedging and backpressure, send the segments a server missed to another
replica in one retry round, and reduce the partials (`query/reduce.py`: a
high-cardinality GROUP BY's array-form partials, one from each server, merge
elementwise). A failed server leaves routing until the failure detector's
probe brings it back; segments that no replica served are surfaced as
`partialResult` and `segmentsUnavailable`, never as a short answer. EXPLAIN
asks one server a table for its plan; EXPLAIN ANALYZE runs the query and
annotates that plan with the rows and milliseconds it recorded.
`stream_query` yields a selection's rows a server partial at a time.

A REALTIME table's consuming segments route as its committed ones do, each
to one stable replica (`routing.py`); a hybrid table's OFFLINE half answers
time <= the boundary and its REALTIME half the rest. A server's partial
names in `served` the consuming segments it counted, so that the retry
round sends a segment on only where no replica counted it, and the merged
stats sum `numConsumingSegmentsQueried` and keep the least
`minConsumingFreshnessTimeMs`.

Failures, as the JAX package sorts them: a transport failure
(ConnectionError, TimeoutError, OSError) marks the server unhealthy;
backpressure (QueryRejectedError, QueryTimeoutError) holds the server out of
hedges and retries for its Retry-After; any other error is a query error,
raised when the segments fail on every replica tried.

A partial's dispatch is async-first (`_dispatch_partial`): a server handle
with `submit_async` (a `remote.RemoteServerHandle` over the mux transport)
returns a Future that holds no scatter thread for the round trip; any other
handle (an in-process server, or a remote one on the legacy POST /query)
takes one scatter-pool thread a call.

Joins and IN-subqueries take the multistage route (`_handle_multistage`):
when every routed server has an HTTP endpoint, the peer-to-peer mailbox
shuffle (`multistage/shuffle.py`: the leaves partition on the servers and
stream straight into the stage workers' mailboxes, the broker receives only
final-stage partials); otherwise, or under OPTION(useMailboxShuffle=false),
the funnel path: `execute_multistage` over leaf scans scattered to the
servers, each partition joined on a server through its stage handle
(`POST /stage`) or, when none is wired or a dispatch fails, here on the
broker's device (`device`: CUDA unless the caller passes "cpu"), under the
data-plane cap `broker.maxDataPlaneBytes`. `IN_SUBQUERY(col, 'SELECT
IDSET(...) ...')` runs its inner query first and splices the id set in. A
GROUP BY asked for with OPTION(distributedGroupBy / useMultistageEngine), or
past `broker.distributedGroupByDocThreshold` docs, merges disjoint key ranges
on the servers (`coordinate_groupby`). Each degradation counts:
`pinot_broker_p2p_fallbacks`, `pinot_broker_stage_dispatch_failures`,
`pinot_broker_data_plane_bytes`. The workload registry waits (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, as_completed
from concurrent.futures import TimeoutError as FutureTimeoutError
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..query import stats as qstats
from ..query.aggregates import make_agg
from ..query.context import QueryContext, QueryValidationError, compile_query
from ..query.explain import ANALYZE_COLUMNS, annotate_plan_rows, explain_result
from ..query.reduce import SegmentResult, merge_segment_results, reduce_to_result
from ..query.result import ResultTable
from ..query.scheduler import QueryQuotaManager, QueryRejectedError, QueryTimeoutError
from ..sql.ast import Function, Identifier, Literal, to_sql
from ..table import TableType
from ..utils import trace as tracing
from ..utils.events import emit_event
from ..utils.metrics import get_registry
from .admission import UNBOUNDED_LIMIT, AdmissionController
from .catalog import ONLINE, Catalog, InstanceInfo
from .routing import PRUNE_ROWS_AVOIDED, PRUNER_KINDS, RoutingManager

# server handle: execute_partial(table, ctx, segment_names, time_filter) -> SegmentResult
ServerHandle = Callable[..., SegmentResult]

class FailureDetector:
    """Re-probes unhealthy servers with exponential backoff (the reference's
    BaseExponentialBackoffRetryFailureDetector): a server taken out of
    routing after a transport failure comes back when its probe succeeds."""

    def __init__(self, routing, initial_interval_s: float = 0.5,
                 backoff_factor: float = 2.0, max_interval_s: float = 30.0,
                 probe_timeout_s: float = 10.0, node: str = ""):
        self.routing = routing
        self._node = node
        self.initial_interval_s = initial_interval_s
        self.backoff_factor = backoff_factor
        self.max_interval_s = max_interval_s
        self.probe_timeout_s = probe_timeout_s
        self._probes: Dict[str, Callable[[], bool]] = {}
        self._pending: Dict[str, Tuple[float, float]] = {}   # server -> (next probe, interval)
        self._fail_counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register_probe(self, server_id: str, probe: Callable[[], bool]) -> None:
        with self._lock:
            self._probes[server_id] = probe

    def notify_unhealthy(self, server_id: str) -> None:
        with self._lock:
            newly_down = server_id in self._probes and server_id not in self._pending
            if newly_down:
                self._pending[server_id] = (time.time() + self.initial_interval_s,
                                            self.initial_interval_s)
        if newly_down:
            emit_event("server.down", node=self._node or None, server=server_id)

    def notify_healthy(self, server_id: str) -> None:
        with self._lock:
            self._pending.pop(server_id, None)
            self._fail_counts.pop(server_id, None)

    def remove(self, server_id: str) -> None:
        with self._lock:
            self._probes.pop(server_id, None)
            self._pending.pop(server_id, None)
            self._fail_counts.pop(server_id, None)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        now = time.time()
        with self._lock:
            out: Dict[str, Dict[str, object]] = {}
            for server_id in self._probes:
                entry = self._pending.get(server_id)
                out[server_id] = ({"state": "healthy", "consecutiveFailures": 0}
                                  if entry is None else
                                  {"state": "probing",
                                   "consecutiveFailures": self._fail_counts.get(server_id, 0),
                                   "nextProbeInS": round(max(0.0, entry[0] - now), 3)})
            return out

    def tick(self, now: Optional[float] = None) -> None:
        """Probe every server that is due, concurrently."""
        now = time.time() if now is None else now
        with self._lock:
            due = [(s, iv) for s, (t, iv) in self._pending.items() if t <= now]
            probes = dict(self._probes)
        if not due:
            return

        def run_probe(server_id: str) -> bool:
            probe = probes.get(server_id)
            try:
                return bool(probe()) if probe else False
            except Exception:   # a probe that raises is a failed probe
                return False

        pool = ThreadPoolExecutor(max_workers=min(8, len(due)), thread_name_prefix="fd-probe")
        try:
            futs = {s: pool.submit(run_probe, s) for s, _ in due}
            results = {}
            for s, f in futs.items():
                try:
                    results[s] = f.result(timeout=self.probe_timeout_s)
                except FutureTimeoutError:
                    results[s] = False
        finally:
            pool.shutdown(wait=False)
        for server_id, interval in due:
            ok = results[server_id]
            with self._lock:
                if server_id not in self._pending:
                    continue
                if ok:
                    self._pending.pop(server_id, None)
                    self._fail_counts.pop(server_id, None)
                else:
                    nxt = min(interval * self.backoff_factor, self.max_interval_s)
                    self._pending[server_id] = (now + nxt, nxt)
                    self._fail_counts[server_id] = self._fail_counts.get(server_id, 0) + 1
            if ok:
                self.routing.mark_server_healthy(server_id)
                emit_event("server.up", node=self._node or None, server=server_id)

    def start(self, tick_s: float = 0.25) -> None:
        def loop():
            while not self._stop.wait(tick_s):
                self.tick()
        self._thread = threading.Thread(target=loop, daemon=True, name="failure-detector")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class _DispatchUnit:
    """One scatter unit: a dispatch to a server and, when hedged, one to an
    alternate replica. The first success wins; the loser's partial is dropped
    unmerged, so no stat counts a unit twice."""

    __slots__ = ("server", "segments", "primary", "t0", "hedge", "hedge_server",
                 "hedge_exhausted", "failed")

    def __init__(self, server: str, segments: List[str], primary: Future):
        self.server = server
        self.segments = segments
        self.primary = primary
        self.t0 = time.monotonic()
        self.hedge: Optional[Future] = None
        self.hedge_server: Optional[str] = None
        self.hedge_exhausted = False
        self.failed: Dict[Future, BaseException] = {}


class Broker:
    #: hedge delay before the dispatch-latency histogram has samples
    HEDGE_DEFAULT_DELAY_MS = 50.0
    #: how long a 429 without a Retry-After hint holds a server out of hedges
    #: and retries, and the ceiling on honoured hints
    BACKPRESSURE_DEFAULT_S = 0.25
    BACKPRESSURE_MAX_S = 5.0
    #: cap on how long a retry round waits out replicas' Retry-After hints
    RETRY_DEFER_CAP_S = 0.5
    SLOW_QUERY_LOGGER = "pinot_tpu_torch.broker.slow_query"

    def __init__(self, instance_id: str, catalog: Catalog, max_scatter_threads: int = 8,
                 device=None):
        self.instance_id = instance_id
        self.catalog = catalog
        # where a funnel-path join partition runs when it runs here (CUDA
        # unless the caller names another), resolved when one does
        self.device = device
        self.routing = RoutingManager(catalog)
        self._servers: Dict[str, ServerHandle] = {}
        self._explain: Dict[str, Callable] = {}
        self._stage: Dict[str, Callable] = {}
        self._urls: Dict[str, str] = {}   # server -> HTTP endpoint (the mailbox shuffle)
        self._pool = ThreadPoolExecutor(max_workers=max_scatter_threads,
                                        thread_name_prefix=f"{instance_id}-scatter")
        # the dispatch timeout of a scatter round and of a shuffle's stage
        self.stage_timeout_s = 120.0
        # the funnel path's cap on inter-stage bytes buffered here (None: the
        # cluster's `broker.maxDataPlaneBytes`, else uncapped); the mailbox
        # shuffle buffers none here
        self.max_data_plane_bytes: Optional[int] = None
        # queries over `broker.slow.query.ms` log one JSON line and land here
        self._recent_slow: deque = deque(maxlen=32)
        self._query_rollup: Dict[str, float] = {"numQueries": 0, "numExceptions": 0,
                                                "numSlowQueries": 0, "totalTimeMs": 0.0,
                                                "maxTimeMs": 0.0}
        self._table_rollup: Dict[str, Dict[str, float]] = {}
        self._table_sweep_countdown = 0
        self._obs_lock = threading.Lock()
        # every query records a trace; the sampler decides which the ring keeps
        self.trace_sampler = tracing.TraceSampler()
        self.trace_ring = tracing.TraceRing(capacity=256)
        self._lock = threading.RLock()
        self.quota = QueryQuotaManager(catalog)
        self.admission = AdmissionController(catalog, node=instance_id)
        self._backpressure_until: Dict[str, float] = {}
        self.failure_detector = FailureDetector(self.routing, node=instance_id)
        catalog.register_instance(InstanceInfo(instance_id, "broker"))

    def register_server_handle(self, server_id: str, handle: ServerHandle,
                               explain_handle=None, probe=None, stage_handle=None,
                               url: Optional[str] = None) -> None:
        """Wire a server's `execute_partial`; `explain_handle(table, ctx,
        segments) -> rows` serves EXPLAIN; `probe() -> bool` lets the failure
        detector bring the server back after a transport failure;
        `stage_handle(spec, left, right, agg=None) -> block | SegmentResult`
        runs one funnel-path join partition on the server (the partial GROUP
        BY too when `agg` is given); `url` is its HTTP endpoint: when every
        routed server has one, joins take the mailbox shuffle."""
        with self._lock:
            self._servers[server_id] = handle
            if explain_handle is not None:
                self._explain[server_id] = explain_handle
            if stage_handle is not None:
                self._stage[server_id] = stage_handle
            if url is not None:
                self._urls[server_id] = url.rstrip("/")
            else:
                self._urls.pop(server_id, None)
        if probe is not None:
            self.failure_detector.register_probe(server_id, probe)
        self.failure_detector.notify_healthy(server_id)
        self.routing.mark_server_healthy(server_id)
        emit_event("server.registered", node=self.instance_id, server=server_id)

    def unregister_server(self, server_id: str) -> None:
        with self._lock:
            self._servers.pop(server_id, None)
            self._explain.pop(server_id, None)
            self._stage.pop(server_id, None)
            self._urls.pop(server_id, None)
        self.failure_detector.remove(server_id)
        self.routing.mark_server_unhealthy(server_id)
        emit_event("server.unregistered", node=self.instance_id, server=server_id)

    # ------------------------------------------------------------------
    def handle_query(self, sql: str, stmt=None) -> ResultTable:
        """The broker's path: compile, route, scatter, gather, reduce. Under
        OPTION(trace=true) the spans come back in `stats["traceInfo"]`."""
        reg = get_registry()
        t0 = time.perf_counter()
        tr = None
        table = None
        self.admission.begin()
        try:
            try:
                if stmt is None:
                    from ..sql.parser import parse_query
                    stmt = parse_query(sql)
                stmt = self._rewrite_subqueries(stmt)
                table = stmt.table
                trace_on = _truthy(stmt.options.get("trace"))
                with tracing.request_trace(True) as tr:
                    tr.sampled = trace_on or self.trace_sampler.sample(
                        self._cluster_float("broker.trace.sample.rate") or 0.0)
                    from ..multistage.planner import stmt_has_in_subquery
                    if stmt.joins or stmt_has_in_subquery(stmt):
                        result = (self._explain_multistage(stmt) if stmt.explain
                                  else self._handle_multistage(stmt))
                    else:
                        result = self._handle_single(stmt, t0)
                    if trace_on:
                        result.stats["traceInfo"] = tr.to_rows()
                    result.stats["traceId"] = tr.trace_id
            except Exception:
                reg.counter("pinot_broker_query_exceptions").inc()
                elapsed_ms = (time.perf_counter() - t0) * 1000
                with self._obs_lock:
                    self._query_rollup["numExceptions"] += 1
                if table:
                    self._table_account(table, elapsed_ms, error=True)
                if tr is not None and tr.sampled:
                    self.trace_ring.admit(tr, sql=sql, error=True,
                                          timeUsedMs=round(elapsed_ms, 3))
                raise
        finally:
            self.admission.end()
        elapsed_ms = (time.perf_counter() - t0) * 1000
        result.stats["timeUsedMs"] = round(elapsed_ms, 3)
        reg.counter("pinot_broker_queries").inc()
        reg.timer("pinot_broker_query_latency_ms").update(elapsed_ms)
        self._account_query(sql, result, elapsed_ms, tr=tr, table=table)
        return result

    def _cluster_float(self, key: str) -> Optional[float]:
        prop = self.catalog.get_property(f"clusterConfig/{key}")
        try:
            return float(prop) if prop not in (None, "") else None
        except (TypeError, ValueError):
            return None

    def _account_query(self, sql: str, result: ResultTable, elapsed_ms: float,
                       tr=None, table=None) -> None:
        """Rollups, the trace ring and, over `broker.slow.query.ms`, one
        structured log line and the slow-query ring."""
        with self._obs_lock:
            self._query_rollup["numQueries"] += 1
            self._query_rollup["totalTimeMs"] += elapsed_ms
            self._query_rollup["maxTimeMs"] = max(self._query_rollup["maxTimeMs"], elapsed_ms)
        thr = self._cluster_float("broker.slow.query.ms")
        slow = thr is not None and elapsed_ms > thr
        if table:
            self._table_account(table, elapsed_ms, result=result, slow=slow)
        if tr is not None and (tr.sampled or slow):
            self.trace_ring.admit(tr, sql=sql, slow=slow, timeUsedMs=round(elapsed_ms, 3))
        if not slow:
            return
        entry = {"sql": sql, "timeUsedMs": round(elapsed_ms, 3), "thresholdMs": thr,
                 "brokerId": self.instance_id,
                 "stats": {k: v for k, v in result.stats.items()
                           if isinstance(v, (int, float, bool, str))}}
        if result.stats.get("traceInfo"):
            entry["traceSpans"] = result.stats["traceInfo"]
        with self._obs_lock:
            self._query_rollup["numSlowQueries"] += 1
            self._recent_slow.append(entry)
        get_registry().counter("pinot_broker_slow_queries").inc()
        logging.getLogger(self.SLOW_QUERY_LOGGER).warning(json.dumps(entry, default=str))

    # per-table rollup -> gauge family (gauges, so a dropped table's series go)
    _TABLE_GAUGES = {"numQueries": "pinot_table_queries", "numErrors": "pinot_table_errors",
                     "numSlowQueries": "pinot_table_slow_queries",
                     "numOverSlo": "pinot_table_over_slo",
                     "totalTimeMs": "pinot_table_time_ms",
                     "rowsScanned": "pinot_table_rows_scanned"}

    def _table_account(self, table: str, elapsed_ms: float, result=None,
                       slow: bool = False, error: bool = False) -> None:
        reg = get_registry()
        stats = result.stats if result is not None else {}
        scanned = stats.get(qstats.NUM_DOCS_SCANNED, 0)
        slo_target = self._cluster_float("slo.latency.p99.ms")
        with self._obs_lock:
            roll = self._table_rollup.setdefault(table, {k: 0.0 for k in self._TABLE_GAUGES})
            roll["numQueries"] += 1
            roll["totalTimeMs"] += elapsed_ms
            roll["numErrors"] += 1 if error else 0
            roll["numSlowQueries"] += 1 if slow else 0
            roll["numOverSlo"] += 1 if slo_target is not None and elapsed_ms > slo_target else 0
            roll["rowsScanned"] += float(scanned) if isinstance(scanned, (int, float)) else 0.0
            snapshot = dict(roll)
        for key, gname in self._TABLE_GAUGES.items():
            reg.gauge(gname, {"table": table}).set(round(snapshot[key], 3))
        reg.histogram("pinot_table_latency_ms", {"table": table}).observe(elapsed_ms)
        self._maybe_sweep_dropped_tables()

    def _maybe_sweep_dropped_tables(self, force: bool = False) -> None:
        """Drop the rollups of tables the catalog no longer has (every 64
        queries, and on each `debug_stats`)."""
        with self._obs_lock:
            self._table_sweep_countdown -= 1
            if not force and self._table_sweep_countdown > 0:
                return
            self._table_sweep_countdown = 64
            tracked = set(self._table_rollup)
        live = set()
        for name in list(self.catalog.table_configs):
            live.add(name)
            for t in TableType:
                if name.endswith(f"_{t.value}"):
                    live.add(name[: -len(t.value) - 1])
        dead = tracked - live
        if not dead:
            return
        reg = get_registry()
        with self._obs_lock:
            for table in dead:
                self._table_rollup.pop(table, None)
        for table in dead:
            for gname in list(self._TABLE_GAUGES.values()) + ["pinot_table_latency_ms"]:
                reg.remove(gname, {"table": table})

    def debug_stats(self) -> Dict:
        """Lifetime query rollups, per-table rollups with their p99, the
        slow-query ring, the trace ring's size, the failure detector and the
        admission state."""
        self._maybe_sweep_dropped_tables(force=True)
        reg = get_registry()
        with self._obs_lock:
            rollup = dict(self._query_rollup)
            recent = list(self._recent_slow)
            tables = {t: dict(r) for t, r in self._table_rollup.items()}
        n = rollup["numQueries"]
        rollup["avgTimeMs"] = round(rollup["totalTimeMs"] / n, 3) if n else 0.0
        for t, r in tables.items():
            nq = r["numQueries"]
            r["avgTimeMs"] = round(r["totalTimeMs"] / nq, 3) if nq else 0.0
            r["p99LatencyMs"] = reg.histogram("pinot_table_latency_ms",
                                              {"table": t}).percentile(0.99)
        return {"instanceId": self.instance_id, "queryStats": rollup, "tableStats": tables,
                "slowQueryThresholdMs": self._cluster_float("broker.slow.query.ms"),
                "recentSlowQueries": recent,
                "traceRing": {"retained": len(self.trace_ring),
                              "capacity": self.trace_ring.capacity},
                "brokerMetrics": {k: v for k, v in sorted(reg.snapshot().items())
                                  if k.startswith("pinot_broker_")},
                "failureDetector": self.failure_detector.snapshot(),
                "admission": self.admission.snapshot()}

    # ------------------------------------------------------------------
    def _admit_tables(self, raw_table: str) -> List[str]:
        """The physical tables, after the state, quota and admission checks
        (a shed refunds its quota tokens)."""
        physical = self._physical_tables(raw_table)
        if not physical:
            raise QueryValidationError(f"unknown table {raw_table!r}")
        if any(self.catalog.get_property(f"tableState/{t}") == "disabled" for t in physical):
            raise QueryValidationError(f"table {raw_table!r} is disabled")
        if not self.quota.try_acquire_all(physical):
            get_registry().counter("pinot_broker_queries_throttled").inc()
            raise QueryRejectedError(f"table {raw_table!r} exceeded its query quota")
        return physical

    def _handle_single(self, stmt, t0: float) -> ResultTable:
        with tracing.span("compile"):
            stmt_ctx = compile_query(stmt)
        raw_table = stmt_ctx.table
        t_compile = time.perf_counter()
        physical = self._admit_tables(raw_table)
        schema = self.catalog.schemas.get(self.catalog.table_configs[physical[0]].name)
        ctx = compile_query(stmt, schema)
        # the deadline: every later stage clamps to the time left
        if "deadlineEpochMs" not in ctx.options:
            t_ms = ctx.options.get("timeoutMs")
            budget_s = float(t_ms) / 1000.0 if t_ms is not None else self.stage_timeout_s
            ctx.options["deadlineEpochMs"] = (time.time() + budget_s) * 1000.0
        if ctx.analyze:
            return self._handle_analyze(stmt, ctx, physical, t0)
        if ctx.explain:
            return self._handle_explain(ctx, physical)
        try:
            self.admission.admit(raw_table, ctx)
        except Exception:
            for t in physical:
                self.quota.refund(t)
            raise
        if self._should_distribute_groupby(ctx, physical):
            from ..multistage.shuffle import P2PUnavailable, coordinate_groupby
            try:
                result = coordinate_groupby(self, ctx, physical, self._num_partitions(stmt))
                result.stats["timeUsedMs"] = round((time.perf_counter() - t0) * 1000, 3)
                return result
            except P2PUnavailable:
                # in-process handles, or workers out of routing: the scatter
                # path's merge answers (correct, not distributed), counted
                get_registry().counter("pinot_broker_p2p_fallbacks").inc()

        aggs = [make_agg(f) for f in ctx.aggregations]
        group_exprs = [e for e, _ in ctx.select_items] if ctx.distinct else list(ctx.group_by)
        partials: List[SegmentResult] = []
        # an EXPLAIN ANALYZE's record, when one is active, takes the partials' stats
        exec_stats = qstats.current_stats() or qstats.ExecutionStats()
        servers_queried = servers_failed = 0
        uncovered_segments: List[str] = []
        query_errors: List[Exception] = []
        error_segments: Set[str] = set()
        boundary = self._time_boundary(physical)
        tr = tracing.current_trace()

        def traced(handle, server_id):
            if tr is None:
                return handle

            def call(*args):
                with tr.activate(), tracing.span(f"server:{server_id}"):
                    return handle(*args)
            return call

        for table in physical:
            tf_expr = _boundary_expr(boundary, table)
            tf = to_sql(tf_expr) if tf_expr is not None else None
            unroutable: List[str] = []
            prune_counts: Dict[str, float] = {}
            with tracing.span("route"):
                routing = self.routing.route_query(table, ctx, extra_filter=tf_expr,
                                                   uncovered=unroutable,
                                                   prune_stats=prune_counts)
            _record_prune_stats(exec_stats, prune_counts)
            uncovered_segments.extend(f"{table}:{s}" for s in sorted(unroutable))
            missing: Dict[str, Set[str]] = {}   # segment -> servers that missed it
            units: List[_DispatchUnit] = []
            for server_id, segments in routing.items():
                handle = self._servers.get(server_id)
                if handle is None:
                    # unregistered between routing and dispatch: retried below
                    for seg in segments:
                        missing.setdefault(seg, set()).add(server_id)
                    continue
                fut = self._dispatch_partial(handle, server_id, traced, table, ctx,
                                             segments, tf)
                units.append(_DispatchUnit(server_id, list(segments), fut))
            q, f = self._gather_units(table, ctx, tf, traced, units, partials, exec_stats,
                                      missing, query_errors, error_segments)
            servers_queried += q
            servers_failed += f
            if missing:
                # one retry round on the other replicas: a replica that missed
                # a segment never shortens the answer silently
                exec_stats.add(qstats.NUM_SEGMENTS_RETRIED, len(missing))
                retry_results, retry_failed = self._retry_missing(
                    table, ctx, missing, tf, traced, exec_stats=exec_stats)
                partials.extend(r for r, _ in retry_results)
                for r, _ in retry_results:
                    exec_stats.merge(r.stats)
                servers_queried += len(retry_results) + retry_failed
                servers_failed += retry_failed
                uncovered = _uncovered_after_retry(missing, retry_results)
                if query_errors and error_segments & uncovered:
                    # the error held on every replica tried: it is the query's
                    raise query_errors[0]
                uncovered_segments.extend(f"{table}:{s}" for s in sorted(uncovered))

        t_scatter = time.perf_counter()
        with tracing.span("reduce"):
            merged = merge_segment_results(partials, aggs)
            if not partials:
                merged.kind = "groups" if group_exprs else "scalar" if aggs else "selection"
            result = reduce_to_result(ctx, merged, aggs, group_exprs)
        t_reduce = time.perf_counter()
        if uncovered_segments:
            get_registry().counter("pinot_broker_segments_unavailable").inc(
                len(uncovered_segments))
            result.stats["segmentsUnavailable"] = uncovered_segments
        exec_stats.add_operator("COMBINE", rows=merged.num_docs_scanned,
                                ms=(t_scatter - t_compile) * 1000)
        exec_stats.add_operator("BROKER_REDUCE", rows=len(result.rows),
                                ms=(t_reduce - t_scatter) * 1000)
        result.stats.update({k: 0 for k in qstats.BROKER_COUNTER_KEYS})
        result.stats.update(exec_stats.to_public_dict())
        result.stats.update({
            qstats.NUM_DOCS_SCANNED: merged.num_docs_scanned,
            "numServersQueried": servers_queried,
            "numServersResponded": servers_queried - servers_failed,
            "partialResult": servers_failed > 0 or bool(uncovered_segments),
            "phaseTimesMs": {"compile": round((t_compile - t0) * 1000, 3),
                             "scatter": round((t_scatter - t_compile) * 1000, 3),
                             "reduce": round((t_reduce - t_scatter) * 1000, 3)},
        })
        return result

    def _should_distribute_groupby(self, ctx, physical: List[str]) -> bool:
        """Whether the query asks for the distributed GROUP BY: an explicit
        OPTION(distributedGroupBy / useMultistageEngine) or the cluster's
        `broker.distributedGroupByDocThreshold` crossed."""
        if ctx.gapfill is not None:
            return False
        if not (ctx.group_by or ctx.distinct):
            return False
        opt = {str(k).lower(): v for k, v in (ctx.options or {}).items()}
        if "distributedgroupby" in opt:
            return _truthy(opt["distributedgroupby"])
        if _truthy(opt.get("usemultistageengine")):
            return True
        thr = self.catalog.get_property("clusterConfig/broker.distributedGroupByDocThreshold")
        if thr:
            docs = sum(m.num_docs for t in physical
                       for m in self.catalog.segments.get(t, {}).values())
            return docs > int(thr)
        return False

    def stream_query(self, sql: str, stmt=None):
        """Yields ("schema", columns) once, then ("rows", batch) a server
        partial at a time (the reference's streaming selection). Only a plain
        selection streams; any other query (a join or an IN-subquery too) is
        answered whole, as one batch.
        A segment no replica serves ends the export with an error."""
        from ..sql.parser import parse_query
        if stmt is None:
            stmt = parse_query(sql)
        stmt = self._rewrite_subqueries(stmt)
        from ..multistage.planner import stmt_has_in_subquery
        multistage = bool(stmt.joins) or stmt_has_in_subquery(stmt)
        probe = None if multistage else compile_query(stmt)
        if multistage or probe.is_aggregation_query or probe.distinct or probe.order_by \
                or probe.offset or probe.explain:
            result = self.handle_query(sql, stmt=stmt)
            yield ("schema", result.columns)
            if result.rows:
                yield ("rows", result.rows)
            return
        physical = self._admit_tables(probe.table)
        try:
            self.admission.admit(probe.table, probe)
        except Exception:
            for t in physical:
                self.quota.refund(t)
            raise
        get_registry().counter("pinot_broker_queries").inc()
        schema = self.catalog.schemas.get(self.catalog.table_configs[physical[0]].name)
        ctx = compile_query(stmt, schema)
        yield ("schema", reduce_to_result(ctx, SegmentResult("selection"), [], []).columns)
        remaining = ctx.limit if ctx.limit is not None else UNBOUNDED_LIMIT
        boundary = self._time_boundary(physical)
        for table in physical:
            tf_expr = _boundary_expr(boundary, table)
            tf = to_sql(tf_expr) if tf_expr is not None else None
            unroutable: List[str] = []
            routing = self.routing.route_query(table, ctx, extra_filter=tf_expr,
                                               uncovered=unroutable)
            if unroutable:
                raise RuntimeError(f"streaming export incomplete: segments "
                                   f"{sorted(unroutable)} have no healthy replica")
            for server_id, segments in routing.items():
                if remaining <= 0:
                    return
                handle = self._servers.get(server_id)
                partial = None
                missed: Set[str] = set(segments)
                query_error: Optional[Exception] = None
                if handle is not None:
                    try:
                        partial = handle(table, ctx, segments, tf)
                        missed = (set(segments) - set(partial.served)
                                  if partial.served is not None else set())
                    except Exception as e:
                        if _is_transport_failure(e):
                            self.routing.mark_server_unhealthy(server_id)
                            self.failure_detector.notify_unhealthy(server_id)
                        elif not _is_backpressure(e):
                            query_error = e
                batches = [] if partial is None else [partial]
                if missed:
                    retries, failed = self._retry_missing(
                        table, ctx, {s: {server_id} for s in missed}, tf, None)
                    uncovered = _uncovered_after_retry({s: set() for s in missed}, retries)
                    if failed or uncovered:
                        if query_error is not None:
                            raise query_error
                        raise RuntimeError(f"streaming export incomplete: segments "
                                           f"{sorted(uncovered)} unavailable on all replicas")
                    batches = [r for r, _ in retries] + batches
                for r in batches:
                    rows = reduce_to_result(ctx, r, [], []).rows[:remaining]
                    if rows:
                        remaining -= len(rows)
                        yield ("rows", rows)

    # -- scatter / gather -------------------------------------------------
    def _dispatch_partial(self, handle, server_id: str, traced, table, ctx, segments,
                          tf) -> Future:
        """One server partial, async-first: a handle's `submit_async` (the
        mux transport) returns a Future without taking a scatter-pool thread
        for the round trip, so the partials in flight are bounded by the
        servers' flow-control windows, not by the pool. A handle without it,
        or one whose `submit_async` returns None (mux off, or a peer without
        /mux), takes a pool thread. A synchronous failure becomes a failed
        Future, which the gather's failure taxonomy sorts like any other."""
        submit = getattr(handle, "submit_async", None)
        if submit is not None:
            try:
                fut = submit(table, ctx, segments, tf, span_name=f"server:{server_id}")
            except Exception as e:
                fut = Future()
                fut.set_exception(e)
                return fut
            if fut is not None:
                return fut
        call = traced(handle, server_id) if traced is not None else handle
        return self._pool.submit(call, table, ctx, segments, tf)

    def _hedge_params(self) -> Tuple[bool, float, int]:
        """(enabled, delay in seconds, most hedges a query) from
        `broker.hedge.enabled`, `.delay.ms` (<= 0: the dispatch latency's
        p99) and `.max`."""
        if not _truthy(self.catalog.get_property("clusterConfig/broker.hedge.enabled", False)):
            return False, 0.0, 0
        delay_ms = self._cluster_float("broker.hedge.delay.ms") or 0.0
        if delay_ms <= 0:
            p99 = get_registry().histogram("pinot_broker_dispatch_latency_ms").percentile(0.99)
            delay_ms = p99 if p99 > 0 else self.HEDGE_DEFAULT_DELAY_MS
        budget = self._cluster_float("broker.hedge.max")
        return True, delay_ms / 1000.0, max(0, int(2 if budget is None else budget))

    def _note_backpressure(self, server_id: str, hint_ms: Optional[float]) -> None:
        hold_s = (min(hint_ms / 1000.0, self.BACKPRESSURE_MAX_S)
                  if hint_ms is not None and hint_ms > 0 else self.BACKPRESSURE_DEFAULT_S)
        self._backpressure_until[server_id] = time.monotonic() + hold_s
        emit_event("backpressure.hold", node=self.instance_id, server=server_id,
                   holdMs=round(hold_s * 1000.0, 3))

    def _backpressured_servers(self) -> Set[str]:
        now = time.monotonic()
        for s, t in list(self._backpressure_until.items()):
            if t <= now:
                self._backpressure_until.pop(s, None)
        return {s for s, t in list(self._backpressure_until.items()) if t > now}

    def _hedge_target(self, table: str, primary: str, segments: Sequence[str]) -> Optional[str]:
        """A healthy replica, not in backpressure, that serves every segment
        of the unit, or None."""
        unhealthy = self.routing.unhealthy_servers()
        backpressured = self._backpressured_servers()
        candidates: Optional[Set[str]] = None
        for seg in segments:
            cands = {c for c in self.routing.segment_candidates(table, seg)
                     if c != primary and c in self._servers
                     and c not in unhealthy and c not in backpressured}
            candidates = cands if candidates is None else candidates & cands
            if not candidates:
                return None
        return min(candidates) if candidates else None

    def _gather_units(self, table: str, ctx, tf, traced, units: List[_DispatchUnit],
                      partials: List[SegmentResult], exec_stats,
                      missing: Dict[str, Set[str]], query_errors: List[Exception],
                      error_segments: Set[str]) -> Tuple[int, int]:
        """Gather one table's scatter round, hedging stragglers when
        `broker.hedge.enabled` (a unit fails only when every copy failed).
        Every failed unit's segments enter `missing`. Returns (units
        resolved, units failed)."""
        reg = get_registry()
        disp_hist = reg.histogram("pinot_broker_dispatch_latency_ms")
        hedge_on, hedge_delay_s, hedge_budget = self._hedge_params()
        if hedge_on and self.admission.overloaded():
            # a shedding broker does not double its own load
            hedge_on = False
            reg.counter("pinot_broker_hedges_suppressed").inc()
            emit_event("hedge.suppressed", node=self.instance_id, table=table)
        hedges_sent = queried = failed = 0
        owner: Dict[Future, _DispatchUnit] = {u.primary: u for u in units}
        unresolved = set(units)
        deadline = time.monotonic() + self.stage_timeout_s

        def classify(u: _DispatchUnit, server_id: str, exc: BaseException) -> None:
            if _is_transport_failure(exc):
                self.routing.mark_server_unhealthy(server_id)
                self.failure_detector.notify_unhealthy(server_id)
            elif _is_backpressure(exc):
                self._note_backpressure(server_id, getattr(exc, "retry_after_ms", None))
            else:
                query_errors.append(exc)
                error_segments.update(u.segments)

        while unresolved:
            now = time.monotonic()
            if now >= deadline:
                break
            wait_set: List[Future] = []
            next_due: Optional[float] = None
            for u in unresolved:
                if u.primary not in u.failed:
                    wait_set.append(u.primary)
                if u.hedge is not None and u.hedge not in u.failed:
                    wait_set.append(u.hedge)
                if hedge_on and hedges_sent < hedge_budget and u.hedge is None \
                        and not u.hedge_exhausted and u.primary not in u.failed:
                    due = u.t0 + hedge_delay_s
                    next_due = due if next_due is None else min(next_due, due)
            timeout = deadline - now
            if next_due is not None:
                timeout = min(timeout, max(next_due - now, 0.0))
            done = futures_wait(wait_set, timeout=timeout,
                                return_when=FIRST_COMPLETED)[0] if wait_set else set()
            for fut in done:
                u = owner[fut]
                if u not in unresolved:
                    continue   # the other copy already won
                is_hedge = fut is u.hedge
                server_id = u.hedge_server if is_hedge else u.server
                try:
                    partial = fut.result()
                except Exception as e:
                    u.failed[fut] = e
                    classify(u, server_id, e)
                    other = u.primary if is_hedge else u.hedge
                    if other is not None and other not in u.failed:
                        continue   # the other copy may still answer
                    unresolved.discard(u)
                    queried += 1
                    failed += 1
                    for seg in u.segments:
                        missing.setdefault(seg, set()).add(u.server)
                        if u.hedge_server is not None:
                            missing[seg].add(u.hedge_server)
                    continue
                unresolved.discard(u)
                queried += 1
                disp_hist.observe((time.monotonic() - u.t0) * 1000)
                partials.append(partial)
                exec_stats.merge(partial.stats)
                if partial.served is not None:
                    for seg in set(u.segments) - set(partial.served):
                        missing.setdefault(seg, set()).add(server_id)
            if hedge_on and hedges_sent < hedge_budget:
                now = time.monotonic()
                for u in list(unresolved):
                    if hedges_sent >= hedge_budget:
                        break
                    if u.hedge is not None or u.hedge_exhausted or u.primary in u.failed \
                            or now - u.t0 < hedge_delay_s:
                        continue
                    alt = self._hedge_target(table, u.server, u.segments)
                    if alt is None:
                        u.hedge_exhausted = True
                        continue
                    hf = self._dispatch_partial(self._servers[alt], alt, traced, table, ctx,
                                                u.segments, tf)
                    owner[hf] = u
                    u.hedge, u.hedge_server = hf, alt
                    hedges_sent += 1
                    exec_stats.add(qstats.HEDGED_REQUESTS)
                    reg.counter("pinot_broker_hedged_requests").inc()
        # past the stage deadline: a straggler is a transport failure, its
        # segments go to the retry round
        for u in unresolved:
            queried += 1
            failed += 1
            for server_id, fut in ((u.server, u.primary), (u.hedge_server, u.hedge)):
                if fut is None or fut in u.failed:
                    continue
                self.routing.mark_server_unhealthy(server_id)
                self.failure_detector.notify_unhealthy(server_id)
            for seg in u.segments:
                missing.setdefault(seg, set()).add(u.server)
                if u.hedge_server is not None:
                    missing[seg].add(u.hedge_server)
        return queried, failed

    def _retry_missing(self, table: str, ctx, missing: Dict[str, Set[str]],
                       tf: Optional[str], traced, exec_stats=None
                       ) -> Tuple[List[Tuple[SegmentResult, List[str]]], int]:
        """One retry round: each missed segment to another healthy replica,
        in parallel. Returns ([(partial, segments sent to it)], failed
        count). A strictReplicaGroup table never retries a segment alone on
        another replica (an upsert table's valid-doc masks agree only within
        one replica): its segments stay uncovered."""
        if self.routing.selector_for(table) == "strictreplicagroup":
            return [], 0
        backpressured = self._backpressured_servers()
        unhealthy = self.routing.unhealthy_servers()
        now = time.monotonic()
        by_server: Dict[str, List[str]] = {}
        defer_until = 0.0
        for seg, missed_on in missing.items():
            cands = [c for c in self.routing.segment_candidates(table, seg)
                     if c not in missed_on and c in self._servers and c not in unhealthy]
            ready = [c for c in cands if c not in backpressured]
            if ready:
                by_server.setdefault(ready[0], []).append(seg)
            elif cands:
                # every live replica is held: wait out the soonest hint
                c = min(cands, key=lambda s: self._backpressure_until.get(s, 0.0))
                defer_until = max(defer_until, self._backpressure_until.get(c, 0.0))
                by_server.setdefault(c, []).append(seg)
        if defer_until > now:
            delay = min(defer_until - now, self.RETRY_DEFER_CAP_S,
                        max(0.0, _deadline_remaining_s(ctx)))
            if delay > 0:
                time.sleep(delay)
                if exec_stats is not None:
                    exec_stats.add(qstats.ADMISSION_DEFER_MS, round(delay * 1000, 3))
        futures = {self._dispatch_partial(self._servers[s], s, traced, table, ctx, segs, tf):
                   (s, segs) for s, segs in by_server.items()}
        out: List[Tuple[SegmentResult, List[str]]] = []
        failed = 0
        pending = set(futures)
        try:
            for fut in as_completed(futures, timeout=self.stage_timeout_s):
                pending.discard(fut)
                server_id, segs = futures[fut]
                try:
                    out.append((fut.result(), segs))
                except Exception as e:
                    failed += 1
                    if _is_transport_failure(e):
                        self.routing.mark_server_unhealthy(server_id)
                        self.failure_detector.notify_unhealthy(server_id)
        except FutureTimeoutError:
            for fut in pending:
                server_id, _ = futures[fut]
                failed += 1
                self.routing.mark_server_unhealthy(server_id)
                self.failure_detector.notify_unhealthy(server_id)
        return out, failed

    # -- EXPLAIN / EXPLAIN ANALYZE ----------------------------------------
    def _handle_explain(self, ctx, physical: List[str]) -> ResultTable:
        """EXPLAIN: one server a physical table gives its operator plan (the
        replicas are identical); a hybrid table's halves splice under one
        broker prefix, each under its time-boundary predicate."""
        boundary = self._time_boundary(physical)
        merged: Optional[List[list]] = None
        for table in physical:
            tf_expr = _boundary_expr(boundary, table)
            ctx_t = ctx if tf_expr is None else dataclasses.replace(
                ctx, filter=tf_expr if ctx.filter is None
                else Function("and", (ctx.filter, tf_expr)))
            rows = None
            for server_id, segments in self.routing.route_query(table, ctx_t).items():
                handle = self._explain.get(server_id)
                if handle is not None and segments:
                    rows = [list(r) for r in handle(table, ctx_t, segments)]
                    break
            if not rows or len(rows) < 2:
                continue
            if merged is None:
                merged = rows
            else:
                # this table's segment subtrees go under the merged COMBINE
                shift = len(merged) - 2
                for op, op_id, parent in rows[2:]:
                    merged.append([op, op_id + shift, 1 if parent == 1 else parent + shift])
        if merged is None:
            return explain_result(ctx, [])
        return ResultTable(["Operator", "Operator_Id", "Parent_Id"], merged, {"explain": True})

    def _handle_analyze(self, stmt, ctx, physical: List[str], t0: float) -> ResultTable:
        """EXPLAIN ANALYZE: run the query through the scatter path under a
        stats record, then annotate the distributed plan with the rows and
        milliseconds each operator recorded."""
        run_stmt = dataclasses.replace(stmt, explain=False, analyze=False)
        with qstats.collect_stats() as st:
            inner = self._handle_single(run_stmt, t0)
        total_ms = (time.perf_counter() - t0) * 1000
        plan = self._handle_explain(ctx, physical)
        rows = annotate_plan_rows(plan.rows, st, len(inner.rows), total_ms)
        prune_row = _broker_prune_row(st, parent_id=0, next_id=len(rows))
        if prune_row is not None:
            rows.append(prune_row)
        res = ResultTable(list(ANALYZE_COLUMNS), rows, dict(inner.stats))
        res.stats.update(st.to_public_dict())
        res.stats["explain"] = True
        res.stats["analyze"] = True
        return res

    # -- the multistage half ----------------------------------------------
    def _rewrite_subqueries(self, stmt):
        """`IN_SUBQUERY(expr, 'inner sql')`: the inner query runs through this
        broker and its serialized id set is spliced in as `IN_ID_SET(expr,
        '...')` (reference: BaseBrokerRequestHandler's subquery recursion; the
        inner query must give one IDSET(...) value). Nested subqueries resolve
        as each handle_query rewrites its own statement. The `x IN (SELECT
        ...)` form stays: the multistage planner lowers it to a SEMI join. The
        rewritten statement's SQL text is regenerated, since a remote server
        recompiles its partial from the text."""
        from ..sql.ast import Subquery, walk

        def rw(e):
            if not isinstance(e, Function):
                return e
            if e.name in ("in_subquery", "in_partitioned_subquery"):
                if len(e.args) == 2 and isinstance(e.args[1], Subquery):
                    return e
                if len(e.args) != 2 or not isinstance(e.args[1], Literal):
                    raise QueryValidationError(f"IN_SUBQUERY(expr, 'sql') expected: {e!r}")
                sub = self.handle_query(str(e.args[1].value))
                if len(sub.rows) != 1 or len(sub.rows[0]) != 1 \
                        or not isinstance(sub.rows[0][0], str):
                    raise QueryValidationError(
                        "IN_SUBQUERY inner query must return exactly one serialized "
                        "id-set (use IDSET(col))")
                return Function("in_id_set", (rw(e.args[0]), Literal(sub.rows[0][0])))
            return Function(e.name, tuple(rw(a) for a in e.args))

        if stmt.where is None or not any(
                isinstance(n, Function) and n.name in ("in_subquery", "in_partitioned_subquery")
                for n in walk(stmt.where)):
            return stmt
        out = dataclasses.replace(stmt, where=rw(stmt.where))
        if not out.joins:
            out.raw = _statement_sql(out)
        return out

    def _schema_for(self, raw_table: str):
        phys = self._physical_tables(raw_table)
        return self.catalog.schema_for_table(phys[0]) if phys else None

    def _explain_multistage(self, stmt) -> ResultTable:
        """EXPLAIN of a join query: the stage plan, not run (reference: the v2
        engine's logical stage tree), each join with the strategy the catalog's
        metadata chooses."""
        from ..multistage.planner import choose_join_strategy, plan_multistage
        from ..multistage.shuffle import _broadcast_max_bytes
        plan = plan_multistage(stmt, self._schema_for)

        def est_bytes(alias: str) -> int:
            scan = plan.scans[alias]
            docs = sum(int(getattr(m, "num_docs", 0))
                       for t in self._physical_tables(scan.table)
                       for m in self.catalog.segments.get(t, {}).values())
            return docs * max(1, len(scan.columns)) * 8

        bmax = _broadcast_max_bytes(self)
        rows: List[list] = [["MULTISTAGE_REDUCE", 0, -1]]
        parent = 0
        for j in reversed(plan.joins):
            keys = ", ".join(f"{lk}={rk}" for lk, rk in zip(j.left_keys, j.right_keys))
            strategy = choose_join_strategy(j.join_type, est_bytes(j.right_alias), bmax)
            rows.append([f"HASH_JOIN(type:{j.join_type}; keys:[{keys}]; "
                         f"strategy:{strategy})", len(rows), parent])
            parent = len(rows) - 1
        for alias in [plan.base_alias] + [j.right_alias for j in plan.joins]:
            scan = plan.scans[alias]
            label = f"TABLE_SCAN(table:{scan.table}; alias:{alias}"
            if scan.filter is not None:
                label += f"; pushdownFilter:{to_sql(scan.filter)}"
            rows.append([label + ")", len(rows), parent])
        return ResultTable(["Operator", "Operator_Id", "Parent_Id"], rows, {"explain": True})

    def _num_partitions(self, stmt) -> int:
        """The shuffle's width: OPTION(numPartitions / stageParallelism), else
        the runtime's DEFAULT_PARTITIONS."""
        from ..multistage.runtime import DEFAULT_PARTITIONS
        num_partitions = DEFAULT_PARTITIONS
        for key, v in (stmt.options or {}).items():
            if key.lower() in ("numpartitions", "stageparallelism"):
                try:
                    num_partitions = max(1, int(v))
                except (TypeError, ValueError):
                    raise QueryValidationError(
                        f"OPTION({key}=...) must be an integer, got {v!r}") from None
        return num_partitions

    def _stage_workers(self, p: int) -> List[Tuple[str, str]]:
        """Exactly p (server, url) worker slots, round-robin over the healthy
        servers that have an HTTP endpoint (reference: the v2 dispatcher's
        worker assignment)."""
        from ..multistage.shuffle import P2PUnavailable
        unhealthy = self.routing.unhealthy_servers()
        with self._lock:
            cands = sorted((sid, u) for sid, u in self._urls.items()
                           if sid in self._servers and sid not in unhealthy)
        if not cands:
            raise P2PUnavailable("no HTTP-reachable stage workers")
        return [cands[i % len(cands)] for i in range(p)]

    def _route_leaf_table(self, table: str, ctx, boundary, routes: list) -> None:
        """One physical table's leaf routes: full coverage, an HTTP endpoint
        a routed server, a LeafRoute each (appended to `routes`)."""
        from ..multistage.shuffle import LeafRoute, P2PUnavailable
        tf_expr = _boundary_expr(boundary, table)
        tf = to_sql(tf_expr) if tf_expr is not None else None
        unroutable: List[str] = []
        routing = self.routing.route_query(table, ctx, extra_filter=tf_expr,
                                           uncovered=unroutable)
        if unroutable:
            raise RuntimeError(f"distributed scan incomplete: segments "
                               f"{sorted(unroutable)} have no healthy replica")
        for server_id, segments in routing.items():
            url = self._urls.get(server_id)
            if url is None:
                raise P2PUnavailable(f"server {server_id} has no HTTP endpoint")
            if segments:
                routes.append(LeafRoute(server_id, url, table, list(segments), tf))

    def _leaf_routes(self, raw_table: str, columns, filt):
        """A join scan's leaf routes. No quota here: the coordinator takes it
        once every alias routed, so a fallback never charges a table twice."""
        physical = self._physical_tables(raw_table)
        if not physical:
            raise QueryValidationError(f"unknown table {raw_table!r}")
        boundary = self._time_boundary(physical)
        routes: list = []
        for table in physical:
            ctx = _leaf_ctx(table, columns, filt)
            self._route_leaf_table(table, ctx, boundary, routes)
        return routes

    def _acquire_scan_quota(self, raw_tables) -> None:
        """One QPS-quota acquisition a logical table (the funnel path's
        accounting)."""
        for raw in raw_tables:
            if not self.quota.try_acquire_all(self._physical_tables(raw)):
                raise QueryRejectedError(f"table {raw!r} exceeded its query quota")

    def _leaf_routes_groupby(self, ctx, physical: List[str]):
        """A distributed GROUP BY's leaf routes."""
        boundary = self._time_boundary(physical)
        routes: list = []
        for table in physical:
            self._route_leaf_table(table, ctx, boundary, routes)
        return routes

    def _post_leaf_task(self, url: str, path: str, task) -> Dict:
        from .http_service import http_call
        from .wire import decode_value, encode_value
        return decode_value(http_call("POST", f"{url}/{path}", encode_value(task),
                                      timeout=self.stage_timeout_s,
                                      content_type="application/octet-stream"))

    def _data_plane_cap(self) -> Optional[int]:
        cap = self.max_data_plane_bytes
        if cap is None:
            prop = self.catalog.get_property("clusterConfig/broker.maxDataPlaneBytes")
            cap = int(prop) if prop else None
        return cap

    def _handle_multistage(self, stmt) -> ResultTable:
        """A join query: the peer-to-peer mailbox shuffle when every routed
        server is HTTP-reachable (inter-stage data streams server to server,
        the broker receives only final-stage partials); otherwise the funnel
        path, `execute_multistage` over a scatter-based leaf scan, whose rows
        this broker buffers under the data-plane cap."""
        from ..multistage.runtime import (configure_device_join, execute_multistage,
                                          run_join_stage)
        from ..multistage.shuffle import P2PUnavailable, _broadcast_max_bytes, coordinate_join
        from ..query.executor import resolve_device

        # `server.join.device.enabled`: operators can send every join's build
        # and probe to the host fleet-wide without restarting a server
        dev_knob = self.catalog.get_property("clusterConfig/server.join.device.enabled")
        if dev_knob is not None:
            configure_device_join(enabled=str(dev_knob).strip().lower()
                                  not in ("false", "0", "no", "off"))
        opt = {str(k).lower(): v for k, v in (stmt.options or {}).items()}
        if "usemailboxshuffle" not in opt or _truthy(opt["usemailboxshuffle"]):
            try:
                return coordinate_join(self, stmt, self._num_partitions(stmt))
            except P2PUnavailable:
                # in-process handles, or a server without an endpoint: the
                # funnel path, counted
                get_registry().counter("pinot_broker_p2p_fallbacks").inc()

        device = resolve_device(self.device)

        def stage_runner():
            """Round-robin dispatch of join (and partial-aggregation)
            partitions to the healthy servers' stage handles; a partition runs
            here, on the broker's device, when none is wired or its dispatch
            fails (counted; a transport failure takes the server out of
            routing and out of this query's rotation; a query error raises
            again from the local run)."""
            import itertools
            unhealthy = self.routing.unhealthy_servers()
            with self._lock:
                workers = [(sid, h) for sid, h in self._stage.items() if sid not in unhealthy]
            if not workers:
                return None
            rr = itertools.count()
            lock = threading.Lock()

            def run(spec, lp, rp, agg=None):
                with lock:
                    pool = list(workers)
                if not pool:
                    return run_join_stage(spec, lp, rp, agg, device=device)
                sid, h = pool[next(rr) % len(pool)]
                try:
                    return h(spec, lp, rp, agg)
                except Exception as e:
                    get_registry().counter("pinot_broker_stage_dispatch_failures").inc()
                    if _is_transport_failure(e):
                        self.routing.mark_server_unhealthy(sid)
                        self.failure_detector.notify_unhealthy(sid)
                        with lock:
                            workers[:] = [(s, hh) for s, hh in workers if s != sid]
                    return run_join_stage(spec, lp, rp, agg, device=device)
            return run

        # the funnel path holds every leaf row here: meter it, under the cap
        moved = {"bytes": 0}
        cap = self._data_plane_cap()

        def account(nbytes: int) -> None:
            moved["bytes"] += nbytes
            get_registry().counter("pinot_broker_data_plane_bytes").inc(nbytes)
            if cap is not None and moved["bytes"] > cap:
                raise RuntimeError(
                    f"broker data-plane memory cap exceeded ({moved['bytes']} > {cap} bytes "
                    f"buffered at the broker); run servers with HTTP endpoints so the "
                    f"mailbox shuffle streams inter-stage data server to server")

        def scan(raw_table: str, columns, filt, derived=None):
            # `filt` already holds the build-key filter `derived`
            import numpy as np
            from ..sql.ast import _sql_ident
            if not self.quota.try_acquire_all(self._physical_tables(raw_table)):
                raise QueryRejectedError(f"table {raw_table!r} exceeded its query quota")
            schema = self._schema_for(raw_table)
            rows: List[tuple] = []
            # SQL that a remote server recompiles, identifiers quoted as needed
            leaf_sql = (f"SELECT {', '.join(_sql_ident(c) for c in columns)} "
                        f"FROM {_sql_ident(raw_table)}")
            if filt is not None:
                leaf_sql += f" WHERE {to_sql(filt)}"
            leaf_sql += f" LIMIT {UNBOUNDED_LIMIT}"
            physical = self._physical_tables(raw_table)
            boundary = self._time_boundary(physical)
            for table in physical:
                ctx = dataclasses.replace(_leaf_ctx(table, columns, filt), sql=leaf_sql)
                tf_expr = _boundary_expr(boundary, table)
                tf = to_sql(tf_expr) if tf_expr is not None else None
                futures = {}
                for server_id, segments in self.routing.route_query(
                        table, ctx, extra_filter=tf_expr).items():
                    handle = self._servers.get(server_id)
                    if handle is None:
                        continue
                    futures[self._dispatch_partial(handle, server_id, None, table, ctx,
                                                   segments, tf)] = server_id
                try:
                    for fut in as_completed(futures, timeout=self.stage_timeout_s):
                        server_id = futures[fut]
                        try:
                            partial = fut.result()
                        except Exception as e:
                            if _is_transport_failure(e):
                                self.routing.mark_server_unhealthy(server_id)
                                self.failure_detector.notify_unhealthy(server_id)
                            raise
                        account(len(partial.rows) * max(1, len(columns)) * 16)
                        rows.extend(partial.rows)
                except FutureTimeoutError:
                    # a leaf scan cannot be partial: the stragglers leave routing
                    for f, server_id in futures.items():
                        if not f.done():
                            self.routing.mark_server_unhealthy(server_id)
                            self.failure_detector.notify_unhealthy(server_id)
                    raise
            out = {}
            for j, c in enumerate(columns):
                vals = [r[j] for r in rows]
                dt = schema.field_spec(c).data_type
                out[c] = (np.asarray(vals, dtype=dt.numpy_dtype) if dt.is_numeric
                          else np.asarray(vals, dtype=object))
            return out

        scan.device = device
        # the shuffle's width is a query option (reference: the v2 engine's
        # stage parallelism)
        return execute_multistage(stmt, scan, self._schema_for,
                                  num_partitions=self._num_partitions(stmt),
                                  stage_runner=stage_runner(),
                                  broadcast_max_bytes=_broadcast_max_bytes(self))

    # -- physical tables --------------------------------------------------
    def _physical_tables(self, raw_table: str) -> List[str]:
        """A logical name's physical tables: a hybrid table has both halves."""
        out = [t for t in (f"{raw_table}_{TableType.OFFLINE.value}",
                           f"{raw_table}_{TableType.REALTIME.value}")
               if t in self.catalog.table_configs]
        if raw_table in self.catalog.table_configs:
            out.append(raw_table)
        return out

    def _time_boundary(self, physical: List[str]):
        """A hybrid table's split: OFFLINE answers time <= boundary, REALTIME
        time > boundary, the boundary being the largest end time of the
        servable offline segments."""
        offline = [t for t in physical if t.endswith(f"_{TableType.OFFLINE.value}")]
        if len(physical) < 2 or not offline:
            return None
        cfg = self.catalog.table_configs.get(offline[0])
        if cfg is None or not cfg.time_column:
            return None
        ev = self.catalog.external_view.get(offline[0], {})
        ends = [m.end_time_ms for name, m in self.catalog.segments.get(offline[0], {}).items()
                if m.end_time_ms is not None
                and any(st == ONLINE for st in ev.get(name, {}).values())]
        return (cfg.time_column, max(ends)) if ends else None


def _statement_sql(stmt) -> str:
    """A single-table statement's SQL text, its OPTION clause and EXPLAIN
    prefix included."""
    import re

    from ..sql.ast import _sql_literal, statement_to_sql

    def value(v) -> str:
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)) or re.fullmatch(r"[A-Za-z0-9_.]+", str(v)):
            return str(v)
        return _sql_literal(str(v))
    sql = statement_to_sql(stmt)
    if stmt.options:
        sql += " OPTION(" + ", ".join(f"{k}={value(v)}" for k, v in stmt.options.items()) + ")"
    if stmt.analyze:
        return "EXPLAIN ANALYZE " + sql
    return "EXPLAIN PLAN FOR " + sql if stmt.explain else sql


def _leaf_ctx(table: str, columns, filt) -> QueryContext:
    """A multistage leaf scan as a selection context: the columns, the
    pushed-down filter, no limit."""
    return QueryContext(table=table, select_items=[(Identifier(c), c) for c in columns],
                        filter=filt, group_by=[], aggregations=[], having=None, order_by=[],
                        limit=UNBOUNDED_LIMIT, offset=0, distinct=False)


def _record_prune_stats(exec_stats, prune_counts: Dict[str, float]) -> None:
    """The routing pruners' rejections into the query's stats: the per-kind
    breakdown, the numSegmentsPruned total and scanRowsAvoided."""
    total = 0
    for kind in PRUNER_KINDS:
        n = int(prune_counts.get(kind, 0))
        if n:
            exec_stats.add(qstats.PRUNED_BY_KIND[kind], n)
            total += n
    if total:
        exec_stats.add(qstats.NUM_SEGMENTS_PRUNED, total)
    rows = int(prune_counts.get(PRUNE_ROWS_AVOIDED, 0))
    if rows:
        exec_stats.add(qstats.SCAN_ROWS_AVOIDED, rows)


def _broker_prune_row(st, parent_id: int, next_id: int):
    """EXPLAIN ANALYZE's BROKER_PRUNE(kind:N, ...) row, its Rows the segments
    the router rejected; None when it rejected none."""
    pub = st.to_public_dict()
    parts, total = [], 0
    for kind, key in qstats.PRUNED_BY_KIND.items():
        n = int(pub.get(key, 0))
        if n:
            parts.append(f"{kind}:{n}")
            total += n
    if not total:
        return None
    return [f"BROKER_PRUNE({', '.join(parts)})", next_id, parent_id, total, None]


def _boundary_expr(boundary, table: str):
    """The time boundary as a predicate: routing prunes with it, servers get
    its SQL."""
    if boundary is None:
        return None
    col, b = boundary
    if table.endswith(f"_{TableType.OFFLINE.value}"):
        return Function("lte", (Identifier(col), Literal(b)))
    if table.endswith(f"_{TableType.REALTIME.value}"):
        return Function("gt", (Identifier(col), Literal(b)))
    return None


def _uncovered_after_retry(missing, retry_results) -> Set[str]:
    """Segments still unserved after the retry round: a partial's `served`
    list is the evidence; one without it covered what was sent to it."""
    uncovered = set(missing)
    for r, segs in retry_results:
        uncovered -= set(segs) if r.served is None else set(r.served)
    return uncovered


def _truthy(v) -> bool:
    return str(v).lower() in ("true", "1") if v is not None else False


def _is_backpressure(e: BaseException) -> bool:
    return isinstance(e, (QueryRejectedError, QueryTimeoutError))


def _deadline_remaining_s(ctx) -> float:
    d = (ctx.options or {}).get("deadlineEpochMs") if ctx is not None else None
    return float("inf") if d is None else float(d) / 1000.0 - time.time()


def _is_transport_failure(e: BaseException) -> bool:
    """Server unreachable or crashed (it leaves routing), as against a query
    error a live server reported (it stays)."""
    return isinstance(e, (ConnectionError, TimeoutError, OSError))
