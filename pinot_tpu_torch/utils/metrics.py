"""Process-wide metrics registry: counters, gauges, timers and histograms.

A trimmed copy of `pinot_tpu/utils/metrics.py` (the analog of the
reference's ServerMeter / BrokerMeter / ControllerMeter catalogs): one flat
registry a process, a metric's identity being its name and its sorted label
pairs. What the cluster roles record: the broker's query, exception,
throttle, hedge and dispatch-latency series, the server's queries, docs and
segments scanned and partial latency, the controller's uploads and segment
status gauges. The multistage route's: `pinot_broker_p2p_fallbacks` (a
join or distributed GROUP BY that took the funnel or scatter path instead of
the mailbox shuffle), `pinot_broker_stage_dispatch_failures` (a funnel-path
partition run on the broker after its server dispatch failed),
`pinot_broker_data_plane_bytes` (bytes the funnel path buffered at the
broker), `pinot_server_join_stages` (join partitions a server ran),
`pinot_server_mailbox_frames` (frames its mailboxes took over HTTP) and
`pinot_server_mailbox_local_sends` (partitions handed to a mailbox in the
sender's own process). The memory plane's: the ledger's
`pinot_server_hbm_resident_bytes{table,kind}`, `_resident_total_bytes`,
`_capacity_bytes`, `_headroom_pct`, `_watermark_bytes` and
`_transient_peak_bytes` gauges (`utils/memledger.py`), the tiers'
`pinot_server_hbm_admission_rejects{table}`, `_evictions` and `_cold_loads`
counters, and the controller's `pinot_controller_hbm_headroom_pct{instance}`,
`_hbm_healthy{table}`, `_hbm_resident_bytes{table}` gauges and
`pinot_controller_cold_demotions{table}`. The ingestion plane's: each
consuming partition's `pinot_server_realtime_offset_lag{table,partition}`,
`_freshness_lag_ms`, `_rows_per_s` and `_last_consumed_ts_ms` gauges
(`ingest/realtime.py`), and the controller's
`pinot_controller_ingestion_healthy{table}`, `_ingestion_offset_lag` and
`_ingestion_freshness_lag_ms`. Every gauge keeps a bounded ring of its last
`Gauge.HISTORY_LEN` (epoch ms, value) samples, so that a `/debug` view shows
a trend (`gauge_histories`). `reset` empties the registry (tests). Not
ported: the Prometheus text export (`render_prometheus`); a role's
`/metrics` serves the flat snapshot.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

LabelPairs = Tuple[Tuple[str, str], ...]


def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple[str, LabelPairs]:
    return name, tuple(sorted((labels or {}).items()))


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    #: samples the ring keeps: every `set` appends (epoch ms, value); 240 is
    #: 20 minutes at a 5 s poll
    HISTORY_LEN = 240

    __slots__ = ("value", "_history", "_lock")

    def __init__(self):
        self.value = 0.0
        self._history: deque = deque(maxlen=self.HISTORY_LEN)
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)
            self._history.append((int(time.time() * 1000), self.value))

    def history(self) -> List[Tuple[int, float]]:
        """The recent (epoch ms, value) samples, oldest first."""
        with self._lock:
            return list(self._history)


class Timer:
    """Duration accumulator: count, total, min and max (ms)."""

    __slots__ = ("count", "total_ms", "min_ms", "max_ms", "_lock")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0
        self._lock = threading.Lock()

    def update(self, duration_ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += duration_ms
            self.min_ms = min(self.min_ms, duration_ms)
            self.max_ms = max(self.max_ms, duration_ms)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


class Histogram:
    """Fixed-bucket duration histogram (ms). Percentiles read back from the
    bucket counts (an upper-bound estimate); `recent_percentile` reads only
    the last one or two WINDOW_S windows, so a spike ages out of the
    admission decisions that read it."""

    DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                       1000.0, 2500.0, 5000.0, 10000.0)
    WINDOW_S = 60.0

    __slots__ = ("buckets", "bucket_counts", "count", "total", "max", "_lock",
                 "_win_counts", "_prev_counts", "_win_started")

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None):
        self.buckets = tuple(buckets) if buckets else self.DEFAULT_BUCKETS
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # last: +Inf
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._win_counts = [0] * (len(self.buckets) + 1)
        self._prev_counts = [0] * (len(self.buckets) + 1)
        self._win_started = time.monotonic()
        self._lock = threading.Lock()

    def _rotate_locked(self, now: float) -> None:
        age = now - self._win_started
        if age < self.WINDOW_S:
            return
        zeros = [0] * len(self.bucket_counts)
        self._prev_counts = self._win_counts if age < 2 * self.WINDOW_S else zeros
        self._win_counts = list(zeros)
        self._win_started = now

    def observe(self, v: float) -> None:
        with self._lock:
            self._rotate_locked(time.monotonic())
            i = len(self.buckets)
            for j, ub in enumerate(self.buckets):
                if v <= ub:
                    i = j
                    break
            self.bucket_counts[i] += 1
            self._win_counts[i] += 1
            self.count += 1
            self.total += v
            self.max = max(self.max, v)

    def _percentile_locked(self, q: float, counts, total: int) -> float:
        if not total:
            return 0.0
        cum = 0
        for i, n in enumerate(counts):
            cum += n
            if cum >= q * total:
                return self.buckets[i] if i < len(self.buckets) else self.max
        return self.max

    def percentile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (0 < q <= 1)."""
        with self._lock:
            return self._percentile_locked(q, self.bucket_counts, self.count)

    def recent_percentile(self, q: float) -> Tuple[float, int]:
        """(q-quantile over the recent windows, samples it read); the
        lifetime quantile while the windows are empty."""
        with self._lock:
            self._rotate_locked(time.monotonic())
            counts = [a + b for a, b in zip(self._prev_counts, self._win_counts)]
            total = sum(counts)
            if not total:
                return self._percentile_locked(q, self.bucket_counts, self.count), self.count
            return self._percentile_locked(q, counts, total), total


class MetricsRegistry:
    def __init__(self):
        self._series: Dict[type, Dict[Tuple[str, LabelPairs], object]] = {
            Counter: {}, Gauge: {}, Timer: {}, Histogram: {}}
        self._lock = threading.Lock()

    def _get(self, kind: type, name: str, labels, *args):
        k = _key(name, labels)
        with self._lock:
            series = self._series[kind]
            if k not in series:
                series[k] = kind(*args)
            return series[k]

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def timer(self, name: str, labels: Optional[Dict[str, str]] = None) -> Timer:
        return self._get(Timer, name, labels)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, labels, buckets)

    def remove(self, name: str, labels: Optional[Dict[str, str]] = None) -> None:
        """Drop a series of any kind (a dropped table's, say)."""
        k = _key(name, labels)
        with self._lock:
            for series in self._series.values():
                series.pop(k, None)

    def remove_gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> None:
        """`remove` under the JAX package's gauge-only name."""
        self.remove(name, labels)

    def reset(self) -> None:
        """Drop every series (tests start from an empty registry)."""
        with self._lock:
            for series in self._series.values():
                series.clear()

    def snapshot(self) -> Dict[str, float]:
        """Flat {rendered name: value}: counters, gauges, timer and histogram
        aggregates."""
        out: Dict[str, float] = {}
        with self._lock:
            for (name, labels), c in self._series[Counter].items():
                out[_render_name(name, labels)] = c.value
            for (name, labels), g in self._series[Gauge].items():
                out[_render_name(name, labels)] = g.value
            for (name, labels), t in self._series[Timer].items():
                base = _render_name(name, labels)
                out[f"{base}_count"] = t.count
                out[f"{base}_total_ms"] = t.total_ms
            for (name, labels), h in self._series[Histogram].items():
                base = _render_name(name, labels)
                out[f"{base}_count"] = h.count
                out[f"{base}_sum"] = h.total
                out[f"{base}_p50"] = h.percentile(0.5)
        return out

    def gauge_histories(self, prefix: Optional[str] = None
                        ) -> Dict[str, List[Tuple[int, float]]]:
        """{rendered name: [(epoch ms, value), ...]} of the gauges whose name
        starts with `prefix` (all without one), for a role's `/debug`."""
        with self._lock:
            gauges = [(name, labels, g) for (name, labels), g in self._series[Gauge].items()
                      if prefix is None or name.startswith(prefix)]
        # each gauge's own lock, never under the registry's
        return {_render_name(name, labels): g.history() for name, labels, g in gauges}


def _render_name(name: str, labels: LabelPairs) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


# the process-wide registry
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
