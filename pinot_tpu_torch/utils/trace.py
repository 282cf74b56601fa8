"""Per-request tracing: named spans with timings, across scatter threads.

A trimmed copy of `pinot_tpu/utils/trace.py` (the analog of the reference's
trace SPI): one flat span list with depth markers a request, shared by every
thread that works on it (a broker's scatter threads `activate` the request's
Trace). The broker records a Trace for every query; `TraceSampler` decides
which traces `TraceRing` keeps (`broker.trace.sample.rate`), and slow or
failed queries are kept whatever it decided. A query with OPTION(trace=true)
returns its spans in `stats["traceInfo"]`. A remote server's spans ride its
partial back over the wire and `Trace.splice` merges them onto the broker's
trace. The Chrome trace export waits.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_local = threading.local()


def new_trace_id() -> str:
    """16 hex characters."""
    return uuid.uuid4().hex[:16]


class Trace:
    """Request-scoped span recorder: thread-safe appends, one a query."""

    def __init__(self, request_id: str = "", trace_id: Optional[str] = None):
        self.request_id = request_id
        self.trace_id = trace_id or new_trace_id()
        # the head sampler's decision; tail retention may keep it regardless
        self.sampled = False
        self.spans: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def now_ms(self) -> float:
        """Milliseconds since the trace began: the clock of every span."""
        return (time.perf_counter() - self._t0) * 1000

    def elapsed_ms(self) -> float:
        """Alias of `now_ms`, for the call sites that rebase a dispatch."""
        return self.now_ms()

    def record(self, name: str, start_ms: float, duration_ms: float,
               depth: int = 0, error: bool = False) -> None:
        s: Dict[str, Any] = {"name": name, "startMs": round(start_ms, 3),
                             "durationMs": round(duration_ms, 3), "depth": depth}
        if error:
            s["error"] = True
        with self._lock:
            self.spans.append(s)

    def splice(self, spans: List[Dict[str, Any]], prefix: str = "",
               offset_ms: float = 0.0, depth_offset: int = 0) -> None:
        """Merge a remote server's spans. Their startMs count from the
        server's request start: `offset_ms` (when the dispatch left this
        trace) rebases them onto this trace's clock, and `depth_offset` nests
        them under the dispatching span."""
        with self._lock:
            for s in spans:
                s = dict(s)
                if prefix:
                    s["name"] = f"{prefix}/{s['name']}"
                s["startMs"] = round(s.get("startMs", 0.0) + offset_ms, 3)
                s["depth"] = int(s.get("depth", 0)) + depth_offset
                self.spans.append(s)

    def to_rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return sorted(self.spans, key=lambda s: s["startMs"])

    @contextmanager
    def activate(self, depth: int = 0):
        """Make this trace the calling thread's (a scatter thread's), its
        spans nesting from `depth`."""
        prev = getattr(_local, "trace", None)
        prev_depth = getattr(_local, "depth", 0)
        _local.trace = self
        _local.depth = depth
        try:
            yield self
        finally:
            _local.trace = prev
            _local.depth = prev_depth


def current_trace() -> Optional[Trace]:
    return getattr(_local, "trace", None)


def current_depth() -> int:
    return getattr(_local, "depth", 0)


@contextmanager
def request_trace(enabled: bool, request_id: str = "", trace_id: Optional[str] = None):
    """A trace for this request on the calling thread, or None when disabled
    (`span` is then a no-op)."""
    if not enabled:
        yield None
        return
    tr = Trace(request_id, trace_id=trace_id)
    with tr.activate():
        yield tr


@contextmanager
def span(name: str):
    """Record a span on the thread's active trace (a no-op without one); a
    body that raises marks it `error`."""
    tr = getattr(_local, "trace", None)
    if tr is None:
        yield
        return
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    start_ms = tr.now_ms()
    t0 = time.perf_counter()
    error = False
    try:
        yield
    except BaseException:
        error = True
        raise
    finally:
        _local.depth = depth
        tr.record(name, start_ms, (time.perf_counter() - t0) * 1000, depth, error=error)


class TraceSampler:
    """Head-based probabilistic sampler; the rate comes with each call."""

    def __init__(self, rng: Optional[random.Random] = None):
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()

    def sample(self, rate: float) -> bool:
        if rate <= 0.0:
            return False
        if rate >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < rate


class TraceRing:
    """Bounded ring of kept traces by trace id, evicting oldest first."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: deque = deque()
        self._by_id: Dict[str, Dict[str, Any]] = {}

    def admit(self, trace: Trace, **meta: Any) -> Dict[str, Any]:
        entry: Dict[str, Any] = {"traceId": trace.trace_id, "requestId": trace.request_id,
                                 "sampled": bool(trace.sampled), "spans": trace.to_rows()}
        entry.update(meta)
        with self._lock:
            self._entries.append(entry)
            self._by_id[entry["traceId"]] = entry
            while len(self._entries) > self.capacity:
                dead = self._entries.popleft()
                if self._by_id.get(dead["traceId"]) is dead:
                    del self._by_id[dead["traceId"]]
        return entry

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._by_id.get(trace_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
