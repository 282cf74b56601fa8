"""Process-global event journal: the cluster's state transitions in order.

A trimmed copy of `pinot_tpu/utils/events.py`: every role of the process
records its transitions (`emit_event`) into one bounded ring, each event with
a per-node monotonic `seq`, a journal-wide `gseq` (the cursor of
`events_since`) and the trace id of the query active on the emitting thread.
`KINDS` is the closed schema: a kind not listed raises. The kinds are those
the ported roles emit (the broker's failure detector, admission and
backpressure; the realtime segment lifecycle, the deep-store quarantine and
the peer-scheme healing of the LLC segment manager; the server's tiers: an
admission rejected, an eviction, a promotion, a cold demotion and a cold
load; the controller's leadership (`leader.elected`, `leader.lost`,
`cluster/leadership.py`) and its ingestion and memory verdicts). The SLO and
workload verdicts, the fault injection and the incident recorder's kinds come
with those planes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional, Tuple

from .metrics import get_registry
from .trace import current_trace

#: kind -> (default severity, description)
KINDS: Dict[str, Tuple[str, str]] = {
    "admission.state": ("WARN", "broker admission controller changed state (HEALTHY/SHEDDING/SATURATED)"),
    "backpressure.hold": ("WARN", "server 429 put it on backpressure hold (out of hedge/retry sets)"),
    "hedge.suppressed": ("WARN", "hedging suppressed because the broker itself is overloaded"),
    "server.down": ("ERROR", "failure detector marked a server unhealthy (probing started)"),
    "server.up": ("INFO", "failure detector restored a probed server to healthy routing"),
    "server.registered": ("INFO", "server handle registered with the broker"),
    "server.unregistered": ("INFO", "server handle unregistered from the broker"),
    "segment.consuming.created": ("INFO", "new CONSUMING segment opened on a stream partition"),
    "segment.committed": ("INFO", "consuming segment sealed and committed to the deepstore"),
    "segment.online": ("INFO", "committed segment flipped CONSUMING->ONLINE in the ideal state"),
    "segment.cold.demoted": ("INFO", "segment demoted to the cold tier (forms dropped, deepstore-backed)"),
    "segment.cold.loaded": ("INFO", "cold segment lazily reloaded from the deepstore on query touch"),
    "segment.reassigned": ("WARN", "consuming segment moved off a dead server"),
    "tier.admission.rejected": ("WARN", "HBM admission rejected a segment load (headroom below floor)"),
    "tier.evicted": ("INFO", "tiering manager evicted a resident segment to reclaim HBM"),
    "tier.promoted": ("INFO", "queried cold segment promoted back to the hot tier"),
    "deepstore.quarantined": ("ERROR", "deepstore upload retries exhausted; segment quarantined"),
    "deepstore.healed": ("INFO", "quarantined/missing deepstore copy healed from a server peer"),
    "leader.elected": ("INFO", "controller won or took over the leadership lease"),
    "leader.lost": ("WARN", "controller lost the leadership lease"),
    "verdict.ingestion": ("WARN", "ingestion health verdict changed for a table"),
    "verdict.memory": ("WARN", "device-memory health verdict changed for a table"),
}


@dataclass
class Event:
    __slots__ = ("seq", "gseq", "ts_ms", "node", "kind", "severity", "table",
                 "segment", "attrs", "trace_id")
    seq: int
    gseq: int
    ts_ms: int
    node: str
    kind: str
    severity: str
    table: str
    segment: str
    attrs: Dict[str, Any]
    trace_id: str

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"seq": self.seq, "gseq": self.gseq, "tsMs": self.ts_ms,
                             "node": self.node, "kind": self.kind,
                             "severity": self.severity}
        for key, v in (("table", self.table), ("segment", self.segment),
                       ("attrs", self.attrs), ("traceId", self.trace_id)):
            if v:
                d[key] = v
        return d


class EventJournal:
    """Bounded ring of typed events, evicting oldest first;
    `emitted == retained + evicted` always holds."""

    def __init__(self, capacity: int = 512, node: str = "proc"):
        self.capacity = max(1, int(capacity))
        self.node = node
        self._lock = threading.Lock()
        self._entries: Deque[Event] = deque()
        self._seqs: Dict[str, int] = {}
        self._gseq = 0
        self.emitted = 0
        self.evicted = 0

    def emit(self, kind: str, node: Optional[str] = None, table: str = "",
             segment: str = "", severity: Optional[str] = None,
             trace_id: Optional[str] = None, **attrs: Any) -> Event:
        spec = KINDS.get(kind)
        if spec is None:
            raise ValueError(f"unregistered event kind: {kind!r}")
        if trace_id is None:
            tr = current_trace()
            trace_id = tr.trace_id if tr is not None else ""
        ev_node = node if node is not None else self.node
        ts_ms = int(time.time() * 1000)
        with self._lock:
            seq = self._seqs.get(ev_node, 0) + 1
            self._seqs[ev_node] = seq
            self._gseq += 1
            ev = Event(seq, self._gseq, ts_ms, ev_node, kind,
                       severity if severity is not None else spec[0],
                       table, segment, attrs, trace_id)
            self._entries.append(ev)
            self.emitted += 1
            if len(self._entries) > self.capacity:
                self._entries.popleft()
                self.evicted += 1
        get_registry().counter("pinot_events_total", {"kind": kind}).inc()
        return ev

    def events_since(self, since: int = 0, limit: Optional[int] = None) -> Dict[str, Any]:
        """Events with `gseq > since`, oldest first, and the next cursor."""
        with self._lock:
            rows = [e for e in self._entries if e.gseq > since]
            cursor = self._gseq
        if limit is not None:
            rows = rows[-limit:]
        return {"events": [e.as_dict() for e in rows], "cursor": cursor}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"node": self.node, "capacity": self.capacity,
                    "retained": len(self._entries), "emitted": self.emitted,
                    "evicted": self.evicted, "cursor": self._gseq}


# the process-wide journal
JOURNAL = EventJournal()


def get_journal() -> EventJournal:
    return JOURNAL


def emit_event(kind: str, node: Optional[str] = None, table: str = "", segment: str = "",
               severity: Optional[str] = None, trace_id: Optional[str] = None,
               **attrs: Any) -> Event:
    """Record one transition on the process journal."""
    return JOURNAL.emit(kind, node=node, table=table, segment=segment,
                        severity=severity, trace_id=trace_id, **attrs)
