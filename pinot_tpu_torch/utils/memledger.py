"""Device-memory residency ledger: who owns every byte on the card.

A copy of `pinot_tpu/utils/memledger.py` over PyTorch. Every named device
allocation (a segment block's columns, its valid and bitmap words, a stacked
set's columns, consuming-segment staging) registers `(table, segment, kind,
nbytes)` as it is staged, through the `staged()` wrapper, and deregisters on
release (an eviction, a segment unload, a table drop, a consumer's retire).
The tiering gate (`cluster/tiering.py`) reasons on these bytes alone: under
PyTorch's caching allocator a released tensor goes back to the allocator's
cache, not to the card, so the allocator's free memory says nothing about
what is resident.

* `reconcile()` holds the ledger's total against the allocator's live bytes
  (`torch.cuda.memory_allocated`) less a baseline taken before staging, so a
  path that forgot to register, or a reference that outlived its release,
  shows as drift;
* residency is exported as `pinot_server_hbm_resident_bytes{table,kind}`
  gauges with the total, watermark, headroom and capacity gauges, and
  `snapshot()` is the body of the server's `GET /debug/memory`.

The capacity is, in order: `PINOT_TPU_HBM_CAPACITY_BYTES`; the card's total
memory (`torch.cuda.mem_get_info`) once a CUDA device is bound (`bind_device`,
which a server calls with its device) or, unbound, when CUDA is available; an
estimated 16 GiB on the CPU. A CUDA probe that fails raises. The capacity is
resolved at its first use, never at import.

The ledger is process-global, as the metrics registry is: registration
happens deep in engine code that has no server handle. In-process
multi-server clusters share one ledger; each server process has its own.

Kinds are a bounded enum (`KINDS`): gauges are labeled `{table, kind}`, and
label values stay lifecycle-bounded, never a segment or a query. A stacked
set block registers its columns under the kinds a segment block would use,
one entry a member (`SegmentSetBlock`, `parallel/combine.py`).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from .metrics import get_registry

#: the closed set of allocation kinds the ledger accounts (gauge label values)
KINDS = ("ids", "raw", "dict", "valid", "valid_words", "bitmap", "null",
         "decoded", "consuming", "transient")

#: the capacity where no card reports one (the CPU); override with
#: PINOT_TPU_HBM_CAPACITY_BYTES
_DEFAULT_CAPACITY = 16 << 30

#: watermark history ring length
_HISTORY_LEN = 240

#: least seconds between gauge publishes on the register path: staging a
#: segment registers one entry a column in a tight loop. Accounting is always
#: exact; deferred gauge updates flush on the next release, snapshot or flush.
_PUBLISH_INTERVAL_S = 0.05

Key = Tuple[str, str, str, str]


def device_capacity_bytes(device=None) -> Tuple[int, bool]:
    """(capacity_bytes, estimated) of `device` (the CUDA device when None and
    one is available): the environment override, else the card's total memory,
    else the estimated 16 GiB of the CPU."""
    env = os.environ.get("PINOT_TPU_HBM_CAPACITY_BYTES")
    if env:
        try:
            return max(1, int(env)), False
        except ValueError:
            pass
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1]), False
    return _DEFAULT_CAPACITY, True


def live_device_bytes(device=None) -> Optional[int]:
    """Bytes the caching allocator holds in live tensors on a CUDA `device`
    (the reconciliation's ground truth), None off CUDA."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(device))


class MemoryLedger:
    """Byte-exact device-residency accounting, keyed (table, segment, kind,
    name); registering a key again replaces its bytes (re-staging)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Key, int] = {}
        self._by_table_kind: Dict[Tuple[str, str], int] = {}
        self._segment_tables: Dict[str, str] = {}
        self._total = 0
        self._transient_peak = 0
        self._watermark = 0
        self._watermark_history: deque = deque(maxlen=_HISTORY_LEN)
        self._device: Optional[torch.device] = None
        self._capacity: Optional[int] = None     # resolved at first use
        self._capacity_estimated = True
        # gauge handles, rebuilt when the registry is reset
        self._reg = None
        self._tk_gauges: Dict[Tuple[str, str], Any] = {}
        self._g_total: Any = None
        self._g_headroom: Any = None
        self._dirty: set = set()
        self._last_publish = float("-inf")

    # -- the device and its capacity -----------------------------------------

    def bind_device(self, device) -> None:
        """The device whose memory the ledger accounts (a server's). A CUDA
        device replaces an estimated capacity with the card's own; a capacity
        pinned by `set_capacity` or the environment stays."""
        dev = torch.device(device)
        with self._lock:
            self._device = dev
            if self._capacity is not None and not self._capacity_estimated:
                return
            self._capacity, self._capacity_estimated = device_capacity_bytes(dev)

    def _capacity_locked(self) -> int:
        if self._capacity is None:
            self._capacity, self._capacity_estimated = device_capacity_bytes(self._device)
        return self._capacity

    def set_capacity(self, nbytes: int, estimated: bool = False) -> None:
        """Pin the device-memory budget (the `server.hbm.capacity.bytes`
        cluster knob); republishes the capacity and headroom gauges."""
        nbytes = max(1, int(nbytes))
        with self._lock:
            self._capacity = nbytes
            self._capacity_estimated = bool(estimated)
            reg = self._gauges_locked()
            reg.gauge("pinot_server_hbm_capacity_bytes").set(nbytes)
            self._publish_locked(force=True)

    def capacity_bytes(self) -> Tuple[int, bool]:
        """(capacity_bytes, estimated): the budget admission, eviction and
        headroom run against."""
        with self._lock:
            return self._capacity_locked(), self._capacity_estimated

    # -- table attribution ---------------------------------------------------

    def bind_segment(self, table: str, segment: str) -> None:
        """Record that `segment` belongs to `table`, for staging sites that
        know only the segment."""
        with self._lock:
            self._segment_tables[segment] = table

    def _table_for_locked(self, segment: str) -> str:
        t = self._segment_tables.get(segment)
        if t is not None:
            return t
        if segment.endswith("!st"):
            # a star-tree view's block belongs to its segment's table
            return self._table_for_locked(segment[:-3])
        # LLC names embed the table: {table}__{partition}__{seq}__{creation}
        if "__" in segment:
            return segment.split("__", 1)[0]
        return "-"

    # -- write side ----------------------------------------------------------

    def register(self, table: Optional[str], segment: str, kind: str,
                 name: str, nbytes: int) -> Key:
        """Account a named device allocation; `table=None` resolves through
        the segment's binding (or the LLC name). Returns the entry's key."""
        nbytes = int(nbytes)
        with self._lock:
            t = table if table is not None else self._table_for_locked(segment)
            key = (t, segment, kind, name)
            prev = self._entries.get(key, 0)
            self._entries[key] = nbytes
            delta = nbytes - prev
            self._total += delta
            tk = (t, kind)
            self._by_table_kind[tk] = self._by_table_kind.get(tk, 0) + delta
            self._publish_locked(dirty=(tk,))
            return key

    def release(self, table: Optional[str] = None, segment: Optional[str] = None,
                kind: Optional[str] = None, keep_binding: bool = False) -> int:
        """Drop every entry matching the non-None filters (and the segment's
        table binding when releasing by segment, unless `keep_binding`: an
        eviction leaves the segment loaded); returns the bytes released."""
        with self._lock:
            doomed = [k for k in self._entries
                      if (table is None or k[0] == table)
                      and (segment is None or k[1] == segment)
                      and (kind is None or k[2] == kind)]
            freed = self._drop_locked(doomed)
            if segment is not None and not keep_binding:
                self._segment_tables.pop(segment, None)
            if table is not None and segment is None:
                for s in [s for s, t in self._segment_tables.items() if t == table]:
                    self._segment_tables.pop(s, None)
            return freed

    def release_entries(self, keys: Iterable[Key]) -> int:
        """Drop the entries of these keys (those `register` returned)."""
        with self._lock:
            return self._drop_locked([k for k in keys if k in self._entries])

    def _drop_locked(self, doomed) -> int:
        freed = 0
        dirty = set()
        for key in doomed:
            nbytes = self._entries.pop(key)
            freed += nbytes
            tk = (key[0], key[2])
            self._by_table_kind[tk] = self._by_table_kind.get(tk, 0) - nbytes
            dirty.add(tk)
        self._total -= freed
        if doomed:
            self._publish_locked(dirty=tuple(dirty), force=True)
        return freed

    def note_transient(self, nbytes: int) -> None:
        """Track the peak transient fetch footprint: one gauge update, cheap
        enough for every fetch."""
        nbytes = int(nbytes)
        with self._lock:
            if nbytes <= self._transient_peak:
                return
            self._transient_peak = nbytes
            get_registry().gauge("pinot_server_hbm_transient_peak_bytes").set(nbytes)
            self._update_watermark_locked()

    def flush(self) -> None:
        """Publish the gauge updates the register path deferred."""
        with self._lock:
            self._publish_locked(force=True)

    # -- read side -----------------------------------------------------------

    def resident_bytes(self, table: Optional[str] = None, segment: Optional[str] = None,
                       kind: Optional[str] = None) -> int:
        with self._lock:
            if table is None and segment is None and kind is None:
                return self._total
            return sum(n for (t, s, k, _), n in self._entries.items()
                       if (table is None or t == table)
                       and (segment is None or s == segment)
                       and (kind is None or k == kind))

    def snapshot(self) -> Dict[str, Any]:
        """The `GET /debug/memory` body: totals, kind and table breakdowns,
        the top segments by bytes, the watermark and its history, capacity
        and headroom."""
        with self._lock:
            self._publish_locked(force=True)
            kinds: Dict[str, int] = {}
            tables: Dict[str, int] = {}
            segments: Dict[Tuple[str, str], int] = {}
            for (t, s, k, _), n in self._entries.items():
                kinds[k] = kinds.get(k, 0) + n
                tables[t] = tables.get(t, 0) + n
                segments[(t, s)] = segments.get((t, s), 0) + n
            top = sorted(segments.items(), key=lambda kv: -kv[1])[:10]
            cap = self._capacity_locked()
            headroom = max(0.0, 100.0 * (cap - self._total) / cap)
            return {
                "totalBytes": self._total,
                "transientPeakBytes": self._transient_peak,
                "capacityBytes": cap,
                "capacityEstimated": self._capacity_estimated,
                "headroomPct": round(headroom, 3),
                "watermarkBytes": self._watermark,
                "watermarkHistory": list(self._watermark_history),
                "entries": len(self._entries),
                "kinds": kinds,
                "tables": tables,
                "topSegments": [{"table": t, "segment": s, "bytes": n}
                                for (t, s), n in top],
            }

    def reconcile(self, baseline_bytes: int = 0) -> Dict[str, Any]:
        """The ledger's total against the allocator's live bytes on the bound
        device less `baseline_bytes` (what was allocated before the staging
        being checked). driftPct is None off CUDA."""
        with self._lock:
            device = self._device
            ledger = self._total
        live = live_device_bytes(device)
        out: Dict[str, Any] = {"ledgerBytes": ledger, "deviceBytes": live,
                               "baselineBytes": int(baseline_bytes)}
        if live is None:
            out["driftBytes"] = None
            out["driftPct"] = None
            return out
        tracked = live - int(baseline_bytes)
        drift = tracked - ledger
        out["driftBytes"] = drift
        out["driftPct"] = round(100.0 * abs(drift) / max(ledger, tracked, 1), 3)
        return out

    # -- internals -----------------------------------------------------------

    def _update_watermark_locked(self) -> None:
        footprint = self._total + self._transient_peak
        if footprint > self._watermark:
            self._watermark = footprint
            self._watermark_history.append((int(time.time() * 1000), footprint))
            get_registry().gauge("pinot_server_hbm_watermark_bytes").set(footprint)

    def _gauges_locked(self):
        """The registry and the cached gauge handles, rebuilt after a reset."""
        reg = get_registry()
        if self._reg is not reg or self._g_total is None \
                or reg.gauge("pinot_server_hbm_resident_total_bytes") is not self._g_total:
            self._reg = reg
            self._tk_gauges = {}
            self._g_total = reg.gauge("pinot_server_hbm_resident_total_bytes")
            self._g_headroom = reg.gauge("pinot_server_hbm_headroom_pct")
            reg.gauge("pinot_server_hbm_capacity_bytes").set(self._capacity_locked())
        return reg

    def _publish_locked(self, dirty: Iterable[Tuple[str, str]] = (),
                        force: bool = False) -> None:
        self._dirty.update(dirty)
        now = time.perf_counter()
        if not force and (now - self._last_publish) < _PUBLISH_INTERVAL_S:
            return
        self._last_publish = now
        reg = self._gauges_locked()
        for tk in self._dirty:
            t, k = tk
            n = self._by_table_kind.get(tk, 0)
            if n <= 0:
                # a dropped table or kind exports no zero series
                self._by_table_kind.pop(tk, None)
                self._tk_gauges.pop(tk, None)
                reg.remove_gauge("pinot_server_hbm_resident_bytes", {"table": t, "kind": k})
            else:
                g = self._tk_gauges.get(tk)
                if g is None:
                    g = reg.gauge("pinot_server_hbm_resident_bytes", {"table": t, "kind": k})
                    self._tk_gauges[tk] = g
                g.set(n)
        self._dirty.clear()
        self._g_total.set(self._total)
        cap = self._capacity_locked()
        self._g_headroom.set(max(0.0, round(100.0 * (cap - self._total) / cap, 3)))
        self._update_watermark_locked()


_LEDGER = MemoryLedger()


def get_ledger() -> MemoryLedger:
    return _LEDGER


def reset_ledger() -> None:
    """A fresh ledger (tests; the old one's gauges go with the registry's
    reset)."""
    global _LEDGER
    _LEDGER = MemoryLedger()


def staged(tensor, segment: str, kind: str, name: Optional[str] = None,
           table: Optional[str] = None):
    """Register a freshly staged tensor with the ledger and return it
    unchanged: the staging wrapper of the engine, segment and cluster code."""
    try:
        nbytes = int(tensor.nbytes)
    except (AttributeError, TypeError):
        nbytes = 0
    _LEDGER.register(table, segment, kind, name or kind, nbytes)
    return tensor
