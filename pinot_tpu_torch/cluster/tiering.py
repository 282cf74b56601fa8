"""The server's segment tiers: device memory as a managed hot tier.

A copy of `pinot_tpu/cluster/tiering.py` over the memory ledger
(`utils/memledger.py`). Without it every queried segment's columns stage on
the card and stay until unload, so a table larger than the card's memory
ends in `torch.cuda.OutOfMemoryError`. The tiers:

* **hot (device)**: ledger-accounted `SegmentBlock` tensors and the stacked
  set blocks' shares of them, bounded by
  `capacity * (1 - server.hbm.target.headroom.pct / 100)`;
* **warm (host memory)**: the `ImmutableSegment` readers behind the host
  plan. Eviction is `release_block`: the device tensors go, the host readers
  still serve; a later admission stages the block again;
* **cold (deep store)**: segments assigned COLD in the ideal state keep their
  catalog and routing registration but no local copy; the first query loads
  them under its deadline, and they admit like any other segment.

Three ledger-driven mechanisms:

1. the **admission gate** (`admit`) prices a block from the segment's metadata
   (`predicted_block_bytes`) BEFORE anything stages, less what the segment
   already holds, and evicts colder victims until the price fits under the
   target, with reservations held until the query settles so that a query
   admitting its segments back to back cannot over-commit;
2. the **pressure loop** (`run_pressure_sweep`, a server periodic task)
   evicts past the target by a bytes-times-coldness score;
3. the **host tier**: where eviction cannot free enough, `admit` answers
   False before anything stages, and the server runs that segment's host
   plan (`segmentsServedHostTier`). It is the gate's planned route, never a
   fallback: a device failure propagates.

A segment held by an in-flight query is never a victim: its refcount must
drain first (`TableDataManager.release`).

The gate reasons on the ledger's bytes only. Under PyTorch's caching
allocator a released tensor returns to the allocator's cache and free memory
(`torch.cuda.mem_get_info`) does not rise, so free memory says nothing about
residency; `join_device_budget_bytes` reads the ledger for the same reason.
Only the staged price is ported: the fused layout and its knob are not.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from ..engine.datablock import predicted_block_bytes, release_block
from ..utils.events import emit_event
from ..utils.memledger import get_ledger
from ..utils.metrics import get_registry

#: default percent of capacity the gate and the pressure loop keep free (the
#: `server.hbm.target.headroom.pct` cluster knob overrides)
DEFAULT_TARGET_HEADROOM_PCT = 10.0

#: the pressure loop's period (seconds)
PRESSURE_INTERVAL_S = 5.0


# -- join-intermediate pricing ----------------------------------------------
# The device hash join stages both sides' key codes plus the matched output
# beside whatever segments are resident. An exploding join (duplicate build
# keys fanning every probe row out) runs on the host (`joinServedHostTier`).

def predicted_join_bytes(build_rows: int, probe_rows: int, ncols: int,
                         dup_factor: float = 1.0) -> int:
    """Metadata-only sizing of a device join's working set: the staged key
    codes for both sides (at the JAX package's pow2 shapes, so that both
    packages admit alike) plus the expanded candidate index pairs.
    `dup_factor` is the build-side key duplication (rows / distinct keys), the
    upper bound of the probe match rate: every probe row matching
    `dup_factor` build rows."""
    def pow2(n: int) -> int:
        return 1 << (max(1, int(n)) - 1).bit_length()
    code_bytes = 4 * (pow2(build_rows) * 2 + pow2(probe_rows))
    out_rows = int(max(0.0, float(probe_rows)) * max(1.0, float(dup_factor)))
    # candidate (li, ri) int64 pairs + one gathered output column set
    pair_bytes = out_rows * 16
    out_bytes = out_rows * max(1, int(ncols)) * 8
    return int(code_bytes + pair_bytes + out_bytes)


def join_device_budget_bytes(device=None,
                             headroom_pct: float = DEFAULT_TARGET_HEADROOM_PCT) -> int:
    """Device bytes a join may claim now: the ledger's target (capacity less
    the headroom) less what the ledger holds, 0 when scans hold the card. A
    CUDA `device` binds the ledger to that card first."""
    ledger = get_ledger()
    if device is not None and torch.device(device).type == "cuda":
        ledger.bind_device(device)
    cap, _ = ledger.capacity_bytes()
    target = int(cap * (1.0 - max(0.0, min(99.0, headroom_pct)) / 100.0))
    return max(0, target - ledger.resident_bytes())


class _Admitted:
    """One hot-tier resident: its TableDataManager (the refcount and the
    segment), when a query last touched it (the coldness half of the eviction
    score), and the predicted bytes reserved at admission, counted against the
    target until the block stages."""

    __slots__ = ("mgr", "last_access", "reserved")

    def __init__(self, mgr, reserved: int = 0):
        self.mgr = mgr
        self.last_access = time.monotonic()
        self.reserved = int(reserved)


class TieringManager:
    """One server's hot-tier admission and eviction over the process ledger.
    In-process multi-server clusters run several managers against the shared
    ledger, which only makes each more conservative (it sees the process
    total)."""

    def __init__(self, catalog=None, node: str = ""):
        self._catalog = catalog
        self._node = node          # the event journal's label: the server's id
        self._lock = threading.Lock()
        # (table, segment) -> its entry: segment names are unique only within a table
        self._admitted: Dict[Tuple[str, str], _Admitted] = {}
        self._counters = {"admissions": 0, "rejections": 0, "evictions": 0,
                          "promotions": 0, "coldLoads": 0}

    # -- policy inputs -------------------------------------------------------

    def _headroom_pct(self) -> float:
        if self._catalog is not None:
            try:
                raw = self._catalog.get_property(
                    "clusterConfig/server.hbm.target.headroom.pct", None)
                if raw is not None:
                    return max(0.0, min(99.0, float(raw)))
            except (TypeError, ValueError):
                pass
        return DEFAULT_TARGET_HEADROOM_PCT

    def target_bytes(self) -> int:
        """The resident-bytes budget: capacity less the target headroom."""
        cap, _ = get_ledger().capacity_bytes()
        return max(1, int(cap * (1.0 - self._headroom_pct() / 100.0)))

    def _reserved_bytes(self) -> int:
        """Bytes the segments that in-flight queries admitted may still stage:
        each one's predicted block less what it held at its admission, until
        its query settles or it leaves its table manager."""
        total = 0
        with self._lock:
            for (_, name), e in self._admitted.items():
                if not e.reserved:
                    continue
                if e.mgr is not None and e.mgr.get(name) is None:
                    e.reserved = 0
                else:
                    total += e.reserved
        return total

    # -- the admission gate --------------------------------------------------

    def admit(self, table: str, segment, mgr) -> bool:
        """Whether `segment` may stage on the device. Called in the query path
        before anything stages; the caller routes a rejected segment to the
        host plan. `mgr` is the owning TableDataManager (refcounts).

        The price is what the segment may still stage: its predicted block
        less what it already holds. A resident segment is priced too (the
        JAX package admits one without a price): a query that touches columns
        its earlier queries did not, or a stacked set block over a new member
        set, stages again, and an unpriced admission lets the ledger pass the
        target. The reservation lasts until the query settles."""
        name = getattr(segment, "name", str(segment))
        key = (table, name)
        ledger = get_ledger()
        need = max(0, predicted_block_bytes(segment)
                   - ledger.resident_bytes(table=table, segment=name))
        with self._lock:
            entry = self._admitted.get(key)
            if entry is not None:
                entry.last_access = time.monotonic()   # a resident, touched
                entry.reserved = 0        # this admission's price replaces the last
        target = self.target_bytes()
        # in-flight reservations count: a query admits its whole segment set
        # before any block stages, so the ledger alone lags the commitment
        if need and ledger.resident_bytes() + self._reserved_bytes() + need > target:
            self._evict_until(max(0, target - need - self._reserved_bytes()),
                              exclude={key})
        if need and ledger.resident_bytes() + self._reserved_bytes() + need > target:
            with self._lock:
                self._counters["rejections"] += 1
            get_registry().counter("pinot_server_hbm_admission_rejects",
                                   {"table": table}).inc()
            emit_event("tier.admission.rejected", node=self._node or None,
                       table=table, segment=name, neededBytes=need)
            return False
        with self._lock:
            entry = self._admitted.get(key)
            if entry is None:
                self._counters["admissions"] += 1
                self._admitted[key] = _Admitted(mgr, reserved=need)
            else:
                entry.reserved = need
        return True

    def settle(self, table: str, names: Iterable[str]) -> None:
        """End of a query: drop the reservations of the segments it admitted
        (what they staged the ledger now counts; what they did not, a COUNT(*)
        touching no column, would starve later admissions against phantom
        bytes)."""
        with self._lock:
            for name in names:
                e = self._admitted.get((table, name))
                if e is not None:
                    e.reserved = 0

    def note_promotion(self, table: str, name: str) -> None:
        """A freshly admitted segment will stage (host to device)."""
        with self._lock:
            self._counters["promotions"] += 1
            entry = self._admitted.get((table, name))
            reserved = entry.reserved if entry is not None else 0
        emit_event("tier.promoted", node=self._node or None, table=table, segment=name,
                   reservedBytes=reserved)

    def note_cold_load(self) -> None:
        """A COLD segment was loaded for a query."""
        with self._lock:
            self._counters["coldLoads"] += 1
        get_registry().counter("pinot_server_hbm_cold_loads").inc()

    def forget(self, table: str, name: str) -> None:
        """The segment left this server (unload, table drop): drop its entry
        without counting an eviction."""
        with self._lock:
            self._admitted.pop((table, name), None)

    # -- eviction ------------------------------------------------------------

    def _evict_until(self, budget_bytes: int,
                     exclude: Optional[Iterable[Tuple[str, str]]] = None) -> int:
        """Evict residents, biggest-and-coldest first, until the ledger's total
        is at or under `budget_bytes` or no victim is left; only residents no
        in-flight query holds. Returns the evictions."""
        excluded = set(exclude or ())
        ledger = get_ledger()
        now = time.monotonic()
        with self._lock:
            candidates = [(key, e) for key, e in self._admitted.items()
                          if key not in excluded]
        # bytes * coldness: the biggest, least recently touched block frees
        # the most memory for the promotion we are likeliest not to regret
        scored = sorted(candidates,
                        key=lambda ke: -(ledger.resident_bytes(table=ke[0][0],
                                                               segment=ke[0][1])
                                         * max(now - ke[1].last_access, 1e-3)))
        evicted = 0
        for (table, name), entry in scored:
            if ledger.resident_bytes() <= budget_bytes:
                break
            mgr = entry.mgr
            if mgr is not None and mgr.refcount(name) > 0:
                continue   # an in-flight query holds it; the sweep retries
            seg = mgr.get(name) if mgr is not None else None
            freed = ledger.resident_bytes(table=table, segment=name)
            if seg is not None:
                release_block(seg)
            else:
                ledger.release(table=table, segment=name)
            with self._lock:
                self._admitted.pop((table, name), None)
                self._counters["evictions"] += 1
            get_registry().counter("pinot_server_hbm_evictions").inc()
            emit_event("tier.evicted", node=self._node or None, table=table, segment=name,
                       freedBytes=freed)
            evicted += 1
        return evicted

    def run_pressure_sweep(self) -> int:
        """The periodic task's body: walk residency back under the target; a
        no-op at or under it."""
        target = self.target_bytes()
        if get_ledger().resident_bytes() <= target:
            return 0
        return self._evict_until(target)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The `tiering` part of the server's `/debug/memory`, summed per table
        into the controller's memoryStatus."""
        with self._lock:
            out: Dict[str, Any] = dict(self._counters)
            out["admittedSegments"] = len(self._admitted)
        out["targetBytes"] = self.target_bytes()
        out["targetHeadroomPct"] = self._headroom_pct()
        return out
