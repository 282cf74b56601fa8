"""Device serving: one dispatcher owns the card, concurrent queries batch.

Counterpart of `DeviceQueryPipeline` in `pinot_tpu/cluster/device_server.py`.
Handler threads submit (ctx, segments) items and block on futures. A
dispatcher thread drains the queue, PREPARES every pending query through the
set executor (`parallel.MeshQueryExecutor.prepare_partial`: plan and inputs,
no launch), then groups the prepared work before touching the card:

  * items with equal `dedupe_key` are identical dispatches: they share one
    pass and one fetched result;
  * items with equal `stack_key` (the same work over the same stacked block,
    differing only in literals) launch as one stacked group: B passes queued
    back to back on the dispatcher's stream;
  * a selection's stacked top-k (`kind == "topk"`) is deduped but never
    stacked: one fused filter + top-k launch per distinct query;
  * everything a drain dispatched is fetched by a second thread, the fetcher,
    with one device-to-host copy, while the dispatcher already prepares and
    launches the next drain. At most MAX_INFLIGHT drains wait for the
    fetcher; beyond that the dispatcher blocks (backpressure).

On a card the dispatcher launches on a stream of its own and records an
event after each drain; the fetcher waits for that event on its own stream
before it copies, so it never reads outputs before they are written, and the
caching allocator keeps each output until the fetcher's copy is done.

A selection that the stacked top-k does not take (no ORDER BY, an expression
or a wide integer key) is answered by the per-segment executor when it is
prepared, and a top-k whose candidates NaN or -inf keys displaced, or whose
DOUBLE keys tie in f32 at the candidates' cut, is answered by the exact path
when it is decoded; `stats()["topkExact"]` counts both. A set that holds
consuming views or segments committed apart is prepared on the set
executor's merged-dictionary view.

`pipeline_from_config` builds a server process's pipeline from its
`server.device.*` keys.

There is no fallback: a query shape the set executor does not run, a
planning or launch error, or a caller's timeout resolves the caller's future
with the exception (NotImplementedError, the error itself, TimeoutError),
which `execute_partial` raises. An item whose caller gave up is skipped before
its launch and before its fetch.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Dict, List, Optional, Sequence

import torch

MAX_BATCH = 64           # items one drain takes at most
MAX_INFLIGHT = 4         # dispatched drains waiting for the fetcher, at most
SUBMIT_TIMEOUT_S = 120.0  # a caller waits this long at most for its answer

#: pipeline stages timed (ms): queue_wait per item; prepare (the drain's
#: planning and inputs, part of dispatch), dispatch, fetch and decode per drain
_STAGES = ("queue_wait", "prepare", "dispatch", "fetch", "decode")


def _resolve(future: Future, value=None, exc: Optional[BaseException] = None) -> None:
    """set_result/set_exception, tolerant of a caller that already timed out
    and cancelled the future (a cancel can race a resolution)."""
    if future.done():
        return
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(value)
    except (InvalidStateError, CancelledError):
        pass


class _Item:
    __slots__ = ("ctx", "segments", "future", "t_enqueue")

    def __init__(self, ctx, segments):
        self.ctx = ctx
        self.segments = segments
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


class DeviceQueryPipeline:
    """Single-owner device dispatch loop with whole-drain batched fetches."""

    def __init__(self, mesh_exec=None, start: bool = True):
        if mesh_exec is None:
            from ..parallel import MeshQueryExecutor
            mesh_exec = MeshQueryExecutor()
        self.mesh_exec = mesh_exec
        device = getattr(mesh_exec, "device", None)
        on_card = isinstance(device, torch.device) and device.type == "cuda"
        # the dispatcher launches on one stream (the scan's eager finishing
        # ticket is one slot per stream, so launches of a group stay ordered);
        # the fetcher copies on another
        self._streams = ((torch.cuda.Stream(device), torch.cuda.Stream(device))
                         if on_card else None)
        self._q: "queue.Queue[_Item]" = queue.Queue()
        # dispatched-but-unfetched drains: bounded, so a slow fetch applies
        # backpressure to dispatch instead of piling device work up
        self._fetchq: "queue.Queue[list]" = queue.Queue(maxsize=MAX_INFLIGHT)
        self._fetch_busy = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()    # counters: both threads write them
        self.batches = 0
        self.dispatched = 0
        self.errors = 0
        self.timeouts = 0
        self.launches = 0           # launch groups: one per solo pass or stacked group
        self.scan_launches = 0      # masked_sums kernel launches those groups issued
        self.topk_launches = 0      # stacked top-k launches
        self.topk_exact = 0         # selections answered by the exact path
        self.dedupe_hits = 0
        self.stacked_launches = 0   # groups of more than one pass
        self._stage_ms: Dict[str, deque] = {s: deque(maxlen=512) for s in _STAGES}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="device-pipeline")
        self._fetcher = threading.Thread(target=self._fetch_loop, daemon=True,
                                         name="device-fetcher")
        if start:
            self.start()

    def start(self) -> None:
        """Start the dispatcher and fetcher threads (idempotent). Tests build
        with start=False, fill the queue, then start: N queued submissions
        then coalesce into one drain deterministically."""
        if not self._thread.is_alive():
            self._thread.start()
        if not self._fetcher.is_alive():
            self._fetcher.start()

    def _observe(self, stage: str, ms: float) -> None:
        with self._lock:
            self._stage_ms[stage].append(ms)

    def _fail(self, item: _Item, exc: BaseException) -> None:
        with self._lock:
            self.errors += 1
        _resolve(item.future, exc=exc)

    # -- caller side ------------------------------------------------------
    def execute_partial(self, ctx, segments: Sequence):
        """Submit and wait; returns the set's SegmentResult partial (a
        high-cardinality group partial in array form, its `dense` set, where
        the set executor gives one: `merge_segment_results` merges it and
        `materialize_dense` turns it into the state dict). Raises what
        the pipeline raised for it, or TimeoutError after SUBMIT_TIMEOUT_S
        (or the query's `deadlineEpochMs` option, whichever comes first)."""
        item = _Item(ctx, list(segments))
        timeout_s = SUBMIT_TIMEOUT_S
        d_ms = ctx.options.get("deadlineEpochMs") if getattr(ctx, "options", None) else None
        if d_ms is not None:
            timeout_s = max(0.0, min(timeout_s, float(d_ms) / 1000.0 - time.time()))
        self._q.put(item)
        try:
            return item.future.result(timeout=timeout_s)
        except FutureTimeoutError:
            # cancel, so the dispatcher and fetcher skip the item instead of
            # launching and decoding a result nobody reads
            item.future.cancel()
            with self._lock:
                self.timeouts += 1
            raise TimeoutError(f"device pipeline gave no answer within {timeout_s:.3f} s")

    def stop(self) -> None:
        """Stop both threads; queued and unfetched items fail with RuntimeError."""
        self._stop.set()
        for t in (self._thread, self._fetcher):
            if t.is_alive():
                t.join(timeout=5.0)
        stopped = RuntimeError("device pipeline stopped")
        while True:
            try:
                _resolve(self._q.get_nowait().future, exc=stopped)
            except queue.Empty:
                break
        while True:
            try:
                entry = self._fetchq.get_nowait()
            except queue.Empty:
                break
            for item in _entry_items(entry):
                _resolve(item.future, exc=stopped)

    # -- dispatcher thread ------------------------------------------------
    def _drain(self) -> Optional[list]:
        """The next batch: everything already queued, plus, while a fetch is
        still in flight, whatever arrives before it completes. Dispatching
        earlier wins nothing (the fetcher is busy) and would split the batch
        into single fetches."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return None
        batch = [first]
        while len(batch) < MAX_BATCH:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                fetch_pending = self._fetch_busy.is_set() or not self._fetchq.empty()
                if not fetch_pending:
                    break
                try:
                    batch.append(self._q.get(timeout=0.005))
                except queue.Empty:
                    continue
        return batch

    def _loop(self) -> None:
        """Dispatcher: drain -> prepare + group -> launch -> hand to the fetcher.
        While the fetcher copies drain N, drain N+1's passes already run."""
        while not self._stop.is_set():
            # the last drain's launches hold its device inputs: an idle
            # dispatcher must not keep them alive
            batch = entry = event = None
            batch = self._drain()
            if batch is None:
                continue
            t0 = time.perf_counter()
            if self._streams is None:
                entry, n_live = self._dispatch_grouped(batch, t0)
                event = None
            else:
                with torch.cuda.stream(self._streams[0]):
                    entry, n_live = self._dispatch_grouped(batch, t0)
                    event = torch.cuda.Event()
                    event.record()
            self._observe("dispatch", (time.perf_counter() - t0) * 1000)
            if n_live:
                with self._lock:
                    self.batches += 1
                    self.dispatched += n_live
            if not entry:
                continue
            handed_off = False
            while not self._stop.is_set():
                try:
                    self._fetchq.put((entry, event), timeout=0.2)
                    handed_off = True
                    break
                except queue.Full:
                    continue  # fetcher backlogged: backpressure
            if not handed_off:
                stopped = RuntimeError("device pipeline stopped")
                for item in _entry_items((entry, event)):
                    _resolve(item.future, exc=stopped)

    def _dispatch_grouped(self, batch: List[_Item], t0: float):
        """Prepare every live item, collapse identical dispatches, launch the
        dedupe representatives (stacking where the work aligns). Returns
        (fetch entry, items answered): the entry is a list of launches
        `(packed outputs, finish, groups)`, where `groups[i]` holds the
        (item, decode) pairs answered by the launch's i-th output."""
        reps = []                     # dedupe-group representative PreparedDispatch
        rep_groups: List[list] = []   # aligned [(item, decode), ...] lists
        dedupe_index: Dict[tuple, int] = {}
        answered = 0
        prepare_s = 0.0
        for item in batch:
            if item.future.done():
                continue  # the caller gave up: no launch for it
            self._observe("queue_wait", (t0 - item.t_enqueue) * 1000)
            try:
                t_prep = time.perf_counter()
                p = self.mesh_exec.prepare_partial(item.ctx, item.segments)
                prepare_s += time.perf_counter() - t_prep
                if p.kind in ("metadata", "exact"):   # answered without a pass
                    answered += 1
                    if p.kind == "exact":
                        with self._lock:
                            self.topk_exact += 1
                    _resolve(item.future, p.decode({}))
                    continue
            except Exception as e:   # the caller's future carries it, the loop goes on
                self._fail(item, e)
                continue
            if p.dedupe_key is not None and p.dedupe_key in dedupe_index:
                rep_groups[dedupe_index[p.dedupe_key]].append((item, p.decode))
                with self._lock:
                    self.dedupe_hits += 1
                continue
            if p.dedupe_key is not None:
                dedupe_index[p.dedupe_key] = len(reps)
            reps.append(p)
            rep_groups.append([(item, p.decode)])
        self._observe("prepare", prepare_s * 1000)
        if not reps:
            return [], answered
        try:
            launches = self.mesh_exec.dispatch_prepared(reps)
        except Exception as e:
            for group in rep_groups:
                for item, _ in group:
                    self._fail(item, e)
            return [], answered
        with self._lock:
            self.launches += len(launches)
            self.stacked_launches += sum(1 for _, _, idxs in launches if len(idxs) > 1)
            self.scan_launches += sum(1 for p in reps if getattr(p, "route", None))
            self.topk_launches += sum(1 for p in reps if p.kind == "topk")
        entry = [(packed, finish, [rep_groups[i] for i in idxs])
                 for packed, finish, idxs in launches]
        return entry, answered + sum(len(g) for g in rep_groups)

    # -- fetcher thread ---------------------------------------------------
    def _fetch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                entry, event = self._fetchq.get(timeout=0.05)
            except queue.Empty:
                continue
            self._fetch_busy.set()
            try:
                # launches whose every caller gave up are not fetched at all
                live = [L for L in entry
                        if any(not item.future.done() for group in L[2] for item, _ in group)]
                if not live:
                    continue
                t0 = time.perf_counter()
                try:
                    if event is None:
                        fetched = self.mesh_exec.fetch([L[0] for L in live])
                    else:
                        with torch.cuda.stream(self._streams[1]):
                            self._streams[1].wait_event(event)
                            fetched = self.mesh_exec.fetch([L[0] for L in live])
                except Exception as e:
                    for item in _entry_items((live, event)):
                        self._fail(item, e)
                    continue
                self._observe("fetch", (time.perf_counter() - t0) * 1000)
                t1 = time.perf_counter()
                for (_, finish, groups), host in zip(live, fetched):
                    self._decode_launch(finish, groups, host)
                self._observe("decode", (time.perf_counter() - t1) * 1000)
            finally:
                # nor an idle fetcher the last fetch's outputs and inputs
                entry = event = live = fetched = _ = finish = groups = host = None
                self._fetch_busy.clear()

    def _decode_launch(self, finish, groups, host) -> None:
        try:
            outs_list = finish(host)
        except Exception as e:
            for group in groups:
                for item, _ in group:
                    self._fail(item, e)
            return
        for outs, group in zip(outs_list, groups):
            for item, decode in group:
                if item.future.done():
                    continue  # the caller gave up mid-fetch: no decode
                try:
                    r = decode(outs)
                except Exception as e:
                    self._fail(item, e)
                    continue
                if getattr(r, "topk_exact", False):
                    with self._lock:
                        self.topk_exact += 1
                _resolve(item.future, r)

    def stats(self) -> dict:
        with self._lock:
            out = {"batches": self.batches, "dispatched": self.dispatched,
                   "errors": self.errors, "timeouts": self.timeouts,
                   "launches": self.launches, "scanLaunches": self.scan_launches,
                   "topkLaunches": self.topk_launches, "topkExact": self.topk_exact,
                   "dedupeHits": self.dedupe_hits,
                   "stackedLaunches": self.stacked_launches,
                   "meanBatch": round(self.dispatched / self.batches, 2)
                   if self.batches else 0.0}
            out["stageMs"] = {s: _summarize(self._stage_ms[s]) for s in _STAGES}
        return out


def _entry_items(entry_event):
    """Every item of a fetch entry `(launches, event)`."""
    for _, _, groups in entry_event[0]:
        for group in groups:
            for item, _ in group:
                yield item


def _summarize(samples: deque) -> dict:
    vals = sorted(samples)
    if not vals:
        return {"count": 0, "meanMs": 0.0, "p50Ms": 0.0, "p95Ms": 0.0, "maxMs": 0.0}
    n = len(vals)
    return {"count": n,
            "meanMs": round(sum(vals) / n, 3),
            "p50Ms": round(vals[min(n - 1, int(0.5 * n))], 3),
            "p95Ms": round(vals[min(n - 1, int(0.95 * n))], 3),
            "maxMs": round(vals[-1], 3)}


#: `server.*` keys of the JAX package's pipeline this package does not take:
#: its limits are the module constants above
UNPORTED_PIPELINE_KEYS = ("server.device.max.batch", "server.device.max.inflight",
                          "server.device.timeout.seconds", "server.device.stacking.enabled",
                          "server.fused.burst.window.ms", "server.mesh.devices",
                          "server.fused.enabled")


def pipeline_from_config(cfg, device=None) -> Optional[DeviceQueryPipeline]:
    """The server's pipeline from `server.device.enabled` (default false: the
    server answers through the per-segment executor), over a set executor on
    `device` (CUDA unless the caller names another). A key of the JAX
    package's pipeline this one does not take raises NotImplementedError
    rather than be ignored."""
    if not cfg.get_bool("server.device.enabled", False):
        return None
    for key in UNPORTED_PIPELINE_KEYS:
        if key in cfg:
            raise NotImplementedError(
                f"{key}: this package's pipeline takes its limits from "
                "cluster/device_server.py's module constants (ROADMAP.md queue 1)")
    from ..parallel import MeshQueryExecutor
    return DeviceQueryPipeline(mesh_exec=MeshQueryExecutor(device))
