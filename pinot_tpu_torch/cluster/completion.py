"""Realtime (LLC) segment management and the segment completion protocol.

A copy of `pinot_tpu/cluster/completion.py`, the controller side of the
reference's two realtime FSM owners (SURVEY.md §3.2):

* `PinotLLCRealtimeSegmentManager`: creates the CONSUMING segments of each
  stream partition; on commit writes the final metadata (end offset, time
  range, column stats), flips the ideal state CONSUMING -> ONLINE and creates
  the successor CONSUMING segment from the end offset, on the predecessor's
  replica set while those servers live.
* `SegmentCompletionManager`: one FSM a segment elects one committer among
  its replicas. Replicas report `segment_consumed(offset)` at their end
  criteria; the FSM HOLDs until every replica reported (or one re-reported,
  which covers a lost replica), then elects the max-offset reporter
  (ties to the larger server name); laggards get CATCHUP to the committer's
  offset, peers at that offset HOLD until COMMITTED, then KEEP (adopt the
  local build) or DISCARD (download the committed copy). A committer silent
  past `commit_timeout_s` is struck and another elected; an FSM rebuilt after
  a controller restart adopts the replica that claims the in-flight commit.
  The responses are those of the reference's SegmentCompletionProtocol.

A commit whose deep-store upload runs out of its retries still commits, under
the peer download scheme (the reference's PeerSchemeSplitSegmentCommitter):
its download path is `peer://{table}/{segment}`, the segment is quarantined,
and the replicas fetch the committed copy from a serving peer
(`cluster/peers.py`). The validation round's repairs
(`repair_missing_consuming_segments`, `reassign_dead_consuming_segments`,
`validate`) are methods a caller or the controller's periodic task runs;
`validate` also heals each `peer://` segment once the deep store takes it
again (the reference's uploadToDeepStoreIfMissing): its tar fetched from a
peer, uploaded, and its download path set to the deep-store URI.

The catalog's dictionaries are read as copies taken under its lock, as the
other roles of this package read them, and a commit fills in a copy of the
segment's metadata and puts it whole: no reader sees a segment DONE without
its end offset. A commit whose FSM was dropped or replaced during its upload
(the table dropped, the segment reassigned) fails at the flip.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..segment.format import CREATION_META_FILE, SEGMENT_METADATA_FILE, read_json
from ..table import TableConfig
from ..utils.events import emit_event
from ..utils.metrics import get_registry
from .assignment import balanced_assign, compute_counts
from .catalog import (COLUMN_STATS_KEY, CONSUMING, ONLINE, STATUS_DONE, STATUS_IN_PROGRESS,
                      Catalog, SegmentMeta, column_stats_from_meta)
from .deepstore import DeepStoreFS, tar_segment

# protocol responses (the reference's SegmentCompletionProtocol.ControllerResponseStatus)
HOLD = "HOLD"
CATCHUP = "CATCHUP"
COMMIT = "COMMIT"
DISCARD = "DISCARD"
KEEP = "KEEP"
COMMIT_SUCCESS = "COMMIT_SUCCESS"
COMMIT_CONTINUE = "COMMIT_CONTINUE"
FAILED = "FAILED"

_PEER_SCHEME = "peer://"


def llc_segment_name(table: str, partition: int, seq: int) -> str:
    """The reference's LLC name: {table}__{partitionGroup}__{sequence}__{creation ms}."""
    return f"{table}__{partition}__{seq}__{int(time.time() * 1000)}"


def parse_llc_name(name: str) -> dict:
    """`<table>__<partition>__<sequence>__<time>` -> its parts (the
    reference's LLCSegmentName)."""
    parts = name.split("__")
    return {"table": parts[0], "partition": int(parts[1]), "sequence": int(parts[2])}


@dataclass
class CompletionFSM:
    """One segment's completion state (the reference's SegmentCompletionFSM)."""

    segment: str
    num_replicas: int
    state: str = "HOLDING"     # HOLDING -> COMMITTER_NOTIFIED -> COMMITTING -> COMMITTED
    offsets: Dict[str, int] = field(default_factory=dict)
    reports: Dict[str, int] = field(default_factory=dict)   # server -> report count
    committer: Optional[str] = None
    final_offset: Optional[int] = None
    committer_decided_at: float = 0.0
    commit_timeout_s: float = 120.0
    # set only on an FSM rebuilt after a controller restart: it alone may
    # adopt a committer without an election of its own
    rebuilt: bool = False
    replica_set: frozenset = frozenset()   # the servers adoption may pick

    def on_consumed(self, server: str, offset: int) -> Dict[str, object]:
        if self.state == "COMMITTED":
            if offset == self.final_offset:
                return {"status": KEEP, "offset": self.final_offset}
            return {"status": DISCARD, "offset": self.final_offset}

        self.offsets[server] = max(offset, self.offsets.get(server, -1))
        self.reports[server] = self.reports.get(server, 0) + 1

        if self.state == "HOLDING":
            all_reported = len(self.offsets) >= self.num_replicas
            re_reported = any(c > 1 for c in self.reports.values())
            if not (all_reported or re_reported):
                return {"status": HOLD, "offset": offset}
            self._elect()

        if self.state in ("COMMITTER_NOTIFIED", "COMMITTING"):
            if self._committer_stale():
                # a silent committer's report is struck before the
                # re-election, so that its offset cannot win it again; a
                # merely slow one re-reports and rejoins
                if server != self.committer:
                    self.offsets.pop(self.committer, None)
                    self.reports.pop(self.committer, None)
                self._elect()
            target = self.offsets[self.committer]
            if server == self.committer and offset >= target:
                return {"status": COMMIT, "offset": target}
            if offset < target:
                return {"status": CATCHUP, "offset": target}
            return {"status": HOLD, "offset": offset}
        return {"status": HOLD, "offset": offset}

    def _elect(self) -> None:
        self.committer = max(self.offsets, key=lambda s: (self.offsets[s], s))
        self.state = "COMMITTER_NOTIFIED"
        self.committer_decided_at = time.time()

    def _committer_stale(self) -> bool:
        # COMMITTING times out too: a committer that died after commitStart
        # must not wedge the segment (the reference's MAX_COMMIT_TIME)
        return (self.state in ("COMMITTER_NOTIFIED", "COMMITTING")
                and time.time() - self.committer_decided_at > self.commit_timeout_s)

    def can_adopt(self, server: str) -> bool:
        """Whether `server` may claim the in-flight commit after a controller
        restart: the FSM was rebuilt from the catalog (its election is lost),
        holds no committer yet, and the server is of the replica set."""
        return (self.rebuilt and self.state == "HOLDING" and self.committer is None
                and server in self.replica_set)

    def adopt_committer(self, server: str) -> None:
        self.committer = server
        self.offsets.setdefault(server, -1)
        self.committer_decided_at = time.time()
        self.state = "COMMITTING"

    def on_commit_start(self, server: str) -> str:
        if self.can_adopt(server):
            self.adopt_committer(server)
            return COMMIT_CONTINUE
        if self.state not in ("COMMITTER_NOTIFIED", "COMMITTING") or server != self.committer:
            return FAILED
        self.committer_decided_at = time.time()  # the commit clock starts now
        self.state = "COMMITTING"
        return COMMIT_CONTINUE

    def on_commit_end(self, server: str, end_offset: int) -> str:
        if self.state != "COMMITTING" or server != self.committer:
            return FAILED
        self.state = "COMMITTED"
        self.final_offset = end_offset
        return COMMIT_SUCCESS


class LLCSegmentManager:
    """The controller's realtime lifecycle (one a controller)."""

    def __init__(self, catalog: Catalog, deepstore: DeepStoreFS, work_dir: str):
        self.catalog = catalog
        self.deepstore = deepstore
        self.work_dir = work_dir
        self.fsms: Dict[str, CompletionFSM] = {}
        # one lock over the protocol and the repairs: a repair inside a
        # commit's DONE -> successor window would create a second successor
        # consuming the same records
        self._lock = threading.RLock()
        # segments whose deep-store upload ran out of retries -> failures
        self.quarantined: Dict[str, int] = {}
        os.makedirs(work_dir, exist_ok=True)

    # -- table setup (the reference's setUpNewTable) -------------------------
    def setup_realtime_table(self, cfg: TableConfig, num_partitions: int) -> List[str]:
        """The first CONSUMING segment of each partition, from offset 0."""
        with self._lock:
            return [self._create_consuming_segment(cfg.table_name_with_type, cfg, p, 0, 0)
                    for p in range(num_partitions)]

    def _create_consuming_segment(self, table: str, cfg: TableConfig, partition: int,
                                  seq: int, start_offset: int) -> str:
        name = llc_segment_name(cfg.name, partition, seq)
        meta = SegmentMeta(name=name, table=table, status=STATUS_IN_PROGRESS,
                           start_offset=str(start_offset), partition_group=partition,
                           sequence_number=seq, creation_time_ms=int(time.time() * 1000))
        self.catalog.put_segment_meta(meta)
        servers = self.catalog.live_servers(cfg.tenant)
        # every segment of a partition on one replica set (the reference's
        # RealtimeSegmentAssignment): the predecessor's servers while they all
        # live, so that replica-group routing (and an upsert table's valid-doc
        # masks) serve a partition from one server; else balanced placement
        chosen: List[str] = []
        with self.catalog._lock:
            prev_name = next((m.name for m in self.catalog.segments.get(table, {}).values()
                              if m.partition_group == partition
                              and m.sequence_number == seq - 1), None) if seq > 0 else None
            ist = self.catalog.ideal_state.get(table, {})
            prev = dict(ist.get(prev_name) or {}) if prev_name else {}
            counts = compute_counts({s: dict(a) for s, a in ist.items()})
        if prev:
            inherited = [s for s in sorted(prev) if s in servers]
            if len(inherited) == cfg.replication:
                chosen = inherited
        if not chosen:
            chosen = balanced_assign(name, servers, cfg.replication, counts)
        self.catalog.update_ideal_state(table, {name: {s: CONSUMING for s in chosen}})
        self.fsms[name] = CompletionFSM(name, num_replicas=len(chosen))
        emit_event("segment.consuming.created", node="controller", table=table,
                   segment=name, partition=partition, sequence=seq)
        return name

    # -- protocol endpoints (the reference's LLCSegmentCompletionHandlers) ----
    def _fsm_for(self, segment: str, meta: Optional[SegmentMeta]) -> Optional[CompletionFSM]:
        """The segment's FSM; after a controller restart (the FSMs lost, the
        metadata IN_PROGRESS) a HOLDING one rebuilt from the ideal state's
        replica set, so the protocol goes on (the reference's
        lookupOrCreateFsm)."""
        fsm = self.fsms.get(segment)
        if fsm is not None:
            return fsm
        if meta is None or meta.status != STATUS_IN_PROGRESS:
            return None
        with self.catalog._lock:
            assignment = dict(self.catalog.ideal_state.get(meta.table, {}).get(segment, {}))
        fsm = CompletionFSM(segment, num_replicas=max(len(assignment), 1), rebuilt=True,
                            replica_set=frozenset(assignment))
        self.fsms[segment] = fsm
        return fsm

    def segment_consumed(self, segment: str, server: str, offset: int) -> Dict[str, object]:
        with self._lock:
            meta = self._meta(segment)
            fsm = self._fsm_for(segment, meta)
            if fsm is None:
                if meta is not None and meta.status == STATUS_DONE:
                    final = int(meta.end_offset)
                    return {"status": KEEP if offset == final else DISCARD, "offset": final}
                return {"status": FAILED, "offset": offset}
            return fsm.on_consumed(server, offset)

    def segment_commit_start(self, segment: str, server: str) -> str:
        with self._lock:
            fsm = self._fsm_for(segment, self._meta(segment))
            return fsm.on_commit_start(server) if fsm else FAILED

    def segment_commit_end(self, segment: str, server: str, segment_dir: str,
                           end_offset: int) -> str:
        """Upload, then the metadata flip and the successor (the reference's
        commitSegmentFile + commitSegmentMetadata).

        The flip, the FSM transition and the successor hold the manager's
        lock (a repair must never see a DONE segment without its successor);
        the tar and upload run outside it, so that one slow upload does not
        hold every other segment's responses. During the upload the segment
        is IN_PROGRESS with a live committer, which no repair touches; the
        committer is checked again after it."""
        with self._lock:
            meta = self._meta(segment)
            fsm = self._fsm_for(segment, meta)
            if fsm is not None and fsm.can_adopt(server):
                # the controller restarted between this committer's
                # commitStart and its commitEnd: adopt it here too
                fsm.adopt_committer(server)
            if fsm is None or fsm.state != "COMMITTING" or server != fsm.committer:
                return FAILED
            table = meta.table
            cfg = self.catalog.table_configs.get(table)
            if cfg is None:
                return FAILED

        seg_meta_json = read_json(os.path.join(segment_dir, SEGMENT_METADATA_FILE))
        crc = read_json(os.path.join(segment_dir, CREATION_META_FILE))["crc"]
        tar_path = os.path.join(self.work_dir, f"{segment}.tar.gz")
        tar_segment(segment_dir, tar_path)
        uri = f"{table}/{segment}.tar.gz"
        try:
            if not self._upload_with_retry(tar_path, uri, segment):
                # the deep store is down: the commit goes on under the peer
                # download scheme, and the validation round uploads the
                # segment once the deep store takes it again
                uri = f"{_PEER_SCHEME}{table}/{segment}"
            size = os.path.getsize(tar_path)
        finally:
            os.remove(tar_path)

        with self._lock:
            return self._finish_commit(segment, server, fsm, cfg, seg_meta_json, crc, uri, size,
                                       end_offset)

    def _upload_with_retry(self, local_path: str, uri: str, segment: str) -> bool:
        """The upload with `clusterConfig/deepstore.retry.max` tries (default
        3) and an exponential backoff from `deepstore.retry.backoff.ms`
        (default 50). False when every try failed: the segment is then
        quarantined (the commit takes the peer scheme, and each validation
        round tries the deep store once until an upload lands)."""
        reg = get_registry()
        max_tries = max(1, int(self.catalog.get_property(
            "clusterConfig/deepstore.retry.max", 3)))
        backoff_ms = float(self.catalog.get_property(
            "clusterConfig/deepstore.retry.backoff.ms", 50))
        for attempt in range(max_tries):
            if attempt:
                reg.counter("pinot_controller_deepstore_retries").inc()
                time.sleep(backoff_ms * (2 ** (attempt - 1)) / 1000.0)
            try:
                self.deepstore.upload(local_path, uri)
            except Exception:   # counted as a retry by the next try, or quarantined
                continue
            with self._lock:
                self.quarantined.pop(segment, None)
            return True
        with self._lock:
            first_time = segment not in self.quarantined
            self.quarantined[segment] = self.quarantined.get(segment, 0) + max_tries
        if first_time:
            reg.counter("pinot_controller_deepstore_quarantined").inc()
            emit_event("deepstore.quarantined", node="controller", segment=segment,
                       attempts=max_tries)
        return False

    def _finish_commit(self, segment, server, fsm, cfg, seg_meta_json, crc, uri, size,
                       end_offset) -> str:
        """The metadata flip, on a copy taken under the catalog's lock: a
        reader sees the segment IN_PROGRESS or DONE with every field of its
        commit. Fails if the FSM was replaced or dropped during the upload
        (a reassignment, a drop of the table) or the table is gone."""
        if fsm.state != "COMMITTING" or server != fsm.committer:
            return FAILED   # re-elected away during a slow upload
        table = cfg.table_name_with_type
        with self.catalog._lock:
            live = self.catalog.segments.get(table, {}).get(segment)
            if (self.fsms.get(segment) is not fsm or live is None
                    or table not in self.catalog.table_configs):
                return FAILED
            meta = dataclasses.replace(live, custom=dict(live.custom))
        meta.status = STATUS_DONE
        meta.end_offset = str(end_offset)
        meta.num_docs = seg_meta_json["totalDocs"]
        meta.crc = crc
        meta.size_bytes = size
        meta.download_path = uri
        self._fill_time_range(cfg, seg_meta_json, meta)
        col_stats = column_stats_from_meta(seg_meta_json)
        if col_stats:
            meta.custom[COLUMN_STATS_KEY] = col_stats
        self.catalog.put_segment_meta(meta)

        resp = fsm.on_commit_end(server, end_offset)
        if resp != COMMIT_SUCCESS:
            return resp
        with self.catalog._lock:
            assignment = dict(self.catalog.ideal_state.get(table, {}).get(segment, {}))
        self.catalog.update_ideal_state(table, {segment: {s: ONLINE for s in assignment}})
        emit_event("segment.committed", node="controller", table=table, segment=segment,
                   committer=server, endOffset=end_offset)
        emit_event("segment.online", node="controller", table=table, segment=segment)
        # the successor from the end offset, unless consumption is paused:
        # resume creates it then
        if not self.is_paused(table):
            info = parse_llc_name(segment)
            self._create_consuming_segment(table, cfg, info["partition"],
                                           info["sequence"] + 1, end_offset)
        return COMMIT_SUCCESS

    # -- pause and resume (the reference's pauseConsumption / resumeConsumption)
    def is_paused(self, table: str) -> bool:
        return self.catalog.get_property(f"pause/{table}") is not None

    def pause_consumption(self, table: str) -> Dict[str, object]:
        """Servers stop fetching and force-commit the consuming segments that
        hold rows; a segment committed while paused gets no successor."""
        cfg = self.catalog.table_configs.get(table)
        if cfg is None or cfg.stream is None:
            raise ValueError(f"{table!r} is not a realtime table")
        with self.catalog._lock:
            consuming = [m.name for m in self.catalog.segments.get(table, {}).values()
                         if m.status == STATUS_IN_PROGRESS]
        self.catalog.put_property(f"pause/{table}", "paused")
        return {"paused": True, "consumingSegments": consuming}

    def resume_consumption(self, table: str) -> Dict[str, object]:
        """Clear the pause and create the successors of the partitions whose
        last segment committed while paused, from their end offsets."""
        cfg = self.catalog.table_configs.get(table)
        if cfg is None or cfg.stream is None:
            raise ValueError(f"{table!r} is not a realtime table")
        self.catalog.put_property(f"pause/{table}", None)
        with self._lock:
            created = self._repair_missing_consuming_segments(only_table=table)
        return {"paused": False, "created": created}

    # -- repairs (the reference's RealtimeSegmentValidationManager) ----------
    def repair_missing_consuming_segments(self) -> List[str]:
        """Create the CONSUMING successor of each partition whose latest
        segment is DONE (a controller lost between commit and create)."""
        with self._lock:
            return self._repair_missing_consuming_segments()

    def _repair_missing_consuming_segments(self, only_table: Optional[str] = None
                                           ) -> List[str]:
        created = []
        for table, cfg in self._realtime_tables():
            if only_table is not None and table != only_table:
                continue
            if self.is_paused(table) or not self.catalog.live_servers(cfg.tenant):
                # with no live server the successor's metadata would be
                # written and its assignment fail: wait for a server
                continue
            latest: Dict[int, SegmentMeta] = {}
            with self.catalog._lock:
                metas = list(self.catalog.segments.get(table, {}).values())
            for meta in metas:
                if meta.partition_group is None:
                    continue
                cur = latest.get(meta.partition_group)
                if cur is None or meta.sequence_number > cur.sequence_number:
                    latest[meta.partition_group] = meta
            for p, meta in latest.items():
                if meta.status == STATUS_DONE:
                    created.append(self._create_consuming_segment(
                        table, cfg, p, meta.sequence_number + 1, int(meta.end_offset)))
        return created

    def reassign_dead_consuming_segments(self) -> List[str]:
        """Move each CONSUMING segment whose every replica is dead onto live
        servers, with a fresh election; the new replicas consume again from
        the segment's start offset."""
        with self._lock:
            return self._reassign_dead_consuming_segments()

    def _reassign_dead_consuming_segments(self) -> List[str]:
        moved = []
        for table, cfg in self._realtime_tables():
            live = self.catalog.live_servers(cfg.tenant)
            if not live:
                continue
            with self.catalog._lock:
                ist = {s: dict(a) for s, a in self.catalog.ideal_state.get(table, {}).items()}
                metas = dict(self.catalog.segments.get(table, {}))
                alive = {i for i, info in self.catalog.instances.items() if info.alive}
            counts = compute_counts(ist)
            for seg, assignment in ist.items():
                meta = metas.get(seg)
                if meta is None or meta.status != STATUS_IN_PROGRESS:
                    continue
                if any(s in alive for s in assignment):
                    continue
                chosen = balanced_assign(seg, live, cfg.replication, counts)
                for c in chosen:   # moved segments spread
                    counts[c] = counts.get(c, 0) + 1
                self.catalog.update_ideal_state(table, {seg: {s: CONSUMING for s in chosen}})
                self.fsms[seg] = CompletionFSM(seg, num_replicas=len(chosen))
                moved.append(seg)
                emit_event("segment.reassigned", node="controller", table=table,
                           segment=seg, servers=sorted(chosen))
        return moved

    def validate(self) -> Dict[str, List[str]]:
        """One validation round: the missing successors, the dead replicas'
        consuming segments, and the peer-scheme segments healed into the deep
        store."""
        with self._lock:
            out = {"created": self._repair_missing_consuming_segments(),
                   "reassigned": self._reassign_dead_consuming_segments()}
        out["healed"] = self._heal_peer_segments()
        return out

    def _heal_peer_segments(self) -> List[str]:
        """Upload each `peer://` segment's tar, fetched from a serving peer,
        to the deep store and point its download path there. A segment whose
        fetch or upload fails waits for the next round (its quarantine count
        grows); the path flips under the locks, and only where the segment is
        still a peer-scheme one (a drop or another round may have come
        between)."""
        from .peers import fetch_from_peer
        with self.catalog._lock:
            peer = sorted((t, n) for t, segs in self.catalog.segments.items()
                          for n, m in segs.items()
                          if (m.download_path or "").startswith(_PEER_SCHEME))
        healed = []
        for table, name in peer:
            uri = f"{table}/{name}.tar.gz"
            # a name of its own a round: a POST /validate may run beside the
            # periodic round
            tmp = os.path.join(self.work_dir, f"heal_{name}_{uuid.uuid4().hex[:8]}.tar.gz")
            try:
                fetch_from_peer(self.catalog, table, name, tmp)
                self.deepstore.upload(tmp, uri)
            except OSError:   # no peer, or the deep store still down: the next round
                with self._lock:
                    if name in self.quarantined:
                        self.quarantined[name] += 1
                continue
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            with self._lock:
                self.quarantined.pop(name, None)
                with self.catalog._lock:
                    cur = self.catalog.segments.get(table, {}).get(name)
                    if cur is None or not (cur.download_path or "").startswith(_PEER_SCHEME):
                        continue
                    meta = dataclasses.replace(cur, custom=dict(cur.custom))
                meta.download_path = uri
                self.catalog.put_segment_meta(meta)
            healed.append(name)
            emit_event("deepstore.healed", node="controller", table=table, segment=name)
        return healed

    def _realtime_tables(self) -> List[tuple]:
        with self.catalog._lock:
            return [(t, cfg) for t, cfg in self.catalog.table_configs.items()
                    if cfg.stream is not None]

    def _meta(self, segment: str) -> Optional[SegmentMeta]:
        """The catalog's own object, only read: a commit puts a copy."""
        with self.catalog._lock:
            for table_segs in self.catalog.segments.values():
                if segment in table_segs:
                    return table_segs[segment]
        return None

    @staticmethod
    def _fill_time_range(cfg: TableConfig, seg_meta_json, meta: SegmentMeta) -> None:
        if not cfg.time_column:
            return
        col = seg_meta_json["columns"].get(cfg.time_column)
        if col and col.get("minValue") is not None:
            meta.start_time_ms = int(col["minValue"])
            meta.end_time_ms = int(col["maxValue"])
