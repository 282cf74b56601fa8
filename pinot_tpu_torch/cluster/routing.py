"""Broker routing: external-view-driven routing tables, instance selection, pruning.

Analog of the reference's `BrokerRoutingManager`
(`pinot-broker/.../routing/BrokerRoutingManager.java:88,122`), instance selectors
(`routing/instanceselector/`), and segment pruners (`routing/segmentpruner/`): watch the
external view, keep segment -> online replica servers, select one replica per segment
per query (round-robin for balance), and prune segments by partition/time metadata
before scatter.

A copy of `pinot_tpu/cluster/routing.py`, without the cold tier's state, and
with the routing table rebuilt from a copy of the external view, one rebuild
at a time (concurrent uploads report states from several threads). A
realtime table's CONSUMING segments route to the first healthy replica of
their sorted candidates, so that a segment's reads stay on one replica's
offsets; a reassignment or the CONSUMING -> ONLINE flip rebuilds the table
from the external view, after which the committed segment routes as any
ONLINE one does (round-robin under the balanced selector).
"""

from __future__ import annotations

import itertools
import threading
import zlib
from typing import Dict, List, Optional, Set

from ..query.context import QueryContext
from ..sql.ast import Expr, Function, Identifier, Literal
from ..segment.indexes.bloom import bloom_hex_might_contain
from .catalog import COLD, COLUMN_STATS_KEY, CONSUMING, ONLINE, Catalog, SegmentMeta

#: pruner kinds in evaluation order — the FIRST pruner that rejects a segment
#: gets the attribution (numSegmentsPrunedBy<Kind> in ExecutionStats)
PRUNER_KINDS = ("partition", "time", "range", "bloom")

#: key under which `_prune`/`route_query` accumulate pruned-doc counts in the
#: caller-supplied prune_stats dict (feeds scanRowsAvoided)
PRUNE_ROWS_AVOIDED = "rowsAvoided"


def partition_for_value(value, function: str, num_partitions: int) -> int:
    """Partition functions (reference: pinot-segment-spi partition functions)."""
    if function == "modulo":
        return int(value) % num_partitions
    # murmur stand-in: crc32 over the string form — stable across processes
    return zlib.crc32(str(value).encode("utf-8")) % num_partitions


class RoutingTable:
    """segment -> candidate servers, resolved per query to server -> [segments]."""

    def __init__(self, table: str):
        self.table = table
        self.segment_servers: Dict[str, List[str]] = {}
        # segments in the external view whose every replica server is DEAD
        # (left live_servers): undispatchable, but they must still surface in
        # the coverage audit — dropping them entirely would silently shorten
        # results with partialResult=False
        self.dead_segments: Set[str] = set()
        # CONSUMING segments: replicas consume the same partition at
        # INDEPENDENT offsets, so round-robin across them makes COUNT(*)
        # wobble between queries (reads jump to a less-caught-up replica).
        # These route to a STABLE choice — monotonic freshness per segment —
        # until that replica leaves rotation.
        self.consuming_segments: Set[str] = set()
        self._rr = itertools.count()

    def route(self, segments: Optional[Set[str]] = None,
              exclude: Optional[Set[str]] = None,
              selector: str = "balanced",
              uncovered: Optional[List[str]] = None) -> Dict[str, List[str]]:
        """Resolve one healthy replica per segment.

        Selectors (reference: instanceselector/ package):
        - "balanced": per-segment round-robin (BalancedInstanceSelector) —
          best load spread, segments of one query fan across replicas.
        - "replicaGroup"/"strictReplicaGroup": ONE replica ordinal per query
          (ReplicaGroupInstanceSelector / StrictReplicaGroupInstanceSelector):
          every segment is served by the same replica position, so with
          replica-group-aligned assignment a query touches one group — and,
          critically for upsert tables, all segments of a partition are read
          from the SAME server, whose valid-doc bitmaps are mutually
          consistent (mixing replicas can double-count a primary key mid
          upsert propagation)."""
        sel = selector.lower().replace("_", "")
        if sel not in ("balanced", "replicagroup", "strictreplicagroup"):
            raise ValueError(f"unknown routing selector {selector!r}")
        out: Dict[str, List[str]] = {}
        offset = next(self._rr)
        group_mode = sel in ("replicagroup", "strictreplicagroup")
        if group_mode:
            # one per-query PREFERENCE ORDER over all servers: every segment
            # picks its highest-preference candidate, so segments with equal
            # candidate sets always co-locate (partition-consistent realtime
            # assignment makes upsert partitions share candidate sets), and
            # overlapping sets co-locate whenever their preferred server is
            # shared — a per-segment modulo over differing candidate-list
            # lengths would scatter replicas instead
            all_servers = sorted({s for servers in self.segment_servers.values()
                                  for s in servers})
            if all_servers:
                rot = offset % len(all_servers)
                preference = {s: i for i, s in enumerate(
                    all_servers[rot:] + all_servers[:rot])}
        for i, (seg, servers) in enumerate(sorted(self.segment_servers.items())):
            if segments is not None and seg not in segments:
                continue
            candidates = [s for s in servers if not exclude or s not in exclude]
            if not candidates:
                # every replica is excluded (unhealthy): the segment cannot be
                # dispatched — REPORT it so the broker surfaces a partial
                # result instead of a silently-short answer
                if uncovered is not None:
                    uncovered.append(seg)
                continue
            if group_mode:
                chosen = min(candidates, key=preference.__getitem__)
            elif seg in self.consuming_segments:
                chosen = candidates[0]  # stable: monotonic consuming reads
            else:
                chosen = candidates[(offset + i) % len(candidates)]
            out.setdefault(chosen, []).append(seg)
        return out


class RoutingManager:
    """Watches the catalog and maintains routing tables per table."""

    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._tables: Dict[str, RoutingTable] = {}
        self._unhealthy: Set[str] = set()
        self._lock = threading.RLock()
        catalog.subscribe(self._on_event)
        for table in list(catalog.external_view):
            self._rebuild(table)

    def _on_event(self, event: str, table: str) -> None:
        if event in ("external_view", "table", "instance"):
            if event == "instance":
                with self._lock:
                    tables = list(self._tables)
                for t in tables:
                    self._rebuild(t)
            else:
                self._rebuild(table)

    def _rebuild(self, table: str) -> None:
        # rebuilds run one at a time, each from a copy of the external view
        # taken under the catalog's lock: servers report states from several
        # threads at once, and the last table stored is the newest view's
        with self._lock:
            with self.catalog._lock:
                ev = self.catalog.external_view.get(table)
                ev = None if ev is None else {seg: dict(st) for seg, st in ev.items()}
                alive = set(self.catalog.live_servers())
            if ev is None:
                self._tables.pop(table, None)
                return
            rt = RoutingTable(table)
            for seg, states in ev.items():
                # a COLD replica stays routable: its server loads the segment
                # from the deep store on the query
                servers = [srv for srv, st in states.items()
                           if st in (ONLINE, CONSUMING, COLD) and srv in alive]
                if servers:
                    rt.segment_servers[seg] = sorted(servers)
                    if any(st == CONSUMING for st in states.values()):
                        rt.consuming_segments.add(seg)
                elif any(st in (ONLINE, CONSUMING, COLD) for st in states.values()):
                    # the segment WAS being served and every such replica died
                    rt.dead_segments.add(seg)
            self._tables[table] = rt

    # -- health (reference: broker failure detector wiring) -----------------
    def mark_server_unhealthy(self, server: str) -> None:
        with self._lock:
            self._unhealthy.add(server)

    def unhealthy_servers(self) -> Set[str]:
        with self._lock:
            return set(self._unhealthy)

    def mark_server_healthy(self, server: str) -> None:
        with self._lock:
            self._unhealthy.discard(server)

    def segment_candidates(self, table: str, segment: str) -> List[str]:
        """Healthy-state candidate servers for one segment (broker retry)."""
        with self._lock:
            rt = self._tables.get(table)
            return list(rt.segment_servers.get(segment, ())) if rt else []

    # -- query routing -----------------------------------------------------
    def route_query(self, table: str, ctx: Optional[QueryContext] = None,
                    extra_filter: Optional[Expr] = None,
                    uncovered: Optional[List[str]] = None,
                    prune_stats: Optional[Dict[str, float]] = None
                    ) -> Dict[str, List[str]]:
        """`extra_filter` is an additional predicate the servers will apply (the
        broker's hybrid time-boundary split) — fed into the metadata pruner here so
        retained realtime segments entirely below the boundary are never dispatched
        (reference: TimeSegmentPruner sees the boundary-augmented filter).
        `uncovered`, when given, collects segments that survive pruning but have
        no healthy replica to serve them. `prune_stats`, when given, accumulates
        per-pruner-kind rejection counts (PRUNER_KINDS keys) plus the pruned
        segments' total doc count under PRUNE_ROWS_AVOIDED."""
        with self._lock:
            rt = self._tables.get(table)
            unhealthy = set(self._unhealthy)
        if rt is None:
            return {}
        cfg = self.catalog.table_configs.get(table)
        keep = set(rt.segment_servers) | rt.dead_segments
        hidden = self._lineage_hidden(table)
        if hidden:
            keep -= hidden
        if ctx is not None:
            keep = self._prune(table, keep, ctx, prune_stats)
        if extra_filter is not None and cfg is not None:
            metas = self.catalog.segments.get(table, {})
            kept: Set[str] = set()
            for seg in keep:
                meta = metas.get(seg)
                reason = (None if meta is None else
                          _prune_reason(extra_filter, cfg, meta))
                if reason is None:
                    kept.add(seg)
                else:
                    _count_prune(prune_stats, reason, meta)
            keep = kept
        if uncovered is not None:
            # dead-replica segments that survive pruning are part of the
            # query's answer set but have no server at all
            uncovered.extend(sorted(keep & rt.dead_segments))
        return rt.route(keep - rt.dead_segments, exclude=unhealthy,
                        selector=self.selector_for(table), uncovered=uncovered)

    def selector_for(self, table: str) -> str:
        """The table's effective instance selector, NORMALIZED (lowercase, no
        underscores — the same canonical form RoutingTable.route validates
        against) — single source of truth for the first scatter round AND the
        retry round (upsert correctness requires consistent-replica reads;
        reference: upsert tables mandate strictReplicaGroup routing)."""
        cfg = self.catalog.table_configs.get(table)
        if cfg is None:
            return "balanced"
        sel = cfg.routing_selector or (
            "strictReplicaGroup" if cfg.upsert else "balanced")
        return sel.lower().replace("_", "")

    def _lineage_hidden(self, table: str) -> Set[str]:
        """Segments hidden by replace-segment lineage (reference: SegmentLineage,
        `selectSegments` filtering): IN_PROGRESS hides the replacement outputs,
        COMPLETED hides the replaced inputs — so a query never sees both sides."""
        entries = self.catalog.get_property(f"lineage/{table}") or []
        hidden: Set[str] = set()
        for e in entries:
            hidden.update(e["to"] if e["state"] == "IN_PROGRESS" else e["from"])
        return hidden

    def _prune(self, table: str, segments: Set[str], ctx: QueryContext,
               prune_stats: Optional[Dict[str, float]] = None) -> Set[str]:
        """Metadata pruning from SegmentMeta (reference:
        MultiPartitionColumnsSegmentPruner + TimeSegmentPruner +
        ColumnValueSegmentPruner): partition/time from the typed meta fields,
        range/bloom from the commit-time columnStats custom block."""
        cfg = self.catalog.table_configs.get(table)
        metas = self.catalog.segments.get(table, {})
        if cfg is None or ctx.filter is None:
            return segments
        keep = set()
        for seg in segments:
            meta = metas.get(seg)
            if meta is None:
                keep.add(seg)
                continue
            reason = _prune_reason(ctx.filter, cfg, meta)
            if reason is not None:
                _count_prune(prune_stats, reason, meta)
                continue
            keep.add(seg)
        return keep


def _count_prune(prune_stats: Optional[Dict[str, float]], reason: str,
                 meta: Optional[SegmentMeta]) -> None:
    if prune_stats is None:
        return
    prune_stats[reason] = prune_stats.get(reason, 0) + 1
    if meta is not None:
        prune_stats[PRUNE_ROWS_AVOIDED] = (
            prune_stats.get(PRUNE_ROWS_AVOIDED, 0) + meta.num_docs)


def _segment_may_match(filt: Expr, cfg, meta: SegmentMeta) -> bool:
    """Conservative filter check against segment metadata (compat wrapper)."""
    return _prune_reason(filt, cfg, meta) is None


def _out_of_range(name: str, args: List, lo, hi) -> bool:
    """True when the comparison `name(col, *args)` PROVABLY misses [lo, hi].
    columnStats values round-trip through JSON, so a cross-type comparison
    (str vs int, bytes literal vs hex string) degrades to "may match"."""
    try:
        if name == "eq":
            return bool(args[0] < lo or hi < args[0])
        if name == "between":
            return bool(args[1] < lo or hi < args[0])
        if name == "gt":
            return not args[0] < hi          # col > v needs v < max
        if name == "gte":
            return bool(hi < args[0])        # col >= v needs v <= max
        if name == "lt":
            return not lo < args[0]          # col < v needs v > min
        if name == "lte":
            return bool(args[0] < lo)        # col <= v needs v >= min
        if name == "in":
            return all(v < lo or hi < v for v in args)
    except TypeError:
        return False
    return False


def _prune_reason(filt: Expr, cfg, meta: SegmentMeta) -> Optional[str]:
    """Why this segment PROVABLY cannot match `filt` (a PRUNER_KINDS name),
    or None when it may match. Strictly conservative: anything the metadata
    cannot decide is None."""
    if not isinstance(filt, Function):
        return None
    if filt.name == "and":
        for a in filt.args:
            r = _prune_reason(a, cfg, meta)
            if r is not None:
                return r
        return None
    if filt.name == "or":
        first: Optional[str] = None
        for a in filt.args:
            r = _prune_reason(a, cfg, meta)
            if r is None:
                return None      # one satisfiable branch keeps the segment
            if first is None:
                first = r
        return first
    # partition pruning: eq on the partition column
    if (filt.name == "eq" and cfg.partition and meta.partition_id is not None
            and isinstance(filt.args[0], Identifier)
            and filt.args[0].name == cfg.partition.column
            and isinstance(filt.args[1], Literal)):
        pid = partition_for_value(filt.args[1].value, cfg.partition.function,
                                  cfg.partition.num_partitions)
        if pid != meta.partition_id:
            return "partition"
        return None
    # time pruning: range on the time column vs [start_time, end_time]
    if (cfg.time_column and meta.start_time_ms is not None
            and meta.end_time_ms is not None
            and isinstance(filt.args[0], Identifier)
            and filt.args[0].name == cfg.time_column
            and all(isinstance(a, Literal) for a in filt.args[1:])):
        vals = [a.value for a in filt.args[1:]]
        lo, hi = meta.start_time_ms, meta.end_time_ms
        if filt.name == "between" and (vals[1] < lo or vals[0] > hi):
            return "time"
        if filt.name == "eq" and not lo <= vals[0] <= hi:
            return "time"
        if filt.name in ("gt", "gte") and not vals[0] <= hi:
            return "time"
        if filt.name in ("lt", "lte") and not vals[0] >= lo:
            return "time"
        return None
    # range + bloom pruning from the commit-time per-column stats
    col_stats = (meta.custom or {}).get(COLUMN_STATS_KEY)
    if (col_stats and filt.args and isinstance(filt.args[0], Identifier)
            and all(isinstance(a, Literal) for a in filt.args[1:])):
        cs = col_stats.get(filt.args[0].name)
        if not isinstance(cs, dict):
            return None
        vals = [a.value for a in filt.args[1:]]
        if ("min" in cs and "max" in cs and vals
                and _out_of_range(filt.name, vals, cs["min"], cs["max"])):
            return "range"
        if filt.name in ("eq", "in") and cs.get("bloom"):
            if not any(bloom_hex_might_contain(cs["bloom"], v) for v in vals):
                return "bloom"
    return None
