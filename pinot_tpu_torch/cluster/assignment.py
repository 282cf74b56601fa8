"""Segment-to-server assignment strategies.

A copy of `pinot_tpu/cluster/assignment.py`.

Analog of the reference's assignment package
(`pinot-controller/.../helix/core/assignment/segment/`: `OfflineSegmentAssignment`,
`SegmentAssignmentUtils`): choose `replication` servers per segment, balancing load.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence


def balanced_assign(segment: str, servers: Sequence[str], replication: int,
                    current_counts: Dict[str, int]) -> List[str]:
    """Pick the `replication` least-loaded servers (reference: balanced strategy with
    instance-level segment counts)."""
    if not servers:
        raise RuntimeError("no live servers to assign to")
    replication = min(replication, len(servers))
    ranked = sorted(servers, key=lambda s: (current_counts.get(s, 0), s))
    return ranked[:replication]


def compute_counts(ideal_state: Dict[str, Dict[str, str]]) -> Dict[str, int]:
    counts: Dict[str, int] = defaultdict(int)
    for assignment in ideal_state.values():
        for server in assignment:
            counts[server] += 1
    return counts


def replica_group_assign(segment: str, servers: Sequence[str], replication: int,
                         partition_id: int | None,
                         current_counts: Dict[str, int]) -> List[str]:
    """Replica-group assignment (reference: replica-group strategies): servers divide
    into `replication` groups; the segment gets one server from each group, chosen by
    partition id when present (so one partition lands on the same server per group —
    enabling partition-aware routing to hit a stable subset)."""
    if not servers:
        raise RuntimeError("no live servers to assign to")
    replication = min(replication, len(servers))
    ordered = sorted(servers)
    group_size = len(ordered) // replication
    if group_size == 0:
        return balanced_assign(segment, servers, replication, current_counts)
    chosen = []
    for g in range(replication):
        group = ordered[g * group_size:(g + 1) * group_size]
        if partition_id is not None:
            chosen.append(group[partition_id % len(group)])
        else:
            chosen.append(min(group, key=lambda s: (current_counts.get(s, 0), s)))
    return chosen


def rebalance_table(ideal_state: Dict[str, Dict[str, str]], servers: Sequence[str],
                    replication: int) -> Dict[str, Dict[str, str]]:
    """Compute a fresh balanced target assignment for every segment (reference:
    `TableRebalancer.java:114` computes target assignment; the EV-convergence loop that
    applies it incrementally lives in Controller.rebalance)."""
    counts: Dict[str, int] = defaultdict(int)
    target: Dict[str, Dict[str, str]] = {}
    for seg in sorted(ideal_state):
        state = next(iter(ideal_state[seg].values()), "ONLINE")
        chosen = balanced_assign(seg, servers, replication, counts)
        for s in chosen:
            counts[s] += 1
        target[seg] = {s: state for s in chosen}
    return target
