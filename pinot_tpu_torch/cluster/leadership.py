"""The lead controller's lease and a standby's takeover, over the deep store.

A copy of `pinot_tpu/cluster/leadership.py` (the analog of the reference's
`LeadControllerManager` and the Helix leader resource): one controller acts
on the cluster at a time, and a standby takes over once the leader stops
renewing its claim.

The shared durable medium is the deep store, so leadership is a lease blob,
`_leadership/lease.json` (holder, epoch, deadline), that the leader renews
and standbys poll. A store offers no compare-and-swap, so a contender writes
its claim, waits a settle window and reads the blob back: if its claim is
still there, it leads under a new epoch. Every acquisition of a free or
expired lease raises the epoch, a restarted process under its old instance
id included, so a stale incarnation finds a higher epoch and steps down
(fencing).

The catalog rides the same medium: `ControllerFailover` checkpoints
`Catalog.snapshot()` to `_leadership/catalog.json` on every catalog event,
reading the lease before each upload, so that a deposed leader cannot
overwrite its successor's checkpoint; a standby restores the checkpoint when
it takes over. The blobs are the JAX package's, so a leader of either
package hands over to a standby of the other.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional

from ..utils.events import emit_event

LEASE_URI = "_leadership/lease.json"
CATALOG_URI = "_leadership/catalog.json"


class LeaderElection:
    """One contender's view of the lease."""

    def __init__(self, deepstore, instance_id: str, lease_ttl_s: float = 10.0,
                 settle_s: float = 0.05):
        self.deepstore = deepstore
        self.instance_id = instance_id
        self.lease_ttl_s = lease_ttl_s
        self.settle_s = settle_s
        self.epoch = 0
        self.is_leader = False

    def _read_lease(self) -> Optional[dict]:
        try:
            return json.loads(self.deepstore.get_bytes(LEASE_URI).decode())
        except Exception:   # no lease yet, or one being replaced: free
            return None

    def _write_lease(self, lease: dict) -> None:
        self.deepstore.put_bytes(json.dumps(lease).encode(), LEASE_URI)

    def _holds(self, cur: Optional[dict]) -> bool:
        """Whether this incarnation holds the lease `cur`."""
        return bool(self.is_leader and cur is not None and cur["holder"] == self.instance_id
                    and cur["epoch"] == self.epoch)

    def try_acquire(self) -> bool:
        """Claim the lease where it is free or expired, checked after the
        write; renew it where this incarnation holds it."""
        now = time.time()
        cur = self._read_lease()
        if cur is not None and cur["deadline"] > now and not self._holds(cur):
            # a live lease (perhaps an older incarnation of this id): wait
            self.is_leader = False
            return False
        if self._holds(cur):
            return self.renew()
        epoch = (cur["epoch"] if cur else 0) + 1
        self._write_lease({"holder": self.instance_id, "epoch": epoch,
                           "deadline": now + self.lease_ttl_s})
        if self.settle_s:
            time.sleep(self.settle_s)   # a racing contender's write lands
        final = self._read_lease()
        won = bool(final and final["holder"] == self.instance_id and final["epoch"] == epoch)
        if won:
            self.epoch = epoch
        self.is_leader = won
        return won

    def renew(self) -> bool:
        """Extend the lease; False, stepping down, once deposed."""
        if not self._holds(self._read_lease()):
            self.is_leader = False
            return False
        self._write_lease({"holder": self.instance_id, "epoch": self.epoch,
                           "deadline": time.time() + self.lease_ttl_s})
        return True

    def release(self) -> None:
        """Step down: expire the lease, only where this incarnation still
        holds it (a deposed leader must not expire its successor's)."""
        if self._holds(self._read_lease()):
            self._write_lease({"holder": self.instance_id, "epoch": self.epoch,
                               "deadline": 0.0})
        self.is_leader = False


class ControllerFailover:
    """A controller bound to the election: as leader it checkpoints the
    catalog on every catalog event; as standby `try_takeover` restores the
    checkpoint and leads once the lease is free. `on_gain` / `on_loss` run
    when it gains or loses the lead (the reference starts and stops the
    controller's periodic tasks there)."""

    CHECKPOINT_READ_RETRIES = 3

    def __init__(self, controller, election: LeaderElection,
                 on_gain: Optional[Callable[[], None]] = None,
                 on_loss: Optional[Callable[[], None]] = None):
        self.controller = controller
        self.election = election
        self.on_gain = on_gain
        self.on_loss = on_loss
        self._subscribed = False
        # snapshots are numbered under the catalog's lock and uploaded one at
        # a time: an older snapshot that reaches the upload after a newer one
        # is skipped (the upload's lock is never held while taking the
        # catalog's, which an event's thread may hold)
        self._ckpt_lock = threading.Lock()
        self._taken = 0
        self._written = 0
        self.checkpoints = 0          # checkpoints written
        self.checkpoint_bytes = 0     # their bytes
        self.checkpoint_s = 0.0       # the seconds they took

    def lead(self) -> bool:
        """Take the lease where it is free and start checkpointing."""
        if not self.election.try_acquire():
            return False
        self._on_become_leader()
        return True

    def _on_become_leader(self) -> None:
        emit_event("leader.elected", node=self.election.instance_id, epoch=self.election.epoch)
        self._checkpoint()
        if not self._subscribed:   # a leader again: one subscription
            self.controller.catalog.subscribe(self._on_catalog_event)
            self._subscribed = True
        if self.on_gain:
            self.on_gain()

    def _on_catalog_event(self, event: str, key: str) -> None:
        if self.election.is_leader:
            self._checkpoint()

    def _checkpoint(self) -> None:
        t0 = time.perf_counter()
        catalog = self.controller.catalog
        with catalog._lock:
            blob = catalog.snapshot().encode()
            self._taken += 1
            seq = self._taken
        with self._ckpt_lock:
            if seq < self._written:
                return
            # the lease read again just before the upload: a deposed leader's
            # late catalog events must not overwrite the successor's checkpoint
            if not self.election._holds(self.election._read_lease()):
                self.election.is_leader = False
                return
            self.election.deepstore.put_bytes(blob, CATALOG_URI)
            self._written = seq
            self.checkpoints += 1
            self.checkpoint_bytes += len(blob)
            self.checkpoint_s += time.perf_counter() - t0

    def heartbeat(self) -> bool:
        """Renew the lease; once deposed, journal `leader.lost` and stop."""
        ok = self.election.renew()
        if not ok:
            emit_event("leader.lost", node=self.election.instance_id)
            if self.on_loss:
                self.on_loss()
        return ok

    def try_takeover(self) -> bool:
        """A standby's poll: where the lease is free or expired, restore the
        last checkpoint and lead. A checkpoint that exists but cannot be read
        gives the lease back: leading with an empty catalog would overwrite
        the good checkpoint."""
        if self.election.is_leader:
            return True
        if not self.election.try_acquire():
            return False
        if self.election.deepstore.exists(CATALOG_URI):
            restored = False
            for _ in range(self.CHECKPOINT_READ_RETRIES):
                try:
                    blob = self.election.deepstore.get_bytes(CATALOG_URI)
                    self.controller.catalog.restore(blob.decode())
                    restored = True
                    break
                except Exception:   # a checkpoint being replaced: read it again
                    time.sleep(0.05)
            if not restored:
                self.election.release()
                return False
        self._on_become_leader()
        return True
