"""The port's lead-controller lease and failover
(`pinot_tpu_torch/cluster/leadership.py`) against the JAX package's.

Each of the reference's eight scenarios (`tests/test_leadership.py`: one
winner, takeover after expiry, a voluntary release, the catalog restored by
a standby, a stale release that must not expire the successor's lease, a
restarted instance fenced by the epoch, a deposed leader's late checkpoint
refused, a live leader kept) is driven the same way on both packages, and
the outcomes are equal. Then the blobs cross: a JAX-package leader
checkpoints and a port standby takes its lease and restores its catalog,
and the reverse; the leadership events are journaled.
"""

import time
from types import SimpleNamespace

import pytest

import pinot_tpu.cluster.catalog as jcat
import pinot_tpu.cluster.controller as jctl
import pinot_tpu.cluster.deepstore as jds
import pinot_tpu.cluster.leadership as jlead
import pinot_tpu.schema as jschema
import pinot_tpu.table as jtable
import pinot_tpu_torch.cluster.catalog as tcat
import pinot_tpu_torch.cluster.controller as tctl
import pinot_tpu_torch.cluster.deepstore as tds
import pinot_tpu_torch.cluster.leadership as tlead
import pinot_tpu_torch.schema as tschema
import pinot_tpu_torch.table as ttable
from pinot_tpu_torch.utils.events import get_journal


def _pkg(cat, ctl, ds, lead, schema, table):
    return SimpleNamespace(Catalog=cat.Catalog, Controller=ctl.Controller,
                           LocalDeepStore=ds.LocalDeepStore,
                           LeaderElection=lead.LeaderElection,
                           ControllerFailover=lead.ControllerFailover,
                           Schema=schema.Schema, dimension=schema.dimension,
                           metric=schema.metric, TableConfig=table.TableConfig)


PORT = _pkg(tcat, tctl, tds, tlead, tschema, ttable)
JAX = _pkg(jcat, jctl, jds, jlead, jschema, jtable)


def both(tmp_path, scenario):
    """The scenario on each package, each over its own deep store: equal outcomes."""
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        root = tmp_path / name
        out[name] = scenario(p, p.LocalDeepStore(str(root / "deepstore")), root)
    assert out["port"] == out["jax"]
    return out["port"]


def _el(p, ds, iid, ttl, settle=0.0):
    return p.LeaderElection(ds, iid, lease_ttl_s=ttl, settle_s=settle)


def _fo(p, ds, root, iid, ttl):
    ctl = p.Controller(iid, p.Catalog(), ds, str(root / iid))
    return ctl, p.ControllerFailover(ctl, _el(p, ds, iid, ttl))


def test_single_winner(tmp_path):
    def run(p, ds, root):
        a, b = _el(p, ds, "ctrl_a", 5.0), _el(p, ds, "ctrl_b", 5.0)
        return (a.try_acquire(), b.try_acquire(), a.renew(), a.is_leader, b.is_leader, a.epoch)
    assert both(tmp_path, run) == (True, False, True, True, False, 1)


def test_takeover_after_expiry(tmp_path):
    def run(p, ds, root):
        a, b = _el(p, ds, "ctrl_a", 0.05), _el(p, ds, "ctrl_b", 5.0)
        got = [a.try_acquire()]
        time.sleep(0.1)   # the leader stops renewing
        got += [b.try_acquire(), b.epoch - a.epoch, a.renew(), a.is_leader]
        return got
    assert both(tmp_path, run) == [True, True, 1, False, False]


def test_voluntary_release(tmp_path):
    def run(p, ds, root):
        a, b = _el(p, ds, "ctrl_a", 60.0), _el(p, ds, "ctrl_b", 5.0)
        got = [a.try_acquire()]
        a.release()
        return got + [a.is_leader, b.try_acquire(), b.epoch]
    assert both(tmp_path, run) == [True, False, True, 2]


def test_failover_restores_catalog(tmp_path):
    def run(p, ds, root):
        leader, fo_a = _fo(p, ds, root, "ctrl_a", 0.05)
        got = [fo_a.lead()]
        leader.add_schema(p.Schema("trips", [p.dimension("city"), p.metric("fare")]))
        leader.add_table(p.TableConfig("trips", replication=2))
        got.append(fo_a.heartbeat())
        time.sleep(0.1)
        standby, fo_b = _fo(p, ds, root, "ctrl_b", 5.0)
        got += [fo_b.try_takeover(), sorted(standby.catalog.table_configs),
                standby.catalog.table_configs["trips_OFFLINE"].replication,
                standby.catalog.schemas["trips"].has_column("fare"),
                fo_a.heartbeat(), fo_a.election.is_leader]
        # the new leader checkpoints too: its writes survive another failover
        standby.add_schema(p.Schema("orders", [p.dimension("id")]))
        standby.add_table(p.TableConfig("orders"))
        third, fo_c = _fo(p, ds, root, "ctrl_c", 5.0)
        fo_b.election.release()
        got += [fo_c.try_takeover(), sorted(third.catalog.table_configs)]
        return got
    assert both(tmp_path, run) == [True, True, True, ["trips_OFFLINE"], 2, True, False, False,
                                   True, ["orders_OFFLINE", "trips_OFFLINE"]]


def test_stale_release_does_not_clobber_successor(tmp_path):
    def run(p, ds, root):
        a, b = _el(p, ds, "ctrl_a", 0.05), _el(p, ds, "ctrl_b", 60.0)
        got = [a.try_acquire()]
        time.sleep(0.1)
        got.append(b.try_acquire())
        a.release()   # a still believes it leads
        return got + [b.renew()]
    assert both(tmp_path, run) == [True, True, True]


def test_restarted_same_id_bumps_epoch(tmp_path):
    def run(p, ds, root):
        original = _el(p, ds, "ctrl_a", 0.05)
        got = [original.try_acquire()]
        time.sleep(0.1)
        replacement = _el(p, ds, "ctrl_a", 60.0)
        return got + [replacement.try_acquire(), replacement.epoch - original.epoch,
                      original.renew()]
    assert both(tmp_path, run) == [True, True, 1, False]


def test_deposed_leader_cannot_overwrite_checkpoint(tmp_path):
    def run(p, ds, root):
        a, fo_a = _fo(p, ds, root, "ctrl_a", 0.05)
        got = [fo_a.lead()]
        a.add_schema(p.Schema("t1", [p.dimension("x")]))
        time.sleep(0.1)
        b, fo_b = _fo(p, ds, root, "ctrl_b", 60.0)
        got.append(fo_b.try_takeover())
        b.add_schema(p.Schema("t2", [p.dimension("y")]))
        a.add_schema(p.Schema("stale", [p.dimension("z")]))   # a late event of the deposed
        c, fo_c = _fo(p, ds, root, "ctrl_c", 60.0)
        fo_b.election.release()
        got += [fo_c.try_takeover(), sorted(c.catalog.schemas)]
        return got
    assert both(tmp_path, run) == [True, True, True, ["t1", "t2"]]


def test_standby_does_not_take_over_a_live_leader(tmp_path):
    def run(p, ds, root):
        _, fo_a = _fo(p, ds, root, "ctrl_a", 60.0)
        standby, fo_b = _fo(p, ds, root, "ctrl_b", 5.0)
        return [fo_a.lead(), fo_b.try_takeover(), fo_a.heartbeat(),
                sorted(standby.catalog.schemas)]
    assert both(tmp_path, run) == [True, False, True, []]


def test_an_unreadable_checkpoint_aborts_the_takeover(tmp_path):
    ds = tds.LocalDeepStore(str(tmp_path / "deepstore"))
    _, fo_a = _fo(PORT, ds, tmp_path, "ctrl_a", 0.05)
    assert fo_a.lead()
    ds.put_bytes(b"{not json", tlead.CATALOG_URI)
    time.sleep(0.1)
    standby, fo_b = _fo(PORT, ds, tmp_path, "ctrl_b", 5.0)
    assert not fo_b.try_takeover() and not fo_b.election.is_leader
    assert ds.get_bytes(tlead.CATALOG_URI) == b"{not json"   # left as it was
    lease = fo_b.election._read_lease()
    assert lease["holder"] == "ctrl_b" and lease["deadline"] == 0.0   # given back


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_leases_and_checkpoints_cross_packages(tmp_path, direction):
    """One deep store: the first package's leader checkpoints a schema, a
    realtime-free table and a property; the other package's standby takes
    over its expired lease under the next epoch and restores that catalog."""
    first, second = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    ds_first = first.LocalDeepStore(str(tmp_path / "deepstore"))
    ds_second = second.LocalDeepStore(str(tmp_path / "deepstore"))
    leader, fo_a = _fo(first, ds_first, tmp_path, "ctrl_a", 0.05)
    assert fo_a.lead()
    leader.add_schema(first.Schema("trips", [first.dimension("city"), first.metric("fare")]))
    leader.add_table(first.TableConfig("trips", replication=2))
    leader.catalog.put_property("clusterConfig/controller.ingestion.offset.lag.threshold", "7")
    time.sleep(0.1)
    standby, fo_b = _fo(second, ds_second, tmp_path, "ctrl_b", 5.0)
    assert fo_b.try_takeover()
    assert fo_b.election.epoch == fo_a.election.epoch + 1
    assert sorted(standby.catalog.table_configs) == ["trips_OFFLINE"]
    assert standby.catalog.table_configs["trips_OFFLINE"].replication == 2
    assert standby.catalog.get_property(
        "clusterConfig/controller.ingestion.offset.lag.threshold") == "7"
    assert not fo_a.heartbeat()


def test_leadership_events_are_journaled(tmp_path):
    ds = tds.LocalDeepStore(str(tmp_path / "deepstore"))
    since = get_journal().events_since(0)["cursor"]
    _, fo_a = _fo(PORT, ds, tmp_path, "ctrl_a", 0.05)
    assert fo_a.lead()
    time.sleep(0.1)
    _, fo_b = _fo(PORT, ds, tmp_path, "ctrl_b", 5.0)
    assert fo_b.try_takeover() and not fo_a.heartbeat()
    kinds = [(e["kind"], e["node"]) for e in get_journal().events_since(since)["events"]
             if e["kind"].startswith("leader.")]
    assert kinds == [("leader.elected", "ctrl_a"), ("leader.elected", "ctrl_b"),
                     ("leader.lost", "ctrl_a")]
    assert fo_b.checkpoints == 1 and fo_b.checkpoint_bytes > 0
