"""The peer download scheme on the port (`pinot_tpu_torch/cluster/peers.py`,
the peer-scheme commit and healing of `cluster/completion.py`).

* The deep-store outage of `tests/test_peer_download.py` on the port's
  `ProcessCluster(device="cpu")`: a commit whose upload runs out of retries
  commits under `peer://`, both replicas serve it, a replica restarted with
  its local copies gone loads the segments from its peer through
  `/segmentData` (the deep-store segment too, once its download's retries run
  out), and the validation round heals the segment once the deep store is
  back.
* The carry-over: a snapshot of the JAX package's catalog holding a consuming
  segment and a `peer://` segment (its deep store down at the commit) restores
  into the port's catalog; the port's server serves the committed copy and
  consumes from the consuming segment's start offset, and the port's
  validation round heals the segment instead of raising.
* `download_segment_tar`: the deep store first, a peer after its retries,
  the quarantine.
"""

import json
import os
import shutil

import pytest

from pinot_tpu_torch.cluster import peers
from pinot_tpu_torch.cluster.process import ProcessCluster
from pinot_tpu_torch.ingest.kafkalite import LogBrokerClient, LogBrokerServer
from pinot_tpu_torch.schema import DataType, Schema, date_time, dimension, metric
from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType

from conftest import wait_until

TS = 1_700_000_000_000


def _break_deepstore(work_dir: str) -> None:
    """Every deep-store read and write fails: the root directory becomes a
    regular file."""
    root = os.path.join(work_dir, "deepstore")
    os.rename(root, root + ".parked")
    with open(root, "w") as f:
        f.write("outage")


def _restore_deepstore(work_dir: str) -> None:
    root = os.path.join(work_dir, "deepstore")
    os.remove(root)
    os.rename(root + ".parked", root)


def test_commit_and_convergence_survive_a_deepstore_outage(tmp_path):
    schema = Schema("pv", [dimension("u", DataType.STRING), metric("v", DataType.LONG),
                           date_time("ts", DataType.LONG)])
    srv = LogBrokerServer()
    try:
        client = LogBrokerClient(srv.bootstrap)
        client.create_topic("pv_t", 1)

        def produce(lo, hi):
            for i in range(lo, hi):
                client.produce("pv_t", json.dumps({"u": f"u{i % 3}", "v": i, "ts": TS + i}))
        with ProcessCluster(num_servers=2, device="cpu", work_dir=str(tmp_path),
                            startup_timeout_s=90.0) as cluster:
            cluster.controller.add_schema(schema)
            cluster.controller.set_cluster_config("deepstore.retry.backoff.ms", 5)
            cfg = TableConfig("pv", table_type=TableType.REALTIME, time_column="ts",
                              replication=2, stream=StreamConfig(
                                  stream_type="kafkalite", topic="pv_t",
                                  properties={"bootstrap": srv.bootstrap},
                                  flush_threshold_rows=30))
            table = cfg.table_name_with_type
            cluster.controller.add_table(cfg, num_partitions=1)

            def count():
                rows = cluster.query("SELECT COUNT(*) FROM pv")["resultTable"]["rows"]
                return rows[0][0] if rows else 0

            def done():
                metas = cluster.controller.segments_meta(table)["segments"]
                return {n: m for n, m in metas.items() if m["status"] == "DONE"}

            def converged():
                return cluster.controller.table_status(table)["converged"]

            # a first commit with the deep store up, then the outage
            produce(0, 30)
            assert wait_until(lambda: len(done()) == 1 and count() == 30, timeout=60)
            first = next(iter(done()))
            assert not done()[first]["download_path"].startswith("peer://")
            _break_deepstore(str(tmp_path))
            try:
                produce(30, 70)
                assert wait_until(lambda: len(done()) == 2, timeout=90), done()
                peer_segs = [n for n, m in done().items()
                             if m["download_path"].startswith("peer://")]
                assert len(peer_segs) == 1 and done()[peer_segs[0]]["download_path"] == \
                    f"peer://{table}/{peer_segs[0]}"
                assert wait_until(lambda: count() == 70, timeout=60)
                assert wait_until(converged, timeout=60)
                # a replica that must download (its local copies gone) loads
                # both committed segments from its peer, the deep store down
                shutil.rmtree(os.path.join(str(tmp_path), "server_1", table), ignore_errors=True)
                cluster.restart_server("server_1")
                assert wait_until(converged, timeout=90), \
                    cluster.controller.table_status(table)
                assert wait_until(lambda: count() == 70, timeout=60)
                for seg in (first, peer_segs[0]):
                    assert os.path.isdir(os.path.join(str(tmp_path), "server_1", table, seg))
            finally:
                _restore_deepstore(str(tmp_path))
            healed = cluster.controller.validate()
            assert healed["healed"] == peer_segs, healed
            path = cluster.controller.segments_meta(table)["segments"][peer_segs[0]][
                "download_path"]
            assert path == f"{table}/{peer_segs[0]}.tar.gz"
            assert os.path.exists(os.path.join(str(tmp_path), "deepstore", path))
            assert cluster.controller.validate()["healed"] == []
            # every row once, whichever replica of the consuming segment answers

            def sums():
                rows = cluster.query("SELECT u, SUM(v) FROM pv GROUP BY u ORDER BY u LIMIT 5")[
                    "resultTable"]["rows"]
                return {r[0]: r[1] for r in rows}
            want = {f"u{k}": sum(range(k, 70, 3)) for k in range(3)}
            assert wait_until(lambda: sums() == want, timeout=30), sums()
    finally:
        srv.stop()


def test_a_jax_catalog_with_peer_and_consuming_segments_carries_over(tmp_path):
    """The JAX package's in-process cluster commits a segment under peer://
    (its deep store down) and keeps its successor consuming; its catalog's
    snapshot restores into the port's, where a server with the committed
    copy serves it over /segmentData, the consuming segment gets its consumer
    at the committed end offset, and the validation round uploads the segment
    and points it at the deep store."""
    from pinot_tpu.cluster import QuickCluster as JaxQuickCluster
    from pinot_tpu.ingest.stream import MemoryStream as JaxMemoryStream
    from pinot_tpu.schema import Schema as JSchema
    from pinot_tpu.table import TableConfig as JaxTableConfig
    from pinot_tpu_torch.cluster import Catalog, Controller, ServerNode
    from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
    from pinot_tpu_torch.cluster.services import ServerService

    schema = Schema("ev", [dimension("u", DataType.STRING), metric("v", DataType.LONG),
                           date_time("ts", DataType.LONG)])
    cfg = TableConfig("ev", table_type=TableType.REALTIME, time_column="ts", stream=StreamConfig(
        topic="ev_carry", decoder="dict", flush_threshold_rows=4))
    table = cfg.table_name_with_type
    jax = JaxQuickCluster(num_servers=1, work_dir=str(tmp_path / "jax"))
    jax.catalog.put_property("clusterConfig/deepstore.retry.max", 1)

    def failing_upload(local_path, uri):
        raise OSError("deep store down")
    jax.deepstore.upload = failing_upload
    JaxMemoryStream.reset_all()
    jax.create_realtime_table(JSchema.from_json(schema.to_json()),
                              JaxTableConfig.from_json(cfg.to_json()), 1)
    for i in range(6):
        JaxMemoryStream.get("ev_carry").produce({"u": "a", "v": i, "ts": TS + i}, partition=0)
    for _ in range(3):
        jax.pump_realtime(table)
    jmetas = jax.catalog.segments[table]
    peer_seg = next(n for n, m in jmetas.items() if (m.download_path or "").startswith("peer://"))
    consuming = next(n for n, m in jmetas.items() if m.status == "IN_PROGRESS")

    catalog = Catalog()
    catalog.restore(jax.catalog.snapshot())
    metas = catalog.segments[table]
    assert metas[peer_seg].download_path == f"peer://{table}/{peer_seg}"
    assert metas[consuming].start_offset == jmetas[peer_seg].end_offset
    assert catalog.table_configs[table].stream.to_json() == \
        jax.catalog.table_configs[table].stream.to_json()
    store = LocalDeepStore(str(tmp_path / "port_deepstore"))
    controller = Controller("controller_0", catalog, store, str(tmp_path / "controller"))
    # the JAX server's committed copy, where the port's server keeps its segments
    jax_dir = jax.servers[0].local_segment_dir(table, peer_seg)
    data_dir = str(tmp_path / "port_server")
    shutil.copytree(jax_dir, os.path.join(data_dir, table, peer_seg))
    server = ServerNode(jax.servers[0].instance_id, catalog, store, data_dir, device="cpu",
                        completion=controller.llc)
    service = ServerService(server)
    try:
        assert server.local_segment_dir(table, peer_seg) is not None
        rt = server.realtime_manager(table)
        assert rt.consumers[consuming].offset == int(jmetas[peer_seg].end_offset)
        out = controller.llc.validate()
        assert out["healed"] == [peer_seg], out
        assert catalog.segments[table][peer_seg].download_path == f"{table}/{peer_seg}.tar.gz"
        assert store.exists(f"{table}/{peer_seg}.tar.gz")
        assert controller.llc.validate()["healed"] == []
    finally:
        server.shutdown()
        service.stop()


def test_download_falls_back_to_a_peer_and_quarantines(tmp_path, monkeypatch):
    """The deep store first with its retries, then a peer; a download whose
    retries ran out is quarantined, so the next one goes to a peer at once;
    with no peer it raises ConnectionError."""
    from pinot_tpu_torch.cluster import Catalog

    class Store:
        calls = 0

        def download(self, uri, dest):
            Store.calls += 1
            raise OSError("down")
    fetched = []
    monkeypatch.setattr(peers, "fetch_from_peer",
                        lambda catalog, table, seg, dest, exclude_instance=None:
                        fetched.append((table, seg, exclude_instance)) or "peer")
    catalog = Catalog()
    catalog.put_property("clusterConfig/deepstore.retry.max", 2)
    catalog.put_property("clusterConfig/deepstore.retry.backoff.ms", 0)
    peers.clear_download_quarantine()
    dest = str(tmp_path / "x.tar.gz")
    peers.download_segment_tar(Store(), catalog, "t_REALTIME", "s1", dest, "t/s1.tar.gz",
                               exclude_instance="me")
    assert Store.calls == 2 and fetched == [("t_REALTIME", "s1", "me")]
    peers.download_segment_tar(Store(), catalog, "t_REALTIME", "s1", dest, "t/s1.tar.gz")
    assert Store.calls == 2 and len(fetched) == 2   # quarantined: straight to a peer
    peers.download_segment_tar(Store(), catalog, "t_REALTIME", "s2", dest, "peer://t/s2")
    assert Store.calls == 2 and fetched[-1][1] == "s2"
    peers.clear_download_quarantine()
    monkeypatch.undo()
    with pytest.raises(ConnectionError, match="no peer"):
        peers.fetch_from_peer(catalog, "t_REALTIME", "s1", dest)
