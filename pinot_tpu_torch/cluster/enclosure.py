"""In-process cluster: a catalog, a controller, N servers and a broker.

A trimmed copy of `pinot_tpu/cluster/enclosure.py` (the analog of the
reference's single-JVM `ClusterTest` harness and its quickstart): one object
wires the roles, with helpers to create a table, ingest column batches as
segments, create a realtime table on a `MemoryStream` topic
(`create_realtime_table`; the servers report to the controller's LLC segment
manager), drive its consumers one pump and one completion round at a time
(`pump_realtime`, deterministic; `start_loop()` on a server's
`realtime_manager(table)` runs a background loop instead) and query through
the broker. A hybrid table is an OFFLINE and a REALTIME table of one name,
which the broker splits at the time boundary. `run_minion_round` raises NotImplementedError: the minion
waits (ROADMAP.md queue 1).

`device` is every server's device and the broker's (CUDA unless the caller
passes "cpu"; without a card the cluster raises RuntimeError). The servers
run the per-segment executor, as the JAX package's `QuickCluster` does (a
server on the serving pipeline is a `ServerNode` with `device_pipeline=`,
registered on the broker). A join or an IN-subquery takes the broker's
funnel path (its servers are in-process handles, without HTTP endpoints):
the leaf scans scatter to the servers and every partition joins on the
broker's device. The controller's ingestion check polls each server's
`ingestion_snapshot`, its memory check each server's `memory_snapshot` (the
servers share the process's memory ledger).
`shutdown` stops the servers.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional

from ..ingest.stream import MemoryStream
from ..query.result import ResultTable
from ..schema import Schema
from ..segment.writer import SegmentBuilder, SegmentGeneratorConfig
from ..table import TableConfig
from .broker import Broker
from .catalog import Catalog
from .controller import Controller
from .deepstore import LocalDeepStore
from .server import ServerNode


class QuickCluster:
    def __init__(self, num_servers: int = 2, work_dir: Optional[str] = None, device=None):
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_cluster_")
        self.catalog = Catalog()
        self.deepstore = LocalDeepStore(os.path.join(self.work_dir, "deepstore"))
        self.controller = Controller("controller_0", self.catalog, self.deepstore,
                                     os.path.join(self.work_dir, "controller"))
        self.servers: List[ServerNode] = [
            ServerNode(f"server_{i}", self.catalog, self.deepstore,
                       os.path.join(self.work_dir, f"server_{i}"), device=device,
                       completion=self.controller.llc)
            for i in range(num_servers)]
        self.broker = Broker("broker_0", self.catalog, device=device)
        for s in self.servers:
            self.broker.register_server_handle(s.instance_id, s.execute_partial,
                                               explain_handle=s.explain_partial)
            # in process, the controller's checks read each server's rollups
            # (a server process's /debug/consuming and /debug/memory)
            self.controller.ingestion_pollers[s.instance_id] = s.ingestion_snapshot
            self.controller.memory_pollers[s.instance_id] = s.memory_snapshot
        self._seg_seq: Dict[str, int] = {}

    def create_table(self, schema: Schema, config: Optional[TableConfig] = None
                     ) -> TableConfig:
        config = config or TableConfig(schema.name)
        self.controller.add_schema(schema)
        self.controller.add_table(config)
        return config

    def ingest_columns(self, table_config: TableConfig, columns: Dict[str, object],
                       segment_name: Optional[str] = None) -> str:
        """Build one segment from columns and upload it (the batch shortcut)."""
        table = table_config.table_name_with_type
        schema = self.catalog.schemas[table_config.name]
        seq = self._seg_seq.get(table, 0)
        self._seg_seq[table] = seq + 1
        name = segment_name or f"{table_config.name}_{seq}"
        builder = SegmentBuilder(schema, SegmentGeneratorConfig.from_indexing(
            table_config.indexing))
        seg_dir = builder.build(columns, os.path.join(self.work_dir, "build"), name)
        self.controller.upload_segment(table, seg_dir)
        return name

    def create_realtime_table(self, schema: Schema, config: TableConfig,
                              num_partitions: int) -> List[str]:
        """A REALTIME table on the `MemoryStream` topic its stream config
        names (made with `num_partitions` partitions unless it exists);
        returns the first CONSUMING segments."""
        self.controller.add_schema(schema)
        MemoryStream.create(config.stream.topic, num_partitions)
        return self.controller.add_realtime_table(config, num_partitions)

    def pump_realtime(self, table_name_with_type: str) -> int:
        """Each server in turn pumps every consumer of the table once and runs
        one completion round; returns the rows indexed."""
        moved = 0
        for s in self.servers:
            mgr = s.realtime_manager(table_name_with_type)
            if mgr is not None:
                moved += mgr.pump_all()
                mgr.complete_all()
        return moved

    def run_minion_round(self):
        raise NotImplementedError("the minion (minion/tasks.py) waits: ROADMAP.md queue 1")

    def query(self, sql: str) -> ResultTable:
        return self.broker.handle_query(sql)

    def shutdown(self) -> None:
        for s in self.servers:
            s.shutdown()

    # -- chaos helpers (the reference's ChaosMonkeyIntegrationTest) --------
    def kill_server(self, instance_id: str) -> None:
        self.catalog.set_instance_alive(instance_id, False)
        self.broker.routing.mark_server_unhealthy(instance_id)

    def revive_server(self, instance_id: str) -> None:
        self.catalog.set_instance_alive(instance_id, True)
        self.broker.routing.mark_server_healthy(instance_id)
