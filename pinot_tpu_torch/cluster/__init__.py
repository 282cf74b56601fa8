"""The cluster roles in one process: catalog, controller, servers, broker.

Counterpart of `pinot_tpu/cluster/`: the catalog (`catalog.py`: schemas,
table configs, segment metadata, the ideal state and the external view, with
watch callbacks in place of Helix messages), the controller
(`controller.py`: tables, uploads to the deep store, assignment, retention,
rebalance), the servers (`server.py`: they load their segments and answer
partials through the per-segment executor or the serving pipeline,
`device_server.py`), the broker (`broker.py`: routing and pruning,
scatter/gather with retries, reduce), the realtime lifecycle (`completion.py`:
the LLC segment manager and the segment completion protocol, with the
servers' `ingest/realtime.py` consumers) and `QuickCluster`, which wires
them in one process. Offline, realtime and hybrid tables, single-stage
queries, and joins, IN-subqueries and the distributed GROUP BY through the
broker (the mailbox shuffle of `multistage/shuffle.py` between server
processes, else the funnel path). The roles also run as OS processes joined
over HTTP (`process.py`, `ProcessCluster`, for offline tables): `services.py`
puts each role behind its endpoints, `remote.py` mirrors the catalog and
dispatches to servers, `wire.py` is the binary codec and `mux.py` the
multiplexed transport, over `http_service.py`. Device memory is a managed
tier: each server's tiering gate (`tiering.py`) admits segments to the card
against the memory ledger (`utils/memledger.py`), answers the others on the
host, loads COLD segments from the deep store, and the controller gives each
table a memory verdict. What waits (the minion among it) is listed in
ROADMAP.md.
"""

from .broker import Broker
from .catalog import Catalog, SegmentMeta
from .controller import Controller
from .device_server import DeviceQueryPipeline
from .enclosure import QuickCluster
from .server import ServerNode

__all__ = ["Broker", "Catalog", "Controller", "DeviceQueryPipeline", "QuickCluster",
           "SegmentMeta", "ServerNode"]
