"""pinot_tpu_torch: the PyTorch/CUDA counterpart of `pinot_tpu`.

Answers aggregation SQL over immutable offline segments on a CUDA card, with
the scan hot loop as a hand-written CUDA kernel (`csrc/masked_sums.cu`) and
the expression library of the JAX planner's device functions in torch; the
shapes that planner sends to the host (expression group keys, string and
JSON functions, consuming segments) run on the host in numpy, as there. The
package imports nothing of `pinot_tpu` or JAX; it reads and writes the same
segment directories as `pinot_tpu`.

    from pinot_tpu_torch import execute_query, load_segment
    result = execute_query(segments, "SELECT COUNT(*) FROM t WHERE x < 5")

Joins and IN-subqueries run through `pinot_tpu_torch.multistage.execute_multistage`;
realtime ingestion (a stream partition consumed into a consuming segment that
stages its chunks on the card) through `pinot_tpu_torch.ingest`. The cluster
roles (catalog, controller, servers, broker) run in one process through
`pinot_tpu_torch.QuickCluster` (`cluster/`):

    cluster = QuickCluster(num_servers=2)
    config = cluster.create_table(schema, TableConfig("t", replication=2))
    cluster.ingest_columns(config, columns)
    cluster.query("SELECT COUNT(*) FROM t")

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from .query.executor import ServerQueryExecutor, execute_query
from .segment import load_segment, segments_from_columns

__all__ = ["QuickCluster", "ServerQueryExecutor", "execute_query", "load_segment",
           "segments_from_columns"]


def __getattr__(name):
    # the cluster roles load on first use, as `pinot_tpu.QuickCluster` does
    if name == "QuickCluster":
        from .cluster import QuickCluster
        return QuickCluster
    raise AttributeError(f"module 'pinot_tpu_torch' has no attribute {name!r}")
