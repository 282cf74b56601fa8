"""Multistage ("v2") query engine: joins and IN-subqueries.

Counterpart of `pinot_tpu/multistage/`: the planner splits a join query into
leaf scans, hash-join stages and a final reduce; the runtime scans each table
through the single-stage device filter, exchanges blocks through an
in-process mailbox (broadcast or hash-partitioned), joins each partition with
the device hash join (`engine/join_kernels.py`) and reduces. Across server
processes, `shuffle.py` is the data plane: the leaves partition on the
servers and stream into the stage workers' mailboxes over HTTP, and the
broker receives only the final stage's partials.

    from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
    result = execute_multistage(sql, make_segment_scan(tables), schemas.get)

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from .planner import plan_multistage
from .runtime import configure_device_join, execute_multistage, hash_join, make_segment_scan

__all__ = ["plan_multistage", "execute_multistage", "make_segment_scan", "hash_join",
           "configure_device_join"]
