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
stages its chunks on the card) through `pinot_tpu_torch.ingest`.
Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from .query.executor import ServerQueryExecutor, execute_query
from .segment import load_segment, segments_from_columns

__all__ = ["ServerQueryExecutor", "execute_query", "load_segment", "segments_from_columns"]
