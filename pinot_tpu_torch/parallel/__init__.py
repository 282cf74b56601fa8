"""Stacked segment-set execution on one card.

Counterpart of `pinot_tpu/parallel`: a segment set stacks into `[S_pad, rows]`
device tensors and runs one pass per query over the whole set
(`MeshQueryExecutor`); an unaligned set, or one with consuming views, through
the merged-dictionary view (`merged.py`). The JAX package's mesh of devices
becomes the executor's one `torch.device`.
"""

from .combine import MeshQueryExecutor, aligned_dictionaries

__all__ = ["MeshQueryExecutor", "aligned_dictionaries"]
