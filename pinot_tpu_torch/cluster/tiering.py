"""Join admission: price a device join's working set against free device memory.

A subset of `pinot_tpu/cluster/tiering.py`: `predicted_join_bytes` as it is,
and `join_device_budget_bytes` with the reference's meaning (device capacity
less the 10% headroom, less what is resident) read from the card itself,
since the reference's memory ledger is not ported. An exploding join
(duplicate build keys fanning every probe row out) then runs on the host
(`joinServedHostTier`) instead of exhausting device memory.
"""

from __future__ import annotations

from typing import Optional

import torch

#: percent of capacity the admission gate keeps free
DEFAULT_TARGET_HEADROOM_PCT = 10.0


def predicted_join_bytes(build_rows: int, probe_rows: int, ncols: int,
                         dup_factor: float = 1.0) -> int:
    """Metadata-only sizing of a device join's working set: the staged key
    codes for both sides (at the JAX package's pow2 shapes, so that both
    packages admit alike) plus the expanded candidate index pairs.
    `dup_factor` is the build-side key duplication (rows / distinct keys), the
    upper bound of the probe match rate: every probe row matching
    `dup_factor` build rows."""
    def pow2(n: int) -> int:
        return 1 << (max(1, int(n)) - 1).bit_length()
    code_bytes = 4 * (pow2(build_rows) * 2 + pow2(probe_rows))
    out_rows = int(max(0.0, float(probe_rows)) * max(1.0, float(dup_factor)))
    # candidate (li, ri) int64 pairs + one gathered output column set
    pair_bytes = out_rows * 16
    out_bytes = out_rows * max(1, int(ncols)) * 8
    return int(code_bytes + pair_bytes + out_bytes)


def join_device_budget_bytes(device: torch.device) -> Optional[int]:
    """Device bytes a join may claim now: capacity less the headroom less what
    is in use, i.e. free - headroom * capacity, on a CUDA device; None (no
    gate) on the CPU, as the JAX package has no gate without a ledger."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return max(0, int(free - total * DEFAULT_TARGET_HEADROOM_PCT / 100.0))
