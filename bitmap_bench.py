#!/usr/bin/env python3
"""Times `bitmap_filter` at `chip_smoke.py`'s `bitmap_case` shapes for one
checkout of pinot_tpu_torch, on one CUDA card.

    python3 bitmap_bench.py [--root DIR] [--seed 20260729] [--rows 16777216]

Draws lo_discount's and lo_quantity's dict ids from --seed (SSB's
cardinalities, 11 and 50), cuts the rows into 8 segments as the smoke's
tables are, packs each column's bitmap index on the card (`[S, card, W]`
int32 words, all rows valid), and runs `chip_smoke.bitmap_cases` on one
segment and on the stacked set: each output held equal to the plain
version's, then `ms` (graph replay, L2 flushed), `plain_ms`, `call_ms`,
`floor_ms` and the bound, one `bitmap_case` line each. `--root` names the
checkout whose `pinot_tpu_torch` runs (default: this one), so two commits
compare on one card in one call: run the script for each, in turns (A, B,
B, A). Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import chip_smoke
from chip_smoke import SEGMENTS, log

CARDS = {"lo_discount": 11, "lo_quantity": 50}


class WordsBlock:
    """The two columns' bitmap words and the valid words, as the smoke's
    `bitmap_cases` reads a segment block or a stacked set block."""

    def __init__(self, words: dict, valid_words: torch.Tensor):
        self._words = words
        self.valid_words = valid_words
        self.device = valid_words.device

    def bitmap_words(self, col: str) -> torch.Tensor:
        return self._words[col]


def pack_bitmaps(ids: torch.Tensor, card: int) -> torch.Tensor:
    """int64 ids `[S, rows]` -> int32 `[S, card, rows // 32]`: row r of id c
    at bit r % 32 of word r // 32 (`datablock.id_bitmap_words`'s layout)."""
    s, rows = ids.shape
    shifts = torch.arange(32, device=ids.device, dtype=torch.int64)
    out = torch.empty((s, card, rows // 32), dtype=torch.int32, device=ids.device)
    for c in range(card):
        v = ((ids == c).view(s, -1, 32).to(torch.int64) << shifts).sum(-1)
        out[:, c] = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose pinot_tpu_torch package runs")
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--rows", type=int, default=16 * 1024 * 1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bitmap_bench: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from pinot_tpu_torch.engine import bitmap
    if not os.path.abspath(bitmap.__file__).startswith(os.path.abspath(args.root) + os.sep):
        raise RuntimeError(f"imported {bitmap.__file__}, not the package under {args.root}")

    device = torch.device("cuda")
    rows = args.rows // SEGMENTS   # each segment's rows: a power of two, as padded
    if rows % 32 or rows & (rows - 1):
        raise ValueError(f"{rows} rows a segment: expected a power of two")
    rng = np.random.default_rng(args.seed)
    words = {col: pack_bitmaps(torch.from_numpy(rng.integers(0, card, (SEGMENTS, rows)))
                               .to(device), card)
             for col, card in CARDS.items()}
    valid = torch.full((SEGMENTS, rows // 32), -1, dtype=torch.int32, device=device)
    one = WordsBlock({col: w[0].clone() for col, w in words.items()}, valid[0].clone())
    log("bitmap_bench", root=os.path.abspath(args.root), package=bitmap.__file__,
        nvidia_smi=chip_smoke.nvidia_smi_line(), segments=SEGMENTS, rows=rows)
    chip_smoke.bitmap_cases(one, WordsBlock(words, valid))
    return 0


if __name__ == "__main__":
    sys.exit(main())
