"""Auxiliary per-column indexes: inverted, range, bloom, JSON, text, FST and
geo (copies of `pinot_tpu/segment/indexes/` with the same files on disk)."""
