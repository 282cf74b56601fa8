"""Auxiliary per-column indexes: inverted, range and bloom (copies of
`pinot_tpu/segment/indexes/` with the same files on disk)."""
