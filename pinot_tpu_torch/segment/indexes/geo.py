"""Geo grid-cell index: the candidate pre-filter of distance predicates.

A copy of `pinot_tpu/segment/indexes/geo.py` that writes and reads the same
file (the analog of the reference's H3 index, `ImmutableH3IndexReader.java`
and `H3IndexCreator`): docs bucketed by spatial cell; a distance query
resolves a cover of cells and unions their posting lists, then the exact
predicate refines. A fixed-resolution lat/lng grid (default 0.1 degree, about
11 km) stands in for H3's hexagons, with CSR postings over the occupied
cells: one argsort builds the index, and a radius query's cover is box
arithmetic.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ...engine.geo_fns import EARTH_RADIUS_M

DEFAULT_RESOLUTION_DEG = 0.1
GEO_SUFFIX = ".geo.npz"


def _grid(res: float) -> Tuple[int, int]:
    return int(math.ceil(360.0 / res)), int(math.ceil(180.0 / res))


def _cells_for(lng: np.ndarray, lat: np.ndarray, res: float) -> np.ndarray:
    nx, ny = _grid(res)
    # NaN coordinates floor to garbage under int cast: pin them to the corner
    # cell deterministically (their haversine is NaN -> exact refine rejects)
    lng_arr = np.nan_to_num(np.asarray(lng, dtype=np.float64), nan=-180.0)
    ix = np.clip(np.floor((lng_arr + 180.0) / res), 0, nx - 1).astype(np.int64)
    lat_arr = np.nan_to_num(np.asarray(lat, dtype=np.float64), nan=-90.0)
    iy = np.clip(np.floor((np.clip(lat_arr, -90.0, 90.0) + 90.0) / res),
                 0, ny - 1).astype(np.int64)  # lat=90 clamps into the top row
    return iy * nx + ix


def create_geo_index(path: str, lng: np.ndarray, lat: np.ndarray,
                     resolution_deg: float = DEFAULT_RESOLUTION_DEG) -> None:
    cells = _cells_for(lng, lat, resolution_deg)
    order = np.argsort(cells, kind="stable")
    sorted_cells = cells[order]
    uniq, starts = np.unique(sorted_cells, return_index=True)
    offsets = np.append(starts, len(sorted_cells)).astype(np.int64)
    np.savez(path, cells=uniq, offsets=offsets,
             doc_ids=order.astype(np.int32),
             resolution=np.float64(resolution_deg))


class GeoIndexReader:
    def __init__(self, path: str):
        data = np.load(path)
        self._cells = data["cells"]        # sorted unique occupied cell ids
        self._offsets = data["offsets"]    # CSR over _doc_ids, len(cells)+1
        self._doc_ids = data["doc_ids"]
        self.resolution = float(data["resolution"])
        self._nx = int(math.ceil(360.0 / self.resolution))

    def _cover(self, cx: float, cy: float, radius_m: float):
        """(iy0, iy1, [(ix0, ix1), ...]) cell cover for a radius query.

        The x-ranges list handles ANTIMERIDIAN WRAP: a circle crossing lng
        ±180 covers two disjoint column ranges — clamping (the old behavior)
        silently dropped matches near the date line, breaking the superset
        invariant the exact-refine AND depends on. Latitude rows clamp to the
        top/bottom row so lat=±90 docs stay reachable."""
        res = self.resolution
        ny = int(math.ceil(180.0 / res))
        dlat = math.degrees(radius_m / EARTH_RADIUS_M)
        coslat = max(math.cos(math.radians(min(abs(cy) + dlat, 89.9))), 1e-6)
        dlng = dlat / coslat
        iy0 = max(int((max(cy - dlat, -90.0) + 90.0) // res), 0)
        iy1 = min(int((min(cy + dlat, 90.0) + 90.0) // res), ny - 1)
        if dlng * 2 >= 360.0:
            return iy0, iy1, [(0, self._nx - 1)]
        lo, hi = cx - dlng, cx + dlng
        if lo < -180.0:
            ranges = [(0, int((hi + 180.0) // res)),
                      (int((lo + 360.0 + 180.0) // res), self._nx - 1)]
        elif hi > 180.0:
            ranges = [(0, int((hi - 360.0 + 180.0) // res)),
                      (int((lo + 180.0) // res), self._nx - 1)]
        else:
            ranges = [(int((lo + 180.0) // res), int((hi + 180.0) // res))]
        return iy0, iy1, [(max(a, 0), min(b, self._nx - 1)) for a, b in ranges]

    def candidate_mask(self, cx: float, cy: float, radius_m: float,
                       num_docs: int) -> np.ndarray:
        """bool[num_docs] — True for every doc in a cell the radius MAY touch
        (superset of exact matches; caller refines with the exact predicate)."""
        iy0, iy1, xranges = self._cover(cx, cy, radius_m)
        mask = np.zeros(num_docs, dtype=bool)
        for iy in range(iy0, iy1 + 1):
            for ix0, ix1 in xranges:
                a = np.searchsorted(self._cells, iy * self._nx + ix0, "left")
                b = np.searchsorted(self._cells, iy * self._nx + ix1, "right")
                if a < b:
                    docs = self._doc_ids[self._offsets[a]:self._offsets[b]]
                    mask[docs] = True
        return mask

    def match_estimate(self, cx: float, cy: float, radius_m: float) -> int:
        """Candidate count without materializing the mask (planner hint)."""
        iy0, iy1, xranges = self._cover(cx, cy, radius_m)
        total = 0
        for iy in range(iy0, iy1 + 1):
            for ix0, ix1 in xranges:
                a = np.searchsorted(self._cells, iy * self._nx + ix0, "left")
                b = np.searchsorted(self._cells, iy * self._nx + ix1, "right")
                if a < b:
                    total += int(self._offsets[b] - self._offsets[a])
        return total


def geo_index_path(cols_dir_prefix: str, lng_col: str, lat_col: str) -> str:
    """Index file path for a (lng, lat) column pair; lives beside the columns."""
    return f"{cols_dir_prefix}{lng_col}__{lat_col}{GEO_SUFFIX}"
