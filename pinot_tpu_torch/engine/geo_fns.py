"""Geospatial ST_* functions and the compile-time haversine rewrite.

A copy of `pinot_tpu/engine/geo_fns.py` (analog of the reference's geospatial
transforms, `pinot-core/.../geospatial/transform/function/`). On the host,
points are packed complex128 values (lng + i*lat). A distance predicate over
two coordinate columns is rewritten at compile time (`rewrite_geo`) into an
elementwise haversine expression tree of plus/times/sin/cos/asin/sqrt, all of
them device functions (`expr.DEVICE_FUNCS`), so the predicate runs as f32
math in the device filter. Polygons stay on the host (ray casting). The geo
cell index that pre-filters such a predicate in the JAX package is not
ported.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

import numpy as np

from ..sql.ast import Expr, Function, Identifier, Literal
from .expr import register_function

EARTH_RADIUS_M = 6371008.8  # mean Earth radius (reference: StDistanceFunction
                            # uses sphere geography distance in meters)


# -- WKT ----------------------------------------------------------------------

class GeoPolygon:
    """Single-ring polygon (host-side exact geometry)."""

    __slots__ = ("xs", "ys")

    def __init__(self, coords: List[Tuple[float, float]]):
        if coords and coords[0] == coords[-1]:
            coords = coords[:-1]
        self.xs = np.asarray([c[0] for c in coords], dtype=np.float64)
        self.ys = np.asarray([c[1] for c in coords], dtype=np.float64)

    def contains(self, x: float, y: float) -> bool:
        """Ray casting; boundary points count as inside-ish (matches the
        common even-odd rule, exact boundary semantics are out of contract)."""
        n = len(self.xs)
        inside = False
        j = n - 1
        for i in range(n):
            xi, yi, xj, yj = self.xs[i], self.ys[i], self.xs[j], self.ys[j]
            if (yi > y) != (yj > y) and \
                    x < (xj - xi) * (y - yi) / (yj - yi) + xi:
                inside = not inside
            j = i
        return inside

    def to_wkt(self) -> str:
        pts = ", ".join(f"{x:g} {y:g}" for x, y in
                        zip(self.xs.tolist() + [self.xs[0]],
                            self.ys.tolist() + [self.ys[0]]))
        return f"POLYGON (({pts}))"


def parse_wkt(text: str):
    """POINT (x y) -> complex; POLYGON ((x y, ...)) -> GeoPolygon."""
    t = text.strip()
    m = re.fullmatch(r"(?is)\s*POINT\s*\(\s*([-\d.eE+]+)\s+([-\d.eE+]+)\s*\)\s*", t)
    if m:
        return complex(float(m.group(1)), float(m.group(2)))
    m = re.fullmatch(r"(?is)\s*POLYGON\s*\(\s*\((.*?)\)\s*\)\s*", t)
    if m:
        coords = []
        for pair in m.group(1).split(","):
            xs = pair.split()
            coords.append((float(xs[0]), float(xs[1])))
        return GeoPolygon(coords)
    raise ValueError(f"unsupported WKT: {text[:60]!r}")


def point_wkt(p: complex) -> str:
    return f"POINT ({p.real:g} {p.imag:g})"


# -- scalar/vector function library (host path) -------------------------------

def _as_complex(v):
    arr = np.asarray(v)
    if arr.dtype.kind == "c":
        return arr
    if arr.dtype == object:  # WKT strings / mixed
        return np.asarray([x if isinstance(x, complex) else parse_wkt(str(x))
                           for x in arr.reshape(-1)]).reshape(arr.shape)
    return arr.astype(np.complex128)


@register_function("stpoint")
def _stpoint(xp, x, y, *srid):
    return np.asarray(x, dtype=np.float64) + 1j * np.asarray(y, dtype=np.float64)


@register_function("stgeogfromtext")
def _stgeogfromtext(xp, wkt):
    arr = np.asarray(wkt)
    if arr.ndim == 0:
        return parse_wkt(str(arr))
    out = np.empty(arr.shape, dtype=object)
    for i, s in enumerate(arr.reshape(-1)):
        out.reshape(-1)[i] = parse_wkt(str(s))
    return out


@register_function("stastext")
def _stastext(xp, g):
    arr = np.asarray(g)
    if arr.ndim == 0:
        v = arr.item()
        return v.to_wkt() if isinstance(v, GeoPolygon) else point_wkt(v)
    out = np.empty(arr.shape, dtype=object)
    flat = arr.reshape(-1)
    for i, v in enumerate(flat):
        out.reshape(-1)[i] = (v.to_wkt() if isinstance(v, GeoPolygon)
                              else point_wkt(complex(v)))
    return out


@register_function("stx")
def _stx(xp, p):
    return np.real(_as_complex(p))


@register_function("sty")
def _sty(xp, p):
    return np.imag(_as_complex(p))


def haversine_m(x1, y1, x2, y2):
    """Vectorized great-circle distance in meters (lng/lat degrees)."""
    lam1, phi1 = np.radians(x1), np.radians(y1)
    lam2, phi2 = np.radians(x2), np.radians(y2)
    a = (np.sin((phi2 - phi1) / 2) ** 2
         + np.cos(phi1) * np.cos(phi2) * np.sin((lam2 - lam1) / 2) ** 2)
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.minimum(a, 1.0)))


@register_function("stdistance")
def _stdistance(xp, a, b):
    pa, pb = _as_complex(a), _as_complex(b)
    return haversine_m(np.real(pa), np.imag(pa), np.real(pb), np.imag(pb))


def _point_in_poly(poly, pts) -> np.ndarray:
    arr = _as_complex(pts)
    if arr.ndim == 0:
        return np.bool_(poly.contains(float(arr.real), float(arr.imag)))
    flat = arr.reshape(-1)
    out = np.fromiter((poly.contains(float(p.real), float(p.imag))
                       for p in flat), dtype=bool, count=len(flat))
    return out.reshape(arr.shape)


@register_function("stcontains")
def _stcontains(xp, geom, pts):
    g = geom if isinstance(geom, GeoPolygon) else np.asarray(geom).item()
    if not isinstance(g, GeoPolygon):
        raise ValueError("ST_CONTAINS expects a POLYGON first argument")
    return _point_in_poly(g, pts)


@register_function("stwithin")
def _stwithin(xp, pts, geom):
    return _stcontains(xp, geom, pts)


@register_function("stequals")
def _stequals(xp, a, b):
    return _as_complex(a) == _as_complex(b)


# -- compile-time rewrite: distance over coordinate columns -> device math ----

def _literal_point(e: Expr) -> Optional[complex]:
    """A constant point: ST_POINT(lit, lit) or ST_GEOGFROMTEXT('POINT ...')."""
    if isinstance(e, Function) and e.name == "stpoint" and len(e.args) >= 2 \
            and all(isinstance(a, Literal) for a in e.args[:2]):
        return complex(float(e.args[0].value), float(e.args[1].value))
    if isinstance(e, Function) and e.name == "stgeogfromtext" \
            and len(e.args) == 1 and isinstance(e.args[0], Literal):
        g = parse_wkt(str(e.args[0].value))
        return g if isinstance(g, complex) else None
    return None


def _coord_point(e: Expr) -> Optional[Tuple[Expr, Expr]]:
    """ST_POINT over arbitrary (non-constant) coordinate expressions."""
    if isinstance(e, Function) and e.name == "stpoint" and len(e.args) >= 2:
        return e.args[0], e.args[1]
    return None


def haversine_ast(x1: Expr, y1: Expr, x2: float, y2: float) -> Expr:
    """Elementwise haversine tree (meters) — every node is a device function,
    so a distance predicate rides the fused scan kernel as pure f32 math."""
    def f(name, *args):
        return Function(name, tuple(args))

    def rad(e):
        return f("radians", e)
    phi1, lam1 = rad(y1), rad(x1)
    phi2, lam2 = Literal(math.radians(y2)), Literal(math.radians(x2))
    half = Literal(0.5)
    sin_dphi = f("sin", f("times", f("minus", phi2, phi1), half))
    sin_dlam = f("sin", f("times", f("minus", lam2, lam1), half))
    a = f("plus",
          f("times", sin_dphi, sin_dphi),
          f("times", f("times", f("cos", phi1), f("cos", phi2)),
            f("times", sin_dlam, sin_dlam)))
    a = f("least", a, Literal(1.0))
    return f("times", Literal(2 * EARTH_RADIUS_M), f("asin", f("sqrt", a)))


def rewrite_geo(e: Expr) -> Expr:
    """Rewrite ST_DISTANCE(ST_POINT(xExpr, yExpr), <constant point>) (either
    argument order) into the haversine AST. Recurses through the tree; leaves
    every other geo call for the host function library."""
    if isinstance(e, Function):
        args = tuple(rewrite_geo(a) for a in e.args)
        e = Function(e.name, args, e.distinct)
        if e.name == "stdistance" and len(e.args) == 2:
            for cols, const in ((e.args[0], e.args[1]), (e.args[1], e.args[0])):
                cp = _literal_point(const)
                cc = _coord_point(cols)
                if cp is not None and cc is not None:
                    return haversine_ast(cc[0], cc[1], cp.real, cp.imag)
    return e


def distance_predicate_parts(e: Function):
    """For a filter `stdistance(stpoint(xCol, yCol), constPoint) <op> radius`
    (lt/lte only): (x_col, y_col, cx, cy, radius_m) — the geo-index pre-filter
    hook. None when the shape doesn't match."""
    if len(e.args) != 2:
        return None
    lhs, rhs = e.args
    if e.name in ("gt", "gte") and isinstance(lhs, Literal):
        lhs, rhs = rhs, lhs   # `r > stdistance(...)` is the same predicate
    elif e.name not in ("lt", "lte"):
        return None
    if not isinstance(rhs, Literal) or not isinstance(lhs, Function) \
            or lhs.name != "stdistance" or len(lhs.args) != 2:
        return None
    for cols, const in ((lhs.args[0], lhs.args[1]), (lhs.args[1], lhs.args[0])):
        cp = _literal_point(const)
        cc = _coord_point(cols)
        if cp is not None and cc is not None \
                and isinstance(cc[0], Identifier) and isinstance(cc[1], Identifier):
            return (cc[0].name, cc[1].name, cp.real, cp.imag, float(rhs.value))
    return None
