"""Composable idealized-basin topography (counterpart of
``mom6_tpu.user.basin_builder``): the depth starts at 1 (full depth,
nondimensional) and each configured piece takes the pointwise minimum
with a coast or ridge primitive.  The pieces are listed in MOM_input as

    BBUILDER_N = 2
    BBUILDER_001_FUNC = "NS_COAST"
    BBUILDER_001_PARS = lon, lat0, lat1, dlon, shelf_depth_m
    ...

Every primitive works on float64 numpy lon/lat arrays; the last
parameter of each is a depth in m, normalized by the maximum depth.
"""

from __future__ import annotations

import numpy as np

__all__ = ["basin_builder_topography"]


def _scurve(x, x0, L):
    """A cubic ramp from 0 to 1 over (x0, x0 + L)."""
    s = np.clip((x - x0) / L, 0.0, 1.0)
    return (3.0 - 2.0 * s) * s * s


def _cone(x, x0, L, clip=None):
    c = np.maximum(0.0, 1.0 - np.abs(x - x0) / L)
    return np.minimum(clip, c) if clip is not None else c


def _cstprof(x, x0, L, lf=0.125, bf=0.125, sf=0.5, sh=0.1):
    """A coast's profile: land, beach, shelf, slope, full depth."""
    s = np.clip((x - x0) / L, 0.0, 1.0)
    return sh * _scurve(s - lf, 0.0, bf) \
        + (1.0 - sh) * _scurve(s - (1.0 - sf), 0.0, sf)


def _dist_line_fixed_x(x, y, x0, y0, y1):
    dx = x - x0
    yr = np.minimum(max(y0, y1), np.maximum(min(y0, y1), y))
    dy = y - yr
    return np.sqrt(dx * dx + dy * dy)


def _ns_coast(lon, lat, lonC, lat0, lat1, dlon, sh):
    r = _dist_line_fixed_x(lon, lat, lonC, lat0, lat1)
    return _cstprof(r, 0.0, dlon, sh=sh)


def _ew_coast(lon, lat, latC, lon0, lon1, dlat, sh):
    r = _dist_line_fixed_x(lat, lon, latC, lon0, lon1)
    return _cstprof(r, 0.0, dlat, sh=sh)


def _angled_coast(lon, lat, lon_eq, lat_mer, dr, sh):
    i_dr = 1.0 / np.sqrt(lat_mer * lat_mer + lon_eq * lon_eq)
    r = i_dr * (lat_mer * lon + lon_eq * lat - lon_eq * lat_mer)
    return _cstprof(r, 0.0, dr, sh=sh)


def _ns_conic_ridge(lon, lat, lonC, lat0, lat1, dlon, rh):
    r = _dist_line_fixed_x(lon, lat, lonC, lat0, lat1)
    return 1.0 - rh * _cone(r, 0.0, dlon)


def _ns_scurve_ridge(lon, lat, lonC, lat0, lat1, dlon, rh):
    r = _dist_line_fixed_x(lon, lat, lonC, lat0, lat1)
    return 1.0 - rh * (1.0 - _scurve(r, 0.0, dlon))


def _circ_conic_ridge(lon, lat, lon0, lat0, radius, thick, rh):
    r = np.abs(np.hypot(lon - lon0, lat - lat0) - radius)
    return 1.0 - _cone(r, 0.0, thick, clip=rh)


def _circ_scurve_ridge(lon, lat, lon0, lat0, radius, thick, rh):
    r = np.abs(np.hypot(lon - lon0, lat - lat0) - radius)
    return 1.0 - (1.0 - _scurve(r, 0.0, thick)) * rh


_FUNCS = {
    "ns_coast": _ns_coast,
    "ew_coast": _ew_coast,
    "angled_coast": _angled_coast,
    "ns_conic_ridge": _ns_conic_ridge,
    "ns_scurve_ridge": _ns_scurve_ridge,
    "circ_conic_ridge": _circ_conic_ridge,
    "circ_scurve_ridge": _circ_scurve_ridge,
}


def basin_builder_topography(lon, lat, pf, max_depth):
    """The depth [m] of the BBUILDER_* pieces in the parameters ``pf``:
    the minimum over the pieces keeps the shallowest feature."""
    n = pf.get("BBUILDER_N", int, desc="number of basin_builder pieces")
    d = np.ones_like(np.asarray(lon, np.float64))
    for i in range(1, n + 1):
        func = pf.get(f"BBUILDER_{i:03d}_FUNC", str).strip()
        pars = [float(v) for v in pf.get(f"BBUILDER_{i:03d}_PARS", list)]
        key = func.lower()
        if key not in _FUNCS:
            raise ValueError(f"basin_builder: unknown function '{func}'")
        pars[-1] = pars[-1] / max_depth
        d = np.minimum(d, _FUNCS[key](lon, lat, *pars))
    return d * max_depth
