"""Horizontal grid metrics on the Arakawa C-grid.

Counterpart of ``mom6_tpu.core.grid``: a frozen dataclass of
halo-padded ``(njh, nih)`` metric tensors.  Metrics are computed
analytically in float64 numpy over the padded index space (halo rings
included), exactly as the JAX package does, and only then cast to the
requested device and dtype.

Positional staggering: for cell (j, i), h/T points at centres, Cu on
the east face, Cv on the north face, Bu at the north-east corner.
Reciprocal metrics follow the Adcroft rule (1/x where x > 0, else 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mom6_torch.parallel.domain import Domain

__all__ = ["Grid", "cartesian_grid", "spherical_grid", "mercator_grid",
           "mosaic_grid"]

RADIUS_EARTH = 6.378e6     # m
OMEGA = 7.2921e-5          # s-1


def _adcroft_recip(x: np.ndarray) -> np.ndarray:
    return np.where(x > 0, 1.0 / np.where(x > 0, x, 1.0), 0.0)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Halo-padded metrics; every field is an (njh, nih) tensor."""

    domain: Domain
    dxT: torch.Tensor
    dyT: torch.Tensor
    IdxT: torch.Tensor
    IdyT: torch.Tensor
    areaT: torch.Tensor
    IareaT: torch.Tensor
    dxCu: torch.Tensor
    dyCu: torch.Tensor
    IdxCu: torch.Tensor
    IdyCu: torch.Tensor
    areaCu: torch.Tensor
    IareaCu: torch.Tensor
    dxCv: torch.Tensor
    dyCv: torch.Tensor
    IdxCv: torch.Tensor
    IdyCv: torch.Tensor
    areaCv: torch.Tensor
    IareaCv: torch.Tensor
    dxBu: torch.Tensor
    dyBu: torch.Tensor
    IdxBu: torch.Tensor
    IdyBu: torch.Tensor
    areaBu: torch.Tensor
    IareaBu: torch.Tensor
    mask2dT: torch.Tensor
    mask2dCu: torch.Tensor
    mask2dCv: torch.Tensor
    mask2dBu: torch.Tensor
    CoriolisBu: torch.Tensor      # f at corners [s-1]
    bathyT: torch.Tensor          # positive depth at T points [m]
    geoLatT: torch.Tensor
    geoLonT: torch.Tensor
    geoLatCu: torch.Tensor
    geoLonCu: torch.Tensor
    geoLatCv: torch.Tensor
    geoLonCv: torch.Tensor
    geoLatBu: torch.Tensor
    geoLonBu: torch.Tensor
    # porous-barrier subgrid topography at faces (SUBGRID_TOPO_AT_VEL;
    # heights, negative down): None unless a TOPO_AT_VEL file was read
    porous_DminU: Optional[torch.Tensor] = None
    porous_DmaxU: Optional[torch.Tensor] = None
    porous_DavgU: Optional[torch.Tensor] = None
    porous_DminV: Optional[torch.Tensor] = None
    porous_DmaxV: Optional[torch.Tensor] = None
    porous_DavgV: Optional[torch.Tensor] = None


def _padded_index(domain: Domain):
    H = domain.halo
    return np.arange(-H, domain.nj + H), np.arange(-H, domain.ni + H)


def _build(domain: Domain, lon_c, lat_c, lon_f, lat_f, dx_fn, dy_fn,
           f_fn, depth_fn, min_depth: float, device, dtype) -> Grid:
    """Assemble a Grid from 1D padded centre/face coordinates and metric
    callables (mom6_tpu.core.grid._build)."""
    LaT, LoT = np.meshgrid(lat_c, lon_c, indexing="ij")
    LaCu, LoCu = np.meshgrid(lat_c, lon_f, indexing="ij")
    LaCv, LoCv = np.meshgrid(lat_f, lon_c, indexing="ij")
    LaBu, LoBu = np.meshgrid(lat_f, lon_f, indexing="ij")
    dlon = lon_c[1] - lon_c[0]
    dlat = lat_c[1] - lat_c[0]
    dxT, dyT = dx_fn(dlon, LaT), dy_fn(dlat, LaT)
    dxCu, dyCu = dx_fn(dlon, LaCu), dy_fn(dlat, LaCu)
    dxCv, dyCv = dx_fn(dlon, LaCv), dy_fn(dlat, LaCv)
    dxBu, dyBu = dx_fn(dlon, LaBu), dy_fn(dlat, LaBu)
    return _assemble(
        domain, depth_fn(LoT, LaT), min_depth, f_fn(LoBu, LaBu),
        dict(dxT=dxT, dyT=dyT, areaT=dxT * dyT,
             dxCu=dxCu, dyCu=dyCu, areaCu=dxCu * dyCu,
             dxCv=dxCv, dyCv=dyCv, areaCv=dxCv * dyCv,
             dxBu=dxBu, dyBu=dyBu, areaBu=dxBu * dyBu),
        dict(geoLatT=LaT, geoLonT=LoT, geoLatCu=LaCu, geoLonCu=LoCu,
             geoLatCv=LaCv, geoLonCv=LoCv, geoLatBu=LaBu,
             geoLonBu=LoBu),
        device, dtype)


def _assemble(domain: Domain, depth, min_depth: float, f_Bu,
              metrics: dict, coords: dict, device, dtype) -> Grid:
    """Masks, Adcroft reciprocals and packing: the domain's boundary
    semantics are applied to the topography first, so halo cells beyond
    a wall are land and wall faces get mask 0."""
    depth = domain.fill_halos(torch.from_numpy(
        np.asarray(depth, np.float64))).numpy()
    maskT = (depth > min_depth).astype(np.float64)
    maskCu = maskT * np.roll(maskT, -1, axis=-1)
    maskCv = maskT * np.roll(maskT, -1, axis=-2)
    maskBu = maskCu * np.roll(maskCu, -1, axis=-2)
    depth = np.where(maskT > 0, depth, 0.0)

    fields = {}
    for name in ("T", "Cu", "Cv", "Bu"):
        dx, dy = metrics["dx" + name], metrics["dy" + name]
        area = metrics["area" + name]
        fields.update({"dx" + name: dx, "dy" + name: dy,
                       "Idx" + name: _adcroft_recip(dx),
                       "Idy" + name: _adcroft_recip(dy),
                       "area" + name: area,
                       "Iarea" + name: _adcroft_recip(area)})
    fields.update(mask2dT=maskT, mask2dCu=maskCu, mask2dCv=maskCv,
                  mask2dBu=maskBu, CoriolisBu=f_Bu, bathyT=depth,
                  **coords)
    return Grid(domain=domain, **{
        k: torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                           device=device) for k, v in fields.items()})


def cartesian_grid(domain: Domain, lenlon_km: float, lenlat_km: float,
                   f0: float = 0.0, beta: float = 0.0,
                   max_depth: float = 4000.0, *, device,
                   dtype: torch.dtype, depth_fn=None,
                   min_depth: float = 0.0, south_lat: float = 0.0,
                   west_lon: float = 0.0,
                   beta_lat_ref: float = 0.0) -> Grid:
    """Uniform Cartesian grid in km from (``west_lon``, ``south_lat``),
    f/beta plane about ``beta_lat_ref`` [km]
    (mom6_tpu.core.grid.cartesian_grid).  ``depth_fn(lon, lat)`` gives
    the bottom depth at the cell centres (default: flat at
    ``max_depth``); cells no deeper than ``min_depth`` are land."""
    j, i = _padded_index(domain)
    dxi = lenlon_km / domain.ni
    deta = lenlat_km / domain.nj
    lon_c = west_lon + (i + 0.5) * dxi
    lat_c = south_lat + (j + 0.5) * deta
    lon_f = west_lon + (i + 1.0) * dxi       # east face of cell i
    lat_f = south_lat + (j + 1.0) * deta     # north face of cell j

    def dx_fn(dlon, lat):
        return np.full_like(lat, dlon * 1e3)

    def dy_fn(dlat, lat):
        return np.full_like(lat, dlat * 1e3)

    def f_fn(lon, lat):
        return f0 + beta * (lat - beta_lat_ref) * 1e3

    if depth_fn is None:
        def depth_fn(lon, lat):
            return np.full_like(lat, max_depth)

    return _build(domain, lon_c, lat_c, lon_f, lat_f, dx_fn, dy_fn,
                  f_fn, depth_fn, min_depth, device, dtype)


def spherical_grid(domain: Domain, west_lon: float, lenlon: float,
                   south_lat: float, lenlat: float, max_depth: float = 4000.0,
                   *, device, dtype: torch.dtype, depth_fn=None,
                   min_depth: float = 0.0,
                   radius: float = RADIUS_EARTH) -> Grid:
    """Uniform latitude-longitude grid in degrees with f = 2 Omega
    sin(lat) (mom6_tpu.core.grid.spherical_grid); the JAX builder takes
    it for a cartesian grid whose AXIS_UNITS are degrees."""
    j, i = _padded_index(domain)
    dlon = lenlon / domain.ni
    dlat = lenlat / domain.nj
    lon_c = west_lon + (i + 0.5) * dlon
    lat_c = south_lat + (j + 0.5) * dlat
    lon_f = west_lon + (i + 1.0) * dlon
    lat_f = south_lat + (j + 1.0) * dlat
    deg2rad = np.pi / 180.0

    def dx_fn(dlon_, lat):
        return radius * deg2rad * dlon_ * np.cos(deg2rad * lat)

    def dy_fn(dlat_, lat):
        return np.full_like(lat, radius * deg2rad * dlat_)

    def f_fn(lon, lat):
        return 2.0 * OMEGA * np.sin(deg2rad * lat)

    if depth_fn is None:
        def depth_fn(lon, lat):
            return np.full_like(lat, max_depth)

    return _build(domain, lon_c, lat_c, lon_f, lat_f, dx_fn, dy_fn,
                  f_fn, depth_fn, min_depth, device, dtype)


def mercator_grid(domain: Domain, west_lon: float, lenlon: float,
                  south_lat: float, north_lat: float | None = None,
                  max_depth: float = 4000.0, *, device,
                  dtype: torch.dtype, depth_fn=None, min_depth: float = 0.0,
                  radius: float = RADIUS_EARTH) -> Grid:
    """Isotropic Mercator grid (mom6_tpu.core.grid.mercator_grid):
    uniform spacing in y = ln(tan(pi/4 + lat/2)) from ``south_lat`` to
    ``north_lat`` (without it, the spacing of the longitudes, so that
    dx = dy), dy = R cos(lat) dy_merc, f = 2 Omega sin(lat)."""
    deg2rad = np.pi / 180.0

    def to_merc(lat_deg):
        return np.log(np.tan(np.pi / 4.0 + 0.5 * deg2rad * lat_deg))

    def from_merc(y):
        return (2.0 * np.arctan(np.exp(y)) - np.pi / 2.0) / deg2rad

    dlon = lenlon / domain.ni
    y_s = to_merc(south_lat)
    if north_lat is None:
        dy_m = deg2rad * dlon
    else:
        dy_m = (to_merc(north_lat) - y_s) / domain.nj
    j, i = _padded_index(domain)
    lon_c = west_lon + (i + 0.5) * dlon
    lon_f = west_lon + (i + 1.0) * dlon
    lat_c = from_merc(y_s + (j + 0.5) * dy_m)
    lat_f = from_merc(y_s + (j + 1.0) * dy_m)

    def dx_fn(dlon_, lat):
        return radius * deg2rad * dlon_ * np.cos(deg2rad * lat)

    def dy_fn(dlat_, lat):
        return radius * np.cos(deg2rad * lat) * dy_m

    def f_fn(lon, lat):
        return 2.0 * OMEGA * np.sin(deg2rad * lat)

    if depth_fn is None:
        def depth_fn(lon, lat):
            return np.full_like(lat, max_depth)

    return _build(domain, lon_c, lat_c, lon_f, lat_f, dx_fn, dy_fn,
                  f_fn, depth_fn, min_depth, device, dtype)


def _pad_metric(domain: Domain, interior: np.ndarray) -> np.ndarray:
    """A (nj, ni) field padded to the halo: wrapped along reentrant axes,
    edge copies at walls."""
    H = domain.halo
    out = np.pad(interior, ((H, H), (0, 0)),
                 mode="wrap" if domain.reentrant_y else "edge")
    return np.pad(out, ((0, 0), (H, H)),
                  mode="wrap" if domain.reentrant_x else "edge")


def mosaic_grid(domain: Domain, grid_file: str, *, device,
                dtype: torch.dtype, depth_fn=None,
                min_depth: float = 0.0) -> Grid:
    """The horizontal grid of an FMS mosaic supergrid file
    (GRID_CONFIG = mosaic; mom6_tpu.core.grid.mosaic_grid).

    The supergrid has its coordinates x, y at (2 nj + 1, 2 ni + 1)
    points, segment lengths dx (2 nj + 1, 2 ni) and dy (2 nj, 2 ni + 1)
    and areas (2 nj, 2 ni) at twice the resolution: model cell (j, i)
    covers supergrid cells [2j:2j+2, 2i:2i+2], its centre is supergrid
    point (2j+1, 2i+1) and its NE corner (2j+2, 2i+2).  A metric sums
    the two supergrid segments through its point; the last face's
    second segment, beyond the file, wraps on a reentrant axis and
    repeats the last one at a wall.  Halos wrap along reentrant axes
    and copy the edge at walls; f = 2 Omega sin(lat) at the corners."""
    from mom6_torch.framework.io import read_field

    def rd(name):
        return np.asarray(read_field(grid_file, name), np.float64)

    x, y, sdx, sdy, sarea = (rd(n) for n in ("x", "y", "dx", "dy", "area"))
    nj, ni = domain.nj, domain.ni
    if x.shape != (2 * nj + 1, 2 * ni + 1):
        raise ValueError(
            f"supergrid x shape {x.shape} incompatible with "
            f"NIGLOBAL={ni}, NJGLOBAL={nj} (want {(2*nj+1, 2*ni+1)})")
    jc = 2 * np.arange(nj) + 1          # centre rows/columns
    ic = 2 * np.arange(ni) + 1
    jf = 2 * np.arange(nj) + 2          # north faces, NE corners
    if_ = 2 * np.arange(ni) + 2         # east faces
    j0, i0 = 2 * np.arange(nj), 2 * np.arange(ni)
    ix2 = np.where(if_ < 2 * ni, if_, 0 if domain.reentrant_x
                   else 2 * ni - 1)
    jy2 = np.where(jf < 2 * nj, jf, 0 if domain.reentrant_y
                   else 2 * nj - 1)
    dxT = sdx[jc][:, i0] + sdx[jc][:, ic]
    dyT = sdy[j0][:, ic] + sdy[jc][:, ic]
    dxCu = sdx[jc][:, ic] + sdx[jc][:, ix2]
    dyCu = sdy[j0][:, if_] + sdy[jc][:, if_]
    dxCv = sdx[jf][:, i0] + sdx[jf][:, ic]
    dyCv = sdy[jc][:, ic] + sdy[jy2][:, ic]
    dxBu = sdx[jf][:, ic] + sdx[jf][:, ix2]
    dyBu = sdy[jc][:, if_] + sdy[jy2][:, if_]
    areaT = (sarea[::2, ::2] + sarea[1::2, ::2]
             + sarea[::2, 1::2] + sarea[1::2, 1::2])

    def P(a):
        return _pad_metric(domain, a)

    metrics = dict(dxT=P(dxT), dyT=P(dyT), areaT=P(areaT),
                   dxCu=P(dxCu), dyCu=P(dyCu), areaCu=P(dxCu) * P(dyCu),
                   dxCv=P(dxCv), dyCv=P(dyCv), areaCv=P(dxCv) * P(dyCv),
                   dxBu=P(dxBu), dyBu=P(dyBu), areaBu=P(dxBu) * P(dyBu))
    coords = dict(geoLatT=P(y[jc[:, None], ic]),
                  geoLonT=P(x[jc[:, None], ic]),
                  geoLatCu=P(y[jc[:, None], if_]),
                  geoLonCu=P(x[jc[:, None], if_]),
                  geoLatCv=P(y[jf[:, None], ic]),
                  geoLonCv=P(x[jf[:, None], ic]),
                  geoLatBu=P(y[jf[:, None], if_]),
                  geoLonBu=P(x[jf[:, None], if_]))
    f = 2.0 * OMEGA * np.sin(np.pi / 180.0 * coords["geoLatBu"])
    if depth_fn is None:
        def depth_fn(lon, lat):
            return np.full_like(lat, 4000.0)
    depth = depth_fn(coords["geoLonT"], coords["geoLatT"])
    return _assemble(domain, depth, min_depth, f, metrics, coords, device,
                     dtype)
