"""Z-space initial conditions (INIT_LAYERS_FROM_Z_FILE with
Z_INIT_ALE_REMAPPING, TRACER_Z_INIT_FILE).

Counterpart of ``mom6_tpu.initialization.z_init`` (MOM6's
MOM_temp_salt_initialize_from_Z and MOM_tracer_Z_init): a file's z-level
profiles are taken as cell means on a column of z-cells (edges midway
between the stated depths, the last one extended to the bottom), filled
under land level by level, regridded bilinearly to the model's T points
and remapped conservatively onto the model thicknesses with the ALE
remap (``remap_column_means``).
"""

from __future__ import annotations

import numpy as np
import torch

from mom6_torch.ale.remapping import RemapCfg, remap_column_means
from mom6_torch.initialization.horizontal_regrid import (bilinear_regrid,
                                                         fill_missing)

__all__ = ["z_edges_from_centers", "thickness_from_z_edges",
           "temp_salt_from_z", "tracer_from_z"]

_F64 = torch.float64


def z_edges_from_centers(z_centers, max_depth: float) -> np.ndarray:
    """Interface depths of file levels given at cell centres: 0 at the
    surface, midway between centres inside, and the last at
    max(``max_depth``, the deepest centre plus its half cell)."""
    z = np.asarray(z_centers, np.float64)
    if np.any(np.diff(z) <= 0):
        raise ValueError("file depths must increase monotonically")
    edges = np.empty(z.size + 1)
    edges[0] = 0.0
    edges[1:-1] = 0.5 * (z[:-1] + z[1:])
    edges[-1] = max(max_depth, z[-1] + (z[-1] - edges[-2]))
    return edges


def thickness_from_z_edges(z_edges, bathy, angstrom: float) -> torch.Tensor:
    """Thicknesses of fixed z-cells cut by the local bottom:
    max(min(e[k+1], D) - min(e[k], D), angstrom), on the device of
    ``bathy`` (a tensor) in float64."""
    D = torch.as_tensor(bathy, dtype=_F64)
    e = torch.as_tensor(np.asarray(z_edges, np.float64), dtype=_F64,
                        device=D.device).reshape((-1,) + (1,) * D.ndim)
    ecap = torch.minimum(e, D[None])
    return torch.clamp(ecap[1:] - ecap[:-1], min=angstrom)


def _valid(a: torch.Tensor, missing_value: float) -> torch.Tensor:
    return torch.isfinite(a) & (a > missing_value)


def _source_thickness(z_centers, bathy: torch.Tensor, angstrom: float):
    z_edges = z_edges_from_centers(z_centers, float(torch.max(bathy)))
    return thickness_from_z_edges(z_edges, bathy, angstrom)


def tracer_from_z(tr_z, src_lon, src_lat, z_centers, dst_lon, dst_lat,
                  bathy, h_target: torch.Tensor, angstrom: float,
                  remap_cfg: RemapCfg = RemapCfg(),
                  missing_value: float = -1e10) -> torch.Tensor:
    """One tracer on the model layers from a z-space file profile
    ``tr_z`` (nz, ny_src, nx_src), in float64 on the device of
    ``h_target``."""
    dev = h_target.device
    tr = torch.as_tensor(np.asarray(tr_z, np.float64), device=dev)
    tr_m = bilinear_regrid(
        fill_missing(tr, _valid(tr, missing_value), device=dev),
        src_lon, src_lat, dst_lon, dst_lat)
    bathy = torch.as_tensor(bathy, dtype=_F64, device=dev)
    h_src = _source_thickness(z_centers, bathy, angstrom)
    return remap_column_means(h_src, tr_m, h_target.to(_F64), remap_cfg)


def temp_salt_from_z(T_z, S_z, src_lon, src_lat, z_centers, dst_lon,
                     dst_lat, bathy, h_target: torch.Tensor,
                     angstrom: float, remap_cfg: RemapCfg = RemapCfg(),
                     missing_value: float = -1e10):
    """(T, S) on the model layers from z-space file profiles
    (nz, ny_src, nx_src): a point is missing where either field is
    non-finite or at most ``missing_value``.  ``dst_lon``/``dst_lat``
    are the model's T points and ``bathy`` their depths, ``h_target``
    (nk, ...) the model thicknesses there.  float64 on the device of
    ``h_target``."""
    dev = h_target.device
    T = torch.as_tensor(np.asarray(T_z, np.float64), device=dev)
    S = torch.as_tensor(np.asarray(S_z, np.float64), device=dev)
    valid = _valid(T, missing_value) & _valid(S, missing_value)
    T_m, S_m = (bilinear_regrid(fill_missing(a, valid, device=dev),
                                src_lon, src_lat, dst_lon, dst_lat)
                for a in (T, S))
    bathy = torch.as_tensor(bathy, dtype=_F64, device=dev)
    h_src = _source_thickness(z_centers, bathy, angstrom)
    h_t = h_target.to(_F64)
    return (remap_column_means(h_src, T_m, h_t, remap_cfg),
            remap_column_means(h_src, S_m, h_t, remap_cfg))
