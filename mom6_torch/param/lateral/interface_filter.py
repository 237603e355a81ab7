"""Interface-height filter (counterpart of
``mom6_tpu.param.lateral.interface_filter``): grid-scale smoothing of
interface heights by one Laplacian (or, with ``order`` 4, biharmonic)
pass a step, written as streamfunction-form layer transports like GM's,
so that the tracers ride the same mass redistribution."""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.pressure_force import interface_heights
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["InterfaceFilterCfg", "interface_filter"]


@dataclasses.dataclass(frozen=True)
class InterfaceFilterCfg:
    time_scale: float = 0.0        # INTERFACE_FILTER_TIME_SCALE [s]
    order: int = 2                 # 2 Laplacian, 4 biharmonic
    max_smoothing: float = 0.125   # per-pass smoothing strength


def interface_filter(domain, grid: Grid, vgrid: VerticalGrid, h, dt,
                     cfg: InterfaceFilterCfg):
    """Smooth interface heights over dt; h needs 2 halo rings.  Returns
    (h_new, uhD, vhD), the layer volume transports [m3 s-1] that made
    the smoothing."""
    if cfg.time_scale <= 0.0:
        z = torch.zeros_like(h)
        return h, z, z
    coef = min(dt / cfg.time_scale, cfg.max_smoothing)
    e = interface_heights(vgrid, h, grid.bathyT)

    def lap(f):
        return ((ip1(f) - f) * grid.mask2dCu
                - (f - im1(f)) * im1(grid.mask2dCu)
                + (jp1(f) - f) * grid.mask2dCv
                - (f - jm1(f)) * jm1(grid.mask2dCv)) * 0.25

    area_u = 0.5 * (grid.areaT + ip1(grid.areaT))
    area_v = 0.5 * (grid.areaT + jp1(grid.areaT))
    rate = 0.25 * coef / dt
    if cfg.order >= 4:
        s = domain.fill_halos(lap(e), width=1)
        psi_u = rate * area_u * (ip1(s) - s) * grid.mask2dCu
        psi_v = rate * area_v * (jp1(s) - s) * grid.mask2dCv
    else:
        psi_u = -rate * area_u * (ip1(e) - e) * grid.mask2dCu
        psi_v = -rate * area_v * (jp1(e) - e) * grid.mask2dCv
    # the surface and bottom stay put: the column mass is unchanged
    zrow = torch.zeros_like(psi_u[:1])
    psi_u = torch.cat([zrow, psi_u[1:-1], zrow], dim=0)
    psi_v = torch.cat([zrow, psi_v[1:-1], zrow], dim=0)
    uhD = psi_u[:-1] - psi_u[1:]
    vhD = psi_v[:-1] - psi_v[1:]
    # no face drains more than a fifth of the upwind layer a step
    lim = 0.2 * grid.areaT * h / dt
    uhD = torch.minimum(torch.maximum(uhD, -ip1(lim)), lim)
    vhD = torch.minimum(torch.maximum(vhD, -jp1(lim)), lim)
    h_new = h - dt * grid.IareaT * ((uhD - im1(uhD)) + (vhD - jm1(vhD)))
    return torch.clamp(h_new, min=vgrid.angstrom), uhD, vhD
