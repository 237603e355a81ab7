"""Thickness (Gent-McWilliams) diffusion.

Counterpart of ``mom6_tpu.param.lateral.thickness_diffuse``:
interface-height diffusion through a streamfunction at interfaces,
psi(K) = -KhTh dy (e(i+1,K) - e(i,K)) / dx, zero at the surface and
bottom, so the layer transports uhD(k) = psi(K) - psi(K+1) move no net
column mass.  The coefficient is the constant KHTH or a 2-D field at h
points (the MEKE/VarMix chain, capped by KHTH_MAX) averaged to faces,
optionally scaled by the face resolution functions (RESOLN_SCALED_KHTH);
the face coefficient is bounded by KHTH_MAX_CFL and each face transport
by a fifth of the upwind layer's volume per step.  Also returns the
column PE-release rate (the GM source of MEKE) on the given interface
reduced gravities, or on the target-density ones.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.pressure_force import interface_heights
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["ThicknessDiffuseCfg", "ThicknessDiffuseResult",
           "thickness_diffuse"]


@dataclasses.dataclass(frozen=True)
class ThicknessDiffuseCfg:
    khth: float = 0.0              # KHTH [m2 s-1]
    khth_max_cfl: float = 0.1      # stability bound on the applied Kh
    khth_max: float = 0.0          # KHTH_MAX cap on 2D coefficients


class ThicknessDiffuseResult(NamedTuple):
    h: torch.Tensor
    uhD: torch.Tensor     # diffusive layer transports [m3 s-1]
    vhD: torch.Tensor
    gm_work: Optional[torch.Tensor] = None


def _rev_cumsum0(x):
    return torch.flip(torch.cumsum(torch.flip(x, [0]), dim=0), [0])


def thickness_diffuse(grid: Grid, vgrid: VerticalGrid, h, dt,
                      cfg: ThicknessDiffuseCfg, khth_2d=None,
                      gprime_int=None, res_u=None, res_v=None):
    """Apply interface-height diffusion over dt; h needs 2 halo rings.
    ``khth_2d``: an (njh, nih) coefficient replacing KHTH; ``res_u``/
    ``res_v``: face factors on the coefficient; ``gprime_int``: the
    (nk+1, njh, nih) interface reduced gravities of the PE release."""
    if cfg.khth <= 0.0 and khth_2d is None:
        z = torch.zeros_like(h)
        return ThicknessDiffuseResult(h=h, uhD=z, vhD=z,
                                      gm_work=torch.zeros_like(h[0]))

    e = interface_heights(vgrid, h, grid.bathyT)
    if khth_2d is not None:
        kh = khth_2d
        if cfg.khth_max > 0.0:
            kh = torch.clamp(kh, max=cfg.khth_max)
        kh_u0 = 0.5 * (kh + ip1(kh))
        kh_v0 = 0.5 * (kh + jp1(kh))
    else:
        kh_u0 = kh_v0 = cfg.khth
    if res_u is not None:
        kh_u0 = kh_u0 * res_u
    if res_v is not None:
        kh_v0 = kh_v0 * res_v
    kh_u = torch.clamp(cfg.khth_max_cfl * grid.dxCu * grid.dxCu / dt,
                       max=kh_u0)
    kh_v = torch.clamp(cfg.khth_max_cfl * grid.dyCv * grid.dyCv / dt,
                       max=kh_v0)
    de_u = (ip1(e) - e) * grid.mask2dCu
    de_v = (jp1(e) - e) * grid.mask2dCv
    psi_u = -kh_u * grid.dyCu * grid.IdxCu * de_u
    psi_v = -kh_v * grid.dxCv * grid.IdyCv * de_v
    zrow = torch.zeros_like(psi_u[:1])
    psi_u = torch.cat([zrow, psi_u[1:-1], zrow], dim=0)
    psi_v = torch.cat([zrow, psi_v[1:-1], zrow], dim=0)
    uhD = psi_u[:-1] - psi_u[1:]
    vhD = psi_v[:-1] - psi_v[1:]

    lim = 0.2 * grid.areaT * h / dt
    uhD = torch.minimum(torch.maximum(uhD, -ip1(lim)), lim)
    vhD = torch.minimum(torch.maximum(vhD, -jp1(lim)), lim)

    # PE release rate with the streamfunction rebuilt from the clipped
    # transports
    if gprime_int is not None:
        gp = torch.clamp(gprime_int, min=0.0)
    else:
        rl = vgrid.Rlay
        gprime = torch.clamp(vgrid.g_Earth * (rl[1:] - rl[:-1])
                             / vgrid.Rho0, min=0.0)
        gz = torch.zeros(1, dtype=h.dtype, device=h.device)
        gp = torch.cat([gz, gprime, gz]).reshape(-1, 1, 1)
    psi_u_eff = torch.cat([_rev_cumsum0(uhD), zrow], dim=0)
    psi_v_eff = torch.cat([_rev_cumsum0(vhD), zrow], dim=0)
    wu = torch.sum(-gp * psi_u_eff * de_u * grid.IdxCu, dim=0)
    wv = torch.sum(-gp * psi_v_eff * de_v * grid.IdyCv, dim=0)
    gm_work = (torch.clamp(0.5 * (wu + im1(wu)), min=0.0)
               + torch.clamp(0.5 * (wv + jm1(wv)), min=0.0)) * grid.mask2dT

    h_new = h - dt * grid.IareaT * ((uhD - im1(uhD)) + (vhD - jm1(vhD)))
    h_new = torch.clamp(h_new, min=vgrid.angstrom)
    return ThicknessDiffuseResult(h=h_new, uhD=uhD, vhD=vhD,
                                  gm_work=gm_work)
