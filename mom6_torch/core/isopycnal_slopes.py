"""Neutral (isoneutral) slopes (counterpart of
``mom6_tpu.core.isopycnal_slopes``): the x/y slopes of neutral surfaces
at the u/v-point interior interfaces, S_x = -(drho/dx)|_z / (drho/dz)
with z up, from the EOS derivatives at interface pressure, with the N^2
floor and the slope clipping of the parameterizations that use them
(VarMix's USE_STORED_SLOPES, neutral diffusion)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, jp1

__all__ = ["SlopeCfg", "SlopeResult", "isoneutral_slopes"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class SlopeCfg:
    slope_max: float = 0.01       # clip |S|
    n2_floor: float = 1e-8        # minimum stratification [s-2]


class SlopeResult(NamedTuple):
    slope_x: torch.Tensor    # (nk-1, ...) at u-point interior interfaces
    slope_y: torch.Tensor    # at v points
    n2: torch.Tensor         # at h-point interfaces


def isoneutral_slopes(cfg: SlopeCfg, grid: Grid, vgrid: VerticalGrid,
                      h, T, S, eos) -> SlopeResult:
    g, rho0 = vgrid.g_Earth, vgrid.Rho0
    p_int = rho0 * g * torch.cumsum(h, dim=0)[:-1]
    T_i = 0.5 * (T[:-1] + T[1:])
    S_i = 0.5 * (S[:-1] + S[1:])
    dRdT, dRdS = eos.density_derivs(T_i, S_i, p_int)
    dz = 0.5 * (h[:-1] + h[1:]) + _EPS
    drho_dz = (dRdT * (T[1:] - T[:-1]) + dRdS * (S[1:] - S[:-1])) / dz
    n2 = torch.clamp((g / rho0) * drho_dz, min=cfg.n2_floor)
    drho_dz = torch.clamp(drho_dz, min=cfg.n2_floor * rho0 / g)

    def horiz(shift, Idx):
        dT = (shift(T_i) - T_i) * Idx
        dS = (shift(S_i) - S_i) * Idx
        drho_dx = 0.5 * (dRdT + shift(dRdT)) * dT \
            + 0.5 * (dRdS + shift(dRdS)) * dS
        dz_f = 0.5 * (drho_dz + shift(drho_dz))
        # drho_dz is +d rho/d depth, so the z-up slope is +drho_dx/drho_dz
        s = drho_dx / torch.clamp(dz_f, min=_EPS)
        return torch.clamp(s, -cfg.slope_max, cfg.slope_max)

    return SlopeResult(slope_x=horiz(ip1, grid.IdxCu) * grid.mask2dCu,
                       slope_y=horiz(jp1, grid.IdyCv) * grid.mask2dCv,
                       n2=n2)
