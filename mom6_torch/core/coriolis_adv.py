"""Coriolis force and momentum advection, vector-invariant form.

Counterpart of ``mom6_tpu.core.coriolis_adv`` for its default
discretization: the SADOURNY75_ENERGY PV flux with the KE_ARAKAWA
kinetic-energy gradient, free slip,

    CAu =  <q vh> - d(KE)/dx ,   CAv = - <q uh> - d(KE)/dy ,

with q the layer potential vorticity at corner (B) points.  The other
schemes raise ``NotImplementedError``; NOSLIP, BOUND_CORIOLIS and
CORIOLIS_EN_DIS are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["CoriolisCfg", "CoriolisResult", "coriolis_adv",
           "relative_vorticity"]

_VOL_NEGLECT = 1e-30


@dataclasses.dataclass(frozen=True)
class CoriolisCfg:
    scheme: str = "SADOURNY75_ENERGY"   # CORIOLIS_SCHEME
    ke_scheme: str = "KE_ARAKAWA"       # KE_SCHEME


class CoriolisResult(NamedTuple):
    CAu: torch.Tensor
    CAv: torch.Tensor
    rel_vort: torch.Tensor
    pv: torch.Tensor


def relative_vorticity(grid: Grid, u, v):
    """Free-slip relative vorticity at corners."""
    dvdx = ip1(grid.dyCv * v) - grid.dyCv * v
    dudy = jp1(grid.dxCu * u) - grid.dxCu * u
    return grid.mask2dBu * (dvdx - dudy) * grid.IareaBu


def coriolis_adv(grid: Grid, u, v, h, uh, vh,
                 cfg: CoriolisCfg = CoriolisCfg()) -> CoriolisResult:
    """CorAdCalc: (CAu, CAv) [m s-2].  u, v, h need 2 valid halo rings,
    uh, vh one."""
    if cfg.scheme != "SADOURNY75_ENERGY":
        raise NotImplementedError(f"CORIOLIS_SCHEME {cfg.scheme}")
    if cfg.ke_scheme != "KE_ARAKAWA":
        raise NotImplementedError(f"KE_SCHEME {cfg.ke_scheme}")
    rv = relative_vorticity(grid, u, v)
    abs_vort = grid.CoriolisBu + rv
    Area_h = grid.mask2dT * grid.areaT
    Area_q = (Area_h + ip1(jp1(Area_h))) + (ip1(Area_h) + jp1(Area_h))
    Ahh = Area_h * h
    hArea_u = 0.5 * (Ahh + ip1(Ahh))
    hArea_v = 0.5 * (Ahh + jp1(Ahh))
    hArea_q = (hArea_u + jp1(hArea_u)) + (hArea_v + ip1(hArea_v))
    q = abs_vort * (Area_q / (hArea_q + _VOL_NEGLECT))

    A = q * (vh + ip1(vh))
    CAu = 0.25 * (A + jm1(A)) * grid.IdxCu
    B = q * (uh + jp1(uh))
    CAv = -0.25 * (B + im1(B)) * grid.IdyCv

    au2 = grid.areaCu * u * u
    av2 = grid.areaCv * v * v
    KE = ((au2 + im1(au2)) + (av2 + jm1(av2))) * 0.25 * grid.IareaT
    CAu = (CAu - (ip1(KE) - KE) * grid.IdxCu) * grid.mask2dCu
    CAv = (CAv - (jp1(KE) - KE) * grid.IdyCv) * grid.mask2dCv
    return CoriolisResult(CAu=CAu, CAv=CAv, rel_vort=rv, pv=q)
