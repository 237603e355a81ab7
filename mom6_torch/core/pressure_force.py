"""Pressure-gradient accelerations, Boussinesq, layered densities.

Counterpart of ``mom6_tpu.core.pressure_force`` for ``eos=None``: the
finite-volume form (PressureForce_FV_Bouss) with per-layer target
densities, the layered Montgomery form, and ``set_pbce_bouss``, all
with the full surface gravity (GFS_SCALE = 1).  Interface heights e (nk+1, njh, nih): e[0] the free surface,
e[nk] = -bathyT.  An equation of state, tides/SAL and the
non-Boussinesq form are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, jp1

__all__ = ["PressureForceCfg", "PressureForceResult", "pressure_force",
           "interface_heights", "set_pbce_bouss"]

_H_NEGLECT = 1e-30
_DZ_NEGLECT = 1e-30


@dataclasses.dataclass(frozen=True)
class PressureForceCfg:
    rho_ref: float = 1035.0      # RHO_PGF_REF
    montgomery: bool = False     # ANALYTIC_FV_PGF=False


class PressureForceResult(NamedTuple):
    PFu: torch.Tensor
    PFv: torch.Tensor
    pbce: torch.Tensor
    eta_pf: torch.Tensor


def _rev_cumsum0(x):
    return torch.flip(torch.cumsum(torch.flip(x, [0]), dim=0), [0])


def interface_heights(vgrid: VerticalGrid, h, bathyT):
    """e[K], K=0..nk: reverse cumulative sum of h above -bathyT."""
    above_bottom = torch.cat([_rev_cumsum0(h), torch.zeros_like(h[:1])],
                             dim=0)
    return -bathyT[None] + above_bottom


def pressure_force(grid: Grid, vgrid: VerticalGrid, h, T=None, S=None,
                   eos=None, p_atm=None,
                   cfg: PressureForceCfg = PressureForceCfg(),
                   e_tidal=None) -> PressureForceResult:
    """PFu, PFv, pbce and the free surface used (PressureForce_FV_Bouss
    with layer target densities)."""
    if not vgrid.boussinesq:
        raise NotImplementedError("non-Boussinesq pressure force")
    if eos is not None:
        raise NotImplementedError("pressure force with an equation of "
                                  "state")
    if e_tidal is not None:
        raise NotImplementedError("tides: tidal/SAL geopotential")
    g = vgrid.g_Earth
    rho0 = vgrid.Rho0
    I_rho0 = 1.0 / rho0
    e = interface_heights(vgrid, h, grid.bathyT)
    if cfg.montgomery:
        return _montgomery_bouss(grid, vgrid, e, p_atm)

    rho = vgrid.Rlay.reshape(-1, 1, 1).expand(h.shape)
    rho_ref = cfg.rho_ref
    pa_surf = (rho_ref * g) * e[0]
    if p_atm is not None:
        pa_surf = pa_surf + p_atm
    dpa = g * (rho - rho_ref) * h
    pa_int = pa_surf[None] + torch.cat(
        [torch.zeros_like(dpa[:1]), torch.cumsum(dpa, dim=0)], dim=0)
    pa_top = pa_int[:-1]
    intz_dpa = 0.5 * g * (rho - rho_ref) * h * h

    def _dir(shift, Idx_face, mask_face):
        pa_n = shift(pa_top)
        h_n = shift(h)
        intz_n = shift(intz_dpa)
        e_bot = e[1:]
        e_bot_n = shift(e_bot)
        intx_pa = 0.5 * (pa_top + pa_n)
        intx_dpa = 0.5 * (dpa + shift(dpa))
        PF = (((pa_top * h + intz_dpa) - (pa_n * h_n + intz_n))
              + ((h_n - h) * intx_pa - (e_bot_n - e_bot) * intx_dpa)) \
            * ((2.0 * I_rho0 * Idx_face) / ((h + h_n) + _H_NEGLECT))
        return PF * mask_face

    PFu = _dir(ip1, grid.IdxCu, grid.mask2dCu)
    PFv = _dir(jp1, grid.IdyCv, grid.mask2dCv)
    return PressureForceResult(PFu=PFu, PFv=PFv,
                               pbce=set_pbce_bouss(vgrid, e), eta_pf=e[0])


def _montgomery_bouss(grid: Grid, vgrid: VerticalGrid, e,
                      p_atm) -> PressureForceResult:
    """Layered Montgomery-potential form (PressureForce_Mont_Bouss)."""
    gp = vgrid.g_prime.reshape(-1, 1, 1)
    contrib = torch.cat([gp[0:1] * e[0:1], gp[1:-1] * e[1:-1]], dim=0)
    M = torch.cumsum(contrib, dim=0)
    if p_atm is not None:
        M = M + (p_atm / vgrid.Rho0)[None]
    PFu = -(ip1(M) - M) * grid.IdxCu * grid.mask2dCu
    PFv = -(jp1(M) - M) * grid.IdyCv * grid.mask2dCv
    return PressureForceResult(PFu=PFu, PFv=PFv,
                               pbce=set_pbce_bouss(vgrid, e), eta_pf=e[0])


def set_pbce_bouss(vgrid: VerticalGrid, e):
    """pbce[k] = d(layer k PG accel)/d(column eta) for layered densities
    (Set_pbce_Bouss)."""
    Ihtot = 1.0 / ((e[0] - e[-1]) + _DZ_NEGLECT)
    gp = vgrid.g_prime
    pbce0 = gp[0] * torch.ones_like(e[0])
    incs = gp[1:-1].reshape(-1, 1, 1) * ((e[1:-1] - e[-1][None]) * Ihtot)
    return pbce0[None] + torch.cat(
        [torch.zeros_like(pbce0)[None], torch.cumsum(incs, dim=0)], dim=0)
