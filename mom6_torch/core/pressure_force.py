"""Pressure-gradient accelerations, Boussinesq.

Counterpart of ``mom6_tpu.core.pressure_force``: the finite-volume form
(PressureForce_FV_Bouss) with per-layer target densities or, given T/S
and an equation of state, layer-mean in-situ densities (midpoint or
5-point Boole quadrature through each layer, optionally on a limited
PLM profile of T/S), the layered Montgomery form, and
``set_pbce_bouss``, all with the full surface gravity (GFS_SCALE = 1).
Interface heights e (nk+1, njh, nih): e[0] the free surface,
e[nk] = -bathyT.  Tides/SAL, the Stanley density correction and the
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
    quad_points: int = 1         # 1: midpoint, 5: Boole rule per layer
    reconstruct: bool = False    # RECONSTRUCT_FOR_PRESSURE (PLM T/S)


class PressureForceResult(NamedTuple):
    PFu: torch.Tensor
    PFv: torch.Tensor
    pbce: torch.Tensor
    eta_pf: torch.Tensor


def _rev_cumsum0(x):
    return torch.flip(torch.cumsum(torch.flip(x, [0]), dim=0), [0])


_BOOLE_W = (7.0 / 90.0, 32.0 / 90.0, 12.0 / 90.0, 32.0 / 90.0,
            7.0 / 90.0)


def _plm_profile(t):
    """Monotonized-central limited PLM edge values (t_top, t_bot) of a
    layer-mean profile, the layer mean preserved."""
    t_up = torch.cat([t[:1], t[:-1]], dim=0)
    t_dn = torch.cat([t[1:], t[-1:]], dim=0)
    d_up = t - t_up
    d_dn = t_dn - t
    slp = 0.5 * (d_up + d_dn)
    lim = 2.0 * torch.minimum(torch.abs(d_up), torch.abs(d_dn))
    slp = torch.sign(slp) * torch.minimum(torch.abs(slp), lim)
    slp = torch.where(d_up * d_dn > 0.0, slp, 0.0)
    return t - 0.5 * slp, t + 0.5 * slp


def _layer_densities(vgrid: VerticalGrid, h, e, T, S, eos, rho0, g,
                     quad_points: int = 1, reconstruct: bool = False):
    """Layer-mean density (nk, njh, nih): the target densities without
    an EOS; with one, the EOS at the layer's mid-pressure or averaged
    over 5 Boole-rule levels (on the PLM T/S profile with
    ``reconstruct``)."""
    if T is None or eos is None:
        return vgrid.Rlay.reshape(-1, 1, 1).expand(h.shape)
    if quad_points == 5:
        if reconstruct:
            T_t, T_b = _plm_profile(T)
            S_t, S_b = _plm_profile(S)
        rho = 0.0
        for m, w in enumerate(_BOOLE_W):
            frac = m / 4.0
            z = e[:-1] * (1.0 - frac) + e[1:] * frac
            if reconstruct:
                Tm = T_t * (1.0 - frac) + T_b * frac
                Sm = S_t * (1.0 - frac) + S_b * frac
            else:
                Tm, Sm = T, S
            rho = rho + w * eos.density(Tm, Sm, -rho0 * g * z)
        return rho
    if quad_points != 1:
        raise ValueError(f"quad_points must be 1 or 5, not {quad_points}")
    z_mid = 0.5 * (e[:-1] + e[1:])
    return eos.density(T, S, -rho0 * g * z_mid)


def interface_heights(vgrid: VerticalGrid, h, bathyT):
    """e[K], K=0..nk: reverse cumulative sum of h above -bathyT."""
    above_bottom = torch.cat([_rev_cumsum0(h), torch.zeros_like(h[:1])],
                             dim=0)
    return -bathyT[None] + above_bottom


def pressure_force(grid: Grid, vgrid: VerticalGrid, h, T=None, S=None,
                   eos=None, p_atm=None,
                   cfg: PressureForceCfg = PressureForceCfg(),
                   e_tidal=None) -> PressureForceResult:
    """PFu, PFv, pbce and the free surface used
    (PressureForce_FV_Bouss)."""
    if not vgrid.boussinesq:
        raise NotImplementedError("non-Boussinesq pressure force")
    if e_tidal is not None:
        raise NotImplementedError("tides: tidal/SAL geopotential")
    g = vgrid.g_Earth
    rho0 = vgrid.Rho0
    I_rho0 = 1.0 / rho0
    e = interface_heights(vgrid, h, grid.bathyT)
    if cfg.montgomery and (T is None or eos is None):
        return _montgomery_bouss(grid, vgrid, e, p_atm)

    rho = _layer_densities(vgrid, h, e, T, S, eos, rho0, g,
                           cfg.quad_points, cfg.reconstruct)
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
                               pbce=set_pbce_bouss(vgrid, e, T, S, eos),
                               eta_pf=e[0])


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


def set_pbce_bouss(vgrid: VerticalGrid, e, T=None, S=None, eos=None):
    """pbce[k] = d(layer k PG accel)/d(column eta) (Set_pbce_Bouss):
    from the reduced gravities, or from the EOS's surface density and
    its T/S derivatives at the interfaces."""
    Ihtot = 1.0 / ((e[0] - e[-1]) + _DZ_NEGLECT)
    if T is None or eos is None:
        gp = vgrid.g_prime
        pbce0 = gp[0] * torch.ones_like(e[0])
        incs = gp[1:-1].reshape(-1, 1, 1) \
            * ((e[1:-1] - e[-1][None]) * Ihtot)
    else:
        g, rho0 = vgrid.g_Earth, vgrid.Rho0
        pbce0 = (g / rho0) * eos.density(T[0], S[0], -rho0 * g * e[0])
        dRdT, dRdS = eos.density_derivs(0.5 * (T[:-1] + T[1:]),
                                        0.5 * (S[:-1] + S[1:]),
                                        -rho0 * g * e[1:-1])
        incs = (g / rho0) * ((e[1:-1] - e[-1][None]) * Ihtot) * (
            dRdT * (T[1:] - T[:-1]) + dRdS * (S[1:] - S[:-1]))
    return pbce0[None] + torch.cat(
        [torch.zeros_like(pbce0)[None], torch.cumsum(incs, dim=0)], dim=0)
