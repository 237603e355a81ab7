"""Pressure-gradient accelerations.

Counterpart of ``mom6_tpu.core.pressure_force``: the Boussinesq
finite-volume form (PressureForce_FV_Bouss) with per-layer target
densities or, given T/S and an equation of state, layer-mean in-situ
densities (midpoint or 5-point Boole quadrature through each layer,
optionally on a limited PLM profile of T/S) and the Stanley
subgrid-variance correction (USE_STANLEY_PGF); the layered Montgomery
form; the non-Boussinesq specific-volume form
(PressureForce_FV_nonBouss, semi-Boussinesq units: h carries mass,
Rho0 h per unit area) with ``set_pbce_nonbouss``; and ``set_pbce_bouss``.
A tidal/SAL geopotential height ``e_tidal`` shifts the heights (or
the bottom geopotential) the gradient is taken on.  All with the full
surface gravity (GFS_SCALE = 1).  Interface heights e (nk+1, njh,
nih): e[0] the free surface, e[nk] = -bathyT.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.stoch_eos import calc_varT, density_second_dT2
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, jp1

__all__ = ["PressureForceCfg", "PressureForceResult", "pressure_force",
           "interface_heights", "set_pbce_bouss", "set_pbce_nonbouss"]

_H_NEGLECT = 1e-30
_DZ_NEGLECT = 1e-30


@dataclasses.dataclass(frozen=True)
class PressureForceCfg:
    rho_ref: float = 1035.0      # RHO_PGF_REF
    montgomery: bool = False     # ANALYTIC_FV_PGF=False
    quad_points: int = 1         # 1: midpoint, 5: Boole rule per layer
    reconstruct: bool = False    # RECONSTRUCT_FOR_PRESSURE (PLM T/S)
    # USE_STANLEY_PGF: rho += 0.5 varT d2rho/dT2 with varT from
    # calc_varT at this coefficient; < 0 disables
    stanley_coeff: float = -1.0  # STANLEY_COEFF


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
                   e_tidal=None, varT_mult=None) -> PressureForceResult:
    """PFu, PFv, pbce and the free surface used
    (PressureForce_FV_Bouss, or PressureForce_FV_nonBouss when
    ``vgrid.boussinesq`` is False).  ``e_tidal``: the tidal + SAL
    geopotential height anomaly [m] at h points; the heights are taken
    from the perturbed equipotential, and the returned free surface
    stays the true one.  ``varT_mult``: STOCH_EOS's (njh, nih)
    multiplier exp(a pattern) of the Stanley variance."""
    if not vgrid.boussinesq:
        return _pressure_force_nonbouss(grid, vgrid, h, T, S, eos, p_atm,
                                        cfg, e_tidal)
    g = vgrid.g_Earth
    rho0 = vgrid.Rho0
    I_rho0 = 1.0 / rho0
    e_true = interface_heights(vgrid, h, grid.bathyT)
    e = e_true if e_tidal is None else e_true - e_tidal[None]
    if cfg.montgomery and (T is None or eos is None):
        return _montgomery_bouss(grid, vgrid, e, p_atm)._replace(
            eta_pf=e_true[0])

    rho = _layer_densities(vgrid, h, e, T, S, eos, rho0, g,
                           cfg.quad_points, cfg.reconstruct)
    if cfg.stanley_coeff >= 0.0 and T is not None and eos is not None:
        p_mid = -rho0 * g * 0.5 * (e[:-1] + e[1:])
        varT = calc_varT(grid, h, T, cfg.stanley_coeff)
        if varT_mult is not None:
            varT = varT * varT_mult[None]
        rho = rho + 0.5 * varT * density_second_dT2(eos, T, S, p_mid)
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
                               eta_pf=e_true[0])


def _pressure_force_nonbouss(grid: Grid, vgrid: VerticalGrid, h, T, S,
                             eos, p_atm, cfg: PressureForceCfg,
                             e_tidal) -> PressureForceResult:
    """The non-Boussinesq finite-volume form (PressureForce_FV_nonBouss):
    pressure is the mass coordinate (interface pressures accumulate
    g Rho0 h downward), and the geopotential anomaly za = g z +
    alpha_ref p integrates upward from the bottom through
    dza = int (alpha - alpha_ref) dp per layer (Boole or midpoint
    quadrature in p); with the 2-point face quadrature the up-then-down
    ordering of the reference collapses to face means of za."""
    if cfg.stanley_coeff >= 0.0:
        raise ValueError("USE_STANLEY_PGF is not available with "
                         "BOUSSINESQ = False")
    g = vgrid.g_Earth
    H_to_P = g * vgrid.Rho0
    alpha_ref = 1.0 / cfg.rho_ref
    dp_neglect = H_to_P * 1e-30

    dp = H_to_P * h
    p_surf = p_atm if p_atm is not None else torch.zeros_like(h[0])
    p_int = p_surf[None] + torch.cat(
        [torch.zeros_like(dp[:1]), torch.cumsum(dp, dim=0)], dim=0)
    p_top, p_bot = p_int[:-1], p_int[1:]
    # dza = int alpha' dp, intp_dza = int (p - p_top) alpha' dp per layer
    if T is None or eos is None:
        a_anom = (1.0 / vgrid.Rlay - alpha_ref).reshape(-1, 1, 1)
        dza = a_anom * dp
        intp_dza = 0.5 * a_anom * dp * dp
    elif cfg.quad_points == 5:
        s0 = s1 = 0.0
        for m, w in enumerate(_BOOLE_W):
            frac = m / 4.0
            p_m = p_top * (1.0 - frac) + p_bot * frac
            a_m = 1.0 / eos.density(T, S, p_m) - alpha_ref
            s0 = s0 + w * a_m
            s1 = s1 + (w * frac) * a_m
        dza = s0 * dp
        intp_dza = s1 * dp * dp
    else:
        a_mid = 1.0 / eos.density(T, S, 0.5 * (p_top + p_bot)) - alpha_ref
        dza = a_mid * dp
        intp_dza = 0.5 * a_mid * dp * dp

    za_surf = (alpha_ref * p_int[-1] - g * grid.bathyT
               + torch.sum(dza, dim=0))
    if e_tidal is not None:
        za_surf = za_surf - g * e_tidal
    za_bot = za_surf[None] - torch.cumsum(dza, dim=0)

    def _dir(shift, Idx_face, mask_face):
        dp_n = shift(dp)
        zb_n = shift(za_bot)
        ip_n = shift(intp_dza)
        intx_dza = 0.5 * (dza + shift(dza))
        intx_za = 0.5 * (za_bot + zb_n)
        PF = (((za_bot * dp + intp_dza) - (zb_n * dp_n + ip_n))
              + ((dp_n - dp) * intx_za
                 - (shift(p_top) - p_top) * intx_dza)) \
            * ((2.0 * Idx_face) / ((dp + dp_n) + dp_neglect))
        return PF * mask_face

    PFu = _dir(ip1, grid.IdxCu, grid.mask2dCu)
    PFv = _dir(jp1, grid.IdyCv, grid.mask2dCv)
    return PressureForceResult(
        PFu=PFu, PFv=PFv, pbce=set_pbce_nonbouss(vgrid, p_int, T, S, eos),
        eta_pf=interface_heights(vgrid, h, grid.bathyT)[0])


def set_pbce_nonbouss(vgrid: VerticalGrid, p_int, T=None, S=None,
                      eos=None):
    """pbce[k] = d(layer k PG accel)/d(column eta in H units)
    (Set_pbce_nonBouss), built upward from the bottom: the deepest
    layer feels dP_dH / rho_bottom, and each interface adds its
    specific-volume jump weighted by (p_int - p_surf) / (p_bot -
    p_surf)."""
    g = vgrid.g_Earth
    dP_dH = g * vgrid.Rho0
    C_htot = dP_dH / ((p_int[-1] - p_int[0]) + dP_dH * 1e-30)
    if T is not None and eos is not None:
        pbce_nz = dP_dH / eos.density(T[-1], S[-1], p_int[-1])
        T_i = 0.5 * (T[:-1] + T[1:])
        S_i = 0.5 * (S[:-1] + S[1:])
        p_i = p_int[1:-1]
        rho_i = eos.density(T_i, S_i, p_i)
        dRdT, dRdS = eos.density_derivs(T_i, S_i, p_i)
        incs = ((p_i - p_int[0:1]) * C_htot[None]) * (
            (dRdT * (T[1:] - T[:-1]) + dRdS * (S[1:] - S[:-1]))
            / (rho_i * rho_i))
    else:
        alpha_lay = (1.0 / vgrid.Rlay).reshape(-1, 1, 1)
        pbce_nz = dP_dH * alpha_lay[-1] * torch.ones_like(p_int[0])
        incs = ((p_int[1:-1] - p_int[0:1]) * C_htot) * (
            alpha_lay[:-1] - alpha_lay[1:])
    rev = _rev_cumsum0(incs)
    return pbce_nz[None] + torch.cat([rev, torch.zeros_like(rev[:1])],
                                     dim=0)


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
