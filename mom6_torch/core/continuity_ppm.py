"""Finite-volume PPM continuity solver, plain PyTorch.

Counterpart of ``mom6_tpu.core.continuity_ppm``: directionally split
thickness update with piecewise-parabolic edge reconstruction, the
positive-definite (or Colella-Woodward) limiter, upwind parabola-sweep
face fluxes, and the fixed-count clipped Newton iteration that makes
column transports match a barotropic transport.  Every shift is a
``torch.roll`` over the whole padded array, formula for formula as the
JAX package, so the two agree to roundoff everywhere.

On a grid with subgrid (porous-barrier) topography each sweep
multiplies its face mask by the open fraction of each layer, computed
from the thickness that enters that sweep (with ``x_first`` the y
sweep's from the x sweep's result).

This module is the plain version of kernels K1 and K2
(``continuity_cuda.py``); CUDA tensors go through those kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.porous_barriers import porous_widths_from_h
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["ContinuityCfg", "ContinuityResult", "BTContFaces",
           "continuity_ppm", "set_up_bt_cont", "ppm_edges_x",
           "ppm_edges_y", "zonal_mass_flux", "meridional_mass_flux",
           "porous_factor"]


@dataclasses.dataclass(frozen=True)
class ContinuityCfg:
    """CONTINUITY_SCHEME options (MOM_continuity_PPM.F90)."""
    upwind_1st: bool = False       # UPWIND_1ST_CONTINUITY
    simple_2nd: bool = False       # SIMPLE_2ND_PPM_CONTINUITY
    monotonic: bool = False        # MONOTONIC_CONTINUITY
    vol_cfl: bool = False          # CONT_PPM_VOLUME_BASED_CFL
    newton_iters: int = 6          # fixed Newton count for flux adjust
    cfl_limit: float = 0.9         # max CFL for velocity corrections


class ContinuityResult(NamedTuple):
    """h(n+1), the transports and, when the call matched barotropic
    transports, the corrected velocities u_cor = u + visc_rem*du and the
    2D corrections du_cor/dv_cor (which split RK2b carries across
    steps); None otherwise."""
    h: torch.Tensor
    uh: torch.Tensor
    vh: torch.Tensor
    u_cor: Optional[torch.Tensor] = None
    v_cor: Optional[torch.Tensor] = None
    du_cor: Optional[torch.Tensor] = None
    dv_cor: Optional[torch.Tensor] = None


class BTContFaces(NamedTuple):
    """Barotropic face-area curves (BT_cont_type); the field names and
    meanings are those of ``mom6_tpu.core.continuity_ppm.BTContFaces``."""
    FA_u_EE: torch.Tensor
    FA_u_E0: torch.Tensor
    FA_u_W0: torch.Tensor
    FA_u_WW: torch.Tensor
    uBT_EE: torch.Tensor
    uBT_WW: torch.Tensor
    FA_v_NN: torch.Tensor
    FA_v_N0: torch.Tensor
    FA_v_S0: torch.Tensor
    FA_v_SS: torch.Tensor
    vBT_NN: torch.Tensor
    vBT_SS: torch.Tensor


def _ppm_edges(h, mask, shift_p, shift_m, cfg: ContinuityCfg,
               h_min: float):
    """(h_minus, h_plus): thickness at the cell's lower- and
    higher-index edge along one direction."""
    if cfg.upwind_1st:
        return h, h
    m_p = shift_p(mask)
    m_m = shift_m(mask)
    h_p = m_p * shift_p(h) + (1.0 - m_p) * h
    h_m = m_m * shift_m(h) + (1.0 - m_m) * h
    if cfg.simple_2nd:
        return 0.5 * (h_m + h), 0.5 * (h_p + h)

    hp_raw, hm_raw = shift_p(h), shift_m(h)
    slp = 0.5 * (hp_raw - hm_raw)
    dMx = torch.maximum(torch.maximum(hp_raw, hm_raw), h) - h
    dMn = h - torch.minimum(torch.minimum(hp_raw, hm_raw), h)
    slp = torch.sign(slp) * torch.minimum(torch.abs(slp),
                                          2.0 * torch.minimum(dMx, dMn))
    slp = torch.where(shift_p(mask) * mask * shift_m(mask) > 0.0, slp, 0.0)

    one6 = 1.0 / 6.0
    h_minus = 0.5 * (h_m + h) + one6 * (shift_m(slp) - slp)
    h_plus = 0.5 * (h_p + h) + one6 * (slp - shift_p(slp))

    if cfg.monotonic:
        pc = (h_plus - h) * (h - h_minus) <= 0.0
        dh = h_plus - h_minus
        curv = 6.0 * h - 3.0 * (h_minus + h_plus)
        h_minus = torch.where(
            pc, h, torch.where(dh * curv > dh * dh,
                               3.0 * h - 2.0 * h_plus, h_minus))
        h_plus = torch.where(
            pc, h, torch.where(dh * curv < -dh * dh,
                               3.0 * h - 2.0 * h_minus, h_plus))
        return h_minus, h_plus

    # positive-definite limiter (PPM_limit_pos)
    curv = 3.0 * (h_minus + h_plus - 2.0 * h)
    dh = h_plus - h_minus
    interior_min = (curv > 0.0) & (torch.abs(dh) < curv)
    denom = curv * curv + 3.0 * dh * dh
    need_scale = 12.0 * curv * (h - h_min) < denom
    scale = torch.where(denom > 0.0,
                        12.0 * curv * torch.clamp(h - h_min, min=0.0)
                        / torch.where(denom > 0.0, denom, 1.0), 1.0)
    flat = interior_min & (h <= h_min)
    shrink = interior_min & (~flat) & need_scale
    h_minus = torch.where(flat, h, torch.where(
        shrink, h + scale * (h_minus - h), h_minus))
    h_plus = torch.where(flat, h, torch.where(
        shrink, h + scale * (h_plus - h), h_plus))
    return h_minus, h_plus


def ppm_edges_x(grid: Grid, h, cfg: ContinuityCfg, h_min: float):
    return _ppm_edges(h, grid.mask2dT, ip1, im1, cfg, h_min)


def ppm_edges_y(grid: Grid, h, cfg: ContinuityCfg, h_min: float):
    return _ppm_edges(h, grid.mask2dT, jp1, jm1, cfg, h_min)


def _flux_1dir(u, h, h_minus, h_plus, dt, dlen_face, Idx_up, Idx_dn,
               Iarea_up, Iarea_dn, shift_p, vol_cfl, face_mask,
               visc_rem):
    """Upwind PPM face flux and its velocity derivative; face i lies
    between cell i and cell i+1 (zonal_flux_layer)."""
    h_dn = shift_p(h)
    hW_dn = shift_p(h_minus)
    hE_up = h_plus
    hW_up = h_minus
    hE_dn = shift_p(h_plus)
    if vol_cfl:
        cfl_p = (u * dt) * (dlen_face * Iarea_up)
        cfl_m = (-u * dt) * (dlen_face * Iarea_dn)
    else:
        cfl_p = u * dt * Idx_up
        cfl_m = -u * dt * Idx_dn

    curv3_p = hW_up + hE_up - 2.0 * h
    flux_p = dlen_face * u * (
        hE_up + cfl_p * (0.5 * (hW_up - hE_up) + curv3_p * (cfl_p - 1.5)))
    marg_p = hE_up + cfl_p * ((hW_up - hE_up)
                              + 3.0 * curv3_p * (cfl_p - 1.0))
    curv3_m = hW_dn + hE_dn - 2.0 * h_dn
    flux_m = dlen_face * u * (
        hW_dn + cfl_m * (0.5 * (hE_dn - hW_dn) + curv3_m * (cfl_m - 1.5)))
    marg_m = hW_dn + cfl_m * ((hE_dn - hW_dn)
                              + 3.0 * curv3_m * (cfl_m - 1.0))
    pos = u > 0.0
    neg = u < 0.0
    flux = torch.where(pos, flux_p,
                       torch.where(neg, flux_m, 0.0)) * face_mask
    h_marg = torch.where(pos, marg_p,
                         torch.where(neg, marg_m, 0.5 * (hW_dn + hE_up)))
    dflux_du = dlen_face * h_marg * visc_rem * face_mask
    return flux, dflux_du


def _layer_sum(x):
    """Sum over the layer axis in order k = 0, 1, ..., as the CUDA
    kernels accumulate, so that the plain version and the kernels round
    alike (the BT_cont turn velocities magnify any difference)."""
    total = x[0]
    for k in range(1, x.shape[0]):
        total = total + x[k]
    return total


def _over_dt(x, dt: float):
    """x / dt as a true division on every device, as the JAX package and
    the kernels divide: PyTorch divides a CUDA tensor by a Python scalar
    as a product with the scalar's reciprocal, which rounds otherwise."""
    return x / torch.full((), dt, dtype=x.dtype, device=x.device)


def _newton_step(du, flux, dfdu, target, du_lim):
    err = _layer_sum(flux) - target
    denom = _layer_sum(dfdu)
    step = -err / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
    return torch.clamp(du + step, -du_lim, du_lim)


def _flux_adjust(u, h, h_minus, h_plus, dt, flux_args, hbt, visc_rem,
                 cfg: ContinuityCfg, dx_face):
    """Newton iteration for the per-face correction du with
    sum_k flux_k(u_k + visc_rem_k*du) = hbt (zonal_flux_adjust), clipped
    at cfl_limit*dx/dt after every step.  Returns (flux, u_cor, du)."""
    du = torch.zeros_like(hbt)
    du_lim = _over_dt(cfg.cfl_limit * dx_face, dt)
    for _ in range(cfg.newton_iters):
        flux, dfdu = _flux_1dir(u + visc_rem * du[None], h, h_minus,
                                h_plus, dt, *flux_args, visc_rem=visc_rem)
        du = _newton_step(du, flux, dfdu, hbt, du_lim)
    u_cor = u + visc_rem * du[None]
    flux, _ = _flux_1dir(u_cor, h, h_minus, h_plus, dt, *flux_args,
                         visc_rem=visc_rem)
    return flux, u_cor, du


def porous_factor(grid: Grid, h, stagger: str):
    """The open fraction (nk, njh, nih) of each layer at the U or V faces
    of a grid with subgrid (porous-barrier) topography, from the
    thickness ``h`` that enters the sweep; None on other grids.  It
    multiplies the face mask (por_face_areaU/V)."""
    return porous_widths_from_h(grid, h, stagger)["UV".index(stagger)]


def _args_x(grid: Grid, cfg: ContinuityCfg, por=None):
    mask = grid.mask2dCu if por is None else grid.mask2dCu * por
    return (grid.dyCu, grid.IdxT, ip1(grid.IdxT), grid.IareaT,
            ip1(grid.IareaT), ip1, cfg.vol_cfl, mask)


def _args_y(grid: Grid, cfg: ContinuityCfg, por=None):
    mask = grid.mask2dCv if por is None else grid.mask2dCv * por
    return (grid.dxCv, grid.IdyT, jp1(grid.IdyT), grid.IareaT,
            jp1(grid.IareaT), jp1, cfg.vol_cfl, mask)


def zonal_mass_flux(grid: Grid, u, h, h_W, h_E, dt, cfg: ContinuityCfg,
                    uhbt=None, visc_rem_u=None):
    """(uh, u_cor, du) at east faces; Newton-matched to ``uhbt`` if
    given (u_cor and du are None otherwise).  Porous faces pass the
    open fraction of each layer, taken from ``h``."""
    vr = visc_rem_u if visc_rem_u is not None else torch.ones_like(u)
    args = _args_x(grid, cfg, porous_factor(grid, h, "U"))
    if uhbt is None:
        return (_flux_1dir(u, h, h_W, h_E, dt, *args, visc_rem=vr)[0],
                None, None)
    return _flux_adjust(u, h, h_W, h_E, dt, args, uhbt, vr, cfg,
                        dx_face=grid.dxCu)


def meridional_mass_flux(grid: Grid, v, h, h_S, h_N, dt,
                         cfg: ContinuityCfg, vhbt=None, visc_rem_v=None):
    """(vh, v_cor, dv) at north faces; Newton-matched to ``vhbt`` if
    given."""
    vr = visc_rem_v if visc_rem_v is not None else torch.ones_like(v)
    args = _args_y(grid, cfg, porous_factor(grid, h, "V"))
    if vhbt is None:
        return (_flux_1dir(v, h, h_S, h_N, dt, *args, visc_rem=vr)[0],
                None, None)
    return _flux_adjust(v, h, h_S, h_N, dt, args, vhbt, vr, cfg,
                        dx_face=grid.dyCv)


def _bt_cont_1dir(u, h, h_minus, h_plus, dt, args, vr, cfg, dx_face):
    """One direction's face-area curve (set_zonal_BT_cont): probe the
    layered flux at the zero-transport correction du0 (3 Newton steps)
    and at CFL-limited corrections that make every layer flow one way,
    then fit the 3-segment marginal-area curve."""
    du0 = torch.zeros_like(u[0])
    du_lim = _over_dt(cfg.cfl_limit * dx_face, dt)
    for _ in range(3):
        flux, dfdu = _flux_1dir(u + vr * du0[None], h, h_minus, h_plus,
                                dt, *args, visc_rem=vr)
        du0 = _newton_step(du0, flux, dfdu, 0.0, du_lim)
    du_max = du_lim
    du_cfl = _over_dt(1.0e-6 * dx_face, dt)
    vr_max = torch.amax(vr, dim=0)
    vr_lim = torch.maximum(vr, 0.1 * vr_max[None]) + 1e-30
    duL_req = torch.amax((du_cfl[None] * vr - u) / vr_lim, dim=0)
    duL = torch.clamp(torch.maximum(du0 + du_cfl, duL_req),
                      torch.zeros_like(du_max), du_max)
    duR_req = torch.amin(-(u + du_cfl[None] * vr) / vr_lim, dim=0)
    duR = torch.clamp(torch.minimum(du0 - du_cfl, duR_req), -du_max,
                      torch.zeros_like(du_max))

    def probe(du):
        flux, dfdu = _flux_1dir(u + vr * du[None], h, h_minus, h_plus,
                                dt, *args, visc_rem=vr)
        return _layer_sum(flux), _layer_sum(dfdu)

    _, fa_0 = probe(du0)
    uh_l, fa_l = probe(duL)
    uh_r, fa_r = probe(duR)

    def fit(d_probe, uh_tot, fa_far):
        d_safe = torch.where(d_probe != 0.0, d_probe, 1.0)
        fa_avg = torch.where(d_probe != 0.0, uh_tot / d_safe, fa_0)
        hi = torch.maximum(fa_0, fa_far)
        lo = torch.minimum(fa_0, fa_far)
        fa0_adj = torch.where(fa_avg < lo, fa_avg, fa_0)
        fa_avg = torch.clamp(fa_avg, lo, hi)
        denom = fa_far - fa0_adj
        degen = torch.abs(denom) <= 1e-12 * torch.abs(fa0_adj)
        u_turn = torch.where(
            degen, 0.0,
            (1.5 * d_probe) * ((fa_far - fa_avg)
                               / torch.where(degen, 1.0, denom)))
        return fa0_adj, u_turn

    fa_w0, u_ww = fit(duL - du0, uh_l, fa_l)
    fa_e0, u_ee = fit(duR - du0, uh_r, fa_r)
    return (fa_r, fa_e0, fa_w0, fa_l, torch.clamp(u_ee, max=0.0),
            torch.clamp(u_ww, min=0.0))


def set_up_bt_cont(grid: Grid, vgrid: VerticalGrid, u, v, h, dt,
                   cfg: ContinuityCfg = ContinuityCfg(),
                   visc_rem_u=None, visc_rem_v=None) -> BTContFaces:
    """Both directions' BT_cont face-area curves from the current state
    (set_up_BT_cont, MOM_continuity_PPM.F90:757).  Its face masks are
    the plain ones on a porous grid too, as the JAX package's are."""
    hmin2 = 2.0 * vgrid.angstrom
    vru = visc_rem_u if visc_rem_u is not None else torch.ones_like(u)
    vrv = visc_rem_v if visc_rem_v is not None else torch.ones_like(v)
    h_W, h_E = ppm_edges_x(grid, h, cfg, hmin2)
    x = _bt_cont_1dir(u, h, h_W, h_E, dt, _args_x(grid, cfg), vru, cfg,
                      grid.dxCu)
    h_S, h_N = ppm_edges_y(grid, h, cfg, hmin2)
    y = _bt_cont_1dir(v, h, h_S, h_N, dt, _args_y(grid, cfg), vrv, cfg,
                      grid.dyCv)
    return BTContFaces(*x, *y)


def continuity_ppm(grid: Grid, vgrid: VerticalGrid, u, v, h, dt,
                   cfg: ContinuityCfg = ContinuityCfg(),
                   uhbt=None, vhbt=None,
                   visc_rem_u=None, visc_rem_v=None,
                   x_first: bool = True) -> ContinuityResult:
    """h(n+1), uh, vh from the directionally split PPM update
    (continuity_PPM).  Inputs need 4 valid halo rings; the result's
    compute domain is valid, its halos are not."""
    h_min = vgrid.angstrom
    hmin2 = 2.0 * vgrid.angstrom

    def x_sweep(hx):
        h_W, h_E = ppm_edges_x(grid, hx, cfg, hmin2)
        uh, u_cor, du = zonal_mass_flux(grid, u, hx, h_W, h_E, dt, cfg,
                                        uhbt=uhbt, visc_rem_u=visc_rem_u)
        h_new = torch.clamp(hx - dt * grid.IareaT * (uh - im1(uh)),
                            min=h_min)
        return h_new, uh, u_cor, du

    def y_sweep(hy):
        h_S, h_N = ppm_edges_y(grid, hy, cfg, hmin2)
        vh, v_cor, dv = meridional_mass_flux(grid, v, hy, h_S, h_N, dt,
                                             cfg, vhbt=vhbt,
                                             visc_rem_v=visc_rem_v)
        h_new = torch.clamp(hy - dt * grid.IareaT * (vh - jm1(vh)),
                            min=h_min)
        return h_new, vh, v_cor, dv

    if x_first:
        h1, uh, u_cor, du = x_sweep(h)
        h2, vh, v_cor, dv = y_sweep(h1)
    else:
        h1, vh, v_cor, dv = y_sweep(h)
        h2, uh, u_cor, du = x_sweep(h1)
    return ContinuityResult(h=h2, uh=uh, vh=vh, u_cor=u_cor, v_cor=v_cor,
                            du_cor=du, dv_cor=dv)
