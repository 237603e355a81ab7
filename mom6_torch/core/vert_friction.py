"""Implicit vertical viscosity and the visc_rem coupling fractions.

Counterpart of ``mom6_tpu.core.vert_friction``: ``set_viscous_bbl``
(bottom boundary layer piston velocity and thickness), ``vertvisc_coef``
(interface coupling coefficients), ``implicit_visc_solve`` (the Thomas
recursion over layers, vectorized over columns), ``vertvisc``,
``vertvisc_remnant`` and ``vertvisc_limit_vel``, with the quadratic
bottom drag and the stratified/rotational BBL thickness (its
stratification from the target densities, or from the EOS with
BBL_USE_EOS; a fixed HBBL with DYNAMIC_BBL = False), linear drag
(LINEAR_DRAG), or no drag law (BOTTOMDRAGLAW = False: the bottom
interface couples to the bottom through Kv alone); the side-wall
Rayleigh drag of CHANNEL_DRAG; the surface viscous mixed layer (fixed
or dynamic depth); HARMONIC_VISC; KV_ML_INVZ2; and DIRECT_STRESS.  A
shear-driven interface viscosity is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["VertViscCfg", "ViscCoefs", "BBLInfo", "set_viscous_bbl",
           "surface_ustar", "vertvisc_coef", "implicit_visc_solve",
           "vertvisc", "vertvisc_remnant", "vertvisc_limit_vel"]

_H_NEGLECT = 1e-20


@dataclasses.dataclass(frozen=True)
class VertViscCfg:
    kv: float = 1e-4              # KV background viscosity [m2 s-1]
    hbbl: float = 10.0            # HBBL [m]
    cdrag: float = 0.003          # CDRAG quadratic bottom drag
    drag_bg_vel: float = 0.0      # DRAG_BG_VEL [m s-1]
    maxvel: float = 3.0e8         # MAXVEL [m s-1]
    cfl_trunc: float = 0.5        # CFL_TRUNCATE
    bbl_thick_min: float = 0.1    # BBL_THICK_MIN [m]
    kv_bbl_min: float = 1e-4      # KV_BBL_MIN [m2 s-1]
    bbl_use_eos: bool = False     # BBL_USE_EOS: BBL ladder from the EOS
    bottomdraglaw: bool = True    # BOTTOMDRAGLAW (quadratic, via the BBL)
    linear_drag: bool = False     # LINEAR_DRAG: piston cdrag*drag_bg_vel
    channel_drag: bool = False    # CHANNEL_DRAG (side-wall Rayleigh drag)
    dynamic_bbl: bool = True      # DYNAMIC_BBL: stratified/rotational BBL
    # the surface viscous mixed layer: '' off, 'fixed' (HMIX_FIXED) or
    # 'dynamic' (the Ekman depth ml_ekman_coeff*ustar/|f|)
    visc_ml_mode: str = ""        # FIXED_DEPTH_LOTW_ML / DYNAMIC_VISCOUS_ML
    hmix_fixed: float = 20.0      # HMIX_FIXED [m]
    direct_stress: bool = False   # DIRECT_STRESS: wind as a body force
    hmix_stress: float = 20.0     # HMIX_STRESS [m]
    harmonic_visc: bool = False   # HARMONIC_VISC: harmonic-mean spacing
    ml_ekman_coeff: float = 0.5   # Ekman depth coefficient [nondim]
    vonkar: float = 0.41          # VON_KARMAN_CONST
    kv_ml_invz2: float = 0.0      # KV_ML_INVZ2 [m2 s-1]


class ViscCoefs(NamedTuple):
    a_u: torch.Tensor    # (nk+1, njh, nih) coupling at u columns [m s-1]
    a_v: torch.Tensor
    h_u: torch.Tensor    # (nk, njh, nih) face thickness [m]
    h_v: torch.Tensor
    ray_u: torch.Tensor | None = None   # (nk, ...) Rayleigh drag [m s-1]
    ray_v: torch.Tensor | None = None


class BBLInfo(NamedTuple):
    piston_u: torch.Tensor
    thick_u: torch.Tensor
    piston_v: torch.Tensor
    thick_v: torch.Tensor


def _rev_cumsum0(x):
    return torch.flip(torch.cumsum(torch.flip(x, [0]), dim=0), [0])


def _hab_interfaces(h_face):
    """Height of interfaces above the bottom (K=0..nk; [-1]=0)."""
    return torch.cat([_rev_cumsum0(h_face), torch.zeros_like(h_face[:1])],
                     dim=0)


def set_viscous_bbl(grid: Grid, u, v, h, cfg: VertViscCfg = VertViscCfg(),
                    vgrid=None, T=None, S=None, eos=None) -> BBLInfo:
    """BBL piston velocity and thickness at u/v faces (set_viscous_BBL):
    drag-law u* from the velocity over the bottom HBBL, thickness
    limited by the stratification (KW99; the layered target densities,
    or with BBL_USE_EOS the EOS density jumps of T/S) and rotation;
    without ``vgrid``, or with DYNAMIC_BBL = False, the thickness is the
    fixed HBBL.  LINEAR_DRAG gives the piston cdrag * DRAG_BG_VEL."""
    nk = h.shape[0]
    gp_int = gp_u = gp_v = None
    if (cfg.bbl_use_eos and cfg.dynamic_bbl and vgrid is not None
            and T is not None and S is not None and eos is not None):
        p_int = vgrid.Rho0 * vgrid.g_Earth * torch.cumsum(h, dim=0)[:-1]
        drho = eos.density(T[1:], S[1:], p_int) \
            - eos.density(T[:-1], S[:-1], p_int)
        gp_h = torch.clamp(vgrid.g_Earth * drho / vgrid.Rho0, min=0.0)
        gp_u = 0.5 * (gp_h + ip1(gp_h))
        gp_v = 0.5 * (gp_h + jp1(gp_h))
    elif vgrid is not None and cfg.dynamic_bbl:
        rl = vgrid.Rlay
        gp = torch.clamp(vgrid.g_Earth * (rl[1:] - rl[:-1]) / vgrid.Rho0,
                         min=0.0)
        gp_int = gp.reshape((-1,) + (1,) * (h.ndim - 1))

    def face_bbl(h_face, umag2_face, absf, gp_face):
        if cfg.linear_drag:
            piston = cfg.cdrag * cfg.drag_bg_vel \
                * torch.ones_like(h_face[0])
            return piston, torch.full_like(h_face[0], cfg.hbbl)
        hab = _hab_interfaces(h_face)
        w = torch.minimum(torch.clamp(cfg.hbbl - hab[1:], min=0.0),
                          h_face) / cfg.hbbl
        u_bbl2 = torch.sum(w * umag2_face, dim=0) \
            / torch.clamp(torch.sum(w, dim=0), min=1e-10)
        ustar = torch.sqrt(cfg.cdrag * (u_bbl2 + cfg.drag_bg_vel ** 2))
        if gp_face is None:
            gp_face = gp_int
        if gp_face is not None and nk > 1:
            targ = 400.0 * ustar * ustar
            habi = hab[1:nk]
            gcum = _rev_cumsum0(gp_face)
            gh = _rev_cumsum0(gp_face * habi)
            lhs = habi * gcum - gh
            ok = lhs <= targ[None]
            ub = torch.cat([hab[:1], habi[:-1]], dim=0)
            h_cand = torch.where(
                gcum > 0.0, (targ[None] + gh)
                / torch.clamp(gcum, min=1e-30), ub)
            h_cand = torch.minimum(torch.maximum(h_cand, habi), ub)
            h_n = torch.amax(torch.where(ok, h_cand, 0.0), dim=0)
            h_n = torch.where(torch.any(ok, dim=0), h_n,
                              cfg.bbl_thick_min)
            h_n = torch.minimum(h_n, hab[0])
            ust = torch.clamp(ustar, min=1e-12)
            root = torch.sqrt(0.25 * ust * ust
                              + (2.0 * absf * h_n) ** 2)
            bbl_thick = torch.clamp((h_n * ust) / (0.5 * ust + root),
                                    min=cfg.bbl_thick_min)
        else:
            bbl_thick = torch.full_like(h_face[0], cfg.hbbl)
        kv_bbl = torch.clamp(math.sqrt(cfg.cdrag) * ustar * bbl_thick,
                             min=cfg.kv_bbl_min)
        piston = kv_bbl / torch.clamp(bbl_thick, min=cfg.bbl_thick_min)
        return piston, bbl_thick

    h_u = 0.5 * (h + ip1(h))
    h_v = 0.5 * (h + jp1(h))
    v_at_u = 0.25 * ((v + ip1(v)) + jm1(v + ip1(v)))
    u_at_v = 0.25 * ((u + jp1(u)) + im1(u + jp1(u)))
    fq = torch.abs(grid.CoriolisBu)
    pu, tu = face_bbl(h_u, u * u + v_at_u * v_at_u, 0.5 * (fq + jm1(fq)),
                      gp_u)
    pv, tv = face_bbl(h_v, v * v + u_at_v * u_at_v, 0.5 * (fq + im1(fq)),
                      gp_v)
    return BBLInfo(piston_u=pu, thick_u=tu, piston_v=pv, thick_v=tv)


def surface_ustar(grid: Grid, rho0: float, forces):
    """Surface friction velocity at h points, sqrt(|tau|/rho0)."""
    tx_h = 0.5 * (forces.taux + im1(forces.taux)) \
        if forces.taux is not None else 0.0
    ty_h = 0.5 * (forces.tauy + jm1(forces.tauy)) \
        if forces.tauy is not None else 0.0
    tau = torch.sqrt(tx_h * tx_h + ty_h * ty_h + 1e-60)
    return torch.sqrt(tau / rho0) * grid.mask2dT


def vertvisc_coef(grid: Grid, u, v, h, kv_int=None,
                  cfg: VertViscCfg = VertViscCfg(), vgrid=None,
                  bbl: BBLInfo | None = None, ustar=None) -> ViscCoefs:
    """Interface coupling coefficients a = Kv/dz at u and v columns, with
    Kv the constant KV or, with ``kv_int``, that (nk+1, njh, nih)
    interface viscosity at h points averaged to the faces; the bottom
    drag slaves every interface inside the BBL (``bbl`` from
    set_viscous_bbl, computed here from u, v, h when not given); with no
    drag law the bottom coupling is Kv over half the bottom layer and
    ``bbl`` is not used.  ``ustar`` (the surface friction velocity at h
    points) turns on the viscous mixed layer's coupling floor of
    ``cfg.visc_ml_mode``; CHANNEL_DRAG adds the Rayleigh drags."""
    nk = h.shape[0]
    if cfg.bottomdraglaw and bbl is None:
        bbl = set_viscous_bbl(grid, u, v, h, cfg, vgrid)

    def ml_floor(a_int, h_face, ust_face, absf):
        """The viscous-ML floor: visc_ml = z(h_ml - z) kappa u*^2 /
        (|f| z(h_ml - z) + h_ml u*) and the log-layer (h_ml - z) u*^2
        kappa / denom, each a floor on the coupling within the ML."""
        htot = torch.sum(h_face, dim=0)
        if cfg.visc_ml_mode == "fixed":
            h_ml = torch.clamp(htot, max=cfg.hmix_fixed)
        else:
            h_ml = torch.minimum(htot, cfg.ml_ekman_coeff * ust_face
                                 / torch.clamp(absf, min=1e-10))
        z_t = torch.cumsum(h_face[:-1], dim=0)
        temp1 = torch.clamp(z_t * (h_ml[None] - z_t), min=0.0)
        denom = (absf[None] * temp1
                 + (h_ml + _H_NEGLECT)[None] * ust_face[None])
        u2d = (cfg.vonkar * ust_face ** 2)[None] \
            / torch.clamp(denom, min=1e-30)
        a_ml = temp1 * u2d / (0.25 * (h_face[1:] + h_face[:-1])
                              + _H_NEGLECT)
        a_floor = torch.clamp(h_ml[None] - z_t, min=0.0) * u2d
        in_ml = (z_t < h_ml[None]) & (ust_face[None] > 0.0)
        return torch.where(in_ml, torch.maximum(
            a_int, torch.maximum(a_ml, a_floor)), a_int)

    def face_coefs(h_face, kv_face, piston, bbl_thick, ust_face, absf):
        if cfg.harmonic_visc:
            dz = (h_face[:-1] * h_face[1:]) \
                / (h_face[:-1] + h_face[1:] + _H_NEGLECT) + _H_NEGLECT
        else:
            dz = 0.5 * (h_face[:-1] + h_face[1:]) + _H_NEGLECT
        kv_in = kv_face[1:-1]
        if cfg.kv_ml_invz2 > 0.0:
            # Kv += KV_ML_INVZ2 / (z^2 (1 + 0.09 z^6)), z the interface
            # depth in units of HMIX_FIXED.  Under a face of no
            # thickness (land, whose coupling the mask zeroes) z^2 is
            # ~1e-43, which overflows float32 to inf and inf * 0 to NaN:
            # the term is taken there as 0, which changes no masked value
            z_sum = torch.cumsum(h_face[:-1], dim=0)
            i_hmix = 1.0 / (cfg.hmix_fixed + _H_NEGLECT)
            z_t = (z_sum + _H_NEGLECT) * i_hmix
            kv_in = kv_in + torch.where(
                z_sum > 0.0,
                cfg.kv_ml_invz2 / ((z_t * z_t) * (1.0 + 0.09 * z_t ** 6)),
                0.0)
        a_int = kv_in / dz
        if cfg.visc_ml_mode and ust_face is not None:
            a_int = ml_floor(a_int, h_face, ust_face, absf)
        a_top = torch.zeros_like(h_face[0])[None]
        if not cfg.bottomdraglaw:
            a_bot = (kv_face[-1] / (0.5 * h_face[-1] + _H_NEGLECT))[None]
            return torch.cat([a_top, a_int, a_bot], dim=0)
        a_bot = (piston + kv_face[-1] / (0.5 * h_face[-1]
                                         + 0.5 * cfg.hbbl))[None]
        hab = _hab_interfaces(h_face)
        in_bbl = hab[1:nk] < bbl_thick[None]
        a_int = torch.where(in_bbl, torch.maximum(a_int, piston[None]),
                            a_int)
        return torch.cat([a_top, a_int, a_bot], dim=0)

    h_u = 0.5 * (h + ip1(h))
    h_v = 0.5 * (h + jp1(h))
    if kv_int is None:
        kv_u = kv_v = torch.full((nk + 1,) + h.shape[1:], cfg.kv,
                                 dtype=h.dtype, device=h.device)
    else:
        kv_u = 0.5 * (kv_int + ip1(kv_int))
        kv_v = 0.5 * (kv_int + jp1(kv_int))
    pu, tu, pv, tv = bbl if cfg.bottomdraglaw else (None,) * 4
    ust_u = ust_v = absf_u = absf_v = None
    if ustar is not None:
        ust_u = 0.5 * (ustar + ip1(ustar))
        ust_v = 0.5 * (ustar + jp1(ustar))
        fq = torch.abs(grid.CoriolisBu)
        absf_u = 0.5 * (fq + jm1(fq))
        absf_v = 0.5 * (fq + im1(fq))
    a_u = face_coefs(h_u, kv_u, pu, tu, ust_u, absf_u) * grid.mask2dCu[None]
    a_v = face_coefs(h_v, kv_v, pv, tv, ust_v, absf_v) * grid.mask2dCv[None]

    ray_u = ray_v = None
    if cfg.channel_drag:
        # at a face between cells of unequal depth, the part of the
        # column below the shallow side's bottom feels a drag-law
        # Rayleigh drag, scaled by how far below that bottom it sits
        def channel_ray(h_face, u_face, d_a, d_b):
            d_sh = torch.minimum(d_a, d_b)
            d_dp = torch.maximum(d_a, d_b)
            z_c = torch.cumsum(h_face, dim=0) - 0.5 * h_face
            frac = torch.clamp((z_c - d_sh[None])
                               / torch.clamp(d_dp - d_sh, min=1e-9)[None],
                               0.0, 1.0)
            return cfg.cdrag * (torch.abs(u_face) + cfg.drag_bg_vel) * frac

        ray_u = channel_ray(h_u, u, grid.bathyT, ip1(grid.bathyT)) \
            * grid.mask2dCu[None]
        ray_v = channel_ray(h_v, v, grid.bathyT, jp1(grid.bathyT)) \
            * grid.mask2dCv[None]
    return ViscCoefs(a_u=a_u, a_v=a_v, h_u=h_u, h_v=h_v, ray_u=ray_u,
                     ray_v=ray_v)


def implicit_visc_solve(u, h_col, a, dt, rhs_extra=None, ray=None):
    """Thickness-weighted implicit viscosity: solves
    (h + dt*L) u' = h*u (+ rhs_extra in layer 0), L the tridiagonal
    coupling through the interface coefficients ``a`` plus the Rayleigh
    drag ``ray``, with the Thomas recursion of MOM_vert_friction.F90
    vertvisc, over all columns."""
    nk = u.shape[0]
    rhs = h_col * u
    if rhs_extra is not None:
        rhs = torch.cat([(rhs[0] + rhs_extra)[None], rhs[1:]], dim=0)
    b1_prev = torch.zeros_like(u[0])
    d1_prev = torch.ones_like(u[0])
    u_prev = torch.zeros_like(u[0])
    zero = torch.zeros_like(u[0])
    u_fwd, c1 = [], []
    for k in range(nk):
        a_t, a_b = a[k], a[k + 1]
        c1.append(dt * a_t * b1_prev)
        b_denom = h_col[k] + dt * ((zero if ray is None else ray[k])
                                   + a_t * d1_prev)
        b1 = 1.0 / (b_denom + dt * a_b)
        d1 = b_denom * b1
        u_prev = (rhs[k] + dt * a_t * u_prev) * b1
        u_fwd.append(u_prev)
        b1_prev, d1_prev = b1, d1
    out = [None] * nk
    out[nk - 1] = u_fwd[nk - 1]
    for k in range(nk - 2, -1, -1):
        out[k] = u_fwd[k] + c1[k + 1] * out[k + 1]
    return torch.stack(out, dim=0)


def vertvisc(grid: Grid, u, v, h, coefs: ViscCoefs, dt,
             taux=None, tauy=None, rho0: float = 1035.0,
             direct_stress: bool = False, hmix_stress: float = 20.0):
    """The implicit viscosity solve on both velocity components, with
    the surface stress as a boundary condition, or with
    ``direct_stress`` as a body force spread over the topmost
    ``hmix_stress`` of fluid (DIRECT_STRESS / HMIX_STRESS)."""
    stress_u = None if taux is None else \
        (dt / rho0) * taux * grid.mask2dCu
    stress_v = None if tauy is None else \
        (dt / rho0) * tauy * grid.mask2dCv
    hu = coefs.h_u + _H_NEGLECT
    hv = coefs.h_v + _H_NEGLECT
    if direct_stress:
        def body(vel, stress, h_face):
            if stress is None:
                return vel
            z_top = torch.cat([torch.zeros_like(h_face[:1]),
                               torch.cumsum(h_face, dim=0)], dim=0)
            hfr = (torch.minimum(torch.clamp(hmix_stress - z_top[:-1],
                                             min=0.0),
                                 h_face + _H_NEGLECT)
                   / (h_face + _H_NEGLECT))
            return vel + (stress / hmix_stress)[None] * hfr \
                * (h_face > _H_NEGLECT)
        u = body(u, stress_u, hu)
        v = body(v, stress_v, hv)
        stress_u = stress_v = None
    u_new = implicit_visc_solve(u, hu, coefs.a_u, dt, stress_u, coefs.ray_u)
    v_new = implicit_visc_solve(v, hv, coefs.a_v, dt, stress_v, coefs.ray_v)
    return u_new * grid.mask2dCu, v_new * grid.mask2dCv


def vertvisc_remnant(grid: Grid, coefs: ViscCoefs, dt):
    """visc_rem_u/v: the solve applied to u = 1, the fraction of a
    barotropic acceleration each layer keeps (vertvisc_remnant)."""
    rem_u = implicit_visc_solve(torch.ones_like(coefs.h_u),
                                coefs.h_u + _H_NEGLECT, coefs.a_u, dt,
                                ray=coefs.ray_u)
    rem_v = implicit_visc_solve(torch.ones_like(coefs.h_v),
                                coefs.h_v + _H_NEGLECT, coefs.a_v, dt,
                                ray=coefs.ray_v)
    return rem_u * grid.mask2dCu, rem_v * grid.mask2dCv


def vertvisc_limit_vel(grid: Grid, u, v, dt, cfg: VertViscCfg):
    """CFL and absolute velocity truncation; returns (u, v, count)."""
    u_lim = torch.clamp(cfg.cfl_trunc * grid.dxCu / dt, max=cfg.maxvel)
    v_lim = torch.clamp(cfg.cfl_trunc * grid.dyCv / dt, max=cfg.maxvel)
    truncs = (torch.sum(torch.abs(u) > u_lim)
              + torch.sum(torch.abs(v) > v_lim))
    return (torch.clamp(u, -u_lim, u_lim), torch.clamp(v, -v_lim, v_lim),
            truncs)
