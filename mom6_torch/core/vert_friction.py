"""Implicit vertical viscosity and the visc_rem coupling fractions.

Counterpart of ``mom6_tpu.core.vert_friction``: ``set_viscous_bbl``
(bottom boundary layer piston velocity and thickness), ``vertvisc_coef``
(interface coupling coefficients), ``implicit_visc_solve`` (the Thomas
recursion over layers, vectorized over columns), ``vertvisc``,
``vertvisc_remnant`` and ``vertvisc_limit_vel``, with the quadratic
bottom drag and the stratified/rotational BBL thickness, or with no
drag law (BOTTOMDRAGLAW = False: the bottom interface couples to the
bottom through Kv alone).  The other options of the JAX package's VertViscCfg (linear
or channel drag, the viscous mixed layer, DIRECT_STRESS, HARMONIC_VISC,
BBL_USE_EOS, KV_ML_INVZ2) and a shear-driven interface viscosity are
not ported yet.
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
    bbl_use_eos: bool = False     # BBL_USE_EOS (not ported: raises)
    bottomdraglaw: bool = True    # BOTTOMDRAGLAW (quadratic, via the BBL)


class ViscCoefs(NamedTuple):
    a_u: torch.Tensor    # (nk+1, njh, nih) coupling at u columns [m s-1]
    a_v: torch.Tensor
    h_u: torch.Tensor    # (nk, njh, nih) face thickness [m]
    h_v: torch.Tensor


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
                    vgrid=None) -> BBLInfo:
    """BBL piston velocity and thickness at u/v faces (set_viscous_BBL):
    drag-law u* from the velocity over the bottom HBBL, thickness
    limited by the layered stratification (KW99) and rotation; without
    ``vgrid`` the thickness is the fixed HBBL."""
    nk = h.shape[0]
    gp_int = None
    if vgrid is not None:
        rl = vgrid.Rlay
        gp = torch.clamp(vgrid.g_Earth * (rl[1:] - rl[:-1]) / vgrid.Rho0,
                         min=0.0)
        gp_int = gp.reshape((-1,) + (1,) * (h.ndim - 1))

    def face_bbl(h_face, umag2_face, absf):
        hab = _hab_interfaces(h_face)
        w = torch.minimum(torch.clamp(cfg.hbbl - hab[1:], min=0.0),
                          h_face) / cfg.hbbl
        u_bbl2 = torch.sum(w * umag2_face, dim=0) \
            / torch.clamp(torch.sum(w, dim=0), min=1e-10)
        ustar = torch.sqrt(cfg.cdrag * (u_bbl2 + cfg.drag_bg_vel ** 2))
        if gp_int is not None and nk > 1:
            targ = 400.0 * ustar * ustar
            habi = hab[1:nk]
            gcum = _rev_cumsum0(gp_int)
            gh = _rev_cumsum0(gp_int * habi)
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
    pu, tu = face_bbl(h_u, u * u + v_at_u * v_at_u, 0.5 * (fq + jm1(fq)))
    pv, tv = face_bbl(h_v, v * v + u_at_v * u_at_v, 0.5 * (fq + im1(fq)))
    return BBLInfo(piston_u=pu, thick_u=tu, piston_v=pv, thick_v=tv)


def surface_ustar(grid: Grid, rho0: float, forces):
    """Surface friction velocity at h points, sqrt(|tau|/rho0)."""
    tx_h = 0.5 * (forces.taux + im1(forces.taux)) \
        if forces.taux is not None else 0.0
    ty_h = 0.5 * (forces.tauy + jm1(forces.tauy)) \
        if forces.tauy is not None else 0.0
    tau = torch.sqrt(tx_h * tx_h + ty_h * ty_h + 1e-60)
    return torch.sqrt(tau / rho0) * grid.mask2dT


def vertvisc_coef(grid: Grid, u, v, h, cfg: VertViscCfg = VertViscCfg(),
                  vgrid=None, bbl: BBLInfo | None = None) -> ViscCoefs:
    """Interface coupling coefficients a = Kv/dz at u and v columns, with
    the bottom drag slaving every interface inside the BBL (``bbl`` from
    set_viscous_bbl, computed here from u, v, h when not given); with no
    drag law the bottom coupling is Kv over half the bottom layer and
    ``bbl`` is not used."""
    nk = h.shape[0]
    if cfg.bottomdraglaw and bbl is None:
        bbl = set_viscous_bbl(grid, u, v, h, cfg, vgrid)

    def face_coefs(h_face, kv_face, piston, bbl_thick):
        dz = 0.5 * (h_face[:-1] + h_face[1:]) + _H_NEGLECT
        a_int = kv_face[1:-1] / dz
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
    kv = torch.full((nk + 1,) + h.shape[1:], cfg.kv, dtype=h.dtype,
                    device=h.device)
    pu, tu, pv, tv = bbl if cfg.bottomdraglaw else (None,) * 4
    a_u = face_coefs(h_u, kv, pu, tu) * grid.mask2dCu[None]
    a_v = face_coefs(h_v, kv, pv, tv) * grid.mask2dCv[None]
    return ViscCoefs(a_u=a_u, a_v=a_v, h_u=h_u, h_v=h_v)


def implicit_visc_solve(u, h_col, a, dt, rhs_extra=None):
    """Thickness-weighted implicit viscosity: solves
    (h + dt*L) u' = h*u (+ rhs_extra in layer 0) with the Thomas
    recursion of MOM_vert_friction.F90 vertvisc, over all columns."""
    nk = u.shape[0]
    rhs = h_col * u
    if rhs_extra is not None:
        rhs = torch.cat([(rhs[0] + rhs_extra)[None], rhs[1:]], dim=0)
    b1_prev = torch.zeros_like(u[0])
    d1_prev = torch.ones_like(u[0])
    u_prev = torch.zeros_like(u[0])
    ray = torch.zeros_like(u[0])
    u_fwd, c1 = [], []
    for k in range(nk):
        a_t, a_b = a[k], a[k + 1]
        c1.append(dt * a_t * b1_prev)
        b_denom = h_col[k] + dt * (ray + a_t * d1_prev)
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
             taux=None, tauy=None, rho0: float = 1035.0):
    """The implicit viscosity solve on both velocity components, with
    the surface stress as a boundary condition."""
    stress_u = None if taux is None else \
        (dt / rho0) * taux * grid.mask2dCu
    stress_v = None if tauy is None else \
        (dt / rho0) * tauy * grid.mask2dCv
    u_new = implicit_visc_solve(u, coefs.h_u + _H_NEGLECT, coefs.a_u, dt,
                                stress_u)
    v_new = implicit_visc_solve(v, coefs.h_v + _H_NEGLECT, coefs.a_v, dt,
                                stress_v)
    return u_new * grid.mask2dCu, v_new * grid.mask2dCv


def vertvisc_remnant(grid: Grid, coefs: ViscCoefs, dt):
    """visc_rem_u/v: the solve applied to u = 1, the fraction of a
    barotropic acceleration each layer keeps (vertvisc_remnant)."""
    rem_u = implicit_visc_solve(torch.ones_like(coefs.h_u),
                                coefs.h_u + _H_NEGLECT, coefs.a_u, dt)
    rem_v = implicit_visc_solve(torch.ones_like(coefs.h_v),
                                coefs.h_v + _H_NEGLECT, coefs.a_v, dt)
    return rem_u * grid.mask2dCu, rem_v * grid.mask2dCv


def vertvisc_limit_vel(grid: Grid, u, v, dt, cfg: VertViscCfg):
    """CFL and absolute velocity truncation; returns (u, v, count)."""
    u_lim = torch.clamp(cfg.cfl_trunc * grid.dxCu / dt, max=cfg.maxvel)
    v_lim = torch.clamp(cfg.cfl_trunc * grid.dyCv / dt, max=cfg.maxvel)
    truncs = (torch.sum(torch.abs(u) > u_lim)
              + torch.sum(torch.abs(v) > v_lim))
    return (torch.clamp(u, -u_lim, u_lim), torch.clamp(v, -v_lim, v_lim),
            truncs)
