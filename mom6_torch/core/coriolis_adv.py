"""Coriolis force and momentum advection, vector-invariant form.

Counterpart of ``mom6_tpu.core.coriolis_adv`` (CorAdCalc): the layer
potential vorticity q at corner (B) points, a PV-flux discretization and
the kinetic-energy gradient,

    CAu =  <q vh> - d(KE)/dx ,   CAv = - <q uh> - d(KE)/dy .

PV flux schemes: SADOURNY75_ENERGY (the default, optionally with
CORIOLIS_EN_DIS), SADOURNY75_ENSTRO, ARAKAWA_HSU90, ARAKAWA_LAMB81,
ARAKAWA_LAMB_BLEND (AL_BLEND; CORIOLIS_BLEND_WT_LIN and
CORIOLIS_BLEND_F_EFF_MAX) and ROBUST_ENSTRO (PV_ADV_SCHEME centered or
upwind1); BOUND_CORIOLIS clamps the flux.  KE schemes: KE_ARAKAWA (the
default), KE_SIMPLE_GUDONOV and KE_GUDONOV.  NOSLIP doubles the
relative vorticity at land corners.  Every operation follows the JAX
package's formula for formula, so the two agree to roundoff.
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
_SCHEMES = ("SADOURNY75_ENERGY", "SADOURNY75_ENSTRO", "ARAKAWA_HSU90",
            "ARAKAWA_LAMB81", "ARAKAWA_LAMB_BLEND", "AL_BLEND",
            "ROBUST_ENSTRO")
_KE_SCHEMES = ("KE_ARAKAWA", "KE_SIMPLE_GUDONOV", "KE_GUDONOV")


@dataclasses.dataclass(frozen=True)
class CoriolisCfg:
    scheme: str = "SADOURNY75_ENERGY"   # CORIOLIS_SCHEME
    ke_scheme: str = "KE_ARAKAWA"       # KE_SCHEME
    no_slip: bool = False               # NOSLIP
    bound_coriolis: bool = False        # BOUND_CORIOLIS
    pv_adv_upwind: bool = False         # PV_ADV_SCHEME = PV_ADV_UPWIND1
    coriolis_en_dis: bool = False       # CORIOLIS_EN_DIS
    blend_wt_lin: float = 0.125         # CORIOLIS_BLEND_WT_LIN
    blend_f_eff_max: float = 4.0        # CORIOLIS_BLEND_F_EFF_MAX
    h_tiny: float = 1e-10               # ANGSTROM [m]


class CoriolisResult(NamedTuple):
    CAu: torch.Tensor
    CAv: torch.Tensor
    rel_vort: torch.Tensor
    pv: torch.Tensor


def relative_vorticity(grid: Grid, u, v, no_slip: bool = False):
    """Relative vorticity at corners from the circulation; NOSLIP
    doubles it at land corners (2 - mask)."""
    dvdx = ip1(grid.dyCv * v) - grid.dyCv * v
    dudy = jp1(grid.dxCu * u) - grid.dxCu * u
    fac = (2.0 - grid.mask2dBu) if no_slip else grid.mask2dBu
    return fac * (dvdx - dudy) * grid.IareaBu


def _en_dis(grid: Grid, u, v, h, uh, vh, q):
    """CORIOLIS_EN_DIS: the Sadourny-energy PV flux biased between the
    continuity transports and a centred estimate, the branch picked by
    the sign of q*u (q*v) so that the Coriolis term dissipates energy."""
    def min_max(c, m, dlen):
        c = torch.where(dlen == 0.0, m, c)
        ac, am = torch.abs(c), torch.abs(m)
        m_adj = torch.where(ac < 0.1 * am, 10.0 * c, m)
        c_adj = torch.where(
            ac <= 0.25 * am, c,
            torch.where(ac < 0.5 * am, 3.0 * c - 0.5 * m,
                        torch.where(ac <= 2.0 * am, m, 0.5 * c)))
        c_adj = torch.where(ac < 0.1 * am, c, c_adj)
        return torch.minimum(c_adj, m_adj), torch.maximum(c_adj, m_adj)

    uh_c = 0.5 * grid.dyCu * u * (h + ip1(h))
    vh_c = 0.5 * grid.dxCv * v * (h + jp1(h))
    uh_min, uh_max = min_max(uh_c, uh, grid.dyCu)
    vh_min, vh_max = min_max(vh_c, vh, grid.dxCv)

    def pick(qq, sel, pr_min, pr_max):
        # sel < 0: the max branch, > 0: the min, == 0: their mean
        return torch.where(
            sel == 0.0, qq * 0.5 * (pr_max + pr_min),
            torch.where(sel < 0.0, qq * pr_max, qq * pr_min))

    vmin_p = vh_min + ip1(vh_min)
    vmax_p = vh_max + ip1(vh_max)
    t1 = pick(q, q * u, vmin_p, vmax_p)
    t2 = pick(jm1(q), jm1(q) * u, jm1(vmin_p), jm1(vmax_p))
    CAu = 0.25 * (t1 + t2) * grid.IdxCu
    umin_p = uh_min + jp1(uh_min)
    umax_p = uh_max + jp1(uh_max)
    s1 = pick(im1(q), -(im1(q) * v), im1(umin_p), im1(umax_p))
    s2 = pick(q, -(q * v), umin_p, umax_p)
    CAv = -0.25 * (s1 + s2) * grid.IdyCv
    return CAu, CAv


def _arakawa_weights(cfg: CoriolisCfg, q, Ih_q):
    """(a, b, c, d, ep_u, ep_v) corner weights of the Arakawa schemes
    (ep_* None for ARAKAWA_HSU90)."""
    c12 = 1.0 / 12.0
    c24 = 1.0 / 24.0
    if cfg.scheme == "ARAKAWA_HSU90":
        a_w = (q + (ip1(q) + jm1(q))) * c12
        d_w = ((q + ip1(jm1(q))) + jm1(q)) * c12
        b_w = (q + (im1(q) + jm1(q))) * c12
        c_w = ((q + im1(jm1(q))) + jm1(q)) * c12
        return a_w, b_w, c_w, d_w, None, None
    if cfg.scheme == "ARAKAWA_LAMB81":
        a_w = (2.0 * (ip1(q) + jm1(q)) + (q + ip1(jm1(q)))) * c24
        d_w = ((ip1(q) + jm1(q)) + 2.0 * (q + ip1(jm1(q)))) * c24
        b_w = ((q + im1(jm1(q))) + 2.0 * (im1(q) + jm1(q))) * c24
        c_w = (2.0 * (q + im1(jm1(q))) + (im1(q) + jm1(q))) * c24
        ep_u = ((q - im1(jm1(q))) + (im1(q) - jm1(q))) * c24
        ep_v = (-(q - im1(jm1(q))) + (im1(q) - jm1(q))) * c24
        return a_w, b_w, c_w, d_w, ep_u, ep_v
    # ARAKAWA_LAMB_BLEND: AL81 -> AH90 -> Sadourny energy by the spread of
    # 1/h around each cell, keeping the effective Coriolis amplification
    # under F_eff_max
    fe_m2 = cfg.blend_f_eff_max - 2.0
    wt_lin = min(1.0, max(cfg.blend_wt_lin, 1e-16))
    rat_lin = 1.5 * fe_m2 / max(wt_lin, 1e-16)
    if cfg.blend_f_eff_max <= 2.0:
        fe_m2, rat_lin = -1.0, -1.0
    q00, q10 = im1(jm1(Ih_q)), jm1(Ih_q)
    q01, q11 = im1(Ih_q), Ih_q
    min_ihq = torch.minimum(torch.minimum(q00, q10), torch.minimum(q01, q11))
    max_ihq = torch.maximum(torch.maximum(q00, q10), torch.maximum(q01, q11))
    rat_m1 = torch.where(max_ihq < 1e15 * min_ihq,
                         max_ihq / torch.clamp(min_ihq, min=1e-300) - 1.0,
                         1e15)
    al_wt = torch.where(
        rat_m1 <= fe_m2, 1.0,
        torch.where(rat_m1 < 1.5 * fe_m2,
                    3.0 * fe_m2 / torch.clamp(rat_m1, min=1e-300) - 2.0,
                    0.0))
    sad_wt = torch.where(
        rat_m1 <= 1.5 * fe_m2, 0.0,
        torch.where(
            rat_m1 <= rat_lin,
            1.0 - (1.5 * fe_m2) / torch.clamp(rat_m1, min=1e-300),
            torch.where(rat_m1 < 2.0 * rat_lin,
                        1.0 - (wt_lin / rat_lin) * (rat_m1 - 2.0 * rat_lin),
                        1.0)))
    swp, alp = ip1(sad_wt), ip1(al_wt)
    a_w = (swp * 0.25 * q + (1.0 - swp)
           * (((2.0 - alp) * q + alp * ip1(jm1(q)))
              + 2.0 * (ip1(q) + jm1(q))) * c24)
    d_w = (swp * 0.25 * jm1(q) + (1.0 - swp)
           * (((2.0 - alp) * jm1(q) + alp * ip1(q))
              + 2.0 * (q + ip1(jm1(q)))) * c24)
    b_w = (sad_wt * 0.25 * q + (1.0 - sad_wt)
           * (((2.0 - al_wt) * q + al_wt * im1(jm1(q)))
              + 2.0 * (im1(q) + jm1(q))) * c24)
    c_w = (sad_wt * 0.25 * jm1(q) + (1.0 - sad_wt)
           * (((2.0 - al_wt) * jm1(q) + al_wt * im1(q))
              + 2.0 * (q + im1(jm1(q)))) * c24)
    ep_u = al_wt * ((q - im1(jm1(q))) + (im1(q) - jm1(q))) * c24
    ep_v = al_wt * (-(q - im1(jm1(q))) + (im1(q) - jm1(q))) * c24
    return a_w, b_w, c_w, d_w, ep_u, ep_v


def _robust_enstro(grid: Grid, cfg: CoriolisCfg, u, v, h, uh, vh,
                   abs_vort):
    """ROBUST_ENSTRO: the enstrophy form that divides by effective
    thicknesses diagnosed from transport over velocity, clamped into the
    range of the neighbouring h."""
    eps_vel = 1e-10

    def heff(tr, vel, h_a, h_b, idx):
        he = torch.abs(tr * idx) / (eps_vel + torch.abs(vel))
        he = torch.maximum(he, torch.minimum(h_a, h_b))
        return torch.minimum(he, torch.maximum(h_a, h_b))

    he1 = heff(vh, v, h, jp1(h), grid.IdxCv)
    he2 = heff(jm1(vh), jm1(v), jm1(h), h, jm1(grid.IdxCv))
    he3, he4 = ip1(he1), ip1(he2)
    vheff = (vh + ip1(jm1(vh))) + (jm1(vh) + ip1(vh))
    denom_u = cfg.h_tiny + ((he1 + he4) + (he2 + he3))
    if cfg.pv_adv_upwind:
        qvh = 0.5 * ((abs_vort + jm1(abs_vort)) * vheff
                     - (abs_vort - jm1(abs_vort)) * torch.abs(vheff))
        CAu = qvh / denom_u * grid.IdxCu
    else:
        CAu = (0.5 * (abs_vort + jm1(abs_vort)) * vheff
               / denom_u * grid.IdxCu)
    hf1 = heff(uh, u, h, ip1(h), grid.IdyCu)
    hf2 = heff(im1(uh), im1(u), im1(h), h, im1(grid.IdyCu))
    hf3, hf4 = jp1(hf1), jp1(hf2)
    uheff = (uh + im1(jp1(uh))) + (im1(uh) + jp1(uh))
    denom_v = cfg.h_tiny + ((hf1 + hf4) + (hf2 + hf3))
    if cfg.pv_adv_upwind:
        quh = 0.5 * ((abs_vort + im1(abs_vort)) * uheff
                     - (abs_vort - im1(abs_vort)) * torch.abs(uheff))
        CAv = -quh / denom_v * grid.IdyCv
    else:
        CAv = (-0.5 * (abs_vort + im1(abs_vort)) * uheff
               / denom_v * grid.IdyCv)
    return CAu, CAv


def _bound(CAu, CAv, u, v, abs_vort):
    """BOUND_CORIOLIS: clamp the PV flux to the range of f_eff*v
    (f_eff*u) at the four surrounding points."""
    fv1 = abs_vort * ip1(v)
    fv2 = abs_vort * v
    fv3 = jm1(abs_vort) * ip1(jm1(v))
    fv4 = jm1(abs_vort) * jm1(v)
    CAu = torch.clamp(CAu,
                      torch.minimum(torch.minimum(fv1, fv2),
                                    torch.minimum(fv3, fv4)),
                      torch.maximum(torch.maximum(fv1, fv2),
                                    torch.maximum(fv3, fv4)))
    fu1 = -abs_vort * jp1(u)
    fu2 = -abs_vort * u
    fu3 = -im1(abs_vort) * im1(jp1(u))
    fu4 = -im1(abs_vort) * im1(u)
    CAv = torch.clamp(CAv,
                      torch.minimum(torch.minimum(fu1, fu2),
                                    torch.minimum(fu3, fu4)),
                      torch.maximum(torch.maximum(fu1, fu2),
                                    torch.maximum(fu3, fu4)))
    return CAu, CAv


def _kinetic_energy(grid: Grid, u, v, ke_scheme: str):
    """KE at h points (gradKE)."""
    if ke_scheme == "KE_ARAKAWA":
        au2 = grid.areaCu * u * u
        av2 = grid.areaCv * v * v
        return ((au2 + im1(au2)) + (av2 + jm1(av2))) * 0.25 * grid.IareaT
    up = 0.5 * (im1(u) + torch.abs(im1(u)))
    um = 0.5 * (u - torch.abs(u))
    vp = 0.5 * (jm1(v) + torch.abs(jm1(v)))
    vm = 0.5 * (v - torch.abs(v))
    if ke_scheme == "KE_SIMPLE_GUDONOV":
        return (torch.maximum(up * up, um * um)
                + torch.maximum(vp * vp, vm * vm)) * 0.5
    return (torch.maximum(up * up * im1(grid.areaCu), um * um * grid.areaCu)
            + torch.maximum(vp * vp * jm1(grid.areaCv),
                            vm * vm * grid.areaCv)) * 0.5 * grid.IareaT


def coriolis_adv(grid: Grid, u, v, h, uh, vh,
                 cfg: CoriolisCfg = CoriolisCfg()) -> CoriolisResult:
    """CorAdCalc: (CAu, CAv) [m s-2].  u, v, h need 2 valid halo rings,
    uh, vh one."""
    if cfg.scheme not in _SCHEMES:
        raise ValueError(f"Unsupported CORIOLIS_SCHEME {cfg.scheme}")
    if cfg.ke_scheme not in _KE_SCHEMES:
        raise ValueError(f"Unsupported KE_SCHEME {cfg.ke_scheme}")
    rv = relative_vorticity(grid, u, v, cfg.no_slip)
    abs_vort = grid.CoriolisBu + rv
    Area_h = grid.mask2dT * grid.areaT
    Area_q = (Area_h + ip1(jp1(Area_h))) + (ip1(Area_h) + jp1(Area_h))
    Ahh = Area_h * h
    hArea_u = 0.5 * (Ahh + ip1(Ahh))
    hArea_v = 0.5 * (Ahh + jp1(Ahh))
    hArea_q = (hArea_u + jp1(hArea_u)) + (hArea_v + ip1(hArea_v))
    Ih_q = Area_q / (hArea_q + _VOL_NEGLECT)
    q = abs_vort * Ih_q

    if cfg.scheme == "SADOURNY75_ENERGY" and cfg.coriolis_en_dis:
        CAu, CAv = _en_dis(grid, u, v, h, uh, vh, q)
    elif cfg.scheme == "SADOURNY75_ENERGY":
        A = q * (vh + ip1(vh))
        CAu = 0.25 * (A + jm1(A)) * grid.IdxCu
        B = q * (uh + jp1(uh))
        CAv = -0.25 * (B + im1(B)) * grid.IdyCv
    elif cfg.scheme == "SADOURNY75_ENSTRO":
        CAu = (0.125 * grid.IdxCu * (q + jm1(q))
               * ((vh + ip1(vh)) + (jm1(vh) + ip1(jm1(vh)))))
        CAv = (-0.125 * grid.IdyCv * (q + im1(q))
               * ((uh + jp1(uh)) + (im1(uh) + im1(jp1(uh)))))
    elif cfg.scheme == "ROBUST_ENSTRO":
        CAu, CAv = _robust_enstro(grid, cfg, u, v, h, uh, vh, abs_vort)
    else:
        a_w, b_w, c_w, d_w, ep_u, ep_v = _arakawa_weights(cfg, q, Ih_q)
        CAu = ((a_w * ip1(vh) + c_w * jm1(vh))
               + (b_w * vh + d_w * ip1(jm1(vh)))) * grid.IdxCu
        CAv = -((im1(a_w) * im1(uh) + jp1(c_w) * jp1(uh))
                + (b_w * uh + im1(jp1(d_w)) * im1(jp1(uh)))) * grid.IdyCv
        if ep_u is not None:
            # the Arakawa & Lamb divergence-correction terms
            CAu = CAu + (ep_u * im1(uh) - ip1(ep_u) * ip1(uh)) * grid.IdxCu
            CAv = CAv + (ep_v * jm1(vh) - jp1(ep_v) * jp1(vh)) * grid.IdyCv

    if cfg.bound_coriolis and cfg.scheme != "ROBUST_ENSTRO":
        CAu, CAv = _bound(CAu, CAv, u, v, abs_vort)

    KE = _kinetic_energy(grid, u, v, cfg.ke_scheme)
    CAu = (CAu - (ip1(KE) - KE) * grid.IdxCu) * grid.mask2dCu
    CAv = (CAv - (jp1(KE) - KE) * grid.IdyCv) * grid.mask2dCv
    return CoriolisResult(CAu=CAu, CAv=CAv, rel_vort=rv, pv=q)
