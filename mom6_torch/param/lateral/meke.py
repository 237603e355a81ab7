"""Mesoscale Eddy Kinetic Energy (MEKE) budget.

Counterpart of ``mom6_tpu.param.lateral.meke``: a prognostic 2-D budget
of the sub-grid eddy energy E [m2 s-2],

  dE/dt = gamma_GM GM work + gamma_fric frictional work + background
          - (lambda_0 + drag) E + div(K_E grad E) - adv u_bt.grad E,

the drag implicit; the mixing length blends the deformation, frictional,
Rhines, Eady and grid scales (inverse sum, or the minimum under
MEKE_USE_MIN_LSCALE), and the vertical-structure factors gamma_b^2 and
gamma_t^2 shape it.  The diffusivity handed to KHTH/KHTR is
c_K gamma_t sqrt(2E) L_mix (or the GEOMETRIC alpha E / SN), the
viscosity to hor_visc MEKE_VISCOSITY_COEFF_KU sqrt(2E) L_mix.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["MEKECfg", "meke_length_scales", "step_meke", "meke_khth",
           "meke_ku", "meke_equilibrium"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class MEKECfg:
    frcoeff: float = 0.1        # MEKE_FRCOEFF
    gmcoeff: float = 0.1        # MEKE_GMCOEFF
    damping: float = 0.0        # MEKE_DAMPING [s-1]
    cdrag: float = 0.003        # MEKE_CDRAG
    cb: float = 25.0            # MEKE_CB
    ct: float = 50.0            # MEKE_CT
    cd_scale: float = 0.0       # MEKE_CD_SCALE
    min_gamma: float = 0.0001   # MEKE_MIN_GAMMA2
    khmeke_fac: float = 1.0     # MEKE_KHMEKE_FAC
    ks_coeff: float = 1.0       # MEKE_KHCOEFF
    bgsrc: float = 0.0          # MEKE_BGSRC [W kg-1]
    viscosity_coeff_ku: float = 0.0   # MEKE_VISCOSITY_COEFF_KU
    advection_factor: float = 0.0     # MEKE_ADVECTION_FACTOR
    a_deform: float = 0.0       # MEKE_ALPHA_DEFORM
    a_frict: float = 0.0        # MEKE_ALPHA_FRICT
    a_rhines: float = 0.0       # MEKE_ALPHA_RHINES
    a_eady: float = 0.0         # MEKE_ALPHA_EADY
    a_grid: float = 0.0         # MEKE_ALPHA_GRID
    l_fixed: float = 1e4        # MEKE_FIXED_MIXING_LENGTH [m]
    use_min_lscale: bool = False    # MEKE_USE_MIN_LSCALE
    lscale_max: float = 1e6
    geometric: bool = False         # MEKE_GEOMETRIC
    geometric_alpha: float = 0.05   # MEKE_GEOMETRIC_ALPHA
    sn_min: float = 1e-8            # Eady-rate floor [s-1]
    min_depth: float = 10.0


def meke_length_scales(cfg: MEKECfg, grid: Grid, e, depth, rd_dx=None,
                       sn=None, beta=None):
    """(LmixScale, bottomFac2, barotrFac2)."""
    l_grid = torch.sqrt(grid.areaT)
    l_deform = l_grid * (rd_dx if rd_dx is not None
                         else torch.zeros_like(l_grid))
    l_frict = torch.clamp(depth, min=cfg.min_depth) / max(cfg.cdrag, _EPS)
    bottom2 = cfg.cd_scale ** 2 + 1.0 / (
        1.0 + cfg.cb * (l_deform / (l_frict + _EPS))) ** 0.8
    bottom2 = torch.clamp(bottom2, min=cfg.min_gamma)
    barotr2 = 1.0 / (1.0 + cfg.ct * (l_deform
                                     / (l_frict + _EPS))) ** 0.25
    barotr2 = torch.clamp(barotr2, min=cfg.min_gamma)

    ue = torch.sqrt(2.0 * torch.clamp(barotr2 * e, min=0.0))
    l_rhines = torch.sqrt(ue / torch.clamp(
        beta if beta is not None else torch.zeros_like(ue), min=1e-30))
    l_eady = ue / torch.clamp(sn if sn is not None
                              else torch.zeros_like(ue), min=1e-15)

    pairs = ((cfg.a_deform, l_deform), (cfg.a_frict, l_frict),
             (cfg.a_rhines, l_rhines), (cfg.a_eady, l_eady),
             (cfg.a_grid, l_grid))
    if cfg.use_min_lscale:
        lmix = torch.full_like(l_grid, cfg.lscale_max)
        for a, l in pairs:
            if a > 0.0:
                lmix = torch.minimum(lmix, a * l)
        if cfg.l_fixed > 0.0:
            lmix = torch.clamp(lmix, max=cfg.l_fixed)
    else:
        inv = torch.zeros_like(l_grid)
        any_term = False
        for a, l in pairs:
            if a > 0.0:
                inv = inv + 1.0 / torch.clamp(a * l, min=_EPS)
                any_term = True
        if cfg.l_fixed > 0.0:
            inv = inv + 1.0 / cfg.l_fixed
            any_term = True
        lmix = torch.where(inv > 0.0, 1.0 / torch.clamp(inv, min=_EPS),
                           0.0) if any_term \
            else torch.full_like(l_grid, cfg.l_fixed)
    return lmix, bottom2, barotr2


def step_meke(cfg: MEKECfg, grid: Grid, meke_e, dt, gm_work=None,
              fric_work=None, depth_tot=None, rd_dx=None, sn=None,
              u_bt=None, v_bt=None):
    """E advanced one step.  gm_work/fric_work: column-integrated
    conversion rates [m3 s-3]; depth_tot: column depth [m]; rd_dx:
    Rd/dx from VarMix; sn: Eady growth rate [s-1]; u_bt/v_bt: the
    depth-mean flow of the drag and the advection of E."""
    e = torch.clamp(meke_e, min=0.0)
    depth = depth_tot if depth_tot is not None \
        else torch.clamp(grid.bathyT, min=cfg.min_depth)

    fq = grid.CoriolisBu
    dfy = torch.abs((fq - jm1(fq)) * grid.IdyCv)
    dfx = torch.abs((fq - im1(fq)) * grid.IdxCu)
    beta = torch.sqrt(dfx * dfx + dfy * dfy)
    lmix, bottom2, barotr2 = meke_length_scales(cfg, grid, e, depth,
                                                rd_dx=rd_dx, sn=sn,
                                                beta=beta)

    src = torch.zeros_like(e)
    if gm_work is not None:
        src = src + cfg.gmcoeff * gm_work
    if fric_work is not None:
        src = src + cfg.frcoeff * fric_work
    src = src / torch.clamp(depth, min=cfg.min_depth)
    src = src + cfg.bgsrc

    ub2 = torch.zeros_like(e)
    if u_bt is not None:
        u_h = 0.5 * (u_bt + im1(u_bt))
        v_h = 0.5 * (v_bt + jm1(v_bt))
        ub2 = u_h * u_h + v_h * v_h
    drag_vel = cfg.cdrag * torch.sqrt(2.0 * bottom2 * e + ub2
                                      + cfg.cb * cfg.cdrag ** 2)
    lam = cfg.damping + drag_vel / torch.clamp(depth, min=cfg.min_depth)

    # lateral diffusion of E: face-mean, CFL-limited K_MEKE
    ke = meke_khth(cfg, e, lmix=lmix, barotr2=barotr2)
    kh_u = cfg.khmeke_fac * 0.5 * (ke + ip1(ke))
    kh_v = cfg.khmeke_fac * 0.5 * (ke + jp1(ke))
    geo_u = grid.dyCu * grid.IdxCu
    geo_v = grid.dxCv * grid.IdyCv
    inv_max_u = 2.0 * dt * geo_u * torch.maximum(grid.IareaT,
                                                 ip1(grid.IareaT))
    inv_max_v = 2.0 * dt * geo_v * torch.maximum(grid.IareaT,
                                                 jp1(grid.IareaT))
    kh_u = torch.minimum(kh_u, 0.25 / torch.clamp(inv_max_u, min=_EPS))
    kh_v = torch.minimum(kh_v, 0.25 / torch.clamp(inv_max_v, min=_EPS))
    fx = kh_u * geo_u * (e - ip1(e)) * grid.mask2dCu
    fy = kh_v * geo_v * (e - jp1(e)) * grid.mask2dCv
    diff = ((im1(fx) - fx) + (jm1(fy) - fy)) * grid.IareaT

    adv = torch.zeros_like(e)
    if cfg.advection_factor > 0.0 and u_bt is not None:
        fu = torch.where(u_bt > 0.0, e, ip1(e)) * u_bt * grid.dyCu \
            * grid.mask2dCu
        fv = torch.where(v_bt > 0.0, e, jp1(e)) * v_bt * grid.dxCv \
            * grid.mask2dCv
        adv = -cfg.advection_factor * ((fu - im1(fu))
                                       + (fv - jm1(fv))) * grid.IareaT

    e_new = (e + dt * (src + diff + adv)) / (1.0 + dt * lam)
    return torch.clamp(e_new, min=0.0) * grid.mask2dT


def meke_khth(cfg: MEKECfg, meke_e, lmix=None, barotr2=None, sn=None):
    """Eddy diffusivity from E [m2 s-1]: c_K gamma_t sqrt(2E) L_mix, or
    alpha E / max(SN, sn_min) under MEKE_GEOMETRIC."""
    e = torch.clamp(meke_e, min=0.0)
    if cfg.geometric and sn is not None:
        return cfg.geometric_alpha * e / torch.clamp(sn, min=cfg.sn_min)
    gt = torch.sqrt(barotr2) if barotr2 is not None else 1.0
    l = lmix if lmix is not None else cfg.l_fixed
    return cfg.ks_coeff * gt * torch.sqrt(2.0 * e) * l


def meke_ku(cfg: MEKECfg, meke_e, lmix=None):
    """Additive Laplacian viscosity coeff sqrt(2E) L_mix (negative
    coefficients backscatter)."""
    e = torch.clamp(meke_e, min=0.0)
    l = lmix if lmix is not None else cfg.l_fixed
    return cfg.viscosity_coeff_ku * torch.sqrt(2.0 * e) * l


def meke_equilibrium(cfg: MEKECfg, grid: Grid, depth, sn, gm_work=None):
    """Equilibrium E for initialization: (alpha SN H)^2 / cdrag^2 under
    MEKE_GEOMETRIC, else the source/drag balance
    ((gamma_GM src H / cdrag)^(2/3)) / 2."""
    d = torch.clamp(depth, min=cfg.min_depth)
    if cfg.geometric:
        e0 = (cfg.geometric_alpha * torch.clamp(sn, min=0.0) * d) ** 2 \
            / max(cfg.cdrag ** 2, _EPS)
        return e0 * grid.mask2dT
    if gm_work is None:
        return torch.zeros_like(depth)
    src = cfg.gmcoeff * torch.clamp(gm_work, min=0.0) / d
    e0 = 0.5 * (src * d / max(cfg.cdrag, _EPS)) ** (2.0 / 3.0)
    return e0 * grid.mask2dT
