"""Assembly of the interface diapycnal diffusivities (counterpart of
``mom6_tpu.param.vertical.set_diffusivity``): the background profile
plus, where switched on, LMD94/PP81 shear mixing, Jackson-Hallberg-Legg
kappa-shear, CVMix convection, the law-of-the-wall bottom boundary
layer, mixed-layer TKE radiated below the mixed layer, tidal mixing,
double diffusion (with the salt's excess returned apart) and the user
bands; clipped to [KD_MIN, KD_MAX] and zeroed at the surface and bottom.
The shear terms times PRANDTL_TURB come back as ``kv_shear``, the
viscosity the next dynamics step adds to Kv."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from mom6_torch.diagnostics.wave_speed import brunt_vaisala2
from mom6_torch.param.vertical.bkgnd_mixing import (BkgndMixingCfg,
                                                    bkgnd_mixing_coeffs)
from mom6_torch.param.vertical.conv_ddiff import (ConvectionCfg,
                                                  DoubleDiffusionCfg,
                                                  convection_coeffs,
                                                  ddiff_coeffs)
from mom6_torch.param.vertical.kappa_shear import (KappaShearCfg,
                                                   kappa_shear_coeffs)
from mom6_torch.param.vertical.shear_mixing import (ShearMixingCfg,
                                                    shear_mixing_coeffs)
from mom6_torch.param.vertical.tidal_mixing import (TidalMixingCfg,
                                                    tidal_mixing_coeffs)
from mom6_torch.param.vertical.user_change_diff import (UserKdCfg,
                                                        user_change_diff)
from mom6_torch.parallel.stencil import im1, jm1

__all__ = ["DiffusivityCfg", "DiffusivityResult", "set_diffusivity",
           "absf_2d", "lotw_bbl_diffusivity", "mlrad_diffusivity"]


@dataclasses.dataclass(frozen=True)
class DiffusivityCfg:
    kd: float = 1e-5              # KD background [m2 s-1]
    kd_min: float = 0.0           # KD_MIN
    kd_max: float = -1.0          # KD_MAX (<0: none)
    kv_conversion: float = 1.0    # Kv/Kd of the returned Kv
    bkgnd: Optional[BkgndMixingCfg] = None
    use_shear: bool = False       # USE_LMD94 / USE_PP81
    shear: ShearMixingCfg = ShearMixingCfg()
    use_conv: bool = False        # USE_CVMIX_CONVECTION
    conv: ConvectionCfg = ConvectionCfg()
    use_ddiff: bool = False       # DOUBLE_DIFFUSION
    ddiff: DoubleDiffusionCfg = DoubleDiffusionCfg()
    use_kappa_shear: bool = False  # USE_JACKSON_PARAM
    kappa_shear: KappaShearCfg = KappaShearCfg()
    prandtl_turb: float = 1.0     # PRANDTL_TURB: Kv_shear / Kd_shear
    use_tidal: bool = False       # INT_TIDE_DISSIPATION
    tidal: TidalMixingCfg = TidalMixingCfg()
    use_user_kd: bool = False     # USER_CHANGE_DIFFUSIVITY
    user_kd: Optional[UserKdCfg] = None
    use_lotw_bbl: bool = False    # USE_LOTW_BBL_DIFFUSIVITY
    bbl_effic: float = 0.2        # BBL_EFFIC
    lotw_cdrag: float = 0.003     # CDRAG
    lotw_max_decay: float = 200.0  # the largest decay scale [m]
    vonkar: float = 0.41
    ml_radiation: bool = False    # ML_RADIATION
    ml_rad_coeff: float = 0.2     # ML_RAD_COEFF
    ml_rad_efold: float = 2.0     # ML_RAD_EFOLD_COEFF
    ml_rad_kd_max: float = 1e-3   # ML_RAD_KD_MAX [m2 s-1]
    mstar_mlrad: float = 1.2      # MSTAR
    tke_decay_mlrad: float = 2.5  # TKE_DECAY
    # the internal-tide energy flux [W m-2], uniform (TIDAL_ENERGY_FLUX)
    tidal_energy_flux: float = 0.0


class DiffusivityResult(NamedTuple):
    kd_int: torch.Tensor
    kv_int: torch.Tensor
    kd_extra_S: Optional[torch.Tensor] = None   # double diffusion's salt
    kv_shear: Optional[torch.Tensor] = None     # PRANDTL_TURB x shear Kd


def _add_inner(x, inner):
    """x with ``inner`` added to its interior interfaces x[1:-1]."""
    return torch.cat([x[:1], x[1:-1] + inner, x[-1:]], dim=0)


def _inner(inner):
    """An (nk+1, ...) field that is ``inner`` inside and 0 at the
    surface and bottom."""
    z = torch.zeros_like(inner[:1])
    return torch.cat([z, inner, z], dim=0)


def set_diffusivity(h, cfg: DiffusivityCfg, vgrid=None, u=None, v=None,
                    T=None, S=None, eos=None, lat=None,
                    tidal_energy_2d=None, ustar=None, mld=None):
    """(nk+1, ...) interface diffusivities and viscosities.
    ``tidal_energy_2d`` replaces the uniform TIDAL_ENERGY_FLUX; ``ustar``
    and ``mld`` feed ML_RADIATION."""
    bk = cfg.bkgnd or BkgndMixingCfg(kd=cfg.kd)
    kd = bkgnd_mixing_coeffs(bk, h, lat)
    kv = cfg.kv_conversion * kd
    kd_extra_S = None
    kv_shear = None

    needs_n2 = (cfg.use_shear or cfg.use_conv or cfg.use_kappa_shear
                or cfg.use_tidal or cfg.use_lotw_bbl or cfg.ml_radiation)
    if needs_n2 and vgrid is not None:
        n2 = brunt_vaisala2(vgrid, h, T, S, eos)
        if cfg.use_shear and u is not None:
            ks = shear_mixing_coeffs(cfg.shear, u, v, h, n2)
            kd = _add_inner(kd, ks)
            kv = _add_inner(kv, cfg.prandtl_turb * ks)
            kv_shear = _inner(cfg.prandtl_turb * ks) if kv_shear is None \
                else _add_inner(kv_shear, cfg.prandtl_turb * ks)
        if cfg.use_kappa_shear and u is not None:
            kj = kappa_shear_coeffs(cfg.kappa_shear, u, v, h, n2)
            kd = _add_inner(kd, kj)
            kv = _add_inner(kv, cfg.prandtl_turb * kj)
            kv_shear = _inner(cfg.prandtl_turb * kj) if kv_shear is None \
                else _add_inner(kv_shear, cfg.prandtl_turb * kj)
        if cfg.use_conv:
            kc = convection_coeffs(cfg.conv, n2)
            kd = _add_inner(kd, kc)
            kv = _add_inner(kv, 0.1 * kc)
        if cfg.use_lotw_bbl and u is not None:
            kb = lotw_bbl_diffusivity(cfg, h, n2, u, v, absf=absf_2d(h, lat))
            kd = _add_inner(kd, kb)
            kv = _add_inner(kv, kb)
        if cfg.ml_radiation and ustar is not None and mld is not None:
            km = mlrad_diffusivity(cfg, h, n2, ustar, mld, absf_2d(h, lat))
            kd = _add_inner(kd, km)
            kv = _add_inner(kv, km)
        if cfg.use_tidal:
            e_flux = tidal_energy_2d if tidal_energy_2d is not None \
                else torch.full_like(h[0], cfg.tidal_energy_flux)
            kt = tidal_mixing_coeffs(cfg.tidal, h, n2, e_flux,
                                     rho0=vgrid.Rho0)
            kd = _add_inner(kd, kt)
            kv = _add_inner(kv, kt)

    if cfg.use_ddiff and T is not None and eos is not None:
        zs = torch.cumsum(h, dim=0)
        rho0 = vgrid.Rho0 if vgrid is not None else 1035.0
        g = vgrid.g_Earth if vgrid is not None else 9.8
        p_int = rho0 * g * zs[:-1]
        kd_t, kd_s = ddiff_coeffs(cfg.ddiff, T, S, p_int, eos)
        kd = _add_inner(kd, kd_t)
        kd_extra_S = _inner(torch.clamp(kd_s - kd_t, min=0.0))

    if cfg.use_user_kd and cfg.user_kd is not None and T is not None \
            and eos is not None and lat is not None:
        kd = _add_inner(kd, user_change_diff(cfg.user_kd, h, T, S, eos, lat))

    kd = torch.clamp(kd, min=cfg.kd_min)
    if cfg.kd_max > 0:
        kd = torch.clamp(kd, max=cfg.kd_max)
    kd = _inner(kd[1:-1])
    return DiffusivityResult(kd_int=kd, kv_int=kv, kd_extra_S=kd_extra_S,
                             kv_shear=kv_shear)


def absf_2d(h, lat, omega: float = 7.2921e-5):
    """|f| at h points from the latitude, plus 1e-7; 1e-5 where there is
    no latitude or beyond 90 degrees (the pseudo-latitudes of a grid in
    km)."""
    if lat is None:
        return torch.full_like(h[0], 1e-5)
    f = torch.abs(2.0 * omega * torch.sin(lat * math.pi / 180.0)) + 1e-7
    return torch.where(torch.abs(lat) <= 90.0, f, torch.full_like(f, 1e-5))


def lotw_bbl_diffusivity(cfg: DiffusivityCfg, h, n2, u, v, absf):
    """The bottom-drag TKE cdrag^3/2 |u_b|^3 BBL_EFFIC spent upward from
    the bottom against Kd_wall = vonKar u*^2 z (D - z) / (u* D + f z (D -
    z)), decaying as exp(-z / min(u*/f, 200 m)): a loop over the
    interfaces from the bottom up."""
    u_b = 0.5 * (u[-1] + im1(u[-1]))
    v_b = 0.5 * (v[-1] + jm1(v[-1]))
    umag = torch.sqrt(u_b * u_b + v_b * v_b)
    cdrag = cfg.lotw_cdrag
    ustar = math.sqrt(cdrag) * umag
    ustar2 = ustar * ustar
    tke_rem = cfg.bbl_effic * (cdrag ** 1.5) * umag ** 3
    idecay = torch.clamp(absf / torch.clamp(ustar, min=1e-10),
                         min=1.0 / cfg.lotw_max_decay)
    D = torch.sum(h, dim=0) + 1e-30
    ustar_D = ustar * D
    n2min = 1e-10
    nk = h.shape[0]
    z_bot = torch.zeros_like(D)
    zero = torch.zeros_like(D)
    kd = [None] * (nk - 1)
    # interface K between layers K-1 and K, K = nk-1 .. 1, bottom up
    for K in range(nk - 1, 0, -1):
        h_k, h_km1, n2_k = h[K], h[K - 1], n2[K - 1]
        tke_rem = torch.exp(-idecay * h_k) * tke_rem
        z_b = z_bot + h_k
        dmz = torch.clamp(D - z_b, min=0.0)
        kd_wall = (cfg.vonkar * ustar2 * z_b * dmz) \
            / (ustar_D + absf * (z_b * dmz) + 1e-30)
        dz_int = 0.5 * (h_k + h_km1)
        tke_need = kd_wall * dz_int * torch.clamp(n2_k, min=n2min)
        consumed = torch.minimum(tke_need, tke_rem)
        kd[K - 1] = torch.where(tke_need > 0.0,
                                kd_wall * consumed / (tke_need + 1e-300),
                                zero)
        tke_rem = tke_rem - consumed
        z_bot = z_b
    return torch.stack(kd)


def mlrad_diffusivity(cfg: DiffusivityCfg, h, n2, ustar, mld, absf):
    """Mixed-layer TKE radiated below the mixed layer: the flux MSTAR
    ML_RAD_COEFF u*^3 decays below the MLD with I_decay^2 = TKE_DECAY^2
    f^2/u*^2 + 1/(efold h_ml)^2; each interface turns the flux absorbed
    across its span into Kd = dTKE / (dz N^2), capped at
    ML_RAD_KD_MAX."""
    us = torch.clamp(ustar, min=1e-8)
    flux0 = cfg.mstar_mlrad * cfg.ml_rad_coeff * us ** 3
    h_ml = torch.clamp(mld, min=1.0)
    hml_sq = (cfg.ml_rad_efold * h_ml) ** 2
    i_dec2 = cfg.tke_decay_mlrad ** 2 * (absf / us) ** 2
    i_decay = torch.sqrt((i_dec2 * hml_sq + 1.0) / hml_sq)
    z_int = torch.cumsum(h, dim=0)[:-1]
    dz_int = 0.5 * (h[:-1] + h[1:]) + 1e-30
    below = torch.clamp(z_int - h_ml[None], min=0.0)
    flux = flux0[None] * torch.exp(-i_decay[None] * below)
    absorbed = flux * (1.0 - torch.exp(-i_decay[None] * dz_int))
    kd = absorbed / (dz_int * torch.clamp(n2, min=1e-10))
    kd = torch.where(z_int > h_ml[None], kd, torch.zeros_like(kd))
    return torch.clamp(kd, max=cfg.ml_rad_kd_max)
