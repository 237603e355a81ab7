"""K-profile parameterization (KPP) of the surface boundary layer.

Counterpart of ``mom6_tpu.param.vertical.kpp`` (Large, McWilliams &
Doney 1994 at CVMix fidelity): the Monin-Obukhov stability functions
with their stable, unstable and convective branches, the surface-layer
cap sigma <= 0.1 in unstable forcing, the bulk Richardson number with
the LMD94 eq. 23 unresolved shear, the boundary-layer depth by linear
interpolation to the Ri_crit crossing, and the cubic shape function
G(sigma) = sigma (1 - sigma)^2 with the nonlocal transport shape.  All
branch-free column math over the whole (njh, nih) block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from mom6_torch.parallel.stencil import im1, jm1

__all__ = ["KPPCfg", "KPPResult", "kpp_coefficients"]

_EPS = 1e-14
_VON_KARMAN = 0.4
_ZETA_M = -0.2
_ZETA_S = -1.0
_A_M = 1.26
_C_M = 8.38
_A_S = -28.86
_C_S = 98.96
_SURF_EPS = 0.1


@dataclasses.dataclass(frozen=True)
class KPPCfg:
    ri_crit: float = 0.3          # RI_CRIT
    min_bld: float = 1.0          # minimum boundary layer depth [m]
    cv: float = 1.7               # C_v unresolved-shear coefficient
    beta_t: float = -0.2          # entrainment ratio beta_T
    min_vt2: float = 1e-10        # V_t^2 floor [m2 s-2]
    enhance_entrain: float = 1.0
    nonlocal_transport: bool = True
    kv_prandtl: float = 1.0       # Kv = Pr Kd within the BL


class KPPResult(NamedTuple):
    kd_int: torch.Tensor          # (nk+1, ...) diffusivity [m2 s-1]
    kv_int: torch.Tensor
    bld: torch.Tensor             # boundary layer depth [m]
    nonlocal_shape: torch.Tensor  # (nk+1, ...)


def _phi_m(zeta):
    stable = 1.0 + 5.0 * zeta
    x = torch.clamp(1.0 - 16.0 * zeta, min=1e-12)
    unstable = x ** -0.25
    conv = (_A_M - _C_M * zeta) ** (-1.0 / 3.0)
    return torch.where(zeta >= 0.0, stable,
                       torch.where(zeta >= _ZETA_M, unstable, conv))


def _phi_s(zeta):
    stable = 1.0 + 5.0 * zeta
    x = torch.clamp(1.0 - 16.0 * zeta, min=1e-12)
    unstable = x ** -0.5
    conv = (_A_S - _C_S * zeta) ** (-1.0 / 3.0)
    return torch.where(zeta >= 0.0, stable,
                       torch.where(zeta >= _ZETA_S, unstable, conv))


def _w_scales(sigma, bld, ustar, buoy_flux):
    """(w_m, w_s) at normalized depth sigma; destabilizing buoy_flux > 0
    freezes sigma at the surface-layer value."""
    us = torch.clamp(ustar, min=1e-10)
    u3 = us ** 3
    sig_eff = torch.where(buoy_flux > 0.0,
                          torch.clamp(sigma, max=_SURF_EPS), sigma)
    zeta = -sig_eff * bld * _VON_KARMAN * buoy_flux / u3
    return _VON_KARMAN * us / _phi_m(zeta), _VON_KARMAN * us / _phi_s(zeta)


def _set_ends(x, top=True):
    x = x.clone()
    if top:
        x[0] = 0.0
    x[-1] = 0.0
    return x


def kpp_coefficients(cfg: KPPCfg, u, v, h, T, S, eos, rho0, g,
                     ustar=None, buoy_flux=None) -> KPPResult:
    """KPP boundary-layer diffusivities; ustar [m s-1] and the
    destabilizing-positive surface buoyancy flux [m2 s-3] are
    (njh, nih)."""
    if ustar is None:
        ustar = torch.zeros_like(h[0])
    if buoy_flux is None:
        buoy_flux = torch.zeros_like(h[0])
    z_int = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                      dim=0)
    z_mid = 0.5 * (z_int[:-1] + z_int[1:])

    if T is not None and eos is not None:
        rho = eos.density(T, S, torch.zeros_like(T))
    else:
        rho = torch.zeros_like(h) + rho0
    buoy = -g * (rho - rho0) / rho0

    dz_c = 0.5 * (h[:-1] + h[1:]) + _EPS
    n2_c = torch.clamp((buoy[:-1] - buoy[1:]) / dz_c, min=0.0)
    n_mid = torch.sqrt(torch.cat([n2_c, n2_c[-1:]], dim=0))

    u_h = 0.5 * (u + im1(u))
    v_h = 0.5 * (v + jm1(v))
    db = buoy[0:1] - buoy
    du2 = (u_h - u_h[0:1]) ** 2 + (v_h - v_h[0:1]) ** 2

    _, ws_cand = _w_scales(torch.ones_like(z_mid), z_mid, ustar[None],
                           buoy_flux[None])
    cv_fac = cfg.cv * math.sqrt(-cfg.beta_t / (_C_S * _SURF_EPS)) \
        / (cfg.ri_crit * _VON_KARMAN ** 2)
    vt2 = torch.clamp(cv_fac * z_mid * n_mid * ws_cand, min=cfg.min_vt2)
    ri_b = db * z_mid / torch.clamp(du2 + vt2, min=_EPS)

    exceeded = ri_b >= cfg.ri_crit
    before = torch.cumsum(torch.cat([torch.zeros_like(ri_b[:1]),
                                     exceeded[:-1].to(ri_b.dtype)], dim=0),
                          dim=0) != 0
    first = exceeded & ~before
    ri_up = torch.cat([torch.zeros_like(ri_b[:1]), ri_b[:-1]], dim=0)
    z_up = torch.cat([torch.zeros_like(z_mid[:1]), z_mid[:-1]], dim=0)
    dri = ri_b - ri_up
    frac = torch.clamp((cfg.ri_crit - ri_up)
                       / torch.where(torch.abs(dri) > _EPS, dri, _EPS),
                       0.0, 1.0)
    z_cross = z_up + frac * (z_mid - z_up)
    bld = torch.sum(torch.where(first, z_cross, 0.0), dim=0)
    bld = torch.where(~torch.any(exceeded, dim=0), z_int[-1], bld)
    bld = torch.minimum(torch.clamp(bld, min=cfg.min_bld), z_int[-1])

    sigma = torch.clamp(z_int / torch.clamp(bld[None], min=_EPS), 0.0, 1.0)
    w_m, w_s = _w_scales(sigma, bld[None], ustar[None], buoy_flux[None])
    Gs = sigma * (1.0 - sigma) ** 2
    kd = _set_ends(bld[None] * w_s * Gs * cfg.enhance_entrain)
    kv = _set_ends(bld[None] * w_m * Gs * cfg.kv_prandtl)
    if cfg.nonlocal_transport:
        nl = torch.where(buoy_flux[None] > 0.0, Gs * 6.32739901508, 0.0)
        nl = nl.clone()
        nl[0] = 0.0
    else:
        nl = torch.zeros_like(kd)
    return KPPResult(kd_int=kd, kv_int=kv, bld=bld, nonlocal_shape=nl)
