"""Energetically constrained planetary boundary layer, ePBL (counterpart
of ``mom6_tpu.param.vertical.energetic_pbl``).

The boundary layer deepens as far as the mechanical TKE m* u*^3 dt,
decaying with depth over u*/(TKE_DECAY |f|), and the convective release
n* B z dt pay the potential-energy cost of homogenizing the column above
each interface (closed form from cumulative moments).  m* (constant, or
the rotation-dependent form of EPBL_MSTAR_MODE 2) depends on the mixed
layer depth it sets: a fixed number of fixed-point passes resolves that
coupling (USE_MLD_ITERATION, EPBL_MLD_MAX_ITS).  Kd = c_K v* l(z), with
v* = (u*^3 + n* B MLD)^(1/3) and the parabolic mixing length l(z) = z (1
- z/MLD), floored at the minimum mixing length inside the layer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["EPBLCfg", "EPBLResult", "energetic_pbl"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class EPBLCfg:
    mstar: float = 1.2           # EPBL_MSTAR
    mstar_mode: int = 0          # EPBL_MSTAR_MODE: 0 constant, else OM4
    mstar_at_xint: float = 0.095
    mstar_slope: float = 0.85
    nstar: float = 0.2           # EPBL_NSTAR
    tke_decay: float = 2.5       # TKE_DECAY
    min_mld: float = 1.0
    max_mld: float = 0.0         # 0: no cap
    use_mld_iteration: bool = True   # USE_MLD_ITERATION
    mld_iters: int = 3           # EPBL_MLD_MAX_ITS
    c_k: float = 0.55            # Kd = c_k v* l(z)
    vstar_scale: float = 1.0
    min_mix_len: float = 1.0     # [m]
    kd_max: float = 0.1          # [m2 s-1]


class EPBLResult(NamedTuple):
    kd_int: torch.Tensor
    mld: torch.Tensor


def _mstar_value(cfg: EPBLCfg, ustar, absf, h_bl):
    if cfg.mstar_mode == 0:
        return torch.full_like(ustar, cfg.mstar)
    # the mixing efficiency drops where the layer is deep against the
    # Ekman depth u*/f
    x = absf * h_bl / torch.clamp(ustar, min=1e-10)
    return cfg.mstar / (1.0 + (cfg.mstar_at_xint * x) ** cfg.mstar_slope)


def energetic_pbl(cfg: EPBLCfg, h, T, S, eos, rho0, g, dt, ustar=None,
                  buoy_flux=None, absf=None):
    """Boundary-layer Kd (nk+1, ...) and the mixed layer depth [m].
    ``buoy_flux``: the destabilizing-positive surface buoyancy flux [m2
    s-3]; ``absf``: |f| at h points."""
    if ustar is None:
        ustar = torch.zeros_like(h[0])
    if buoy_flux is None:
        buoy_flux = torch.zeros_like(h[0])
    if absf is None:
        absf = torch.full_like(h[0], 1e-4)

    z_int = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                      dim=0)
    z_mid = 0.5 * (z_int[:-1] + z_int[1:])
    # surface-referenced potential density: no compressibility in the cost
    if T is not None and eos is not None:
        rho = eos.density(T, S, torch.zeros_like(T))
    else:
        rho = torch.full_like(h, rho0)

    # PE cost of homogenizing the column above each interface [J m-2]
    m_cum = torch.cumsum(rho * h, dim=0)
    hz_cum = torch.cumsum(h * z_mid, dim=0)
    rhz_cum = torch.cumsum(rho * h * z_mid, dim=0)
    h_cum = torch.cumsum(h, dim=0)
    rho_bar = m_cum / (h_cum + _EPS)
    cost = torch.clamp(g * (rhz_cum - rho_bar * hz_cum), min=0.0)

    w_star3 = torch.clamp(buoy_flux, min=0.0)
    w_conv = (torch.clamp(w_star3, min=0.0) * 50.0) ** (1.0 / 3.0)
    v_scale = torch.clamp(torch.maximum(ustar, 0.5 * w_conv), min=1e-8)
    decay = torch.clamp(
        v_scale / (torch.clamp(absf, min=1e-8) * cfg.tke_decay), min=1.0)

    mld = torch.clamp(h[0], min=cfg.min_mld)
    n_its = max(cfg.mld_iters, 1) if cfg.use_mld_iteration else 1
    zero = torch.zeros_like(cost)
    for _ in range(n_its):
        mstar = _mstar_value(cfg, ustar, absf, mld)
        mech = mstar * rho0 * ustar[None] ** 3 * dt
        conv = cfg.nstar * rho0 * w_star3[None] * z_int[1:] * dt
        avail = mech * torch.exp(-z_int[1:] / decay[None]) + conv
        z_aff = torch.where(cost <= avail, z_int[1:], zero)
        mld = torch.clamp(torch.amax(z_aff, dim=0), min=cfg.min_mld)
        if cfg.max_mld > 0.0:
            mld = torch.clamp(mld, max=cfg.max_mld)

    vstar = cfg.vstar_scale * (
        ustar[None] ** 3
        + cfg.nstar * w_star3[None] * mld[None]) ** (1.0 / 3.0)
    zfrac = torch.clamp(z_int / torch.clamp(mld[None], min=_EPS), 0.0, 1.0)
    mix_len = torch.clamp(mld[None] * zfrac * (1.0 - zfrac), min=0.0)
    in_bl = (z_int > 0.0) & (zfrac < 1.0)
    mix_len = torch.where(in_bl, torch.clamp(mix_len, min=cfg.min_mix_len),
                          mix_len)
    kd = torch.clamp(cfg.c_k * vstar * mix_len, max=cfg.kd_max)
    z = torch.zeros_like(kd[:1])
    kd = torch.cat([z, kd[1:-1], z], dim=0)
    return EPBLResult(kd_int=kd, mld=mld)
