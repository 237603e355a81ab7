"""Convective and double-diffusive mixing (counterpart of
``mom6_tpu.param.vertical.conv_ddiff``): KD_CONV where N^2 is at or
below its threshold, and the salt-fingering and diffusive-convection
diffusivities of T and S from the density ratio (Large et al. 1994)."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ConvectionCfg", "convection_coeffs", "DoubleDiffusionCfg",
           "ddiff_coeffs"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class ConvectionCfg:
    kd_conv: float = 1.0          # KD_CONV [m2 s-1]
    bv_sqr_conv: float = 0.0      # N^2 at or below which the water convects


def convection_coeffs(cfg: ConvectionCfg, n2):
    """Kd at the interior interfaces: KD_CONV where convecting."""
    return torch.where(n2 <= cfg.bv_sqr_conv, torch.full_like(n2, cfg.kd_conv),
                       torch.zeros_like(n2))


@dataclasses.dataclass(frozen=True)
class DoubleDiffusionCfg:
    max_salt_kd: float = 1e-4     # salt-fingering Kd at R_rho = 1
    r_rho0: float = 1.9           # salt-fingering cutoff density ratio
    mol_diff: float = 1.5e-6      # molecular diffusivity [m2 s-1]


def ddiff_coeffs(cfg: DoubleDiffusionCfg, T, S, p_int, eos):
    """(kd_T, kd_S) at the interior interfaces from R_rho = alpha dT /
    (beta dS)."""
    T_i = 0.5 * (T[:-1] + T[1:])
    S_i = 0.5 * (S[:-1] + S[1:])
    dRdT, dRdS = eos.density_derivs(T_i, S_i, p_int)
    aTz = -dRdT * (T[:-1] - T[1:])
    bSz = dRdS * (S[:-1] - S[1:])
    r_rho = aTz / torch.where(torch.abs(bSz) > _EPS, bSz,
                              torch.full_like(bSz, _EPS))
    zero = torch.zeros_like(r_rho)

    # salt fingering: warm salty over cool fresh, 1 < R_rho < R_rho0
    finger = (aTz > 0) & (bSz > 0) & (r_rho > 1.0) & (r_rho < cfg.r_rho0)
    fac = torch.clamp(1.0 - (r_rho - 1.0) / (cfg.r_rho0 - 1.0), 0.0, 1.0)
    kd_s_f = cfg.max_salt_kd * fac ** 3
    kd_t_f = 0.7 * kd_s_f

    # diffusive convection: cool fresh over warm salty, 0 < R_rho < 1
    dc = (aTz < 0) & (bSz < 0) & (r_rho > 0.0) & (r_rho < 1.0)
    r_safe = torch.clamp(r_rho, min=_EPS)
    kd_t_d = cfg.mol_diff * 0.909 * torch.exp(
        4.6 * torch.exp(-0.54 * (1.0 / r_safe - 1.0)))
    fac_s = torch.where(r_rho >= 0.5, (1.85 - 0.85 / r_safe) * r_rho,
                        0.15 * r_rho)
    kd_s_d = kd_t_d * fac_s

    kd_T = torch.where(finger, kd_t_f, zero) + torch.where(dc, kd_t_d, zero)
    kd_S = torch.where(finger, kd_s_f, zero) + torch.where(dc, kd_s_d, zero)
    return kd_T, kd_S
