"""Shear-driven interior mixing by the gradient Richardson number
(counterpart of ``mom6_tpu.param.vertical.shear_mixing``, CVMix's LMD94
and PP81 closures):

  LMD94: Kd = NU_ZERO (1 - min(Ri/RI_ZERO, 1)^2)^KPP_EXP for Ri > 0,
         NU_ZERO for Ri < 0;
  PP81:  nu = NU_ZERO / (1 + a Ri)^n, Kd = nu / (1 + a Ri).
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.parallel.stencil import im1, jm1

__all__ = ["ShearMixingCfg", "shear_mixing_coeffs", "richardson_number"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class ShearMixingCfg:
    scheme: str = "LMD94"         # LMD94 | PP81 | NONE
    nu_zero: float = 5e-3         # NU_ZERO [m2 s-1]
    ri_zero: float = 0.8          # RI_ZERO
    kpp_exp: float = 3.0          # KPP_EXP
    pp_alpha: float = 5.0         # PP81 alpha
    pp_exp: float = 2.0           # PP81 exponent n


def richardson_number(u, v, h, n2):
    """Gradient Ri at the interior interfaces from the shear of the
    h-point velocities."""
    u_h = 0.5 * (u + im1(u))
    v_h = 0.5 * (v + jm1(v))
    dz = 0.5 * (h[:-1] + h[1:]) + _EPS
    du = (u_h[1:] - u_h[:-1]) / dz
    dv = (v_h[1:] - v_h[:-1]) / dz
    s2 = du * du + dv * dv
    return n2 / torch.clamp(s2, min=_EPS)


def shear_mixing_coeffs(cfg: ShearMixingCfg, u, v, h, n2):
    """Kd at the interior interfaces (nk-1, ...)."""
    scheme = cfg.scheme.upper()
    if scheme == "NONE":
        return torch.zeros_like(h[1:])
    ri = richardson_number(u, v, h, n2)
    if scheme == "LMD94":
        frac = torch.clamp(ri / cfg.ri_zero, 0.0, 1.0)
        kd = cfg.nu_zero * (1.0 - frac * frac) ** cfg.kpp_exp
        return torch.where(ri < 0.0, torch.full_like(kd, cfg.nu_zero), kd)
    if scheme == "PP81":
        denom = 1.0 + cfg.pp_alpha * torch.clamp(ri, min=0.0)
        nu = cfg.nu_zero / denom ** cfg.pp_exp
        return nu / denom
    raise ValueError(f"Unknown shear mixing scheme '{cfg.scheme}'")
