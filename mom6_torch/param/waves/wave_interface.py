"""Surface-wave coupling: Stokes drift and the Langmuir enhancement of
boundary-layer mixing (counterpart of
``mom6_tpu.param.waves.wave_interface``): an exponential Stokes profile
from a constant surface drift or from the wind (U_s = 0.016 U10, decay
from the fully developed peak wavelength), the turbulent Langmuir number
La_t = sqrt(u*/U_s), and the Li et al. (2016) factor on the KPP or ePBL
diffusivity."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["WavesCfg", "StokesResult", "stokes_profile", "langmuir_number",
           "langmuir_enhancement"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class WavesCfg:
    wave_method: str = "EMPIRICAL"   # EMPIRICAL (from the wind) | CONST
    const_us: float = 0.0            # CONST_STOKES_DRIFT [m s-1]
    const_decay: float = 5.0         # STOKES_DECAY_SCALE [m]
    us_wind_frac: float = 0.016      # U_s / U10


class StokesResult(NamedTuple):
    us: torch.Tensor      # (nk, ...) zonal drift at layer centres
    vs: torch.Tensor
    us0: torch.Tensor     # surface magnitude


def stokes_profile(cfg: WavesCfg, h, u10=None, wind_dir_x=None,
                   wind_dir_y=None):
    """u_s(z) = U_s0 exp(-z / decay) at the layer centres."""
    z_int = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                      dim=0)
    z_mid = 0.5 * (z_int[:-1] + z_int[1:])
    if cfg.wave_method == "CONST":
        us0 = torch.full_like(h[0], cfg.const_us)
        decay = torch.full_like(h[0], cfg.const_decay)
    else:
        u10 = u10 if u10 is not None else torch.zeros_like(h[0])
        us0 = cfg.us_wind_frac * u10
        decay = torch.clamp(0.33 * u10 * u10 / (4.0 * math.pi), min=1.0)
    prof = us0[None] * torch.exp(-z_mid / torch.clamp(decay, min=_EPS))
    dx = wind_dir_x if wind_dir_x is not None else torch.ones_like(h[0])
    dy = wind_dir_y if wind_dir_y is not None else torch.zeros_like(h[0])
    norm = torch.sqrt(dx * dx + dy * dy) + _EPS
    return StokesResult(us=prof * (dx / norm)[None],
                        vs=prof * (dy / norm)[None], us0=us0)


def langmuir_number(ustar, us0):
    """La_t = sqrt(u* / U_s0)."""
    return torch.sqrt(torch.clamp(ustar, min=_EPS)
                      / torch.clamp(us0, min=_EPS))


def langmuir_enhancement(la_t):
    """sqrt(1 + (1.5 La)^-2 + (5.4 La)^-4), La floored at 0.1, capped at
    5."""
    la = torch.clamp(la_t, min=0.1)
    f = torch.sqrt(1.0 + (1.5 * la) ** -2 + (5.4 * la) ** -4)
    return torch.clamp(f, max=5.0)
