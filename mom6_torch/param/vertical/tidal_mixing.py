"""Tidally driven internal-wave mixing (counterpart of
``mom6_tpu.param.vertical.tidal_mixing``; St Laurent et al. 2002 and
Polzin 2009 vertical structures): the energy E(x, y) the barotropic
tide loses to internal tides deposits as

  Kd = q Gamma E F(z) / (rho0 max(N^2, N0^2)),

F the bottom-intensified profile of unit integral, capped at kd_max;
``internal_tide_input`` is the barotropic-to-internal conversion that
feeds the internal-tide energy (Jayne and St Laurent 2001)."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TidalMixingCfg", "tidal_mixing_coeffs", "internal_tide_input"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class TidalMixingCfg:
    int_tide_dissipation: bool = True
    gamma_itides: float = 0.2          # GAMMA_ITIDES
    q_itides: float = 0.3333           # locally dissipating fraction
    int_tide_decay_scale: float = 500.0   # INT_TIDE_DECAY_SCALE [m]
    kd_max: float = 5e-3               # cap [m2 s-1]
    min_n2: float = 1e-8               # N0^2 floor [s-2]
    profile: str = "STLAURENT_02"      # INT_TIDE_PROFILE | POLZIN_09
    polzin_decay_scale: float = 300.0  # z_p [m]


def internal_tide_input(u_tide_amp, h_rough, n_bot, rho0=1035.0,
                        kappa_itides=2.0 * 3.14159265 / 1.0e4):
    """Barotropic-to-internal tide energy flux E = 0.5 rho0 kappa h^2
    N_bot U^2 [W m-2]."""
    return 0.5 * rho0 * kappa_itides * h_rough ** 2 * n_bot \
        * u_tide_amp ** 2


def tidal_mixing_coeffs(cfg: TidalMixingCfg, h, n2, e_flux,
                        rho0: float = 1035.0):
    """Kd at the interior interfaces (nk-1, ...) from the tidal energy
    flux ``e_flux`` (njh, nih)."""
    if not cfg.int_tide_dissipation:
        return torch.zeros_like(h[1:])
    htot = torch.sum(h, dim=0)
    z_int = torch.cumsum(h, dim=0)[:-1]
    hab = htot[None] - z_int
    if cfg.profile.upper().startswith("POLZIN"):
        zp = cfg.polzin_decay_scale
        norm = htot / (zp + htot) + _EPS
        Fz = (zp / (zp + hab) ** 2) / norm[None]
    else:
        zeta = cfg.int_tide_decay_scale
        norm = zeta * (1.0 - torch.exp(-htot / zeta)) + _EPS
        Fz = torch.exp(-hab / zeta) / norm[None]
    kd = (cfg.q_itides * cfg.gamma_itides * e_flux[None] * Fz
          / (rho0 * torch.clamp(n2, min=cfg.min_n2)))
    return torch.clamp(kd, max=cfg.kd_max)
