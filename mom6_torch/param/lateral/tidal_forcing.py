"""Astronomical tidal forcing and scalar self-attraction and loading.

Counterpart of ``mom6_tpu.param.lateral.tidal_forcing``: the
equilibrium tidal potential of the main semidiurnal and diurnal
constituents,

  semidiurnal: eta_eq = A L cos^2(lat) cos(w t + 2 lon)
  diurnal:     eta_eq = A L sin(2 lat) cos(w t + lon)

with the Love-number factor L = 1 + k2 - h2 = 0.693, and the scalar
SAL approximation eta_sal = beta eta (SAL_SCALAR_VALUE).  Their sum is
a geopotential height anomaly that the pressure force subtracts from
the interface heights.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TidalForcingCfg", "CONSTITUENTS", "equilibrium_tide",
           "scalar_sal", "tides_fn"]

# name: (frequency [rad/s], amplitude [m], species: 2 semidiurnal,
# 1 diurnal)
CONSTITUENTS = {
    "M2": (1.40519e-4, 0.242334, 2),
    "S2": (1.45444e-4, 0.112743, 2),
    "N2": (1.37880e-4, 0.046397, 2),
    "K2": (1.45842e-4, 0.030684, 2),
    "K1": (0.72921e-4, 0.141565, 1),
    "O1": (0.67598e-4, 0.100661, 1),
    "P1": (0.72523e-4, 0.046848, 1),
    "Q1": (0.64959e-4, 0.019273, 1),
}

_LOVE = 0.693      # 1 + k2 - h2


@dataclasses.dataclass(frozen=True)
class TidalForcingCfg:
    constituents: tuple = ("M2",)       # the TIDE_<name> switches
    use_sal_scalar: bool = True         # SAL_SCALAR_APPROX
    sal_scalar: float = 0.094           # SAL_SCALAR_VALUE


def equilibrium_tide(cfg: TidalForcingCfg, time_s: float, lat_deg,
                     lon_deg):
    """eta_eq(t) [m] at h points from the selected constituents."""
    phi = torch.deg2rad(lat_deg)
    lam = torch.deg2rad(lon_deg)
    eta = torch.zeros_like(lat_deg)
    for name in cfg.constituents:
        om, amp, species = CONSTITUENTS[name]
        if species == 2:
            eta = eta + _LOVE * amp * torch.cos(phi) ** 2 \
                * torch.cos(om * time_s + 2.0 * lam)
        else:
            eta = eta + _LOVE * amp * torch.sin(2.0 * phi) \
                * torch.cos(om * time_s + lam)
    return eta


def scalar_sal(cfg: TidalForcingCfg, eta):
    """Scalar self-attraction and loading: eta_sal = beta eta."""
    if not cfg.use_sal_scalar:
        return torch.zeros_like(eta)
    return cfg.sal_scalar * eta


def tides_fn(cfg: TidalForcingCfg, grid, sal=None):
    """The (eta, t) -> tidal + SAL geopotential height anomaly [m] that
    the steppers call once a step (the JAX builder's ``tides_fn``):
    the equilibrium tide plus the spherical-harmonic SAL ``sal`` when
    given, else the scalar SAL, masked to wet cells."""
    def fn(eta, t):
        e = equilibrium_tide(cfg, t, grid.geoLatT, grid.geoLonT)
        if sal is not None:
            e = e + sal(eta)
        elif cfg.use_sal_scalar:
            e = e + cfg.sal_scalar * eta
        return e * grid.mask2dT
    fn.cfg, fn.sal = cfg, sal
    return fn
