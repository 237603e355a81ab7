"""Geothermal heating (counterpart of
``mom6_tpu.param.vertical.geothermal``): a bottom heat flux warms the
deepest layer thicker than 1 mm of each column."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GeothermalCfg", "geothermal_heating"]

_CP = 3991.86795711963


@dataclasses.dataclass(frozen=True)
class GeothermalCfg:
    geothermal_flux: float = 0.0     # GEOTHERMAL_FLUX [W m-2]
    rho0: float = 1035.0


def geothermal_heating(cfg: GeothermalCfg, T, h, dt, flux_2d=None):
    """T + Q dt / (rho0 Cp h) in each column's deepest wet layer."""
    if cfg.geothermal_flux <= 0.0 and flux_2d is None:
        return T
    q = flux_2d if flux_2d is not None else cfg.geothermal_flux
    nk = h.shape[0]
    htol = 1e-3
    k_idx = torch.arange(nk, device=h.device).reshape(
        (-1,) + (1,) * (h.dim() - 1))
    k_bot = torch.amax(torch.where(h > htol, k_idx, -1), dim=0)
    sel = k_idx == k_bot[None]
    dT = q * dt / (cfg.rho0 * _CP * torch.clamp(h, min=htol))
    return T + torch.where(sel, dT, torch.zeros_like(dT))
