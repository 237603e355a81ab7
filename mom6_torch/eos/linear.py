"""Linear equation of state (counterpart of ``mom6_tpu.eos.linear``):
rho = Rho_T0_S0 + dRho_dT*T + dRho_dS*S, pressure-independent."""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.eos.base import EOS

__all__ = ["LinearEOS"]


@dataclasses.dataclass(frozen=True)
class LinearEOS(EOS):
    rho_t0_s0: float = 1000.0
    drho_dt: float = -0.2
    drho_ds: float = 0.8

    name = "LINEAR"

    def density(self, T, S, p, rho_ref: float = 0.0):
        return ((self.rho_t0_s0 - rho_ref)
                + (self.drho_dt * T + self.drho_ds * S))

    def density_derivs(self, T, S, p):
        one = torch.ones_like(T)
        return self.drho_dt * one, self.drho_ds * one

    def compressibility(self, T, S, p):
        return torch.zeros_like(T)
