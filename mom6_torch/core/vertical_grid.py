"""Vertical grid description (counterpart of
``mom6_tpu.core.vertical_grid``): layer count, target densities and
reduced gravities.  ``Rlay`` (nk,) and ``g_prime`` (nk+1,) are tensors
on the grid's device; the scalars stay Python floats."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["VerticalGrid"]


@dataclasses.dataclass(frozen=True)
class VerticalGrid:
    nk: int
    g_Earth: float = 9.8
    Rho0: float = 1035.0
    boussinesq: bool = True
    angstrom: float = 1e-10          # minimum layer thickness [m]
    Rlay: torch.Tensor = None        # layer target densities (nk,)
    g_prime: torch.Tensor = None     # interface reduced gravity (nk+1,)

    @staticmethod
    def from_rlay(rlay, g_Earth: float = 9.8, Rho0: float = 1035.0,
                  g_fs: float | None = None, *, device, dtype: torch.dtype,
                  **kw) -> "VerticalGrid":
        """Layer densities given directly (COORD_CONFIG ts_range):
        g_prime[0] = g_fs (default g), g_prime[K] = g dRlay / Rho0."""
        rlay = np.asarray(rlay, dtype=np.float64)
        nk = rlay.shape[0]
        gp = np.zeros(nk + 1)
        gp[0] = g_Earth if g_fs is None else g_fs
        gp[1:nk] = (g_Earth / Rho0) * (rlay[1:] - rlay[:-1])
        return VerticalGrid(
            nk=nk, g_Earth=g_Earth, Rho0=Rho0,
            Rlay=torch.as_tensor(rlay, dtype=dtype, device=device),
            g_prime=torch.as_tensor(gp, dtype=dtype, device=device), **kw)

    @staticmethod
    def uniform(nk: int, g_Earth: float = 9.8, Rho0: float = 1035.0,
                gint: float | None = None, light: float | None = None,
                *, device, dtype: torch.dtype, **kw) -> "VerticalGrid":
        """Layer densities from a uniform interface reduced gravity
        ``gint`` (VerticalGrid.uniform of the JAX package)."""
        gp = np.zeros(nk + 1)
        gp[0] = g_Earth
        if gint is not None:
            gp[1:] = gint
        rlay = np.zeros(nk)
        rlay[0] = light if light is not None else Rho0
        for k in range(1, nk):
            rlay[k] = rlay[k - 1] + gp[k] * Rho0 / g_Earth
        return VerticalGrid(
            nk=nk, g_Earth=g_Earth, Rho0=Rho0,
            Rlay=torch.as_tensor(rlay, dtype=dtype, device=device),
            g_prime=torch.as_tensor(gp, dtype=dtype, device=device), **kw)
