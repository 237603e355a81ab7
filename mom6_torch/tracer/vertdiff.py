"""Implicit vertical diffusion of tracers (counterpart of
``mom6_tpu.tracer.vertdiff``): a fully implicit tridiagonal solve per
column, sharing the Thomas recursion of the viscosity solver."""

from __future__ import annotations

import torch

from mom6_torch.core.vert_friction import implicit_visc_solve

__all__ = ["tracer_vertdiff"]

_H_NEGLECT = 1e-30


def tracer_vertdiff(t, h, kd_int, dt, sfc_flux=None, bot_flux=None):
    """Implicit vertical diffusion: (h + dt L) t' = h t + dt*fluxes.

    kd_int: (nk+1, ...) interface diffusivities [m2 s-1];
    sfc_flux: tracer flux into the top layer [conc m s-1]."""
    dz = 0.5 * (h[:-1] + h[1:]) + _H_NEGLECT
    a_int = kd_int[1:-1] / dz
    a = torch.cat([torch.zeros_like(h[:1]), a_int, torch.zeros_like(h[:1])],
                  dim=0)
    rhs_extra = None
    if sfc_flux is not None:
        rhs_extra = dt * sfc_flux
    t_new = implicit_visc_solve(t, h + _H_NEGLECT, a, dt,
                                rhs_extra=rhs_extra)
    if bot_flux is not None:
        t_new = torch.cat([t_new[:-1], t_new[-1:] + (
            dt * bot_flux / (h[-1] + _H_NEGLECT))[None]], dim=0)
    return t_new
