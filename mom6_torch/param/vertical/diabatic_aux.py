"""Diabatic auxiliaries: surface-flux application.

Counterpart of ``apply_boundary_fluxes`` in
``mom6_tpu.param.vertical.diabatic_aux`` (applyBoundaryFluxesInOut):
non-penetrative heat, the shortwave absorbed in the top layer,
freshwater mass in or out of the top layer diluting or concentrating
its salinity, and an explicit salt flux.  The opacity-profile
shortwave penetration, DEPTH_LIMIT_FLUXES and frazil formation are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BoundaryFluxResult", "apply_boundary_fluxes"]

_H_NEGLECT = 1e-30
_CP = 3991.86795711963      # J kg-1 K-1


class BoundaryFluxResult(NamedTuple):
    h: torch.Tensor
    T: torch.Tensor
    S: torch.Tensor
    net_heat: torch.Tensor      # surface heat into the ocean [W m-2]
    net_salt: torch.Tensor      # salt flux [ppt m s-1 equivalent]
    net_massin: torch.Tensor    # freshwater mass in [kg m-2 s-1]


def _with_top(x, top):
    return torch.cat([top[None], x[1:]], dim=0)


def apply_boundary_fluxes(h, T, S, fluxes, dt, rho0: float,
                          cp: float = _CP, opacity_cfg=None,
                          pen_sw_frac: float = 0.42,
                          angstrom: float = 1e-10,
                          depth_limit_fluxes: float = 0.0):
    """Deposit the surface fluxes into the top layer over dt; returns
    BoundaryFluxResult."""
    zero = torch.zeros_like(h[0])
    if fluxes is None:
        return BoundaryFluxResult(h, T, S, zero, zero, zero)
    if depth_limit_fluxes > 0.0:
        raise NotImplementedError("DEPTH_LIMIT_FLUXES")
    if opacity_cfg is not None and fluxes.sw is not None:
        raise NotImplementedError("opacity: penetrating shortwave")

    heat_nonpen = zero
    for f in (fluxes.lw, fluxes.latent, fluxes.sensible):
        if f is not None:
            heat_nonpen = heat_nonpen + f
    net_heat = heat_nonpen
    if fluxes.sw is not None:
        net_heat = net_heat + fluxes.sw
        heat_nonpen = heat_nonpen + fluxes.sw

    massin = zero
    for f in (fluxes.lprec, fluxes.fprec):
        if f is not None:
            massin = massin + f
    if fluxes.evap is not None:
        massin = massin - fluxes.evap
    dh = massin * dt / rho0
    h0_old = h[0]
    h0_new = torch.clamp(h0_old + dh, min=angstrom)
    if S is not None:
        S = _with_top(S, S[0] * h0_old / torch.clamp(h0_new, min=_H_NEGLECT))
    h = _with_top(h, h0_new)

    net_salt = zero
    if T is not None:
        T = _with_top(T, T[0] + heat_nonpen * dt / (rho0 * cp)
                      / torch.clamp(h[0], min=_H_NEGLECT))
    if S is not None and fluxes.salt_flux is not None:
        net_salt = fluxes.salt_flux * (1000.0 / rho0)
        S = _with_top(S, S[0] + net_salt * dt
                      / torch.clamp(h[0], min=_H_NEGLECT))
    return BoundaryFluxResult(h, T, S, net_heat, net_salt, massin)
