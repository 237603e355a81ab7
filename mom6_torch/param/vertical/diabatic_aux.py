"""Diabatic auxiliaries: frazil formation and the surface fluxes.

Counterpart of ``mom6_tpu.param.vertical.diabatic_aux``: ``make_frazil``
clamps water below its (pressure- and salinity-dependent) freezing
point back to it with the JAX package's bottom-up deficit march, the
deficit surfacing as frazil heat [J m-2] that the state accumulates
(RECLAIM_FRAZIL lets warm surface water melt the pending frazil first);
``apply_boundary_fluxes`` (applyBoundaryFluxesInOut) deposits the
non-penetrative heat, the shortwave (spread over the column by the
opacity bands when given), freshwater mass diluting or concentrating
the top layer's salinity, and an explicit salt flux, all scaled away
over columns shallower than DEPTH_LIMIT_FLUXES.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.param.vertical.opacity import sw_absorption_profile
from mom6_torch.parallel.domain import tree_map

__all__ = ["FrazilCfg", "t_freeze", "make_frazil", "BoundaryFluxResult",
           "apply_boundary_fluxes"]

_H_NEGLECT = 1e-30
_CP = 3991.86795711963      # J kg-1 K-1


@dataclasses.dataclass(frozen=True)
class FrazilCfg:
    # linear freezing point Tf = dtfr_ds S + tfr_s0_p0 + dtfr_dp p
    tfr_s0_p0: float = 0.0        # [degC]
    dtfr_ds: float = -0.054       # [degC ppt-1]
    dtfr_dp: float = -7.75e-8     # [degC Pa-1]
    rho0: float = 1035.0
    cp: float = 3991.86795711963  # C_P [J kg-1 K-1]
    g: float = 9.81
    reclaim: bool = True          # RECLAIM_FRAZIL


def t_freeze(cfg: FrazilCfg, S, p):
    return cfg.tfr_s0_p0 + cfg.dtfr_ds * S + cfg.dtfr_dp * p


def make_frazil(cfg: FrazilCfg, h, T, S, angstrom: float = 1e-10,
                p_surf=None, frazil_prev=None):
    """(T, frazil): from the bottom up, a sub-freezing layer adds its
    heat deficit to the column's, which the warmer layers above absorb
    down to their own freezing point before the rest surfaces as frazil;
    layers no thicker than 10 angstrom are clamped and pass the deficit
    on.  ``frazil_prev`` is the accumulated frazil not yet extracted:
    with RECLAIM_FRAZIL an above-freezing surface layer melts it first,
    and the returned frazil is the new accumulated total."""
    z_mid = torch.cumsum(h, dim=0) - 0.5 * h
    p = cfg.rho0 * cfg.g * z_mid
    if p_surf is not None:
        p = p + p_surf
    tf = t_freeze(cfg, S, p)
    hc = cfg.rho0 * cfg.cp * torch.clamp(h, min=_H_NEGLECT)
    thin = h <= 10.0 * angstrom

    carried = torch.zeros_like(T[0]) if frazil_prev is None else frazil_prev
    if cfg.reclaim and frazil_prev is not None:
        warm = hc[0] * torch.clamp(T[0] - tf[0], min=0.0)
        melt = torch.minimum(carried, warm)
        T = torch.cat([(T[0] - melt / hc[0])[None], T[1:]], dim=0)
        carried = carried - melt

    nk = h.shape[0]
    fraz = torch.zeros_like(T[0])
    out = [None] * nk
    for k in range(nk - 1, -1, -1):
        t_k, tf_k, hc_k = T[k], tf[k], hc[k]
        t_thick = torch.maximum(tf_k, t_k - fraz / hc_k)
        f_thick = torch.clamp(fraz + hc_k * (tf_k - t_k), min=0.0)
        t_thin = torch.maximum(tf_k, t_k)
        f_thin = fraz + hc_k * torch.clamp(tf_k - t_k, min=0.0)
        out[k] = torch.where(thin[k], t_thin, t_thick)
        fraz = torch.where(thin[k], f_thin, f_thick)
    return torch.stack(out), carried + fraz


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
    """Deposit the surface fluxes over dt; returns BoundaryFluxResult.
    Only the top layer changes, except under penetrating shortwave."""
    zero = torch.zeros_like(h[0])
    if fluxes is None:
        return BoundaryFluxResult(h, T, S, zero, zero, zero)
    if depth_limit_fluxes > 0.0:
        scale = torch.clamp(torch.sum(h, dim=0) / depth_limit_fluxes,
                            max=1.0)
        fluxes = type(fluxes)(**{
            f.name: tree_map(lambda a: a * scale, getattr(fluxes, f.name))
            for f in dataclasses.fields(fluxes)})

    heat_nonpen = zero
    for f in (fluxes.lw, fluxes.latent, fluxes.sensible):
        if f is not None:
            heat_nonpen = heat_nonpen + f
    net_heat = heat_nonpen
    sw = fluxes.sw
    if sw is not None:
        net_heat = net_heat + sw
    if sw is not None and opacity_cfg is not None:
        heating, sw_bottom = sw_absorption_profile(opacity_cfg, h, sw)
        # the shortwave reaching the bottom heats the deepest layer
        heating = torch.cat([heating[:-1], (heating[-1] + sw_bottom)[None]],
                            dim=0)
        T = T + heating * (dt / (rho0 * cp)) / torch.clamp(h, min=_H_NEGLECT)
    elif sw is not None:
        heat_nonpen = heat_nonpen + sw

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

