"""Vertical coordinate generators (the regrid half of ALE).

Counterpart of ``mom6_tpu.ale.regridding``: from the column state,
build the target thickness distribution with the same column total.
Modes (REGRIDDING_COORDINATE_MODE): LAYER (no change), Z* (stretched
geopotential), SIGMA (terrain following), RHO (isopycnal target
densities), HYCOM1 (isopycnal interfaces held below the nominal z*
depths), HYBGEN (the HYCOM hybrid generator, ``hybgen_regrid``) and
ADAPTIVE (interfaces chase the lateral curvature of neutral density,
then relax under a vertical grid diffusion).

The working dtype is the thickness's: the nominal resolution is taken
into it, so a float32 run stays float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mom6_torch.ale.hybgen_regrid import HybgenRegridCfg, hybgen_regrid
from mom6_torch.ale.remapping import _thomas_interfaces
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["RegridCfg", "build_grid"]

_H_NEGLECT = 1e-30


@dataclasses.dataclass(frozen=True)
class RegridCfg:
    mode: str = "Z*"                  # REGRIDDING_COORDINATE_MODE
    # nominal layer resolution dz (m for Z*, fractions for SIGMA), or the
    # target densities for RHO (ALE_RESOLUTION / ALE_COORDINATE_CONFIG)
    resolution: tuple = ()
    min_thickness: float = 1e-3       # MIN_THICKNESS [m]
    # the ADAPTIVE coordinate's ADAPT_* parameters
    adapt_time_ratio: float = 0.1     # ADAPT_TIME_RATIO
    adapt_zoom: float = 200.0         # ADAPT_ZOOM_DEPTH [m]
    adapt_zoom_coeff: float = 0.2     # ADAPT_ZOOM_COEFF
    adapt_buoy_coeff: float = 0.8     # ADAPT_BUOY_COEFF
    adapt_alpha: float = 1.0          # ADAPT_ALPHA
    adapt_drho0: float = 0.5          # ADAPT_DRHO0 [kg m-3]
    adapt_do_min: bool = False        # ADAPT_DO_MIN_DEPTH
    # HYBGEN: the hybgen generator's own parameters
    hybgen: Optional[HybgenRegridCfg] = None


def _nominal(cfg: RegridCfg, nk: int) -> np.ndarray:
    if cfg.resolution and len(cfg.resolution) == nk:
        return np.asarray(cfg.resolution, dtype=np.float64)
    return np.full(nk, 1.0 / nk)


def _nominal_interfaces(cfg: RegridCfg, nk: int, bathyT, like):
    """The nominal interface depths (nk+1, 1, 1): the resolution's
    running sum, or fractions of the deepest column without one."""
    dz = torch.as_tensor(_nominal(cfg, nk), dtype=like.dtype,
                         device=like.device)
    if cfg.resolution == ():
        dz = dz * torch.max(bathyT)
    return torch.cat([torch.zeros_like(dz[:1]), torch.cumsum(dz, dim=0)]
                     ).reshape(-1, 1, 1)


def _cummax0(z):
    return torch.cummax(z, dim=0).values


def _zcat(h):
    return torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                     dim=0)


def _build_adapt(cfg: RegridCfg, h, htot, bathyT, T, S, eos, rho0, g,
                 mask2dT):
    """The ADAPTIVE coordinate:

    1. each interior interface moves by the lateral Laplacian of neutral
       density over the vertical density jump (at most half the upwind
       layer, scaled by ADAPT_ALPHA);
    2. the interfaces then relax under an implicit grid diffusion whose
       diffusivity blends a near-surface zoom term, a stratification
       term and a uniform background;
    3. interfaces are made monotonic and no layer is left below
       MIN_THICKNESS.

    The neighbours come from shifts of halo-padded fields: h, T and S need
    one valid halo ring, and ``mask2dT`` keeps land neighbours out.  The
    relaxation is a Thomas solve over the interfaces of every column."""
    nk = h.shape[0]
    if mask2dT is None:
        mask2dT = torch.ones_like(htot)
    zInt = _zcat(h)
    tInt = torch.cat([T[:1], 0.5 * (T[:-1] + T[1:]), T[-1:]], dim=0)
    sInt = torch.cat([S[:1], 0.5 * (S[:-1] + S[1:]), S[-1:]], dim=0)
    pInt = rho0 * g * zInt

    # the lateral curvature of neutral density at the interfaces
    del2sigma = torch.zeros_like(zInt)
    for shift in (ip1, im1, jp1, jm1):
        tn, sn, pn, mn = (shift(tInt), shift(sInt), shift(pInt),
                          shift(mask2dT))
        alpha_n, beta_n = eos.density_derivs(
            0.5 * (tInt + tn), 0.5 * (sInt + sn), 0.5 * (pInt + pn))
        del2sigma = del2sigma + mn[None] * (
            alpha_n * (tn - tInt) + beta_n * (sn - sInt))

    alpha, beta = eos.density_derivs(tInt, sInt, pInt)
    # the vertical density jump across each interior interface
    dT = torch.cat([torch.zeros_like(T[:1]), T[1:] - T[:-1]], dim=0)
    dS = torch.cat([torch.zeros_like(S[:1]), S[1:] - S[:-1]], dim=0)
    drho_v = torch.clamp(alpha[:nk] * dT + beta[:nk] * dS, min=1e-20)
    h_mid = torch.cat([h[:1], 0.5 * (h[:-1] + h[1:])], dim=0)
    dh = del2sigma[:nk] * h_mid / drho_v
    h_up = torch.where(dh > 0.0, h, torch.cat([h[:1], h[:-1]], dim=0))
    dh = (0.5 * cfg.adapt_alpha * torch.sign(dh)
          * torch.minimum(del2sigma[:nk].abs(), 0.5 * h_up))
    K = torch.arange(nk, device=h.device).reshape(-1, 1, 1)
    dh = torch.where(K == 0, 0.0, dh)            # the surface is pinned
    zNext = torch.cat([zInt[:nk] + dh, zInt[-1:]], dim=0)

    # the grid-diffusion relaxation: layer diffusivities from the zoom,
    # stratification and background terms (the stratification across
    # each layer over its new, positive thickness)
    depth = torch.clamp(htot, min=1e-10)
    z_mid = 0.5 * (zNext[:-1] + zNext[1:])
    drdz_lay = (0.5 * (alpha[:-1] + alpha[1:]) * (tInt[1:] - tInt[:-1])
                + 0.5 * (beta[:-1] + beta[1:]) * (sInt[1:] - sInt[:-1]))
    drdz = torch.clamp(drdz_lay / (zNext[1:] - zNext[:-1] + 1e-30),
                       min=0.0)
    kgrid = (cfg.adapt_time_ratio * nk ** 2 * depth) * (
        cfg.adapt_zoom_coeff / (cfg.adapt_zoom + z_mid)
        + cfg.adapt_buoy_coeff * drdz / cfg.adapt_drho0
        + max(1.0 - cfg.adapt_zoom_coeff - cfg.adapt_buoy_coeff, 0.0)
        / depth)
    # (1 + kg[k-1] + kg[k]) z_K - kg[k-1] z_{K-1} - kg[k] z_{K+1} = z*_K
    zero = torch.zeros_like(kgrid[:1])
    kg_up = torch.cat([zero, kgrid], dim=0)[:nk + 1]
    kg_dn = torch.cat([kgrid, zero], dim=0)
    Ki = torch.arange(nk + 1, device=h.device).reshape(-1, 1, 1)
    interior = (Ki >= 1) & (Ki <= nk - 1)
    zNext = _thomas_interfaces(torch.where(interior, -kg_up, 0.0),
                               torch.where(interior, 1.0 + kg_up + kg_dn,
                                           1.0),
                               torch.where(interior, -kg_dn, 0.0), zNext)

    if cfg.adapt_do_min:
        # no interface above the nominal coordinate depths stretched to
        # the column (a HYCOM-like mixed layer)
        dz_nom = torch.as_tensor(_nominal(cfg, nk), dtype=h.dtype,
                                 device=h.device)
        if cfg.resolution == ():
            dz_nom = dz_nom * torch.max(bathyT)
        stretch = zInt[-1] / depth
        z_nom = torch.cumsum(dz_nom.reshape(-1, 1, 1) * stretch[None],
                             dim=0)
        zNext = torch.cat([zNext[:1], torch.minimum(
            torch.maximum(zNext[1:], z_nom), zInt[-1][None])], dim=0)

    # monotonic interfaces and the minimum thickness, totals kept
    zNext = _cummax0(zNext)
    zNext = torch.cat([torch.zeros_like(zNext[:1]), zNext[1:-1],
                       htot[None]], dim=0)
    h_new = _enforce_min(cfg, zNext[1:] - zNext[:-1], htot)
    # land columns keep their grid
    return torch.where(mask2dT[None] > 0.0, h_new, h)


def build_grid(cfg: RegridCfg, h, bathyT, T=None, S=None, eos=None,
               rlay=None, rho0: float = 1035.0, g: float = 9.8,
               mask2dT=None):
    """h_new (nk, njh, nih) with the column totals of h.

    ``mask2dT`` is read by ADAPTIVE only, whose neighbour stencil needs
    one valid halo ring of h, T and S."""
    nk = h.shape[0]
    htot = torch.sum(h, dim=0)
    mode = cfg.mode.upper().replace("*", "STAR")

    if mode in ("LAYER", "NONE"):
        return h
    if mode in ("ADAPTIVE", "ADAPT"):
        if T is None or S is None or eos is None:
            raise ValueError("ADAPTIVE regridding needs T, S and an EOS")
        return _build_adapt(cfg, h, htot, bathyT, T, S, eos, rho0, g,
                            mask2dT)
    if mode == "HYBGEN":
        hcfg = cfg.hybgen
        if hcfg is None:
            dz = _nominal(cfg, nk)
            if cfg.resolution == ():
                dz = dz * float(torch.max(bathyT))
            hcfg = HybgenRegridCfg(dp0k=tuple(dz), ds0k=tuple(0.1 * dz),
                                   min_thickness=cfg.min_thickness)
        if T is not None and eos is not None:
            rcv = eos.density(T, S, hcfg.ref_pressure)
        else:
            rcv = torch.broadcast_to(rlay.reshape(-1, 1, 1), h.shape)
        return _enforce_min(cfg, hybgen_regrid(hcfg, h, rcv, rlay, bathyT),
                            htot)

    if mode in ("HYCOM1", "HYBRID"):
        # isopycnal interfaces, never above the nominal z* depths
        h_rho = build_grid(dataclasses.replace(cfg, mode="RHO"), h,
                           bathyT, T, S, eos, rlay=rlay, rho0=rho0, g=g)
        z_nom = torch.minimum(_nominal_interfaces(cfg, nk, bathyT, h),
                              htot[None])
        z_new = _cummax0(torch.maximum(_zcat(h_rho), z_nom))
        z_new = torch.cat([z_new[:-1], htot[None]], dim=0)
        return _enforce_min(cfg, z_new[1:] - z_new[:-1], htot)

    if mode == "SIGMA":
        frac = _nominal(cfg, nk)
        frac = frac / frac.sum()
        h_new = torch.as_tensor(frac, dtype=h.dtype, device=h.device
                                ).reshape(-1, 1, 1) * htot[None]

    elif mode == "ZSTAR":
        # nominal interfaces capped at the local depth, then stretched so
        # the deepest one meets the column total
        zcap = torch.minimum(_nominal_interfaces(cfg, nk, bathyT, h),
                             bathyT[None])
        z_new = zcap * (htot[None] / (zcap[-1:] + _H_NEGLECT))
        h_new = z_new[1:] - z_new[:-1]

    elif mode == "RHO":
        if rlay is None:
            raise ValueError("RHO regridding requires target densities")
        zs = _zcat(h)
        z_mid = 0.5 * (zs[:-1] + zs[1:])
        if T is not None and eos is not None:
            rho = eos.density(T, S, rho0 * g * z_mid)
        else:
            rho = torch.broadcast_to(rlay.reshape(-1, 1, 1), h.shape)
        # the monotonic (stably stratified) profile, inverted piecewise
        # linearly at the interface target densities
        rho_mono = _cummax0(rho)
        rho_int = 0.5 * (rlay[:-1] + rlay[1:])
        r_lo, r_hi = rho_mono[:-1][None], rho_mono[1:][None]
        z_lo, z_hi = z_mid[:-1][None], z_mid[1:][None]
        tgt = rho_int.reshape((-1, 1) + (1,) * (h.dim() - 1))
        inside = (tgt >= r_lo) & (tgt < r_hi + 1e-12)
        first = torch.cumsum(inside.to(torch.int32), dim=1) == 1
        sel = inside & first
        frac = torch.where(r_hi > r_lo + 1e-12,
                           (tgt - r_lo) / (r_hi - r_lo + _H_NEGLECT), 0.0)
        z_at = torch.sum(torch.where(sel, z_lo + frac * (z_hi - z_lo), 0.0),
                         dim=1)
        # targets lighter than the whole column go to the surface,
        # denser ones to the bottom
        above = tgt[:, 0] < rho_mono[0][None]
        below = tgt[:, 0] >= rho_mono[-1][None]
        z_at = torch.where(above, 0.0, torch.where(below, htot[None], z_at))
        z_new = _cummax0(torch.cat([torch.zeros_like(htot)[None], z_at,
                                    htot[None]], dim=0))
        h_new = z_new[1:] - z_new[:-1]
    else:
        raise ValueError(f"Unknown REGRIDDING_COORDINATE_MODE "
                         f"'{cfg.mode}'")

    return _enforce_min(cfg, h_new, htot)


def _enforce_min(cfg: RegridCfg, h_new, htot):
    """Minimum thickness: the deficit carried down the column, then up,
    and the column rescaled to its exact total."""
    h_min = cfg.min_thickness

    def enforce(hv):
        debt = torch.zeros_like(hv[0])
        out = []
        for k in range(hv.shape[0]):
            avail = hv[k] + debt
            o = torch.clamp(avail, min=h_min)
            debt = avail - o
            out.append(o)
        return torch.stack(out, dim=0)

    hv = enforce(h_new)
    hv = enforce(hv.flip(0)).flip(0)
    tot2 = torch.sum(hv, dim=0)
    return hv * (htot / (tot2 + _H_NEGLECT))[None]
