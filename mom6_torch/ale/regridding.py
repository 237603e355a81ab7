"""Vertical coordinate generators (the regrid half of ALE).

Counterpart of ``mom6_tpu.ale.regridding``: from the column state,
build the target thickness distribution with the same column total.
Modes (REGRIDDING_COORDINATE_MODE): LAYER (no change), Z* (stretched
geopotential), SIGMA (terrain following), RHO (isopycnal target
densities) and HYCOM1 (isopycnal interfaces held below the nominal
z* depths).  ADAPTIVE and the HYCOM hybgen generator (HYBGEN) are not
ported yet and raise ``NotImplementedError``.

The working dtype is the thickness's: the nominal resolution is taken
into it, so a float32 run stays float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["RegridCfg", "build_grid"]

_H_NEGLECT = 1e-30


@dataclasses.dataclass(frozen=True)
class RegridCfg:
    mode: str = "Z*"                  # REGRIDDING_COORDINATE_MODE
    # nominal layer resolution dz (m for Z*, fractions for SIGMA), or the
    # target densities for RHO (ALE_RESOLUTION / ALE_COORDINATE_CONFIG)
    resolution: tuple = ()
    min_thickness: float = 1e-3       # MIN_THICKNESS [m]


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


def build_grid(cfg: RegridCfg, h, bathyT, T=None, S=None, eos=None,
               rlay=None, rho0: float = 1035.0, g: float = 9.8,
               mask2dT=None):
    """h_new (nk, njh, nih) with the column totals of h."""
    nk = h.shape[0]
    htot = torch.sum(h, dim=0)
    mode = cfg.mode.upper().replace("*", "STAR")

    if mode in ("LAYER", "NONE"):
        return h
    if mode in ("ADAPTIVE", "ADAPT"):
        raise NotImplementedError("REGRIDDING_COORDINATE_MODE = ADAPTIVE")
    if mode == "HYBGEN":
        raise NotImplementedError("REGRIDDING_COORDINATE_MODE = HYBGEN: "
                                  "the HYCOM hybgen generator")

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
