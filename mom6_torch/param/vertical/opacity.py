"""Shortwave penetration (counterpart of
``mom6_tpu.param.vertical.opacity``): the downward shortwave splits into
bands that decay exponentially with band e-folding depths (Jerlov water
types, Manizza et al. 2005, Morel & Antoine 1994, or the single
PEN_SW_SCALE / PEN_SW_FRAC band); the heating of each layer is the flux
convergence across it, optionally with CORRECT_ABSORPTION_DEPTH moving
part of a layer's heating into the water above."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["OpacityCfg", "sw_absorption_profile"]

# Jerlov water types: (fraction in band 1, its e-folding depth [m], the
# e-folding depth of band 2 [m])
_JERLOV = {
    "I": (0.58, 0.35, 23.0),
    "IA": (0.62, 0.60, 20.0),
    "IB": (0.67, 1.00, 17.0),
    "II": (0.77, 1.50, 14.0),
    "III": (0.78, 1.40, 7.9),
}


@dataclasses.dataclass(frozen=True)
class OpacityCfg:
    scheme: str = "JERLOV"         # JERLOV | MANIZZA_05 | MOREL_88 | EXPONENTIAL
    water_type: str = "IB"         # WATER_TYPE
    chl: float = 0.1               # CHL_CONC [mg m-3]
    sw_max_pen_depth: float = 1e4
    pen_sw_scale: float = 15.0     # PEN_SW_SCALE [m]
    pen_sw_frac: float = 0.42      # PEN_SW_FRAC
    correct_absorption_depth: bool = False   # CORRECT_ABSORPTION_DEPTH


def _bands(cfg: OpacityCfg):
    scheme = cfg.scheme.upper()
    if scheme == "EXPONENTIAL":
        return ((cfg.pen_sw_frac, max(cfg.pen_sw_scale, 1e-3)),)
    if scheme == "JERLOV":
        r1, z1, z2 = _JERLOV[cfg.water_type.upper()]
        return ((r1, z1), (1.0 - r1, z2))
    if scheme == "MANIZZA_05":
        chl = max(cfg.chl, 0.001)
        k_bg = 0.0232 + 0.074 * chl ** 0.674
        k_r = 0.225 + 0.037 * chl ** 0.629
        return ((0.58, 1.0 / k_r), (0.42, 1.0 / k_bg))
    if scheme == "MOREL_88":
        chl = math.log10(min(max(cfg.chl, 0.02), 60.0))
        chl2 = chl * chl
        z2 = (7.925 - 6.644 * chl) + chl2 * (
            (3.662 - 1.815 * chl) + chl2 * (-0.218 + 0.502 * chl))
        pen = 1.0 - ((0.321 + 0.008 * chl) + chl2 * (
            (0.132 + 0.038 * chl) + chl2 * (-0.017 - 0.007 * chl)))
        return ((1.0 - pen, 0.35), (pen, z2))
    raise ValueError(f"Unknown opacity scheme '{cfg.scheme}'")


def sw_absorption_profile(cfg: OpacityCfg, h, sw_surface):
    """(heating (nk, ...) [W m-2 absorbed in each layer], the shortwave
    left at the bottom)."""
    z_int = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                      dim=0)
    flux_bot = 0.0
    heating = torch.zeros_like(h)
    fsum = 0.0
    hh = z_int[:-1]                          # the water above each layer
    for frac, zpen in _bands(cfg):
        fsum += frac
        fb = frac * sw_surface[None] * torch.exp(
            -torch.clamp(z_int / zpen, max=80.0))
        absorbed = fb[:-1] - fb[1:]
        flux_bot = flux_bot + fb[-1]
        if not cfg.correct_absorption_depth:
            heating = heating + absorbed
            continue
        # a fraction swa of the layer's absorption heats the water above
        # uniformly, so that the pressure-weighted mean heating depth is
        # that of the exact profile within the layer
        od = h / zpen
        e = torch.exp(-torch.clamp(od, max=80.0))
        swa_full = (((od + (od + 2.0) * e) - 2.0)
                    / ((od + hh / zpen) * torch.clamp(1.0 - e, min=1e-30)))
        swa_taylor = h * (od * (1.0 - od)) \
            / ((hh + h) * (6.0 - 3.0 * od) + 1e-30)
        swa = torch.where(od > 1e-5, swa_full, swa_taylor)
        swa = torch.where(hh > 0.0,
                          torch.minimum(swa, hh / (hh + h + 1e-30)),
                          torch.zeros_like(swa))
        heating = heating + (1.0 - swa) * absorbed
        dT_above = swa * absorbed / torch.clamp(hh, min=1e-30)
        s = torch.flip(torch.cumsum(torch.flip(dT_above, [0]), dim=0), [0])
        s_excl = torch.cat([s[1:], torch.zeros_like(s[:1])], dim=0)
        heating = heating + h * s_excl
    if fsum < 1.0 - 1e-12:
        # the non-penetrating remainder is absorbed at the surface
        heating = torch.cat([heating[:1] + (1.0 - fsum) * sw_surface,
                             heating[1:]], dim=0)
    return heating, flux_bot
