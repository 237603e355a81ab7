"""Stochastic physics perturbations: SPPT and SKEB.

Counterpart of ``mom6_tpu.param.stochastic.stochastics``
(MOM_stochastics): AR(1)-in-time, spatially smoothed random patterns
from the layout-invariant gridded generator (``framework/random.py``).
SPPT multiplies the column-physics tendencies by (1 + a pattern);
SKEB adds a non-divergent velocity increment curl(psi) whose amplitude
follows the smoothed local dissipation rate of the resolved flow,
modulated by a second pattern and tapered to zero near land.  The
patterns take the dtype and device of the grid.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mom6_torch.framework.random import gridded_normal
from mom6_torch.parallel.domain import Domain
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["StochasticsCfg", "init_pattern", "step_pattern", "apply_sppt",
           "skeb_taper", "apply_skeb"]


@dataclasses.dataclass(frozen=True)
class StochasticsCfg:
    do_sppt: bool = False            # DO_SPPT
    sppt_amplitude: float = 0.5      # SPPT_AMPLITUDE
    decorr_steps: int = 48           # SPPT_DECORR_STEPS: AR(1) [steps]
    smooth_passes: int = 4           # SPPT_SMOOTH_PASSES
    clip: float = 0.8                # |pattern| clip for stability
    do_skeb: bool = False            # DO_SKEB
    skeb_npass: int = 5              # SKEB_NPASS 9-point smoother passes
    skeb_taper_width: int = 4        # SKEB_TAPER_WIDTH [cells]
    skeb_amplitude: float = 1.0      # SKEB_AMPLITUDE


def _smooth(domain: Domain, f, passes: int):
    for _ in range(passes):
        f = 0.5 * f + 0.125 * ((ip1(f) + im1(f)) + (jp1(f) + jm1(f)))
        f = domain.fill_halos(f, width=1)
    return f


def init_pattern(domain: Domain, cfg: StochasticsCfg, seed: int, i0=0,
                 j0=0, *, dtype: torch.dtype = torch.float64, device="cpu"):
    """A smoothed normal pattern (njh, nih) from ``seed``."""
    r = gridded_normal(domain, seed, 1, i0, j0, dtype=dtype,
                       device=device)[0]
    return _smooth(domain, r, cfg.smooth_passes)


def step_pattern(domain: Domain, cfg: StochasticsCfg, pattern, seed: int,
                 step: int, i0=0, j0=0):
    """AR(1) update p' = phi p + sqrt(1 - phi^2) eps, with fresh smoothed
    noise eps from the seed ``seed + step + 1``."""
    phi = math.exp(-1.0 / cfg.decorr_steps)
    eps = gridded_normal(domain, seed + step + 1, 1, i0, j0,
                         dtype=pattern.dtype, device=pattern.device)[0]
    eps = _smooth(domain, eps, cfg.smooth_passes)
    return phi * pattern + math.sqrt(1.0 - phi * phi) * eps


def apply_sppt(cfg: StochasticsCfg, tendency, pattern):
    """A physics tendency times (1 + a clip(pattern))."""
    return tendency * (1.0 + cfg.sppt_amplitude
                       * torch.clamp(pattern, -cfg.clip, cfg.clip))


def skeb_taper(domain: Domain, grid, width: int):
    """(taperCu, taperCv): ramps to zero within ``width`` cells of land,
    from ``width`` passes of a min filter on the T mask (a normalized
    distance to land)."""
    t = grid.mask2dT
    for _ in range(width):
        mn = torch.minimum(t, torch.minimum(ip1(t), im1(t)))
        mn = torch.minimum(mn, torch.minimum(jp1(t), jm1(t)))
        t = domain.fill_halos(torch.minimum(t, mn + 1.0 / width), width=1)
    taper = torch.clamp(t, 0.0, 1.0) * grid.mask2dT
    t_cu = torch.minimum(taper, ip1(taper)) * grid.mask2dCu
    t_cv = torch.minimum(taper, jp1(taper)) * grid.mask2dCv
    return t_cu, t_cv


def apply_skeb(domain: Domain, grid, cfg: StochasticsCfg, u, v, wts,
               dt: float, taper_cu=None, taper_cv=None, extra_diss=None):
    """(u, v) plus the SKEB increment: the dissipation rate estimated from
    the deformation (shear and tension) of the flow, smoothed by an
    area-weighted 9-point filter SKEB_NPASS times, gives at each corner
    psi = amplitude sqrt(dt/4 * (sum of the 4 cells' rates)) * wts; the
    increment is (-dpsi/dy, dpsi/dx) times the land taper.  u and v need
    one valid halo ring."""
    mcv2 = grid.mask2dCv * im1(grid.mask2dCv)
    mcu2 = grid.mask2dCu * jm1(grid.mask2dCu)
    shr = (v - im1(v)) * (mcv2 * grid.IdxCv)[None] \
        + (u - jm1(u)) * (mcu2 * grid.IdyCu)[None]
    ten = (v - im1(v)) * (mcv2 * grid.IdyCv)[None] \
        + (u - jm1(u)) * (mcu2 * grid.IdxCu)[None]
    tot = torch.sqrt(shr * shr + ten * ten) * grid.mask2dT[None]
    diss = tot ** 3 * grid.areaT[None]
    if extra_diss is not None:
        diss = diss + extra_diss
    w = grid.mask2dT * grid.areaT
    den = (w + ip1(w) + im1(w) + jp1(w) + jm1(w) + ip1(jp1(w))
           + ip1(jm1(w)) + im1(jp1(w)) + im1(jm1(w)))
    diss = domain.fill_halos(diss, width=1)
    for _ in range(cfg.skeb_npass):
        wd = w * diss
        num = (wd + ip1(wd) + im1(wd) + jp1(wd) + jm1(wd) + ip1(jp1(wd))
               + ip1(jm1(wd)) + im1(jp1(wd)) + im1(jm1(wd)))
        diss = domain.fill_halos(
            torch.where(grid.mask2dT[None] > 0, num / (den + 1e-16), diss),
            width=1)
    d4 = (diss + ip1(jp1(diss))) + (jp1(diss) + ip1(diss))
    psi = cfg.skeb_amplitude * torch.sqrt(
        0.25 * dt * torch.clamp(d4, min=0.0)) * wts[None]
    if taper_cu is None or taper_cv is None:
        taper_cu, taper_cv = skeb_taper(domain, grid, cfg.skeb_taper_width)
    ustar = -(psi - jm1(psi)) * (taper_cu * grid.IdyCu)[None]
    vstar = (psi - im1(psi)) * (taper_cv * grid.IdxCv)[None]
    return u + ustar, v + vstar
