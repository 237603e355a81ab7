"""Near-boundary lateral tracer diffusion (counterpart of
``mom6_tpu.tracer.hor_bnd_diffusion``): horizontal diffusion restricted
to the surface boundary layer, each layer's exchange thickness the part
of it above the boundary-layer depth (KPP/ePBL), in the conservative
thickness-weighted flux form of the along-layer diffusion."""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["HorBndDiffCfg", "hor_bnd_diffusion"]

_EPS = 1e-20


@dataclasses.dataclass(frozen=True)
class HorBndDiffCfg:
    khtr_bnd: float = 0.0        # HBD_KHTR [m2 s-1]
    max_diff_cfl: float = 0.2


def hor_bnd_diffusion(domain, grid: Grid, tracers: dict, h, bld, dt,
                      cfg: HorBndDiffCfg):
    """Diffuse tracers laterally inside the boundary layer of depth
    ``bld`` (njh, nih) [m]; h and bld need 1 halo ring."""
    if cfg.khtr_bnd <= 0.0:
        return tracers
    z_top = torch.cat([torch.zeros_like(h[:1]),
                       torch.cumsum(h, dim=0)[:-1]], dim=0)
    frac = torch.clamp((bld[None] - z_top) / (h + _EPS), 0.0, 1.0)
    kh_u = torch.clamp(cfg.max_diff_cfl * grid.dxCu ** 2 / dt,
                       max=cfg.khtr_bnd) * grid.mask2dCu
    kh_v = torch.clamp(cfg.max_diff_cfl * grid.dyCv ** 2 / dt,
                       max=cfg.khtr_bnd) * grid.mask2dCv
    hb = frac * h
    hb_u = 2.0 * hb * ip1(hb) / (hb + ip1(hb) + _EPS)
    hb_v = 2.0 * hb * jp1(hb) / (hb + jp1(hb) + _EPS)
    hvol = h * grid.areaT + _EPS
    out = dict(tracers)
    for name, t in out.items():
        fx = kh_u * grid.dyCu * grid.IdxCu * hb_u * (ip1(t) - t)
        fy = kh_v * grid.dxCv * grid.IdyCv * hb_v * (jp1(t) - t)
        out[name] = t + ((fx - im1(fx)) + (fy - jm1(fy))) * dt / hvol
    return out
