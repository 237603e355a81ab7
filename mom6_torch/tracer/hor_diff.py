"""Lateral (along-layer) tracer diffusion.

Counterpart of ``mom6_tpu.tracer.hor_diff`` for the plain KHTR path:
Laplacian diffusion along layers with harmonic-mean face thicknesses,
exactly conservative, in ``passes`` sub-steps whose face coefficient is
bounded by the diffusive CFL.  A 2D coefficient, the resolution and
Visbeck face terms, and the mixed-layer epipycnal diffusion are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["TracerHorDiffCfg", "tracer_hordiff"]

_H_NEGLECT = 1e-20


@dataclasses.dataclass(frozen=True)
class TracerHorDiffCfg:
    khtr: float = 0.0             # KHTR [m2 s-1]
    khtr_min: float = 0.0         # KHTR_MIN
    khtr_max: float = -1.0        # KHTR_MAX (<= 0: none)
    max_diff_cfl: float = 0.2     # per-pass diffusive CFL bound
    passes: int = 2
    khtr_slope_cff: float = 0.0   # KHTR_SLOPE_CFF (not ported)
    diffuse_ml_to_interior: bool = False   # (not ported)

    # the JAX package's mixed-layer epipycnal settings, inert while
    # DIFFUSE_ML_TO_INTERIOR (not ported: it raises) is off
    _INERT = {"ml_khtr_scale": "diffuse_ml_to_interior",
              "nkml": "diffuse_ml_to_interior",
              "nkmb": "diffuse_ml_to_interior",
              "p_ref": "diffuse_ml_to_interior"}


def tracer_hordiff(domain, grid: Grid, tracers: dict, h, dt,
                   cfg: TracerHorDiffCfg, khtr_2d=None):
    """Diffuse each tracer along layers over dt; h needs 1 halo ring."""
    if khtr_2d is not None:
        raise NotImplementedError("khtr_2d: spatially varying KHTR")
    if cfg.khtr_slope_cff > 0.0:
        raise NotImplementedError("KHTR_SLOPE_CFF: Visbeck tracer "
                                  "diffusivity")
    if cfg.diffuse_ml_to_interior:
        raise NotImplementedError("DIFFUSE_ML_TO_INTERIOR: epipycnal "
                                  "mixed-layer diffusion")
    if cfg.khtr <= 0.0:
        return tracers

    k = cfg.khtr
    if cfg.khtr_max > 0:
        k = min(k, cfg.khtr_max)
    k = max(k, cfg.khtr_min)

    out = dict(tracers)
    dt_pass = dt / cfg.passes
    for _ in range(cfg.passes):
        kh_u = torch.clamp(cfg.max_diff_cfl * grid.dxCu ** 2 / dt_pass,
                           max=k) * grid.mask2dCu
        kh_v = torch.clamp(cfg.max_diff_cfl * grid.dyCv ** 2 / dt_pass,
                           max=k) * grid.mask2dCv
        h_u = 2.0 * h * ip1(h) / (h + ip1(h) + _H_NEGLECT)
        h_v = 2.0 * h * jp1(h) / (h + jp1(h) + _H_NEGLECT)
        coef_u = kh_u * grid.dyCu * grid.IdxCu * h_u
        coef_v = kh_v * grid.dxCv * grid.IdyCv * h_v
        hvol = h * grid.areaT + _H_NEGLECT
        for name, t in out.items():
            fx = coef_u * (ip1(t) - t)
            fy = coef_v * (jp1(t) - t)
            dtr = ((fx - im1(fx)) + (fy - jm1(fy))) * dt_pass
            out[name] = t + dtr / hvol
        out = domain.fill_halos(out, width=1)
    return out
