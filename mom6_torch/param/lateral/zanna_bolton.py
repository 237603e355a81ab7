"""Zanna & Bolton (2020) subgrid momentum closure.

Counterpart of ``mom6_tpu.param.lateral.zanna_bolton``: a deterministic
eddy stress from the velocity-gradient invariants,

    Txx/Tyy = -k ( -/+ vort*shear + (vort^2 + shear^2 + tension^2)/2 )
    Txy     = -k ( vort*tension )

with k = ZB_SCALING times the cell area (compute_stress), whose
thickness-weighted divergence accelerates the flow
(compute_stress_divergence).  The reference's high-pass filters and
attenuation are not in the JAX package either.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.param.lateral.hor_visc import _strains
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["ZB2020Cfg", "zb2020_accel"]

_H_NEGLECT = 1e-20


@dataclasses.dataclass(frozen=True)
class ZB2020Cfg:
    amplitude: float = 0.5    # ZB_SCALING
    zb_type: int = 0          # ZB_TYPE: 0 full, 1 trace-free, 2 trace only
    zb_cons: int = 0          # ZB_CONS: 0 plain, 1 area-weighted vort*shear


class ZBResult(NamedTuple):
    du: torch.Tensor
    dv: torch.Tensor


def zb2020_accel(grid: Grid, u, v, h, cfg: ZB2020Cfg) -> ZBResult:
    """(du, dv) accelerations [m s-2]; u, v need 2 halo rings, h one."""
    sh_xx, sh_xy, _, vort_xy = _strains(grid, u, v, no_slip=False)
    sh_xy = sh_xy * grid.mask2dBu
    vort_xy = vort_xy * grid.mask2dBu
    kappa_h = -cfg.amplitude * grid.areaT * grid.mask2dT
    kappa_q = -cfg.amplitude * grid.areaBu * grid.mask2dBu

    def q_to_h(f):
        return 0.25 * ((im1(jm1(f)) + f) + (im1(f) + jm1(f)))

    sh_xy_h = q_to_h(sh_xy)
    vort_h = q_to_h(vort_xy)
    sum_sq = 0.0
    if cfg.zb_type != 1:
        sum_sq = 0.5 * ((vort_h * vort_h + sh_xy_h * sh_xy_h)
                        + sh_xx * sh_xx)
    vort_sh = 0.0
    if cfg.zb_type != 2:
        if cfg.zb_cons == 1:
            vort_sh = q_to_h(grid.areaBu * vort_xy * sh_xy) * grid.IareaT
        else:
            vort_sh = vort_h * sh_xy_h
    Txx = kappa_h * (-vort_sh + sum_sq)
    Tyy = kappa_h * (vort_sh + sum_sq)
    if cfg.zb_type != 2:
        sh_xx_q = 0.25 * ((ip1(jp1(sh_xx)) + sh_xx)
                          + (ip1(sh_xx) + jp1(sh_xx)))
        Txy = kappa_q * (vort_xy * sh_xx_q)
    else:
        Txy = torch.zeros_like(vort_xy)

    dy2h = grid.dyT * grid.dyT
    dx2h = grid.dxT * grid.dxT
    dx2q = grid.dxBu * grid.dxBu
    dy2q = grid.dyBu * grid.dyBu
    hq = 0.25 * ((h + ip1(jp1(h))) + (ip1(h) + jp1(h))) * grid.mask2dBu
    Mxx = Txx * h * dy2h
    Myy = Tyy * h * dx2h
    Mxy = Txy * hq
    h_m = grid.mask2dT * h
    h_u = 0.5 * (h_m + ip1(h_m)) + _H_NEGLECT
    h_v = 0.5 * (h_m + jp1(h_m)) + _H_NEGLECT
    fx = -((grid.IdyCu * (Mxx - ip1(Mxx))
            + grid.IdxCu * (jm1(dx2q * Mxy) - dx2q * Mxy))
           * grid.IareaCu) / h_u
    fy = -((grid.IdyCv * (im1(dy2q * Mxy) - dy2q * Mxy)
            + grid.IdxCv * (Myy - jp1(Myy)))
           * grid.IareaCv) / h_v
    return ZBResult(du=fx * grid.mask2dCu, dv=fy * grid.mask2dCv)
