"""Variable mixing coefficient scalings (VarMix).

Counterpart of ``mom6_tpu.param.lateral.varmix``: the resolution
function Res = dx_term^p / (dx_term^p + (coef c1)^p), with
dx_term = f^2 L^2 + c1 beta L^2 the squared length-scale term, which
damps the eddy parameterizations where the deformation radius is
resolved (at h points and, evaluated directly or averaged under
INTERPOLATE_RES_FN, at u and v faces); the column Eady growth rate SN
from interface-height slopes (or from the EOS isoneutral slopes under
USE_STORED_SLOPES); and the Visbeck diffusivity KHTH_SLOPE_CFF SN L^2.

The divisions by (coef c1)^p and N^2 guard against a zero denominator,
which only a float32 column at rest reaches; no float64 value changes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.isopycnal_slopes import SlopeCfg, isoneutral_slopes
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.diagnostics.wave_speed import wave_speed_wkb
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["VarMixCfg", "VarMixResult", "calc_resolution_function",
           "calc_eady_rate", "visbeck_kh"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class VarMixCfg:
    use_variable_mixing: bool = False   # USE_VARIABLE_MIXING
    res_scale_meke: bool = False
    res_fn_power: int = 2               # KH_RES_FN_POWER
    res_coef: float = 1.0               # KH_RES_SCALE_COEF
    khth_slope_cff: float = 0.0         # KHTH_SLOPE_CFF
    visbeck_l_scale: float = 0.0        # VISBECK_L_SCALE [m]; <= 0: grid
    slope_max: float = 1e-2             # slope cap in the Eady integrand
    gill_equatorial_ld: bool = True     # GILL_EQUATORIAL_LD
    interpolate_res_fn: bool = False    # INTERPOLATE_RES_FN
    varmix_ktop: int = 2                # VARMIX_KTOP
    use_stored_slopes: bool = False     # USE_STORED_SLOPES


class VarMixResult(NamedTuple):
    res_fn: torch.Tensor          # (njh, nih) in [0, 1]
    rd_dx: torch.Tensor           # deformation radius / grid spacing
    res_fn_u: Optional[torch.Tensor] = None
    res_fn_v: Optional[torch.Tensor] = None


def _safe_ratio(num, den):
    """num / den, with a zero den (float32 underflow) taken as the
    smallest normal number of the dtype."""
    return num / torch.clamp(den, min=torch.finfo(den.dtype).tiny)


def _res_fn(dx_term2, cg1, coef, power):
    """dx_term^p / (dx_term^p + (coef cg1)^p) with dx_term2 the squared
    length-scale term; power >= 100 is the sharp cutoff."""
    if power >= 100:
        return (~((coef * cg1) ** 2 > dx_term2)).to(dx_term2.dtype)
    if power == 2:
        return _safe_ratio(dx_term2, dx_term2 + (coef * cg1) ** 2)
    if power % 2 == 0:
        dxt = dx_term2 ** (power // 2)
    else:
        dxt = torch.sqrt(dx_term2) ** power
    return _safe_ratio(dxt, dxt + (coef * cg1) ** power)


def calc_resolution_function(cfg: VarMixCfg, grid: Grid,
                             vgrid: VerticalGrid, h, T=None, S=None,
                             eos=None, f_min: float = 1e-17) -> VarMixResult:
    """The resolution function at h points and faces and Rd/dx, with
    Gill's (factor 2 on beta, the default) or Pedlosky's equatorial
    deformation radius; ``f_min`` is VERY_SMALL_FREQUENCY."""
    c1 = wave_speed_wkb(vgrid, h, T, S, eos)
    fB = grid.CoriolisBu
    fB2 = fB * fB
    one_or_two = 2.0 if cfg.gill_equatorial_ld else 1.0
    dfx = (fB - im1(fB)) * grid.IdxCv
    dfy = (fB - jm1(fB)) * grid.IdyCu
    dfx2, dfy2 = dfx * dfx, dfy * dfy

    f2_h = 0.25 * ((fB2 + im1(jm1(fB2))) + (im1(fB2) + jm1(fB2)))
    L2_h = grid.dxT ** 2 + grid.dyT ** 2
    f2_dx2_h = L2_h * torch.clamp(f2_h, min=f_min ** 2)
    beta_dx2_h = one_or_two * L2_h * torch.sqrt(
        0.5 * ((dfx2 + jm1(dfx2)) + (dfy2 + im1(dfy2))))
    dx_term_h = f2_dx2_h + c1 * beta_dx2_h
    rd_dx = c1 / torch.sqrt(torch.clamp(dx_term_h, min=_EPS))
    res_h = _res_fn(dx_term_h, c1, cfg.res_coef, cfg.res_fn_power)

    if cfg.interpolate_res_fn:
        res_u = 0.5 * (res_h + ip1(res_h))
        res_v = 0.5 * (res_h + jp1(res_h))
    else:
        L2_u = grid.dxCu ** 2 + grid.dyCu ** 2
        f2_u = torch.clamp(0.5 * (fB2 + jm1(fB2)), min=f_min ** 2)
        beta_u = one_or_two * L2_u * torch.sqrt(
            0.25 * ((jm1(dfx2) + ip1(dfx2)) + (ip1(jm1(dfx2)) + dfx2))
            + dfy2)
        cg1_u = 0.5 * (c1 + ip1(c1))
        res_u = _res_fn(L2_u * f2_u + cg1_u * beta_u, cg1_u,
                        cfg.res_coef, cfg.res_fn_power)
        L2_v = grid.dxCv ** 2 + grid.dyCv ** 2
        f2_v = torch.clamp(0.5 * (fB2 + im1(fB2)), min=f_min ** 2)
        beta_v = one_or_two * L2_v * torch.sqrt(
            dfx2 + 0.25 * ((im1(dfy2) + jp1(dfy2))
                           + (jp1(im1(dfy2)) + dfy2)))
        cg1_v = 0.5 * (c1 + jp1(c1))
        res_v = _res_fn(L2_v * f2_v + cg1_v * beta_v, cg1_v,
                        cfg.res_coef, cfg.res_fn_power)
    return VarMixResult(res_fn=res_h, rd_dx=rd_dx, res_fn_u=res_u,
                        res_fn_v=res_v)


def calc_eady_rate(cfg: VarMixCfg, grid: Grid, vgrid: VerticalGrid,
                   h, T=None, S=None, eos=None):
    """Column Eady growth rate SN [s-1] at h points:
    SN^2 = (1/D) int S^2 N^2 dz with the slopes capped at slope_max;
    slopes from interface-height gradients and N^2 from the Rlay jumps
    unless USE_STORED_SLOPES (then the EOS isoneutral slopes and
    N^2), interfaces above VARMIX_KTOP left out."""
    if T is None or eos is None or not cfg.use_stored_slopes:
        e = -torch.cumsum(h, dim=0)[:-1]
        sx = (e - im1(e)) * grid.IdxT
        sy = (e - jm1(e)) * grid.IdyT
        s2 = torch.clamp(sx * sx + sy * sy, max=cfg.slope_max ** 2)
        rl = vgrid.Rlay.reshape((-1,) + (1,) * (h.dim() - 1))
        dz = 0.5 * (h[:-1] + h[1:]) + _EPS
        n2 = (vgrid.g_Earth / vgrid.Rho0) \
            * torch.clamp(rl[1:] - rl[:-1], min=0.0) / dz
    else:
        sl = isoneutral_slopes(SlopeCfg(slope_max=cfg.slope_max), grid,
                               vgrid, h, T, S, eos)
        sx_h = 0.5 * (sl.slope_x + im1(sl.slope_x))
        sy_h = 0.5 * (sl.slope_y + jm1(sl.slope_y))
        s2 = torch.clamp(sx_h * sx_h + sy_h * sy_h, max=cfg.slope_max ** 2)
        n2 = sl.n2
        dz = 0.5 * (h[:-1] + h[1:])
    if cfg.varmix_ktop > 2:
        kidx = torch.arange(s2.shape[0], device=s2.device).reshape(
            (-1,) + (1,) * (s2.dim() - 1))
        s2 = torch.where(kidx >= cfg.varmix_ktop - 2, s2, 0.0)
    depth = torch.sum(h, dim=0) + _EPS
    sn2 = torch.sum(s2 * torch.clamp(n2, min=0.0) * dz, dim=0) / depth
    return torch.sqrt(torch.clamp(sn2, min=0.0)) * grid.mask2dT


def visbeck_kh(cfg: VarMixCfg, grid: Grid, sn):
    """Visbeck et al. (1997) thickness diffusivity KHTH_SLOPE_CFF SN L^2
    with L the grid scale or VISBECK_L_SCALE; None when the coefficient
    is off."""
    if cfg.khth_slope_cff <= 0.0:
        return None
    L = cfg.visbeck_l_scale if cfg.visbeck_l_scale > 0.0 \
        else torch.sqrt(grid.areaT)
    return cfg.khth_slope_cff * sn * L * L * grid.mask2dT
