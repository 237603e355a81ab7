"""Integral-feedback controlled forcing.

Counterpart of ``mom6_tpu.drivers.controlled_forcing``: slowly evolving
corrective fluxes heat_0 and precip_0 driven by the surface temperature
and salinity anomalies, with a diffusive smoothing of the correction
fields,

    d(heat_0)/dt   = rate (-lambda_T SST' + div(L^2 grad heat_0))
    d(precip_0)/dt = rate (+lambda_S SSS'/S_mean + div(L^2 grad precip_0)),

added to the surface heat flux and precipitation each thermodynamic
step.  The reference's seasonal cycle of corrections is not reproduced,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["CtrlForcingCfg", "apply_ctrl_forcing", "init_ctrl_state"]


@dataclasses.dataclass(frozen=True)
class CtrlForcingCfg:
    heat_int_rate: float = 0.0    # CTRL_FORCE_HEAT_INT_RATE [s-1]
    prec_int_rate: float = 0.0    # CTRL_FORCE_PREC_INT_RATE [s-1]
    smooth_len: float = 0.0       # CTRL_FORCE_SMOOTH_LENGTH [m]
    lam_heat: float = 0.0         # CTRL_FORCE_LAMDA_HEAT [W m-2 K-1]
    lam_prec: float = 0.0         # CTRL_FORCE_LAMDA_PREC [kg m-2 s-1]


def init_ctrl_state(shape2d, *, device="cuda",
                    dtype: torch.dtype = torch.float64) -> dict:
    """Zero heat_0 and precip_0 controller fields."""
    return {"heat_0": torch.zeros(shape2d, device=device, dtype=dtype),
            "precip_0": torch.zeros(shape2d, device=device, dtype=dtype)}


def _smooth_div(grid, f, len2):
    """div(L^2 grad f) with the reference's metric factors."""
    fx = len2 * grid.dyCu * grid.IdxCu * (f - ip1(f))
    fy = len2 * grid.dxCv * grid.IdyCv * (f - jp1(f))
    return grid.IareaT * ((im1(fx) - fx) + (jm1(fy) - fy))


def apply_ctrl_forcing(cfg: CtrlForcingCfg, grid, ctrl, sst_anom,
                       sss_anom, sss_mean, dt):
    """One controller update: (new ctrl, virtual heat [W m-2], virtual
    precipitation [kg m-2 s-1])."""
    len2 = cfg.smooth_len ** 2
    h0, p0 = ctrl["heat_0"], ctrl["precip_0"]
    h0 = h0 + (dt * cfg.heat_int_rate) * (
        -cfg.lam_heat * grid.mask2dT * sst_anom
        + _smooth_div(grid, h0, len2))
    p0 = p0 + (dt * cfg.prec_int_rate) * (
        cfg.lam_prec * grid.mask2dT
        * (sss_anom / (torch.clamp(sss_mean, min=1e-12)
                       if torch.is_tensor(sss_mean) else max(sss_mean, 1e-12)))
        + _smooth_div(grid, p0, len2))
    return {"heat_0": h0, "precip_0": p0}, h0, p0
