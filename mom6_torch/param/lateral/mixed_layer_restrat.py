"""Mixed-layer restratification by submesoscale eddies.

Counterpart of ``mom6_tpu.param.lateral.mixed_layer_restrat``: the Fox-
Kemper, Ferrari & Hallberg (2008) overturning streamfunction

  Psi = C_e (H_ml^2 grad b) / sqrt(f^2 + tau^-2) mu(z),
  mu(z) = max(0, (1 - zn^2)(1 + (5/21) zn^2)),  zn = 2z/H_ml - 1,

applied as layer transports within the mixed layer, with the buoyancy
gradient from the mixed-layer mean surface-referenced density and each
face transport limited to a fifth of the upwind layer's volume.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["MLRestratCfg", "MLRestratResult", "mixed_layer_restrat"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class MLRestratCfg:
    fox_kemper_ml_restrat_coef: float = 20.0   # FOX_KEMPER_ML_RESTRAT_COEF
    ml_restrat_timescale: float = 86400.0      # front timescale tau [s]
    hml_const: float = 50.0                    # fallback Hml [m]


class MLRestratResult(NamedTuple):
    h: torch.Tensor
    uhml: torch.Tensor
    vhml: torch.Tensor


def _mu(zi, hbl):
    zn = torch.clamp(2.0 * zi / torch.clamp(hbl[None], min=_EPS) - 1.0,
                     -1.0, 1.0)
    return torch.clamp((1.0 - zn * zn) * (1.0 + (5.0 / 21.0) * zn * zn),
                       min=0.0)


def mixed_layer_restrat(cfg: MLRestratCfg, grid: Grid, vgrid: VerticalGrid,
                        h, dt, T=None, S=None, eos=None, hml=None):
    """Apply the MLE overturning transports over dt (h/T/S need 1 halo
    ring); hml is the mixed-layer depth (e.g. the KPP BLD), default
    ``hml_const``."""
    g_acc, rho0 = vgrid.g_Earth, vgrid.Rho0
    if hml is None:
        hml = torch.full_like(h[0], cfg.hml_const)
    z_int = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                      dim=0)
    frac_in = torch.clamp((hml[None] - z_int[:-1]) / (h + _EPS), 0.0, 1.0)
    w = frac_in * h
    if T is not None and eos is not None:
        rho = eos.density(T, S, torch.zeros_like(T))
    else:
        rho = vgrid.Rlay.reshape(-1, 1, 1).expand(h.shape)
    rho_ml = torch.sum(rho * w, dim=0) / (torch.sum(w, dim=0) + _EPS)
    b_ml = -g_acc * rho_ml / rho0

    fq = torch.abs(grid.CoriolisBu)
    absf_u = 0.5 * (fq + jm1(fq))
    absf_v = 0.5 * (fq + im1(fq))
    itau2 = (1.0 / cfg.ml_restrat_timescale) ** 2
    hml_u = 0.5 * (hml + ip1(hml))
    hml_v = 0.5 * (hml + jp1(hml))
    dbdx = (ip1(b_ml) - b_ml) * grid.IdxCu
    dbdy = (jp1(b_ml) - b_ml) * grid.IdyCv
    psi_u_max = (cfg.fox_kemper_ml_restrat_coef * hml_u * hml_u * dbdx
                 / torch.sqrt(absf_u * absf_u + itau2)) * grid.mask2dCu
    psi_v_max = (cfg.fox_kemper_ml_restrat_coef * hml_v * hml_v * dbdy
                 / torch.sqrt(absf_v * absf_v + itau2)) * grid.mask2dCv

    mu_u = _mu(0.5 * (z_int + ip1(z_int)), hml_u)
    mu_v = _mu(0.5 * (z_int + jp1(z_int)), hml_v)
    uhml = (mu_u[:-1] - mu_u[1:]) * psi_u_max[None] * grid.dyCu[None]
    vhml = (mu_v[:-1] - mu_v[1:]) * psi_v_max[None] * grid.dxCv[None]

    lim = 0.2 * grid.areaT * h / dt
    uhml = torch.minimum(torch.maximum(uhml, -ip1(lim)), lim)
    vhml = torch.minimum(torch.maximum(vhml, -jp1(lim)), lim)
    h_new = h - dt * grid.IareaT * ((uhml - im1(uhml))
                                    + (vhml - jm1(vhml)))
    return MLRestratResult(h=torch.clamp(h_new, min=vgrid.angstrom),
                           uhml=uhml, vhml=vhml)
