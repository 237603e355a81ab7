"""Ice-shelf basal melt, the three-equation model (counterpart of
``mom6_tpu.ice_shelf.thermo``, Holland and Jenkins 1999):

  freezing point:  T_b = l1 S_b + l2 + l3 p_b
  heat balance:    rho_w c_w gamma_T (T_w - T_b) = m L_f
  salt balance:    rho_w gamma_S (S_w - S_b) = m S_b

Eliminating T_b gives a quadratic in S_b, solved in closed form in each
column; ``three_equation_melt`` returns the melt rate and the heat and
freshwater fluxes into the ocean.  ``shelf_draft`` gives the ice draft
and basal pressure of a thickness.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["IceShelfCfg", "MeltResult", "three_equation_melt",
           "shelf_draft"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class IceShelfCfg:
    lambda1: float = -0.0573      # dTf/dS [degC ppt-1]
    lambda2: float = 0.0832       # Tf offset [degC]
    lambda3: float = -7.53e-8     # dTf/dp [degC Pa-1]
    gamma_t: float = 1e-4         # thermal exchange velocity [m s-1]
    gamma_s: float = 5.05e-7      # haline exchange velocity [m s-1]
    rho_ice: float = 918.0
    latent_heat: float = 3.34e5   # L_f [J kg-1]
    cp_w: float = 3974.0          # seawater heat capacity [J kg-1 K-1]
    rho0: float = 1035.0
    utide: float = 0.0            # tidal rms velocity [m s-1] (read,
                                  # not used, as in the JAX package)


class MeltResult(NamedTuple):
    melt: torch.Tensor         # melt rate [kg m-2 s-1] (+ = melting)
    t_b: torch.Tensor          # boundary-layer temperature [degC]
    s_b: torch.Tensor          # boundary-layer salinity [ppt]
    heat_flux: torch.Tensor    # into the ocean [W m-2] (negative cools)
    fw_flux: torch.Tensor      # freshwater into the ocean [kg m-2 s-1]


def shelf_draft(cfg: IceShelfCfg, h_shelf):
    """The ice draft [m] and the basal pressure [Pa] of a thickness."""
    draft = (cfg.rho_ice / cfg.rho0) * h_shelf
    p_base = cfg.rho_ice * 9.8 * h_shelf
    return draft, p_base


def three_equation_melt(cfg: IceShelfCfg, t_w, s_w, p_b,
                        shelf_mask=None) -> MeltResult:
    """The melt of ice over water of temperature ``t_w`` and salinity
    ``s_w`` at the basal pressure ``p_b`` [Pa].  With S_b the root of
    a S_b^2 + b S_b + c = 0,

      a = -c_w gamma_T l1 (> 0),
      b = c_w gamma_T (T_w - l2 - l3 p) + gamma_S L_f,
      c = -gamma_S L_f S_w (< 0),

    the roots straddle zero and the + branch is the physical one; S_b is
    clipped to [1e-3, 2 max(S_w, 1)].  Outside ``shelf_mask`` the fluxes
    are 0 and T_b, S_b the water's own."""
    gt, gs = cfg.gamma_t, cfg.gamma_s
    l1, l2, l3 = cfg.lambda1, cfg.lambda2, cfg.lambda3
    c_w, lf = cfg.cp_w, cfg.latent_heat
    a = -gt * c_w * l1
    b = gt * c_w * (t_w - l2 - l3 * p_b) + gs * lf
    c = -gs * lf * s_w
    if abs(a) > _EPS:
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        s_b = (-b + torch.sqrt(disc)) / (2.0 * a)
    else:
        s_b = -c / torch.where(torch.abs(b) > _EPS, b, _EPS)
    s_b = torch.minimum(torch.clamp(s_b, min=1e-3),
                        2.0 * torch.clamp(s_w, min=1.0))
    t_b = l1 * s_b + l2 + l3 * p_b

    m_prime = gs * (s_w - s_b) / torch.clamp(s_b, min=_EPS)   # [m s-1]
    melt = cfg.rho0 * m_prime                                 # [kg m-2 s-1]
    heat = -cfg.rho0 * c_w * gt * (t_w - t_b)
    fw = melt
    if shelf_mask is not None:
        melt = melt * shelf_mask
        heat = heat * shelf_mask
        fw = fw * shelf_mask
        t_b = torch.where(shelf_mask > 0, t_b, t_w)
        s_b = torch.where(shelf_mask > 0, s_b, s_w)
    return MeltResult(melt=melt, t_b=t_b, s_b=s_b, heat_flux=heat,
                      fw_flux=fw)
