"""Surface forcing containers (counterparts of
``mom6_tpu.core.forcing.MechForcing`` and ``Fluxes``): halo-padded
(njh, nih) tensors or None."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["MechForcing", "Fluxes"]


@dataclasses.dataclass(frozen=True)
class MechForcing:
    taux: Optional[torch.Tensor] = None      # zonal stress at u [Pa]
    tauy: Optional[torch.Tensor] = None      # meridional stress at v [Pa]
    p_surf: Optional[torch.Tensor] = None    # surface pressure at h [Pa]


@dataclasses.dataclass(frozen=True)
class Fluxes:
    """Buoyancy fluxes into the ocean surface."""
    sw: Optional[torch.Tensor] = None        # shortwave [W m-2]
    lw: Optional[torch.Tensor] = None        # longwave [W m-2]
    latent: Optional[torch.Tensor] = None    # [W m-2]
    sensible: Optional[torch.Tensor] = None  # [W m-2]
    evap: Optional[torch.Tensor] = None      # [kg m-2 s-1]
    lprec: Optional[torch.Tensor] = None     # [kg m-2 s-1]
    fprec: Optional[torch.Tensor] = None     # [kg m-2 s-1]
    salt_flux: Optional[torch.Tensor] = None  # [kg m-2 s-1 of salt]
    # a coupler's gas-exchange fields: {name: (njh, nih) tensor}, the
    # atmospheric partial pressures under the BGC packages' atm_field
    # names (pco2_atm, po2_atm, pcfc11_atm, ...) and optionally "u10"
    # and "ice_frac"; they take precedence over the packages' own
    # constants and files
    gas_fields: Optional[dict] = None
