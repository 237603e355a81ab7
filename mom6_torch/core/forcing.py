"""Mechanical forcing (counterpart of
``mom6_tpu.core.forcing.MechForcing``): halo-padded (njh, nih) tensors
or None."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["MechForcing"]


@dataclasses.dataclass(frozen=True)
class MechForcing:
    taux: Optional[torch.Tensor] = None      # zonal stress at u [Pa]
    tauy: Optional[torch.Tensor] = None      # meridional stress at v [Pa]
    p_surf: Optional[torch.Tensor] = None    # surface pressure at h [Pa]
