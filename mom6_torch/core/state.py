"""Prognostic state (counterpart of ``mom6_tpu.core.state.State``):
halo-padded (nk, njh, nih) tensors."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["State"]


@dataclasses.dataclass(frozen=True)
class State:
    u: torch.Tensor                    # zonal velocity at Cu [m s-1]
    v: torch.Tensor                    # meridional velocity at Cv [m s-1]
    h: torch.Tensor                    # layer thickness [m]
    T: Optional[torch.Tensor] = None   # temperature [degC]
    S: Optional[torch.Tensor] = None   # salinity [ppt]
    # the MEKE eddy energy (njh, nih) [m2 s-2] (USE_MEKE)
    meke: Optional[torch.Tensor] = None
    # the accumulated frazil heat deficit not yet extracted [J m-2]
    # (FRAZIL; a restart field)
    frazil: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)
