"""Background diapycnal diffusivity profiles (counterpart of
``mom6_tpu.param.vertical.bkgnd_mixing``): constant and the Bryan &
Lewis (1979) arctangent profile; the Henyey latitude scaling is not
ported yet and raises ``NotImplementedError``."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["BkgndMixingCfg", "bkgnd_mixing_coeffs"]


@dataclasses.dataclass(frozen=True)
class BkgndMixingCfg:
    scheme: str = "constant"       # constant | bryan_lewis | henyey
    kd: float = 1e-5               # KD surface/background [m2 s-1]
    bl_kd_deep: float = 1.3e-4     # deep diffusivity [m2 s-1]
    bl_depth: float = 2500.0       # transition depth [m]
    bl_width: float = 222.2        # transition width [m]
    henyey_n0_2omega: float = 20.0


def bkgnd_mixing_coeffs(cfg: BkgndMixingCfg, h, lat=None):
    """Kd at interfaces (nk+1, ...), zero at the surface and bottom."""
    z_int = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                      dim=0)
    scheme = cfg.scheme.lower()
    if scheme == "constant":
        kd = torch.full_like(z_int, cfg.kd)
    elif scheme == "bryan_lewis":
        inv_w = 1.0 / max(cfg.bl_width, 1e-10)
        kd = cfg.kd + (cfg.bl_kd_deep - cfg.kd) * 0.5 * (
            1.0 + (2.0 / math.pi) * torch.atan(
                (z_int - cfg.bl_depth) * inv_w))
    elif scheme == "henyey":
        raise NotImplementedError("background mixing scheme henyey")
    else:
        raise ValueError(f"Unknown background mixing scheme "
                         f"'{cfg.scheme}'")
    kd = kd.clone()
    kd[0] = 0.0
    kd[-1] = 0.0
    return kd
