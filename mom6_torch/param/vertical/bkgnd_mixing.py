"""Background diapycnal diffusivity profiles (counterpart of
``mom6_tpu.param.vertical.bkgnd_mixing``): constant, the Bryan &
Lewis (1979) arctangent profile, and the constant scaled by a
Henyey-style function of latitude."""

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
        if lat is None:
            kd = torch.full_like(z_int, cfg.kd)
        else:
            absf = torch.abs(torch.sin(torch.deg2rad(lat)))
            scale = torch.clamp(absf * (1.0 + torch.log(torch.clamp(
                cfg.henyey_n0_2omega / torch.clamp(absf, min=1e-8),
                min=1.0))), min=0.05)
            scale = scale / torch.max(scale)
            kd = cfg.kd * scale[None] * torch.ones_like(z_int)
    else:
        raise ValueError(f"Unknown background mixing scheme "
                         f"'{cfg.scheme}'")
    kd = kd.clone()
    kd[0] = 0.0
    kd[-1] = 0.0
    return kd
