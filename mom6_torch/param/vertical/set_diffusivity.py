"""Assembly of interface diapycnal diffusivities (counterpart of
``mom6_tpu.param.vertical.set_diffusivity``) on the branches the full
step takes: the background profile, clipped to [KD_MIN, KD_MAX] and
zeroed at the surface and bottom.  Shear (LMD94/PP81), kappa-shear,
convection, double diffusion, tidal, user, law-of-the-wall BBL and
mixed-layer-radiation mixing are not ported yet and raise
``NotImplementedError``."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mom6_torch.param.vertical.bkgnd_mixing import (BkgndMixingCfg,
                                                    bkgnd_mixing_coeffs)

__all__ = ["DiffusivityCfg", "DiffusivityResult", "set_diffusivity"]

_UNPORTED = (("use_shear", "USE_LMD94/USE_PP81: shear mixing"),
             ("use_conv", "USE_CVMix_CONVECTION: convective mixing"),
             ("use_ddiff", "DOUBLE_DIFFUSION: double diffusion"),
             ("use_kappa_shear", "USE_JACKSON_PARAM: kappa-shear mixing"),
             ("use_tidal", "INT_TIDE_DISSIPATION: tidal mixing"),
             ("use_user_kd", "USER_CHANGE_DIFFUSIVITY"),
             ("use_lotw_bbl", "USE_LOTW_BBL_DIFFUSIVITY"),
             ("ml_radiation", "ML_RADIATION"))


@dataclasses.dataclass(frozen=True)
class DiffusivityCfg:
    kd: float = 1e-5              # KD background [m2 s-1]
    kd_min: float = 0.0           # KD_MIN
    kd_max: float = -1.0          # KD_MAX (<0: none)
    kv_conversion: float = 1.0    # Kv/Kd of the returned Kv
    bkgnd: Optional[BkgndMixingCfg] = None
    use_shear: bool = False
    use_conv: bool = False
    use_ddiff: bool = False
    use_kappa_shear: bool = False
    use_tidal: bool = False
    use_user_kd: bool = False
    use_lotw_bbl: bool = False
    ml_radiation: bool = False

    # sub-configurations of the JAX package's DiffusivityCfg that only
    # matter when a named switch (not ported: it raises) is on
    _INERT = {"shear": "use_shear", "conv": "use_conv",
              "ddiff": "use_ddiff", "kappa_shear": "use_kappa_shear",
              "prandtl_turb": ("use_shear", "use_kappa_shear"),
              "tidal": "use_tidal", "tidal_energy_flux": "use_tidal",
              "user_kd": "use_user_kd", "bbl_effic": "use_lotw_bbl",
              "lotw_cdrag": "use_lotw_bbl", "lotw_max_decay": "use_lotw_bbl",
              "vonkar": "use_lotw_bbl", "ml_rad_coeff": "ml_radiation",
              "ml_rad_efold": "ml_radiation", "ml_rad_kd_max": "ml_radiation",
              "mstar_mlrad": "ml_radiation",
              "tke_decay_mlrad": "ml_radiation"}


class DiffusivityResult(NamedTuple):
    kd_int: torch.Tensor
    kv_int: torch.Tensor
    kd_extra_S: Optional[torch.Tensor] = None
    kv_shear: Optional[torch.Tensor] = None


def set_diffusivity(h, cfg: DiffusivityCfg, lat=None) -> DiffusivityResult:
    """(nk+1, ...) interface diffusivities and viscosities."""
    for name, what in _UNPORTED:
        if getattr(cfg, name):
            raise NotImplementedError(what)
    bk = cfg.bkgnd or BkgndMixingCfg(kd=cfg.kd)
    kd = bkgnd_mixing_coeffs(bk, h, lat)
    kv = cfg.kv_conversion * kd
    kd = torch.clamp(kd, min=cfg.kd_min)
    if cfg.kd_max > 0:
        kd = torch.clamp(kd, max=cfg.kd_max)
    kd = kd.clone()
    kd[0] = 0.0
    kd[-1] = 0.0
    return DiffusivityResult(kd_int=kd, kv_int=kv)
