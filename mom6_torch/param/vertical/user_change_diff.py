"""User-prescribed added diffusivity in latitude and density bands
(counterpart of ``mom6_tpu.param.vertical.user_change_diff``,
USER_CHANGE_DIFFUSIVITY): Kd += USER_KD_ADD f(lat) g(rho), f and g smooth
0 -> 1 -> 0 windows over four-point ranges."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["UserKdCfg", "user_change_diff"]


@dataclasses.dataclass(frozen=True)
class UserKdCfg:
    kd_add: float = 0.0              # USER_KD_ADD [m2 s-1]
    # USER_KD_ADD_LAT_RANGE / _RHO_RANGE: (v1, v2, v3, v4), ascending
    lat_range: tuple = (-1.0e9, -1.0e9, 1.0e9, 1.0e9)
    rho_range: tuple = (-1.0e9, -1.0e9, 1.0e9, 1.0e9)
    use_abs_lat: bool = False        # USER_KD_ADD_ABS_LAT
    p_ref: float = 2.0e7             # P_REF [Pa]

    def validate(self):
        for nm, r in (("USER_KD_ADD_LAT_RANGE", self.lat_range),
                      ("USER_KD_ADD_RHO_RANGE", self.rho_range)):
            if not (r[0] <= r[1] <= r[2] <= r[3]):
                raise ValueError(f"{nm} must be ascending, got {r}")
        return self


def _val_weights(val, rng):
    """The window: cubic ramps with zero end slopes over (v1, v2) and
    (v3, v4), 1 between."""
    x_lo = (val - rng[0]) / max(rng[1] - rng[0], 1e-30)
    x_hi = (rng[3] - val) / max(rng[3] - rng[2], 1e-30)
    x = torch.clamp(torch.minimum(x_lo, x_hi), 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def user_change_diff(cfg: UserKdCfg, h, T, S, eos, lat):
    """The added diffusivity (nk-1, nj, ni) on the interior interfaces;
    an interface's density is the mean of its layers' potential
    densities at P_REF."""
    latv = torch.abs(lat) if cfg.use_abs_lat else lat
    lat_fn = _val_weights(latv, cfg.lat_range)
    p = torch.full_like(T, cfg.p_ref)
    rcv = eos.density(T, S, p)
    rho_int = 0.5 * (rcv[:-1] + rcv[1:])
    rho_fn = _val_weights(rho_int, cfg.rho_range)
    return cfg.kd_add * rho_fn * lat_fn[None]
