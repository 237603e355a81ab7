"""Analytic surface forcing of the solo driver.

Counterpart of ``mom6_tpu.drivers.surface_forcing``: the named wind
configurations (zero, constant, gyres, 2gyre), the linear-target
surface restoring of BUOY_CONFIG = linear_restoring, and the forcing read
from files (WIND_CONFIG = file, BUOY_CONFIG = file), time-interpolated
at the step's model time, producing (MechForcing, Fluxes).  The other
wind and buoyancy configurations are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.grid import Grid

__all__ = ["SurfaceForcingCfg", "build_wind", "buoyancy_restoring",
           "wind_forcing_from_file", "buoyancy_forcing_from_files"]

_CP = 3991.86795711963


@dataclasses.dataclass(frozen=True)
class SurfaceForcingCfg:
    wind_config: str = "zero"           # WIND_CONFIG
    taux_magnitude: float = 0.1         # TAUX_MAGNITUDE [Pa]
    taux_const: float = 0.0             # TAUX_CONST [Pa]
    taux_sin_amp: float = 0.0           # TAUX_SIN_AMP [Pa]
    taux_cos_amp: float = 0.0           # TAUX_COS_AMP [Pa]
    taux_n_pis: float = 1.0             # TAUX_N_PIS
    buoy_config: str = "zero"           # BUOY_CONFIG
    sensible_heat: float = 0.0          # constant heat flux [W m-2]
    restore_sst: bool = False           # RESTOREBUOY
    fluxconst: float = 0.0              # FLUXCONST piston [m day-1]
    sst_north: float = 5.0              # linear target SST range
    sst_south: float = 25.0
    sss_north: float = 35.0             # linear target SSS range
    sss_south: float = 35.0
    restore_sss: bool = False
    rho0: float = 1035.0
    cp: float = _CP


def build_wind(cfg: SurfaceForcingCfg, grid: Grid, south: float,
               lenlat: float) -> MechForcing:
    """The static wind stress of WIND_CONFIG."""
    yn = (grid.geoLatT - south) / max(lenlat, 1e-30)
    if cfg.wind_config == "zero":
        return MechForcing()
    if cfg.wind_config == "constant":
        return MechForcing(taux=cfg.taux_magnitude * grid.mask2dCu)
    if cfg.wind_config == "gyres":
        if cfg.taux_sin_amp != 0.0 or cfg.taux_cos_amp != 0.0 \
                or cfg.taux_const != 0.0:
            n = cfg.taux_n_pis
            taux = (cfg.taux_const
                    + cfg.taux_sin_amp * torch.sin(n * math.pi * yn)
                    + cfg.taux_cos_amp * torch.cos(n * math.pi * yn))
        else:
            taux = cfg.taux_magnitude * -torch.cos(2.0 * math.pi * yn)
        return MechForcing(taux=taux * grid.mask2dCu)
    if cfg.wind_config == "2gyre":
        taux = cfg.taux_magnitude * (1.0 - torch.cos(2.0 * math.pi * yn)) \
            * 0.5
        return MechForcing(taux=taux * grid.mask2dCu)
    if cfg.wind_config in ("SCM_CVMix_tests", "dumbbell"):
        raise NotImplementedError(f"WIND_CONFIG {cfg.wind_config}")
    raise ValueError(f"Unknown WIND_CONFIG '{cfg.wind_config}'")


def buoyancy_restoring(cfg: SurfaceForcingCfg, grid: Grid, sst, south,
                       lenlat, sss=None) -> Fluxes:
    """Heat (and salt) fluxes restoring the surface toward targets
    linear in y (buoyancy_forcing_linear with RESTOREBUOY/FLUXCONST),
    plus any constant heat flux."""
    heat = torch.zeros_like(sst)
    salt = None
    if cfg.sensible_heat != 0.0:
        heat = heat + cfg.sensible_heat
    if cfg.restore_sst and cfg.fluxconst > 0.0:
        yn = (grid.geoLatT - south) / max(lenlat, 1e-30)
        sst_target = cfg.sst_south + (cfg.sst_north - cfg.sst_south) * yn
        piston = cfg.fluxconst / 86400.0         # m/s
        heat = heat + piston * cfg.rho0 * cfg.cp * (sst_target - sst)
        if cfg.restore_sss and sss is not None:
            sss_target = cfg.sss_south \
                + (cfg.sss_north - cfg.sss_south) * yn
            salt = piston * cfg.rho0 * (sss_target - sss) / 1000.0 \
                * grid.mask2dT
    return Fluxes(sensible=heat * grid.mask2dT, salt_flux=salt)


def wind_forcing_from_file(grid: Grid, wind_file: str, x_var: str,
                           y_var: str, scale: float = 1.0):
    """WIND_CONFIG = file: a function t [s] -> MechForcing with the
    stresses of ``wind_file`` interpolated in time.  A field on the
    compute domain is taken as on the u/v points (WIND_STAGGER C);
    any other is regridded from the file's lon/lat to them.  The
    function's ``time_varying`` says whether the file has more than
    one record."""
    from mom6_torch.framework.interp_external import load_external_field
    tx = load_external_field(wind_file, x_var, grid=grid, stagger="U",
                             scale=scale)
    ty = load_external_field(wind_file, y_var, grid=grid, stagger="V",
                             scale=scale)

    def forces_fn(t):
        return MechForcing(taux=tx.at(t) * grid.mask2dCu,
                           tauy=ty.at(t) * grid.mask2dCv)
    forces_fn.time_varying = not (tx.static and ty.static)
    return forces_fn


_BUOY_FILE_FIELDS = (
    # (Fluxes field, MOM_input parameter, file variable)
    ("lw", "LONGWAVE_FILE", "LW"),
    ("sw", "SHORTWAVE_FILE", "SW"),
    ("latent", "LATENTHEAT_FILE", "latent"),
    ("sensible", "SENSIBLEHEAT_FILE", "sensible"),
    ("evap", "EVAPORATION_FILE", "evap"),
    ("lprec", "RAIN_FILE", "liq_precip"),
    ("fprec", "SNOW_FILE", "froz_precip"),
)


def buoyancy_forcing_from_files(grid: Grid, files: dict):
    """BUOY_CONFIG = file: a function (state, t) -> Fluxes with the
    heat and freshwater fluxes of per-component files interpolated in
    time.  ``files`` maps a Fluxes field to (path, variable)."""
    from mom6_torch.framework.interp_external import load_external_field
    efs = {name: load_external_field(path, var, grid=grid, stagger="T")
           for name, (path, var) in files.items()}

    def fluxes_fn(state, t):
        return Fluxes(**{name: ef.at(t) * grid.mask2dT
                         for name, ef in efs.items()})
    fluxes_fn.time_varying = any(not ef.static for ef in efs.values())
    return fluxes_fn
