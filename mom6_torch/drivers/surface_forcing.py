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
from mom6_torch.parallel.stencil import im1, jm1

__all__ = ["SurfaceForcingCfg", "build_wind", "buoyancy_restoring",
           "wind_forcing_from_file", "buoyancy_forcing_from_files",
           "scm_wind", "scm_buoyancy_fn", "HurricaneCfg",
           "idealized_hurricane_fn", "bfb_buoyancy_fn",
           "DumbbellForcingCfg", "dumbbell_forcing"]

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
    stresses of ``wind_file`` interpolated in time.  The file's shape
    decides: a field on the compute domain is taken as on the u/v
    points, any other shape is regridded from the file's lon/lat to
    them.  The function's
    ``time_varying`` says whether the file has more than one record."""
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


def scm_wind(grid: Grid, tau_x: float, tau_y: float) -> MechForcing:
    """WIND_CONFIG = SCM_CVMix_tests: a uniform stress."""
    return MechForcing(taux=tau_x * grid.mask2dCu,
                       tauy=tau_y * grid.mask2dCv)


def scm_buoyancy_fn(grid: Grid, heat_flux: float = 0.0,
                    evaporation: float = 0.0, max_sw: float = 0.0,
                    rho_restore: float = 1035.0, cp: float = _CP):
    """BUOY_CONFIG = SCM_CVMix_tests: a function (state, t) -> Fluxes.
    The CVMix tests give the heat flux in kinematic units [m degC s-1]
    and the evaporation in [m s-1], converted with ``rho_restore``
    (RESTORE_FLUX_RHO) and ``cp``; the diurnal shortwave peaks at local
    noon, max_sw max(0, cos(2 pi (t/86400 - 0.5))) rho cp."""
    def fluxes_fn(state, t):
        sens = sw = evap = None
        if heat_flux != 0.0:
            sens = heat_flux * rho_restore * cp * grid.mask2dT
        if evaporation != 0.0:
            evap = evaporation * rho_restore * grid.mask2dT
        if max_sw != 0.0:
            amp = max(0.0, math.cos(2.0 * math.pi * (t / 86400.0 - 0.5)))
            sw = max_sw * amp * rho_restore * cp * grid.mask2dT
        return Fluxes(sensible=sens, sw=sw, evap=evap)
    fluxes_fn.time_varying = max_sw != 0.0
    return fluxes_fn


@dataclasses.dataclass(frozen=True)
class HurricaneCfg:
    """An idealized translating hurricane: Holland's (1980) parametric
    wind with the Zhang and Uhlhorn (2012) inflow angle."""
    rho_air: float = 1.2              # IDL_HURR_RHO_AIR [kg m-3]
    p_ambient: float = 101200.0       # IDL_HURR_AMBIENT_PRESSURE [Pa]
    p_central: float = 96800.0        # IDL_HURR_CENTRAL_PRESSURE [Pa]
    rad_max_wind: float = 50.0e3      # IDL_HURR_RAD_MAX_WIND [m]
    max_windspeed: float = 65.0       # IDL_HURR_MAX_WIND [m s-1]
    translation_spd: float = 5.0      # IDL_HURR_TRAN_SPEED [m s-1]
    translation_dir: float = 180.0    # IDL_HURR_TRAN_DIR [deg]
    x0: float = 0.0                   # IDL_HURR_X0 [m]
    y0: float = 0.0                   # IDL_HURR_Y0 [m]
    scm_mode: bool = False            # IDL_HURR_SCM
    br_bench: bool = False            # IDL_HURR_SCM_BR_BENCH
    dy_from_center: float = 0.0       # IDL_HURR_SCM_LOCY [m]

    @property
    def holland_b(self) -> float:
        dp = self.p_ambient - self.p_central
        return self.max_windspeed ** 2 * self.rho_air * math.e / dp

    @property
    def holland_a(self) -> float:
        return self.rad_max_wind ** self.holland_b


def _hurricane_stress(cfg: HurricaneCfg, xx, yy, absf):
    """(taux, tauy) of the Holland-profile 10 m wind at points (xx, yy)
    [m] from the storm's centre, with |f| ``absf`` there: the
    algebraically stable U10 form, ramped linearly to zero between 10
    and 15 radii of maximum wind, the inflow angle, half the translation
    velocity added, zero ocean currents and Sullivan et al.'s (2010)
    piecewise drag coefficient."""
    deg2rad = math.pi / 180.0
    dp = cfg.p_ambient - cfg.p_central
    B = cfg.holland_b
    A = cfg.holland_a
    AxBxDP = A * B * dp
    rmw = cfg.rad_max_wind

    radius = torch.sqrt(xx ** 2 + yy ** 2)
    # the benchmark variant keeps the original experiment's km-based
    # Coriolis term
    km = 1.0e-3 if cfg.br_bench else 1.0
    radiusB = torch.clamp(radius, min=1e-3 * rmw) ** B
    tmp = (0.5 * radius * km * absf) * (cfg.rho_air * radiusB)
    core = AxBxDP * torch.exp(-A / radiusB)
    u10_in = core / (tmp + torch.sqrt(core * (cfg.rho_air * radiusB)
                                      + tmp ** 2))
    # the outer ring, 10-15 radii: the 10-radius wind ramped to zero
    radiusB10 = (10.0 * rmw) ** B
    tmp10 = (0.5 * 10.0 * rmw * km * absf) * (cfg.rho_air * radiusB10)
    core10 = AxBxDP * math.exp(-A / radiusB10)
    u10_edge = (3.0 - radius / (5.0 * rmw)) * core10 \
        / (tmp10 + torch.sqrt(core10 * (cfg.rho_air * radiusB10)
                              + tmp10 ** 2))
    u10 = torch.where(radius <= 1e-3 * rmw, 0.0,
                      torch.where(radius < 10.0 * rmw, u10_in,
                                  torch.where(radius < 15.0 * rmw,
                                              torch.clamp(u10_edge, min=0.0),
                                              0.0)))

    adir = torch.atan2(yy, xx)
    trans_dir = cfg.translation_dir * deg2rad
    # the inflow angle, ramped off beyond 10 radii
    rstr = torch.clamp(radius / rmw, max=10.0)
    a0 = -0.9 * rstr - 0.09 * cfg.max_windspeed - 14.33
    a1 = -a0 * (0.04 * rstr + 0.05 * cfg.translation_spd + 0.14)
    p1 = (6.88 * rstr - 9.60 * cfg.translation_spd + 85.31) * deg2rad
    alph = a0 - a1 * torch.cos(trans_dir - adir - p1)
    alph = torch.where(radius > 15.0 * rmw, 0.0,
                       torch.where(radius > 10.0 * rmw,
                                   alph * (15.0 - radius / rmw) / 5.0,
                                   alph)) * deg2rad

    u_ts = cfg.translation_spd * 0.5 * math.cos(trans_dir)
    v_ts = cfg.translation_spd * 0.5 * math.sin(trans_dir)
    du = u10 * torch.sin(adir - math.pi - alph) + u_ts
    dv = u10 * torch.cos(adir - alph) + v_ts
    du10 = torch.sqrt(du ** 2 + dv ** 2)
    cd = torch.where(du10 < 11.0, 1.2e-3,
                     torch.where(du10 < 20.0,
                                 (0.49 + 0.065 * du10) * 1.0e-3, 1.8e-3))
    return (cfg.rho_air * cd * du10 * du,
            cfg.rho_air * cd * du10 * dv)


def idealized_hurricane_fn(cfg: HurricaneCfg, grid: Grid):
    """WIND_CONFIG = ideal_hurr or SCM_ideal_hurr: a function t [s] ->
    MechForcing, the storm's centre translating from (x0, y0) at the
    configured speed and heading.  The grid's positions are in km (a
    cartesian grid with AXIS_UNITS k), hence the factor 1000.  In the
    single-column mode the column sits on the storm's track at (XC, YC
    + dy) from the centre.  |f| is averaged from the corners onto the u
    and v points, or fixed at 5.5659e-5 s-1 under the BR benchmark."""
    trans_dir = cfg.translation_dir * math.pi / 180.0
    fq = grid.CoriolisBu
    if cfg.br_bench:
        absf_u = torch.full_like(fq, 5.5659e-5)
        absf_v = absf_u
    else:
        absf_u = torch.abs(0.5 * (fq + jm1(fq)))
        absf_v = torch.abs(0.5 * (fq + im1(fq)))

    def forces_fn(t):
        xc = cfg.x0 + t * cfg.translation_spd * math.cos(trans_dir)
        yc = cfg.y0 + t * cfg.translation_spd * math.sin(trans_dir)
        if cfg.scm_mode:
            ones = torch.ones_like(grid.geoLonCu)
            xx_u = xc * ones
            yy_u = (yc + cfg.dy_from_center) * ones
            xx_v, yy_v = xx_u, yy_u
        else:
            xx_u = grid.geoLonCu * 1000.0 - xc
            yy_u = grid.geoLatCu * 1000.0 - yc
            xx_v = grid.geoLonCv * 1000.0 - xc
            yy_v = grid.geoLatCv * 1000.0 - yc
        tx, _ = _hurricane_stress(cfg, xx_u, yy_u, absf_u)
        _, ty = _hurricane_stress(cfg, xx_v, yy_v, absf_v)
        return MechForcing(taux=tx * grid.mask2dCu,
                           tauy=ty * grid.mask2dCv)
    forces_fn.time_varying = True
    return forces_fn


def bfb_buoyancy_fn(grid: Grid, sst_s: float = 20.0, sst_n: float = 10.0,
                    lfr_slat: float = 20.0, lfr_nlat: float = 40.0,
                    flux_const: float = 0.0, rho_restore: float = 1035.0,
                    cp: float = _CP):
    """BUOY_CONFIG = BFB: a function (state, t) -> Fluxes restoring the
    top layer's T toward a meridional ramp from ``sst_s`` at
    ``lfr_slat`` to ``sst_n`` at ``lfr_nlat`` (constant beyond), as the
    equivalent heat flux rho cp piston (T_rest - SST), the piston
    ``flux_const`` [m day-1]."""
    lat = grid.geoLatT
    ramp = (sst_s - sst_n) / (lfr_slat - lfr_nlat) * (lat - lfr_slat) \
        + sst_s
    t_rest = torch.where(lat <= lfr_slat, sst_s,
                         torch.where(lat >= lfr_nlat, sst_n, ramp))
    piston = flux_const / 86400.0

    def fluxes_fn(state, t):
        heat = piston * rho_restore * cp * (t_rest - state.T[0])
        return Fluxes(sensible=heat * grid.mask2dT)
    fluxes_fn.time_varying = False
    return fluxes_fn


@dataclasses.dataclass(frozen=True)
class DumbbellForcingCfg:
    """The dumbbell test's forcing: an oscillating sea-level pressure
    over the two reservoirs and salinity restoring there."""
    slp_amplitude: float = 10000.0   # DUMBBELL_SLP_AMP [Pa]
    slp_period: float = 1.0          # DUMBBELL_SLP_PERIOD [days]
    s_surf: float = 34.0             # INITIAL_SSS [ppt]
    s_range: float = 2.0             # INITIAL_S_RANGE [ppt]
    flux_const: float = 0.0          # FLUXCONST [m day-1]
    rho_restore: float = 1035.0      # RESTORE_FLUX_RHO [kg m-3]
    rotate: bool = False             # DUMBBELL_ROTATION


def dumbbell_forcing(cfg: DumbbellForcingCfg, grid: Grid, west, lenlon,
                     south, lenlat):
    """(forces_fn, fluxes_fn or None) of the dumbbell test: the seesaw
    p_surf = mask A sin(deg2rad days / period) over the reservoirs (the
    outer quarters along x, or along y under DUMBBELL_ROTATION; the
    sine's argument converted from degrees, as the reference has it),
    and with FLUXCONST > 0 the reservoirs' salinity restored toward
    s_surf +- s_range by a virtual precipitation [kg m-2 s-1]."""
    if cfg.rotate:
        x = (grid.geoLatT - south) / max(lenlat, 1e-30) - 0.5
    else:
        x = (grid.geoLonT - west) / max(lenlon, 1e-30) - 0.5
    fmask = torch.where(torch.abs(x) > 0.25, 1.0, 0.0) * grid.mask2dT
    s_rest = torch.where(x > 0.25, cfg.s_surf + cfg.s_range,
                         torch.where(x < -0.25, cfg.s_surf - cfg.s_range,
                                     cfg.s_surf))
    deg_rad = math.pi / 180.0
    fc = cfg.rho_restore * cfg.flux_const / 86400.0

    def forces_fn(t):
        rdays = t / 86400.0
        p = fmask * cfg.slp_amplitude \
            * math.sin(deg_rad * rdays / cfg.slp_period)
        return MechForcing(p_surf=p)
    forces_fn.time_varying = True

    def fluxes_fn(state, t):
        sss = state.S[0]
        vprec = -(fmask * fc) * (s_rest - sss) \
            / torch.clamp(0.5 * (s_rest + sss), min=1e-12)
        return Fluxes(lprec=vprec)
    fluxes_fn.time_varying = False
    return forces_fn, (fluxes_fn if cfg.flux_const > 0.0 else None)
