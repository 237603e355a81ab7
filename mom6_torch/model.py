"""Model assembly: MOM_input parameters → domain, grid, state and the
stepping driver.

Counterpart of ``mom6_tpu.model``: ``build_model`` reads the MOM_input
dialect (``framework/config.py``) with the JAX package's parameter
names, types, defaults and units, builds the grid, the vertical grid,
the configuration dataclasses of the port, the forcing and the initial
state, and returns a ``Model`` whose ``step_fn`` steps the full ocean
step (``core/orchestrator.py``).

It follows the JAX builder on the branches that bench.py's CONFIG (with
and without USE_REGRIDDING, BT_WIDE_HALO_PERIOD 1 or 2),
``cases/double_gyre``, ``cases/tc0``, ``cases/ref_tc0``,
``cases/layer_mode``, ``cases/benchmark``, ``cases/ref_tc1``,
``cases/ref_tc2``, ``cases/ref_tc3``, ``cases/ref_tc4``, ``cases/tc1`` to
``cases/tc4``, ``cases/phillips`` and the texts of ``configs.py`` take: a
single-device
cartesian grid in km or degrees, or a spherical or Mercator grid
(GRID_CONFIG, ISOTROPIC, an f/beta plane with ROTATION = beta), or an
FMS mosaic supergrid file (GRID_CONFIG mosaic),
TOPO_CONFIG flat, bowl, spoon, file, basin_builder (BBUILDER_*) or any
topography of ``user/configs.py`` (seamount, dome2d, dumbbell, benchmark,
halfpipe, dome, isomip, dense_water, neverworld, shelfwave), with
porous-barrier face topography from a TOPO_AT_VEL file
(SUBGRID_TOPO_AT_VEL), Boussinesq or not, split RK2, split RK2b
(SPLIT_RK2B) or unsplit (SPLIT = False) dynamics with every Coriolis and
KE scheme, tides with scalar or spherical-harmonic SAL, the Stanley
pressure-force correction, the barotropic options BEGW,
BT_PROJECT_VELOCITY (read, unused), BOUND_BT_CORRECTION, MAXCFL_BT_CONT
and BT_STRONG_DRAG, the vertical-friction options (linear and channel
drag, DYNAMIC_BBL, BBL_USE_EOS, the fixed and dynamic viscous mixed
layer, DIRECT_STRESS, HARMONIC_VISC, KV_ML_INVZ2) and the
horizontal-viscosity options (velocity scales, Leith and modified Leith,
ADD_LES_VISCOSITY, anisotropic, ZB2020), open boundaries (OBC segments,
whole or partial, with constant or file data, OBC_USER_CONFIG updates,
the OBC viscosity flags and the dyed OBC tracers of NUM_DYE_TRACERS),
every EQN_OF_STATE form of ``mom6_torch/eos``, COORD_CONFIG ts_range,
linear, layer_ref or BFB (or the uniform GINT stacking),
THICKNESS_CONFIG uniform, sigma or any initializer of
``user/configs.py`` (with its own T/S and velocities), or z-space
initial T/S from a file remapped onto the z* layers
(INIT_LAYERS_FROM_Z_FILE with Z_INIT_ALE_REMAPPING, TRACER_Z_INIT_FILE),
TS_CONFIG uniform, linear, from_file, benchmark, ISOMIP, baroclinic_zone,
SCM_CVMix_tests or the thickness initializer's own, VELOCITY_CONFIG zero,
uniform, circular or file, an ice shelf over the ocean (ICE_SHELF: its
pressure, the stress shielding and the melt fluxes, the shelf itself held
static as in the JAX Model), every WIND_CONFIG (zero, constant, gyres,
2gyre, file with WIND_STAGGER read and, as in the JAX builder, unused,
SCM_CVMix_tests, ideal_hurr, SCM_ideal_hurr, dumbbell) and BUOY_CONFIG
(zero, linear restoring, file, const_heat, SCM_CVMix_tests, BFB,
dumbbell) of the JAX package, a data_table of
overrides in the case directory, ALE
with the coordinates and remap schemes of ``mom6_torch/ale`` (hybgen
with HYBGEN_*, ADAPTIVE with ADAPT_*, HYBGEN_UNMIX under HYCOM1) and
REGRID_ACCELERATE_INIT, the column physics of ``param/vertical`` (the
background, Bryan-Lewis and shear, kappa-shear, convective,
double-diffusive, tidal, user, law-of-the-wall and ML-radiation
diffusivities, KPP or ePBL with the Langmuir factor of USE_WAVES,
penetrating shortwave, DEPTH_LIMIT_FLUXES, geothermal heating, full
convection, frazil, and in layer mode the bulk mixed layer, diffusive
entrainment and the regularization of the surface layers), the sponges
of SPONGE (SPONGE_CONFIG file, with layer, z-space (ALE) or interface
targets, BFB and RGC with SPONGE_UV), GM thickness diffusion (THICKNESSDIFFUSE_FIRST too), MLE,
along-layer tracer diffusion, the ideal age tracer, GME, SPPT, SKEB and
STOCH_EOS, DIABATIC_FIRST, and the lateral parameterizations of the
fourth breadth item: MEKE, VarMix with Visbeck and RESOLN_SCALED_*,
KHTR_SLOPE_CFF, DIFFUSE_ML_TO_INTERIOR, the interface filter, neutral
and boundary diffusion and the internal tides. Every other value of an
option it reads raises ``NotImplementedError`` naming the parameter; an
option set to its default is read and accepted. An obsolete parameter
of the reference fails with its hint text (``framework/obsolete_params``),
as in the JAX builder. A parameter it does not
read at all is left for the caller's unused-parameter audit (the solo
driver raises on it).

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional

import numpy as np
import torch

from mom6_torch.ale.ale_main import ALECfg, ale_regrid_accelerated
from mom6_torch.ale.hybgen_regrid import HybgenRegridCfg
from mom6_torch.ale.hybgen_unmix import HybgenUnmixCfg
from mom6_torch.ale.regridding import RegridCfg
from mom6_torch.ale.remapping import RemapCfg
from mom6_torch.core.barotropic import BarotropicCfg, set_dtbt
from mom6_torch.core.continuity_ppm import ContinuityCfg
from mom6_torch.core.coriolis_adv import CoriolisCfg
from mom6_torch.core.dynamics_split_rk2 import (SplitCfg, SplitDynState,
                                                init_split_state)
from mom6_torch.core.dynamics_split_rk2b import (SplitBDynState,
                                                 init_split_b_state)
from mom6_torch.core.dynamics_unsplit import UnsplitCfg
from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.grid import (Grid, cartesian_grid, mercator_grid,
                                  mosaic_grid, spherical_grid)
from mom6_torch.core.orchestrator import OceanCfg, step_ocean
from mom6_torch.core.pressure_force import PressureForceCfg
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import VertViscCfg
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.drivers.surface_forcing import (
    _BUOY_FILE_FIELDS, DumbbellForcingCfg, HurricaneCfg, SurfaceForcingCfg,
    bfb_buoyancy_fn, build_wind, buoyancy_restoring,
    buoyancy_forcing_from_files, dumbbell_forcing, idealized_hurricane_fn,
    scm_buoyancy_fn, scm_wind, wind_forcing_from_file)
from mom6_torch.eos import EOS, make_eos
from mom6_torch.framework.config import ParamFile
from mom6_torch.framework.error_handler import FATAL, WARNING, MOM_error
from mom6_torch.framework.data_override import DataOverride
from mom6_torch.framework.io import field_names, read_field
from mom6_torch.framework.obsolete_params import check_obsolete_params
from mom6_torch.ice_shelf import shelf_main
from mom6_torch.ice_shelf.dynamics import SSACfg
from mom6_torch.ice_shelf.shelf_main import (ShelfCfg, ShelfState,
                                             init_shelf_thickness)
from mom6_torch.ice_shelf.thermo import IceShelfCfg
from mom6_torch.initialization import (temp_salt_from_z,
                                       thickness_from_z_edges, tracer_from_z,
                                       z_edges_from_centers)
from mom6_torch.obc.boundary_update import build_obc_update
from mom6_torch.obc.open_boundary import (build_obc_data_interp,
                                          build_open_boundaries,
                                          open_grid_masks)
from mom6_torch.param.lateral.hor_visc import HorViscCfg
from mom6_torch.param.lateral.interface_filter import InterfaceFilterCfg
from mom6_torch.param.lateral.internal_tides import InternalTidesCfg
from mom6_torch.param.lateral.meke import MEKECfg
from mom6_torch.param.lateral.mixed_layer_restrat import MLRestratCfg
from mom6_torch.param.lateral.self_attr_load import SALHarmonics
from mom6_torch.param.lateral.tidal_forcing import (CONSTITUENTS,
                                                    TidalForcingCfg,
                                                    tides_fn)
from mom6_torch.param.lateral.thickness_diffuse import ThicknessDiffuseCfg
from mom6_torch.param.lateral.varmix import VarMixCfg
from mom6_torch.param.stochastic.stochastics import StochasticsCfg
from mom6_torch.param.vertical.bkgnd_mixing import BkgndMixingCfg
from mom6_torch.param.vertical.bulk_mixed_layer import BulkMixedLayerCfg
from mom6_torch.param.vertical.conv_ddiff import ConvectionCfg
from mom6_torch.param.vertical.diabatic import DiabaticCfg
from mom6_torch.param.vertical.diabatic_aux import FrazilCfg
from mom6_torch.param.vertical.energetic_pbl import EPBLCfg
from mom6_torch.param.vertical.entrain_diffusive import EntrainDiffusiveCfg
from mom6_torch.param.vertical.geothermal import GeothermalCfg
from mom6_torch.param.vertical.kappa_shear import KappaShearCfg
from mom6_torch.param.vertical.kpp import KPPCfg
from mom6_torch.param.vertical.opacity import OpacityCfg
from mom6_torch.param.vertical.regularize_layers import RegularizeLayersCfg
from mom6_torch.param.vertical.set_diffusivity import DiffusivityCfg
from mom6_torch.param.vertical.shear_mixing import ShearMixingCfg
from mom6_torch.param.vertical.tidal_mixing import TidalMixingCfg
from mom6_torch.param.vertical.user_change_diff import UserKdCfg
from mom6_torch.param.waves.wave_interface import WavesCfg
from mom6_torch.parallel.domain import Domain
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1
from mom6_torch.tracer.advect import TracerAdvectCfg
from mom6_torch.tracer.hor_bnd_diffusion import HorBndDiffCfg
from mom6_torch.tracer.hor_diff import TracerHorDiffCfg
from mom6_torch.tracer.neutral_diffusion import NeutralDiffCfg
from mom6_torch.tracer import ideal
from mom6_torch.tracer.cfc import register_cfcs
from mom6_torch.tracer.marbl_driver import build_bgc_coupler
from mom6_torch.tracer.registry import TracerRegistry
from mom6_torch.user.basin_builder import basin_builder_topography
from mom6_torch.user.configs import (baroclinic_zone_ts, init_benchmark_ts,
                                     isomip_ts, scm_cvmix_ts,
                                     thickness_registry, topo_registry)

__all__ = ["Model", "build_model", "default_only"]

_WINDS = ("zero", "constant", "gyres", "2gyre", "file", "SCM_CVMix_tests",
          "ideal_hurr", "SCM_ideal_hurr", "dumbbell")
_BUOYS = ("linear_restoring", "linear", "file", "const_heat",
          "SCM_CVMix_tests", "BFB", "dumbbell")
# parameters the reference cases set that change nothing here by design
# (solver tolerances, file names and run guards of the driver, answer-date
# and bug-compatibility switches, IO layout hints), read when present so
# that the unused-parameter audit passes, as the JAX builder reads them
_PARITY_POLICY = (
    ("DO_UNIT_TESTS", bool, False), ("IO_LAYOUT", str, "1, 1"),
    ("NJHALO", int, 4), ("SAVE_INITIAL_CONDS", bool, False),
    ("IC_OUTPUT_FILE", str, ""), ("ETA_TOLERANCE", float, 0.0),
    ("VELOCITY_TOLERANCE", float, 0.0), ("V_TRUNC_FILE", str, ""),
    ("TOLERANCE_ENT", float, 0.0), ("MAXTRUNC", int, 0),
    ("RESTART_CONTROL", int, 1), ("GRID_ROTATION_ANGLE_BUGS", bool, False),
    ("USE_GM_WORK_BUG", bool, False), ("KAPPA_SHEAR_ITER_BUG", bool, False),
    ("KAPPA_SHEAR_ALL_LAYER_TKE_BUG", bool, False),
    ("BULKML_CONV_MOMENTUM_BUG", bool, False),
    ("FIX_USTAR_GUSTLESS_BUG", bool, False),
    ("FIX_UNSPLIT_DT_VISC_BUG", bool, False),
    ("DATE_STAMPED_STDOUT", bool, True), ("VARIABLE_WINDS", bool, False),
    ("VARIABLE_BUOYFORCE", bool, False),
    ("REMAP_UV_USING_OLD_ALG", bool, False),
    ("USE_GRID_SPACE_DIAG_COORDINATE_AXES", bool, False),
    ("ABSORB_ALL_SW", bool, False), ("PEN_SW_ABSORB_MINTHICK", float, 0.0),
    ("PGF_STANLEY_T2_DET_COEFF", float, -1.0),
    ("STANLEY_PRM_DET_COEFF", float, -1.0))
# the shape parameters of the user initializers, read when a case sets
# them (the JAX builder's list)
_USER_IC_KEYS = (
    "PHILLIPS_SLOPE", "PHILLIPS_AMP", "SLOSHING_AMP", "SEAMOUNT_HEIGHT",
    "DISK_RADIUS", "DISK_IC_AMPLITUDE", "BENCHMARK_ML_DEPTH_IC",
    "BENCHMARK_THERMOCLINE_SCALE", "BENCHMARK_T_LIGHT", "FRONT_WIDTH",
    "DELTA_T", "DELTA_S", "ML_DEPTH", "SSH_ANOMALY_HEIGHT", "SHELF_DEPTH",
    "INITIAL_SSS", "INITIAL_S_RANGE", "S_RANGE", "TS_RANGE_S_LIGHT",
    "TS_RANGE_S_DENSE", "INTERFACE_IC_QUANTA", "DOME2D_T_BAY",
    "DUMBBELL_T_SURF", "DUMBBELL_SREF", "DUMBBELL_S_RANGE")
# behavioural reference options the JAX builder accepts without acting on
# them: read when present, with a warning when set away from the default
_PARITY_UNIMPL = (("LIMIT_BUFFER_DETRAIN", bool, False),)


def _topo_fn(config: str, max_depth: float, min_depth: float,
             lenlon: float, lenlat: float, west: float, south: float):
    """TOPO_CONFIG flat, bowl and spoon (the JAX builder's
    ``_topo_fn``)."""
    if config == "flat":
        return lambda lon, lat: np.full_like(lat, max_depth)
    if config == "bowl":
        def bowl(lon, lat):
            xn = 2.0 * (lon - west) / max(lenlon, 1e-30) - 1.0
            yn = 2.0 * (lat - south) / max(lenlat, 1e-30) - 1.0
            r2 = np.minimum(xn ** 2 + yn ** 2, 1.0)
            return min_depth + (max_depth - min_depth) * (1.0 - r2)
        return bowl
    if config == "spoon":
        def spoon(lon, lat):
            yn = (lat - south) / max(lenlat, 1e-30)
            return min_depth + (max_depth - min_depth) * np.sin(
                math.pi * np.clip(yn, 0, 1))
        return spoon
    raise NotImplementedError(f"TOPO_CONFIG = {config!r}: option not ported")


def _drop_time(a) -> np.ndarray:
    """A file field without its leading time axis (the first record of
    a 4-D field)."""
    a = np.asarray(a, np.float64)
    return a[0] if a.ndim == 4 else a


def default_only(pf: ParamFile, name: str, ptype: type, default: Any,
                  **kw) -> Any:
    """Read an option whose other values are not ported: its default is
    accepted, any other value raises ``NotImplementedError``."""
    val = pf.get(name, ptype, default, **kw)
    if val != default:
        raise NotImplementedError(f"{name} = {val!r}: option not ported")
    return val


def _one_of(name: str, val: str, allowed) -> str:
    if val not in allowed:
        raise NotImplementedError(f"{name} = {val!r}: option not ported")
    return val


@dataclasses.dataclass
class Model:
    """A configured model: its grids, configuration, forcing and initial
    state (counterpart of the JAX package's ``Model``).  ``split`` is the
    split scheme's state (the JAX Model's ``split_state``): a
    ``SplitDynState`` under split RK2, a ``SplitBDynState`` under RK2b,
    None under unsplit dynamics (``cfg.split`` False)."""
    domain: Domain
    grid: Grid
    vgrid: VerticalGrid
    eos: Optional[EOS]
    cfg: OceanCfg
    forcing_cfg: SurfaceForcingCfg
    south: float                 # SOUTHLAT [km]
    lenlat: float                # LENLAT [km]
    forces: MechForcing
    registry: TracerRegistry
    state: State
    split: SplitDynState | SplitBDynState | None
    tracers: Optional[dict]
    dt: float
    dt_therm: float
    dt_forcing: float = 0.0
    daymax: float = 1.0
    thermo: bool = True
    # open boundaries, and fn(obc, grid, h, t) -> obc refreshing their
    # external data each step (file data in time, OBC_USER_CONFIG)
    obc: Any = None
    obc_update_fn: Any = None
    # file forcing: fn(t) -> MechForcing of a time-varying file wind
    # (None: ``forces``), fn(state, t) -> Fluxes of BUOY_CONFIG file;
    # and the data_table's overrides on top of both
    forces_fn: Any = None
    fluxes_fn: Any = None
    data_override: Optional[DataOverride] = None
    # the ice shelf over the ocean (ICE_SHELF): its state and
    # configuration, None without one
    ice_shelf: Optional[ShelfState] = None
    shelf_cfg: Optional[ShelfCfg] = None

    def fluxes(self, state: State, t: float = 0.0) -> Optional[Fluxes]:
        """Buoyancy fluxes on the given state at model time ``t`` [s]
        (BUOY_CONFIG), None without buoyancy forcing (also under
        BUOY_CONFIG dumbbell with no FLUXCONST, as in the JAX Model)."""
        if not self.thermo or state.T is None:
            return None
        if self.fluxes_fn is not None:
            return self.fluxes_fn(state, t)
        if self.forcing_cfg.buoy_config in ("linear_restoring", "linear"):
            return buoyancy_restoring(self.forcing_cfg, self.grid,
                                      state.T[0], self.south, self.lenlat,
                                      sss=state.S[0])
        return None

    def forcing(self, state: State, t: float, do_thermo: bool):
        """(MechForcing, Fluxes or None) of a step centred at ``t`` [s]:
        the file wind (or the static stresses), the buoyancy fluxes on
        thermodynamic steps, then the data_table's overrides, then the
        ice shelf's coupling (``shelf_forcing``)."""
        fc = self.forces_fn(t) if self.forces_fn is not None \
            else self.forces
        fl = self.fluxes(state, t) if do_thermo else None
        dov = self.data_override
        if dov is not None:
            fc = dov.mech(fc, t, self.grid)
            if do_thermo and state.T is not None:
                fl = dov.fluxes(fl, t, self.grid)
        if self.ice_shelf is not None:
            fc, fl = self.shelf_forcing(state, fc, fl, do_thermo)
        return fc, fl

    def shelf_forcing(self, state: State, fc: MechForcing,
                      fl: Optional[Fluxes], do_thermo: bool):
        """The ice shelf's coupling on top of the forcing: its pressure
        added to p_surf, the wind stress shielded under it (to
        SHELF_STRESS_FRACTION, with the mask averaged onto the faces),
        and on thermodynamic steps the three-equation melt of the top
        layer's T and S, its heat added to ``sensible`` and its
        freshwater to ``lprec``."""
        sc, ss = self.shelf_cfg, self.ice_shelf
        smask = ss.mask(sc.min_thickness)
        p_shelf = shelf_main.shelf_surface_pressure(sc, ss)
        shield = 1.0 - sc.stress_frac
        fc = dataclasses.replace(
            fc, p_surf=(fc.p_surf if fc.p_surf is not None else 0.0)
            + p_shelf,
            taux=None if fc.taux is None
            else fc.taux * (1.0 - shield * 0.5 * (smask + ip1(smask))),
            tauy=None if fc.tauy is None
            else fc.tauy * (1.0 - shield * 0.5 * (smask + jp1(smask))))
        if do_thermo and state.T is not None:
            heat, fw, _ = shelf_main.shelf_fluxes(sc, ss, state.T[0],
                                                  state.S[0])
            fl = fl if fl is not None else Fluxes()
            fl = dataclasses.replace(
                fl, sensible=(fl.sensible if fl.sensible is not None
                              else 0.0) + heat,
                lprec=(fl.lprec if fl.lprec is not None else 0.0) + fw)
        return fc, fl

    def reset_dtbt(self, state: State) -> int:
        """DTBT_RESET_PERIOD: the barotropic substep count re-estimated
        from the current total column thickness (one host sync).  An
        unsplit model has no barotropic solver and raises."""
        if not self.cfg.split:
            raise ValueError("reset_dtbt: unsplit dynamics have no "
                             "barotropic substeps")
        return set_dtbt(self.domain, self.grid, self.vgrid,
                        self.cfg.split_cfg.barotropic, self.dt, h=state.h)

    def step_fn(self, nstep_bt: int | None = None, carry: dict | None = None):
        """The stepping driver ``step(state, split, tracers, n)`` with the
        JAX Model's cadence: step n is a thermodynamic step when (n + 1)
        is a multiple of DT_THERM/DT, x_first alternates with the parity
        of n, the mass transports accumulate over the thermodynamic
        interval, and the boundary-layer depth, the shear viscosity of
        the last thermodynamic step (which the split RK2 dynamics add to
        KV), the stochastic pattern (a tensor, or {"sppt", "skeb"}
        with SKEB) and the internal-tide energy (``iten``) carry from
        step to step; the accumulated frazil and MEKE's energy ride the
        state.

        ``nstep_bt`` overrides the barotropic substep count (the
        DTBT_RESET_PERIOD path); ``carry`` re-threads the accumulators
        of an earlier closure (``step.carry()``).  The closure carries
        ``truncations()`` (the cumulative velocity-truncation count; the
        count stays on the device until asked for), ``carry()`` (a copy
        of its accumulators), ``set_carry(c)``, ``obc_reservoirs()``
        (the tracer reservoirs of open boundaries, None without),
        ``offline_fields()`` ((uhtr, vhtr, h_end) of the last completed
        thermodynamic interval, None before the first) and ``nstep_bt``
        (None under unsplit dynamics)."""
        cfg = self.cfg
        bt = cfg.split_cfg.barotropic if cfg.split else None
        if bt is not None and nstep_bt and nstep_bt != bt.nstep:
            sp = dataclasses.replace(
                cfg.split_cfg,
                barotropic=dataclasses.replace(bt, nstep=int(nstep_bt)))
            cfg = dataclasses.replace(cfg, split_cfg=sp)
        n_per = max(1, int(round(self.dt_therm / self.dt)))
        # each closure owns its accumulators: the driver hands one
        # closure's carry to another and back (DTBT_RESET_PERIOD), so a
        # carry is copied in and out, never shared
        acc = dict(carry) if carry is not None else {
            "u": None, "v": None, "truncs": 0, "mld": None, "kv": None,
            "res": None, "sppt": None, "iten": None}
        if acc.get("res") is None and self.obc is not None and self.tracers:
            acc["res"] = self.obc.init_tracer_reservoirs(self.tracers)

        def set_carry(c):
            c = dict(c)
            acc.clear()
            acc.update(c)

        def step(state, split, tracers=None, n=0):
            do_thermo = (n + 1) % n_per == 0
            ua = acc["u"] if acc["u"] is not None \
                else torch.zeros_like(state.h)
            va = acc["v"] if acc["v"] is not None \
                else torch.zeros_like(state.h)
            t = (n + 0.5) * self.dt
            fc, fl = self.forcing(state, t, do_thermo)
            ob = self.obc
            if ob is not None and self.obc_update_fn is not None:
                ob = self.obc_update_fn(ob, self.grid, state.h, t)
            st, sp, tr, diags, *res = step_ocean(
                self.domain, self.grid, self.vgrid, state, split, tracers,
                fc, fl, self.dt, cfg, eos=self.eos,
                x_first=(n % 2 == 0), tracer_registry=self.registry,
                do_thermo=do_thermo, uhtr_accum=ua, vhtr_accum=va,
                mld_prev=acc["mld"], kv_shear_prev=acc["kv"], t=t, obc=ob,
                obc_reservoirs=acc.get("res"),
                sppt_pattern=acc.get("sppt"), int_tide_en=acc.get("iten"))
            if res:
                acc["res"] = res[0]
            if diags.mld is not None:
                acc["mld"] = diags.mld
            if diags.kv_shear is not None:
                acc["kv"] = diags.kv_shear
            if diags.sppt_pattern is not None:
                acc["sppt"] = diags.sppt_pattern
            if diags.int_tide_en is not None:
                acc["iten"] = diags.int_tide_en
            if do_thermo:
                # a completed interval: the transports the tracer
                # advection consumed and the thickness at its end, the
                # offline-mode fields
                acc["off"] = (diags.uhtr, diags.vhtr, st.h)
                acc["u"] = acc["v"] = None
            else:
                acc["u"], acc["v"] = diags.uhtr, diags.vhtr
            acc["truncs"] = acc["truncs"] + diags.truncs
            return st, sp, tr

        step.truncations = lambda: int(acc["truncs"])
        step.carry = lambda: dict(acc)
        step.set_carry = set_carry
        step.obc_reservoirs = lambda: acc.get("res")
        step.offline_fields = lambda: acc.get("off")
        step.nstep_bt = cfg.split_cfg.barotropic.nstep if cfg.split \
            else None
        return step


_TOPO_AT_VEL_VARS = (("DmaxU", "TOPO_AT_VEL_VARNAME_U_HIGH", "depthu_hi"),
                     ("DminU", "TOPO_AT_VEL_VARNAME_U_LOW", "depthu_lo"),
                     ("DavgU", "TOPO_AT_VEL_VARNAME_U_AVE", "depthu_av"),
                     ("DmaxV", "TOPO_AT_VEL_VARNAME_V_HIGH", "depthv_hi"),
                     ("DminV", "TOPO_AT_VEL_VARNAME_V_LOW", "depthv_lo"),
                     ("DavgV", "TOPO_AT_VEL_VARNAME_V_AVE", "depthv_av"))


def _read_topo_at_vel(pf: ParamFile, grid: Grid, halo: int) -> Grid:
    """SUBGRID_TOPO_AT_VEL: the six face statistics of the TOPO_AT_VEL
    file (positive depths on the compute domain), edge-padded to the
    halo and turned into heights, negative down, as the JAX builder
    reads them."""
    path = os.path.join(pf.get("INPUTDIR", str, "."),
                        pf.get("TOPO_AT_VEL_FILE", str, "topog_edge.nc"))
    names = {key: pf.get(param, str, default)
             for key, param, default in _TOPO_AT_VEL_VARS}
    dev = dict(device=grid.bathyT.device, dtype=grid.bathyT.dtype)
    return dataclasses.replace(grid, **{
        "porous_" + key: torch.as_tensor(
            -np.pad(np.asarray(read_field(path, var), np.float64), halo,
                    mode="edge"), **dev)
        for key, var in names.items()})


def _tides(pf: ParamFile, grid: Grid, rho0: float):
    """TIDES: the steppers' (eta, t) -> tidal + SAL geopotential, with
    the constituents TIDE_<name>, and SAL_HARMONICS (spherical
    harmonics to SAL_HARMONICS_DEGREE) or the scalar SAL."""
    consts = tuple(c for c in CONSTITUENTS
                   if pf.get(f"TIDE_{c}", bool, c == "M2"))
    cfg = TidalForcingCfg(
        constituents=consts,
        use_sal_scalar=pf.get("SAL_SCALAR_APPROX", bool, True),
        sal_scalar=pf.get("SAL_SCALAR_VALUE", float, 0.094))
    sal = None
    if pf.get("SAL_HARMONICS", bool, False):
        nd = pf.get("SAL_HARMONICS_DEGREE", int, 6)
        sal = SALHarmonics.build(
            grid, nd, rho_w=rho0,
            rho_e=pf.get("RHO_SOLID_EARTH", float, 5517.0, units="kg m-3"))
    return tides_fn(cfg, grid, sal)


def _build_user_kd(pf: ParamFile, p_ref: float) -> UserKdCfg:
    """USER_CHANGE_DIFFUSIVITY's bands (the JAX builder's
    ``_build_user_kd``)."""
    big = 1.0e9
    lat = pf.get("USER_KD_ADD_LAT_RANGE", list, [-big, -big, big, big],
                 units="degrees")
    rho = pf.get("USER_KD_ADD_RHO_RANGE", list, [-big, -big, big, big],
                 units="kg m-3")
    return UserKdCfg(
        kd_add=pf.get("USER_KD_ADD", float, 0.0, units="m2 s-1"),
        lat_range=tuple(float(v) for v in lat),
        rho_range=tuple(float(v) for v in rho),
        use_abs_lat=pf.get("USER_KD_ADD_ABS_LAT", bool, False),
        p_ref=p_ref).validate()


def _build_waves_cfg(pf: ParamFile) -> Optional[WavesCfg]:
    """USE_WAVES: the Stokes drift's parameters (the JAX builder's
    ``_build_waves_cfg``), None without waves."""
    if not pf.get("USE_WAVES", bool, False):
        return None
    return WavesCfg(
        wave_method=pf.get("WAVE_METHOD", str, "EMPIRICAL"),
        const_us=pf.get("CONST_STOKES_DRIFT", float, 0.0, units="m s-1"),
        const_decay=pf.get("STOKES_DECAY_SCALE", float, 5.0, units="m"))


def _internal_tides(pf: ParamFile, domain: Domain, rho0: float, *, device,
                    dtype) -> dict:
    """INTERNAL_TIDES: the OceanCfg entries of the internal-tide energy
    (its configuration with the modes, the frequency axis and the
    advection scheme, UTIDE, TIDAL_ROUGHNESS_H2 and the reflection maps
    of REFL_ANGLE_FILE), read as the JAX builder reads them; none when
    off."""
    if not pf.get("INTERNAL_TIDES", bool, False):
        return {}
    period1 = pf.get("FIRST_MODE_PERIOD", float, 44712.0, units="s")
    cfg = InternalTidesCfg(
        n_angle=pf.get("INTERNAL_TIDE_ANGLES", int, 24),
        freq=2.0 * math.pi / period1,
        q_itides=pf.get("GAMMA_ITIDES", float, 0.3333),
        decay_rate=pf.get("INT_TIDE_DECAY_RATE", float, 0.0, units="s-1"),
        apply_background_drag=pf.get("INT_TIDE_BACKGROUND_DRAG", bool,
                                     False),
        apply_bottom_drag=pf.get("INT_TIDE_QUAD_DRAG", bool, True),
        apply_wave_drag=pf.get("INT_TIDE_WAVE_DRAG", bool, True),
        apply_froude_drag=pf.get("INT_TIDE_FROUDE_DRAG", bool, False),
        cdrag=pf.get("CDRAG", float, 0.003),
        kappa_itides=2.0 * math.pi / pf.get("ITIDE_WAVELENGTH", float,
                                            125e3, units="m"),
        kappa_h2_factor=pf.get("KAPPA_H2_FACTOR", float, 0.75),
        rho0=rho0)
    kw = dict(int_tide_utide=pf.get("UTIDE", float, 0.0, units="m s-1"),
              int_tide_h2=pf.get("TIDAL_ROUGHNESS_H2", float, 2500.0,
                                 units="m2"))
    n_mode = pf.get("INTERNAL_TIDE_MODES", int, 1)
    frac_modes = pf.get("ENERGY_FRACTION_PER_MODE", list, [])
    # the frequency axis: given periods, else the constituent ladder M2,
    # S2, K1, O1, N2 for INTERNAL_TIDE_FREQS > 1
    n_freq = pf.get("INTERNAL_TIDE_FREQS", int, 1)
    periods = pf.get("INTERNAL_TIDE_PERIODS", list, [])
    frac_freq = pf.get("ENERGY_FRACTION_PER_FREQ", list, [])
    if periods:
        freqs = tuple(2.0 * math.pi / float(p) for p in periods)
    elif n_freq > 1:
        freqs = (2.0 * math.pi / period1, 1.45444e-4, 7.2921e-5, 6.7598e-5,
                 1.37880e-4)[:n_freq]
    else:
        freqs = (2.0 * math.pi / period1,)
    kw["int_tides"] = dataclasses.replace(
        cfg, n_mode=n_mode,
        mode_fraction=tuple(float(f) for f in frac_modes), freqs=freqs,
        freq_fraction=tuple(float(f) for f in frac_freq),
        scheme=pf.get("INTERNAL_TIDE_X_SCHEME", str, "upwind_1st").lower())
    refl_file = pf.get("REFL_ANGLE_FILE", str, "")
    if refl_file:
        indir = pf.get("INPUTDIR", str, ".")

        def refl(fname, var):
            a = np.asarray(read_field(os.path.join(indir, fname), var),
                           dtype=np.float64)
            return domain.fill_halos(domain.pad(torch.as_tensor(
                a, device=device, dtype=dtype)))

        ang = refl(refl_file, pf.get("REFL_ANGLE_VAR", str, "refl_angle"))
        # sentinel "null angle" values (e.g. -999) become NaN
        kw["int_tide_refl_angle"] = torch.where(torch.abs(ang) > 100.0,
                                                math.nan, ang)
        pref_file = pf.get("REFL_PREF_FILE", str, "")
        kw["int_tide_refl_pref"] = refl(pref_file, pf.get(
            "REFL_PREF_VAR", str, "refl_pref")) if pref_file else None
        dbl_file = pf.get("REFL_DBL_FILE", str, "")
        kw["int_tide_refl_dbl"] = (refl(dbl_file, pf.get(
            "REFL_DBL_VAR", str, "refl_dbl")) > 0.5) if dbl_file else None
    return kw


def _ts_range_rlay(pf: ParamFile, nk: int, k_light: int, p_ref: float,
                   eos: Optional[EOS]) -> np.ndarray:
    """COORD_CONFIG ts_range: the layer densities at P_REF of a T/S ladder
    from TS_RANGE_*_LIGHT to TS_RANGE_*_DENSE below the ``k_light``
    varying-density layers, finer toward the dense end by
    TS_RANGE_RESOLN_RATIO; the varying layers extrapolated above."""
    t_ref0 = pf.get("T_REF", float, 10.0, units="degC")
    s_ref0 = pf.get("S_REF", float, 35.0, units="ppt")
    t_lt = pf.get("TS_RANGE_T_LIGHT", float, t_ref0)
    t_dn = pf.get("TS_RANGE_T_DENSE", float, t_ref0)
    s_lt = pf.get("TS_RANGE_S_LIGHT", float, s_ref0)
    s_dn = pf.get("TS_RANGE_S_DENSE", float, s_ref0)
    res_rat = pf.get("TS_RANGE_RESOLN_RATIO", float, 1.0)
    nv = max(nk - 1 - k_light, 1)
    a1 = 2.0 * res_rat / (1.0 + res_rat)
    frac = np.clip((np.arange(nk, dtype=np.float64) - k_light) / nv, 0.0,
                   None)
    fr_d = a1 * frac + (1.0 - a1) * frac ** 2
    eos_c = eos if eos is not None else make_eos("WRIGHT")
    rlay = eos_c.density(*(torch.as_tensor(a, dtype=torch.float64) for a in
                           (t_lt + fr_d * (t_dn - t_lt),
                            s_lt + fr_d * (s_dn - s_lt),
                            np.full(nk, p_ref)))).numpy().copy()
    for k in range(k_light - 1, -1, -1):
        rlay[k] = 2.0 * rlay[k + 1] - rlay[k + 2]
    return rlay


def _sponge_data(pf: ParamFile, domain: Domain, grid: Grid,
                 vgrid: VerticalGrid, *, south: float, lenlon: float,
                 max_depth: float, device, dtype) -> Optional[dict]:
    """The sponge of SPONGE/SPONGE_CONFIG (None without one): its inverse
    damping time ``idamp`` and its targets, in the layout of
    ``OceanCfg.sponge``.

    * BFB: 1/day within 2 degrees of the southern edge, falling linearly
      to 0 over the next 2, toward uniform interface depths;
    * RGC: a ramp over the eastern LENSPONGE strip at 1/RGC_TNUDG, T/S
      targets on the file's own thicknesses (SPONGE_H_VAR), and with
      SPONGE_UV u and v toward rest;
    * file: Idamp and the targets of SPONGE_STATE_FILE.  Layer targets
      with the model's NK are restored as they are; targets on other
      levels with a ``depth`` axis keep their z-cells (the ALE sponge,
      remapped onto the model each time); an ETA variable of NK + 1
      interface heights is restored in layer space."""
    if not pf.get("SPONGE", bool, False):
        return None
    dev = dict(device=device, dtype=dtype)
    H = domain.halo
    nk = vgrid.nk

    def pad3(a):
        return np.pad(a, ((0, 0), (H, H), (H, H)), mode="edge")

    def ten(a):
        return torch.as_tensor(np.array(a, np.float64), **dev)

    config = pf.get("SPONGE_CONFIG", str, "file")
    if config == "BFB":
        latT = grid.geoLatT.double().cpu().numpy()
        max_damp = 1.0 / 86400.0
        idamp = np.where(latT < south + 2.0, max_damp,
                         np.where(latT < south + 4.0,
                                  max_damp * (south + 4.0 - latT) / 2.0,
                                  0.0))
        d0 = np.concatenate([max_depth * np.arange(nk) / nk, [max_depth]])
        return {"idamp": ten(idamp) * grid.mask2dT, "T": None, "S": None,
                "eta": ten(np.broadcast_to(d0[:, None, None],
                                           (nk + 1,) + latT.shape))}
    if config == "RGC":
        tnudg = pf.get("RGC_TNUDG", float, 0.0, units="days") * 86400.0
        lensponge = pf.get("LENSPONGE", float, 10.0)
        sponge_uv = pf.get("SPONGE_UV", bool, False)
        sfile = os.path.join(pf.get("INPUTDIR", str, "."),
                             pf.get("RGC_SPONGE_FILE", str))
        tvar = pf.get("SPONGE_PTEMP_VAR", str, "Temp")
        svar = pf.get("SPONGE_SALT_VAR", str, "Salt")
        hvar = pf.get("SPONGE_H_VAR", str, "h")
        lonT = grid.geoLonT.double().cpu().numpy()
        ramp = np.clip((lonT - (lenlon - lensponge))
                       / max(lensponge, 1e-30), 0.0, 1.0)
        rate = 1.0 / max(tnudg, 1e-30)
        idamp = np.where(lonT >= lenlon - lensponge, rate * ramp, 0.0)
        sd = {"idamp": ten(idamp) * grid.mask2dT}
        sd.update((k, ten(pad3(_drop_time(read_field(sfile, v)))))
                  for k, v in (("T", tvar), ("S", svar), ("ref_h", hvar)))
        if sponge_uv:
            sd["uv"] = True
        return sd
    indir = pf.get("INPUTDIR", str, ".")
    dfile = pf.get("SPONGE_DAMPING_FILE", str, "sponge.nc")
    sfile = pf.get("SPONGE_STATE_FILE", str, dfile)
    ivar = pf.get("SPONGE_IDAMP_VAR", str, "Idamp")
    pvar = pf.get("SPONGE_PTEMP_VAR", str, "PTEMP")
    svar = pf.get("SPONGE_SALT_VAR", str, "SALT")

    def load(path, var):
        a = np.asarray(read_field(os.path.join(indir, path), var),
                       np.float64)
        while a.ndim > 3 or (a.ndim == 3 and var == ivar):
            a = a[0]          # drop time (and depth for Idamp)
        return a

    # with one on-grid record these two reduce to reading it
    pf.get("INTERPOLATE_SPONGE_TIME_SPACE", bool, False)
    pf.get("SPONGE_DATA_ONGRID", bool, False)
    fill = domain.fill_halos
    idamp = fill(domain.pad(ten(load(dfile, ivar))))
    spath = os.path.join(indir, sfile)
    names = field_names(spath)
    # T/S targets are optional: a layered sponge may restore ETA only
    have_ts = pvar in names
    t_ref = load(sfile, pvar) if have_ts else None
    s_ref = load(sfile, svar) if have_ts else None
    sd = {"idamp": idamp, "T": None, "S": None}
    if have_ts and t_ref.shape[0] != nk and "depth" in names:
        # targets on the file's own z-cells, remapped each time onto the
        # model's thicknesses (the ALE sponge)
        z_cent = np.asarray(read_field(spath, "depth"), np.float64)
        ze = z_edges_from_centers(z_cent, max_depth)
        sd["ref_h"] = fill(thickness_from_z_edges(
            ze, grid.bathyT.double(), vgrid.angstrom).to(dtype))
        sd["T"], sd["S"] = (fill(ten(pad3(a))) for a in (t_ref, s_ref))
    elif have_ts:
        sd["T"], sd["S"] = (fill(domain.pad(ten(a))) for a in (t_ref, s_ref))
    evar = pf.get("SPONGE_ETA_VAR", str, "ETA")
    if evar in names:
        # NK + 1 interface heights (up positive), kept as depths below
        # the surface
        e_tgt = _drop_time(read_field(spath, evar))
        if e_tgt.shape[0] == nk + 1:
            sd["eta"] = fill(domain.pad(ten(e_tgt[0:1] - e_tgt)))
    return sd


def build_model(pf: ParamFile, *, device="cuda",
                dtype: torch.dtype = torch.float64,
                allow_obsolete: tuple = ()) -> Model:
    """The model that the parameters describe, on ``device`` in
    ``dtype``.  The obsolete-parameter guard runs last, as in the JAX
    builder; ``allow_obsolete`` names entries of its table to skip
    (``("Use_PP81",)`` lets USE_PP81 through: the guard's keys match
    case-insensitively, so its "Use_PP81" entry refuses USE_PP81
    itself, in both packages)."""
    dev = dict(device=device, dtype=dtype)
    f64 = dict(device=device, dtype=torch.float64)

    pf.module("MOM_domains")
    ni = pf.get("NIGLOBAL", int, desc="x grid points")
    nj = pf.get("NJGLOBAL", int, desc="y grid points")
    reentrant_x = pf.get("REENTRANT_X", bool, False)
    reentrant_y = pf.get("REENTRANT_Y", bool, False)
    default_only(pf, "TRIPOLAR_N", bool, False,
                 desc="fold the north edge (tripolar grid)")
    halo = pf.get("NIHALO", int, 4, desc="halo width")
    if pf.has("LAYOUT"):
        # a single-device build runs unsharded whatever layout the case
        # declares, as the JAX builder does
        pf.get("LAYOUT", list, [1, 1], desc="processor layout (nx, ny)")
    domain = Domain(ni=ni, nj=nj, halo=halo, reentrant_x=reentrant_x,
                    reentrant_y=reentrant_y)
    default_only(pf, "MASKTABLE", str, "")
    default_only(pf, "AUTO_MASKTABLE", bool, False)

    pf.module("MOM_grid_init")
    grid_config = _one_of("GRID_CONFIG",
                          pf.get("GRID_CONFIG", str, "cartesian"),
                          ("cartesian", "spherical", "mercator", "mosaic"))
    south = pf.get("SOUTHLAT", float, 0.0)
    lenlat = pf.get("LENLAT", float, float(nj))
    west = pf.get("WESTLON", float, 0.0)
    lenlon = pf.get("LENLON", float, float(ni))
    max_depth_diagnose = not pf.has("MAXIMUM_DEPTH")
    max_depth = pf.get("MAXIMUM_DEPTH", float, 4000.0, units="m")
    min_depth = pf.get("MINIMUM_DEPTH", float, 0.0, units="m")
    topo_config = pf.get("TOPO_CONFIG", str, "flat")
    # ROTATION: 2omegasinlat on geographic grids, or an f/beta plane
    # (beta, betaplane) about BETA_LAT_REF; a cartesian grid is an
    # f/beta plane whatever it says
    rotation = pf.get("ROTATION", str, "2omegasinlat").lower()
    f0 = pf.get("F_0", float, 0.0, units="s-1")
    beta = pf.get("BETA", float, 0.0, units="m-1 s-1")
    axis_units = pf.get("AXIS_UNITS", str, "degrees")
    user_ctx = dict(max_depth=max_depth, min_depth=min_depth, lenlon=lenlon,
                    lenlat=lenlat, west=west, south=south, f0=f0, beta=beta)
    if topo_config in ("halfpipe", "benchmark"):
        user_ctx["edge_depth"] = pf.get("EDGE_DEPTH", float, 100.0,
                                        units="m")
    if pf.has("SHELF_DEPTH"):
        user_ctx["shelf_depth"] = pf.get("SHELF_DEPTH", float, units="m")
    # the user configurations' shape parameters, read once and shared by
    # the topographies and the thickness and T/S initializers
    for key, dflt, un in (
            ("DOME2D_SHELF_WIDTH", 0.1, "nondim"),
            ("DOME2D_BASIN_WIDTH", 0.3, "nondim"),
            ("DOME2D_SHELF_DEPTH", 0.2, "nondim"),
            ("DUMBBELL_LEN", 600.0, "km"),
            ("DUMBBELL_FRACTION", 0.5, "nondim"),
            ("NL_CONTINENT_AMP", 1.0, "nondim"),
            ("NL_ROUGHNESS_AMP", 0.05, "nondim"),
            ("NL_THICKNESS_PERT_AMP", 0.0, "nondim"),
            ("SHELFWAVE_Y_LENGTH_SCALE", 50.0, "km")):
        if pf.has(key):
            user_ctx[key.lower()] = pf.get(key, float, dflt, units=un)
    if pf.has("DUMBBELL_ROTATION"):
        user_ctx["dumbbell_rotation"] = pf.get("DUMBBELL_ROTATION", bool,
                                               False)
    topo_lut = {k.lower(): v for k, v in topo_registry.items()}
    if topo_config == "basin_builder":
        # the BBUILDER_* pieces are read when the grid evaluates the
        # depths, as in the JAX builder
        pf.module("basin_builder")

        def depth_fn(lon, lat, _H=max_depth):
            return basin_builder_topography(lon, lat, pf, _H)
        pf.module("MOM_grid_init")
    elif topo_config.lower() in topo_lut:
        def depth_fn(lon, lat, _fn=topo_lut[topo_config.lower()]):
            return _fn(lon, lat, user_ctx)
    elif topo_config == "file":
        # the bottom depth at the cell centres from a file
        topo_file = pf.get("TOPO_FILE", str, "topog.nc")
        topo_var = pf.get("TOPO_VARNAME", str, "depth")
        depth_2d = np.asarray(read_field(os.path.join(
            pf.get("INPUTDIR", str, "."), topo_file), topo_var), np.float64)
        if depth_2d.shape != (nj, ni):
            raise ValueError(
                f"TOPO_FILE depth shape {depth_2d.shape} != ({nj},{ni})")
        depth_pad = np.pad(depth_2d, halo, mode="edge")

        def depth_fn(lon, lat):
            return depth_pad
    else:
        depth_fn = _topo_fn(topo_config, max_depth, min_depth, lenlon,
                            lenlat, west, south)
    # ISOTROPIC selects Mercator metrics on spherical grids
    isotropic = pf.get("ISOTROPIC", bool, False,
                       desc="isotropic (Mercator) spacing: dy tracks "
                       "dx*cos(lat), the meridional extent set by the "
                       "zonal resolution "
                       "(MOM_grid_initialize.F90:703); read for any "
                       "spherical-family GRID_CONFIG, selects the "
                       "Mercator metrics when GRID_CONFIG=spherical")
    geo = dict(west_lon=west, lenlon=lenlon, south_lat=south,
               depth_fn=depth_fn, max_depth=max_depth, min_depth=min_depth,
               **dev)
    if grid_config == "cartesian" and axis_units.startswith("k"):
        grid = cartesian_grid(domain, lenlon_km=lenlon, lenlat_km=lenlat,
                              f0=f0, beta=beta, max_depth=max_depth,
                              depth_fn=depth_fn, min_depth=min_depth,
                              south_lat=south, west_lon=west,
                              beta_lat_ref=pf.get("BETA_LAT_REF", float,
                                                  0.0, units="km"), **dev)
    elif grid_config == "mosaic":
        # an FMS supergrid file
        grid = mosaic_grid(domain, os.path.join(
            pf.get("INPUTDIR", str, "."),
            pf.get("GRID_FILE", str, "ocean_hgrid.nc")),
            depth_fn=depth_fn, min_depth=min_depth, **dev)
    elif grid_config == "mercator" or (grid_config == "spherical"
                                       and isotropic):
        grid = mercator_grid(domain, north_lat=south + lenlat, **geo)
    else:
        # a cartesian grid in degrees takes the spherical metrics, as in
        # the JAX builder
        grid = spherical_grid(domain, lenlat=lenlat, **geo)
    if rotation in ("beta", "betaplane") and grid_config != "cartesian":
        # an f/beta plane about BETA_LAT_REF [degrees] at the corners
        y_m = (grid.geoLatT - pf.get("BETA_LAT_REF", float, 0.0,
                                     units="degrees")) * 111194.9266
        fq = f0 + beta * 0.25 * (y_m + jp1(y_m) + ip1(y_m) + ip1(jp1(y_m)))
        grid = dataclasses.replace(grid, CoriolisBu=fq)
    if max_depth_diagnose and topo_config != "flat":
        max_depth = float(torch.max(grid.bathyT))
    if pf.get("SUBGRID_TOPO_AT_VEL", bool, False):
        grid = _read_topo_at_vel(pf, grid, halo)

    pf.module("MOM_open_boundary")
    num_dye = pf.get("NUM_DYE_TRACERS", int, 0,
                     desc="dyed_obc tracers, one per segment")
    indir = pf.get("INPUTDIR", str, ".")
    obc = build_open_boundaries(pf, domain, indir=indir,
                                dye_tracers=num_dye, **dev)
    obc_update_fn = None
    if obc is not None:
        grid = open_grid_masks(grid, obc)
        # time-interpolated file data, then the user update
        data_fn = build_obc_data_interp(pf, domain, obc, indir=indir)
        pf.module("MOM_boundary_update")
        user_fn = build_obc_update(pf, south=south, axis_units=axis_units)
        if data_fn is not None and user_fn is not None:
            def obc_update_fn(ob, g, h, t, _d=data_fn, _u=user_fn):
                return _u(_d(ob, g, h, t), g, h, t)
        else:
            obc_update_fn = data_fn or user_fn

    pf.module("MOM_verticalGrid")
    nk = pf.get("NK", int, 1, units="nondim", desc="number of layers")
    g_earth = pf.get("G_EARTH", float, 9.8, units="m s-2")
    rho0 = pf.get("RHO_0", float, 1035.0, units="kg m-3")
    # BOUSSINESQ = False: h carries mass (Rho0 h per unit area) and the
    # pressure force takes the specific-volume form
    boussinesq = pf.get("BOUSSINESQ", bool, True)
    gint = pf.get("GINT", float, 0.0, units="m s-2",
                  desc="uniform interface reduced gravity")

    pf.module("MOM")
    split = pf.get("SPLIT", bool, True)
    split_rk2b = pf.get("SPLIT_RK2B", bool, False)
    dt = pf.get("DT", float, units="s")
    if dt is None:
        raise ValueError("DT must be set")
    dt_forcing = pf.get("DT_FORCING", float, dt, units="s")
    dt_therm = pf.get("DT_THERM", float, dt, units="s")
    timeunit = pf.get("TIMEUNIT", float, 86400.0, units="s")
    daymax = pf.get("DAYMAX", float, 1.0, units="TIMEUNIT") \
        * (timeunit / 86400.0)
    thermo = pf.get("ENABLE_THERMODYNAMICS", bool, True)
    adiabatic = pf.get("ADIABATIC", bool, False)
    use_regrid = pf.get("USE_REGRIDDING", bool, False)
    # the bulk mixed layer defaults on in layered thermodynamic runs; its
    # NKML mixed and NKBL buffer layers have varying coordinate density
    use_bml = pf.get("BULKMIXEDLAYER", bool, thermo and not use_regrid)
    nkml = pf.get("NKML", int, 2 if use_bml else 0)
    nkbl = pf.get("NKBL", int, 2 if use_bml else 0)
    nk_rho_varies = (nkml + nkbl) if use_bml else 0

    pf.module("MOM_EOS")
    eos_form = pf.get("EQN_OF_STATE", str, "WRIGHT")
    eos_kw = {}
    if eos_form.upper() == "LINEAR":
        eos_kw = dict(
            rho_t0_s0=pf.get("RHO_T0_S0", float, 1000.0, units="kg m-3"),
            drho_dt=pf.get("DRHO_DT", float, -0.2,
                           units="kg m-3 degC-1"),
            drho_ds=pf.get("DRHO_DS", float, 0.8, units="kg m-3 ppt-1"))
    eos = make_eos(eos_form, **eos_kw) if thermo else None

    pf.module("MOM_coord_initialization")
    coord_cfg = pf.get("COORD_CONFIG", str, "none")
    p_ref = pf.get("P_REF", float, 2.0e7, units="Pa")
    if coord_cfg == "layer_ref":
        # layer densities evenly spaced over RLAY_RANGE from the lightest
        light = pf.get("LIGHTEST_DENSITY", float, rho0, units="kg m-3")
        rrange = pf.get("RLAY_RANGE", float, 2.0, units="kg m-3")
        vgrid = VerticalGrid.from_rlay(
            light + rrange * np.arange(nk) / max(nk - 1, 1), g_Earth=g_earth,
            Rho0=rho0, boussinesq=boussinesq, **dev)
    elif coord_cfg == "linear":
        # layer densities evenly spaced over DENSITY_RANGE, at the
        # middle of each interval
        light = pf.get("LIGHTEST_DENSITY", float, rho0, units="kg m-3")
        rrange = pf.get("DENSITY_RANGE", float, 2.0, units="kg m-3")
        vgrid = VerticalGrid.from_rlay(
            light + rrange * (np.arange(nk) + 0.5) / nk, g_Earth=g_earth,
            Rho0=rho0, boussinesq=boussinesq, **dev)
    elif coord_cfg == "BFB":
        # layer densities linear between those that the linear EOS gives
        # SST_S (top) and T_BOT (bottom) at S_REF
        drho_dt = pf.get("DRHO_DT", float, -0.2, units="kg m-3 K-1")
        drho_ds = pf.get("DRHO_DS", float, 0.8, units="kg m-3 ppt-1")
        rho_t0_s0 = pf.get("RHO_T0_S0", float, 1000.0, units="kg m-3")
        sst_s = pf.get("SST_S", float, 20.0, units="degC")
        t_bot = pf.get("T_BOT", float, 5.0, units="degC")
        s_ref0 = pf.get("S_REF", float, 35.0, units="ppt")
        rho_top = (rho_t0_s0 + drho_ds * s_ref0) + drho_dt * sst_s
        rho_bot = (rho_t0_s0 + drho_ds * s_ref0) + drho_dt * t_bot
        vgrid = VerticalGrid.from_rlay(
            rho_top + (rho_bot - rho_top) * np.arange(nk) / max(nk - 1, 1),
            g_Earth=g_earth, Rho0=rho0, boussinesq=boussinesq, **dev)
    elif coord_cfg == "ts_range":
        vgrid = VerticalGrid.from_rlay(
            _ts_range_rlay(pf, nk, nk_rho_varies, p_ref, eos),
            g_Earth=g_earth, Rho0=rho0, boussinesq=boussinesq, **dev)
    else:
        vgrid = VerticalGrid.uniform(nk=nk, g_Earth=g_earth, Rho0=rho0,
                                     gint=gint if gint > 0 else None,
                                     boussinesq=boussinesq, **dev)

    pf.module("MOM_continuity_PPM")
    cont = ContinuityCfg(
        upwind_1st=pf.get("UPWIND_1ST_CONTINUITY", bool, False),
        simple_2nd=pf.get("SIMPLE_2ND_PPM_CONTINUITY", bool, False),
        monotonic=pf.get("MONOTONIC_CONTINUITY", bool, False),
        newton_iters=pf.get("CONT_NEWTON_ITERS", int, 6))
    # the JAX package's switch between its Pallas kernel and the jnp
    # path; the port's wrappers choose by the tensors' device
    pf.get("CONTINUITY_USE_PALLAS", bool, True,
           desc="TPU extension: fused Pallas "
           "kernel for the transport-matched "
           "continuity sweeps (both sweeps + "
           "Newton in VMEM); falls back to the "
           "jnp path off-TPU or when "
           "unsupported")

    pf.module("MOM_CoriolisAdv")
    cor = CoriolisCfg(
        scheme=pf.get("CORIOLIS_SCHEME", str, "SADOURNY75_ENERGY"),
        ke_scheme=pf.get("KE_SCHEME", str, "KE_ARAKAWA"),
        no_slip=pf.get("NOSLIP", bool, False),
        bound_coriolis=pf.get("BOUND_CORIOLIS", bool, False),
        coriolis_en_dis=pf.get("CORIOLIS_EN_DIS", bool, False,
                               desc="energy-dissipating biased "
                               "Sadourny-energy PV flux "
                               "(MOM_CoriolisAdv.F90:1087)"),
        pv_adv_upwind=pf.get("PV_ADV_SCHEME", str, "PV_ADV_CENTERED"
                             ).upper() == "PV_ADV_UPWIND1",
        blend_wt_lin=pf.get("CORIOLIS_BLEND_WT_LIN", float, 0.125),
        blend_f_eff_max=pf.get("CORIOLIS_BLEND_F_EFF_MAX", float, 4.0),
        h_tiny=pf.get("ANGSTROM", float, 1e-10, units="m"))

    pf.module("MOM_vert_friction")
    vv = VertViscCfg(
        kv=pf.get("KV", float, 1e-4, units="m2 s-1"),
        hbbl=pf.get("HBBL", float, 10.0, units="m"),
        cdrag=pf.get("CDRAG", float, 0.003),
        bottomdraglaw=pf.get("BOTTOMDRAGLAW", bool, True),
        linear_drag=pf.get("LINEAR_DRAG", bool, False),
        drag_bg_vel=pf.get("DRAG_BG_VEL", float, 0.0, units="m s-1"),
        maxvel=pf.get("MAXVEL", float, 3.0e8, units="m s-1"),
        cfl_trunc=pf.get("CFL_TRUNCATE", float, 0.5),
        channel_drag=pf.get("CHANNEL_DRAG", bool, False),
        dynamic_bbl=pf.get("DYNAMIC_BBL", bool, True),
        bbl_thick_min=pf.get("BBL_THICK_MIN", float, 0.1, units="m"),
        kv_bbl_min=pf.get("KV_BBL_MIN", float, 1e-4, units="m2 s-1"),
        visc_ml_mode=("dynamic" if pf.get("DYNAMIC_VISCOUS_ML", bool, False)
                      else "fixed" if pf.get("FIXED_DEPTH_LOTW_ML", bool,
                                             False) else ""),
        hmix_fixed=pf.get("HMIX_FIXED", float, 20.0, units="m"),
        direct_stress=pf.get("DIRECT_STRESS", bool, False),
        hmix_stress=pf.get("HMIX_STRESS", float,
                           pf.get("HMIX_FIXED", float, 20.0), units="m"),
        harmonic_visc=pf.get("HARMONIC_VISC", bool, False),
        bbl_use_eos=pf.get("BBL_USE_EOS", bool, False,
                           desc="BBL stratification ladder from EOS "
                           "in-situ density differences instead of "
                           "the Rlay targets "
                           "(MOM_set_viscosity.F90:336)"),
        kv_ml_invz2=pf.get("KV_ML_INVZ2", float, 0.0, units="m2 s-1",
                           desc="extra near-surface viscosity with a "
                           "1/z^2 profile over HMIX_FIXED "
                           "(MOM_vert_friction.F90:1877-1888)"),
        vonkar=pf.get("VON_KARMAN_CONST", float, 0.41))

    pf.module("MOM_hor_visc")
    smag_kh = pf.get("SMAGORINSKY_KH", bool, False)
    smag_ah = pf.get("SMAGORINSKY_AH", bool, False)
    use_bih = pf.get("BIHARMONIC", bool, smag_ah)
    aniso_dir = pf.get("ANISO_GRID_DIR", list, [1.0, 0.0])
    hv = HorViscCfg(
        laplacian=pf.get("LAPLACIAN", bool, False),
        biharmonic=use_bih,
        kh=pf.get("KH", float, 0.0, units="m2 s-1"),
        ah=pf.get("AH", float, 0.0, units="m4 s-1"),
        kh_vel_scale=pf.get("KH_VEL_SCALE", float, 0.0, units="m s-1"),
        ah_vel_scale=pf.get("AH_VEL_SCALE", float, 0.0, units="m s-1"),
        smag_lap_const=pf.get("SMAG_LAP_CONST", float, 0.0)
        if smag_kh else 0.0,
        smag_bi_const=pf.get("SMAG_BI_CONST", float, 0.0)
        if smag_ah else 0.0,
        leith_kh=pf.get("LEITH_KH", bool, False),
        leith_lap_const=pf.get("LEITH_LAP_CONST", float, 0.0),
        leith_ah=pf.get("LEITH_AH", bool, False),
        leith_bi_const=pf.get("LEITH_BI_CONST", float, 0.0),
        modified_leith=pf.get("MODIFIED_LEITH", bool, False),
        add_les_viscosity=pf.get("ADD_LES_VISCOSITY", bool, False),
        anisotropic=pf.get("ANISOTROPIC_VISCOSITY", bool, False),
        kh_aniso=pf.get("KH_ANISO", float, 0.0, units="m2 s-1"),
        aniso_n=(float(aniso_dir[0]), float(aniso_dir[1])),
        no_slip=pf.get("NOSLIP", bool, False),
        use_zb2020=pf.get("USE_ZB2020", bool, False),
        zb_scaling=pf.get("ZB_SCALING", float, 0.5),
        zb_type=pf.get("ZB_TYPE", int, 0),
        zb_cons=pf.get("ZB_CONS", int, 0),
        dt=dt,
        use_gme=pf.get("USE_GME", bool, False),
        gme_h0=pf.get("GME_H0", float, 1000.0, units="m"),
        gme_efficiency=pf.get("GME_EFFICIENCY", float, 1.0),
        gme_limiter=pf.get("GME_LIMITER", float, 1.0e7, units="m2 s-1"),
        gme_kh=pf.get("KHTH", float, 0.0, units="m2 s-1"))
    hv = dataclasses.replace(hv, use_land_mask=pf.get(
        "USE_LAND_MASK_FOR_HVISC", bool, True,
        desc="mask cell thicknesses before averaging to faces "
        "(MOM_hor_visc.F90:705,2270)"))
    if obc is not None:
        hv = dataclasses.replace(hv, **{
            name.lower(): pf.get(name, bool, False)
            for name in ("OBC_ZERO_VORTICITY", "OBC_FREESLIP_VORTICITY",
                         "OBC_ZERO_STRAIN", "OBC_FREESLIP_STRAIN",
                         "OBC_ZERO_BIHARMONIC")})

    pf.module("MOM_PressureForce")
    use_stanley_pgf = pf.get("USE_STANLEY_PGF", bool, False)
    if use_stanley_pgf and not boussinesq:
        raise ValueError("USE_STANLEY_PGF is not available with "
                         "BOUSSINESQ=False (MOM_PressureForce_FV.F90:183)")
    pgf_cfg = PressureForceCfg(
        stanley_coeff=pf.get("STANLEY_COEFF", float, -1.0)
        if use_stanley_pgf else -1.0,
        quad_points=pf.get("PGF_QUAD_POINTS", int, 5 if thermo else 1),
        reconstruct=pf.get("RECONSTRUCT_FOR_PRESSURE", bool, use_regrid,
                           desc="limited-PLM T/S reconstruction in "
                           "the FV pressure integrals; default set "
                           "by USE_REGRIDDING "
                           "(MOM_PressureForce_FV.F90:980)"))

    pf.module("MOM_tidal_forcing")
    tides = None
    if pf.get("TIDES", bool, False):
        tides = _tides(pf, grid, rho0)

    pf.module("MOM_barotropic")
    use_bt_cont = pf.get("USE_BT_CONT_TYPE", bool, True)
    if pf.has("NONLINEAR_BT_CONTINUITY"):
        use_bt_cont = pf.get("NONLINEAR_BT_CONTINUITY", bool, True)
    bebt = pf.get("BEBT", float, 0.2)
    bt_project = pf.get("BT_PROJECT_VELOCITY", bool, False)
    dt_bt_filter = pf.get("DT_BT_FILTER", float, -0.25, units="s")
    btcfg = BarotropicCfg(
        bebt=bebt, nstep=1, bt_project=bt_project,
        dt_bt_filter=dt_bt_filter, use_bt_cont=use_bt_cont,
        bound_bt_corr=pf.get("BOUND_BT_CORRECTION", bool, False),
        maxcfl_bt_cont=pf.get("MAXCFL_BT_CONT", float, 0.25),
        strong_drag=pf.get("BT_STRONG_DRAG", bool, False),
        ssh_extra=pf.get("SSH_EXTRA", float, 0.0, units="m"),
        hvel_scheme=pf.get("BT_THICK_SCHEME", str, "FROM_BT_CONT",
                           desc="per-layer face-thickness estimate "
                           "behind the barotropic frhat weights "
                           "(MOM_barotropic.F90:4520)").upper())
    # the JAX package's Pallas switch: the port's wrappers choose by the
    # tensors' device
    pf.get("BT_USE_PALLAS", bool, True)
    btcfg = dataclasses.replace(
        btcfg, wide_halo_period=pf.get("BT_WIDE_HALO_PERIOD", int, 1))
    split_cfg = unsplit_cfg = None
    if split:
        nstep = set_dtbt(domain, grid, vgrid, btcfg, dt,
                         max_depth=max_depth)
        dtbt = pf.get("DTBT", float, -0.95, units="s or nondim")
        if dtbt > 0:
            nstep = max(1, int(math.ceil(dt / dtbt)))
        btcfg = dataclasses.replace(btcfg, nstep=nstep)
        split_cfg = SplitCfg(be=pf.get("BE", float, 0.6),
                             begw=pf.get("BEGW", float, 0.0),
                             continuity=cont, coriolis=cor, vertvisc=vv,
                             horvisc=hv, barotropic=btcfg,
                             pressure=pgf_cfg, tides_fn=tides,
                             stoch_eos_a=pf.get("STANLEY_A", float, 1.0)
                             if pf.get("STOCH_EOS", bool, False) else 0.0)
    else:
        # the JAX builder always takes the RK3 scheme; RK2 is reached by
        # calling step_dyn_unsplit with UnsplitCfg(scheme="RK2")
        unsplit_cfg = UnsplitCfg(continuity=cont, coriolis=cor, vertvisc=vv,
                                 horvisc=hv, pressure=pgf_cfg,
                                 tides_fn=tides)
    # the ice shelf over the ocean: its pressure on the surface, the
    # stress shielding and the melt fluxes (Model.forcing); the JAX
    # Model holds the shelf itself static (DYNAMIC_SHELF and
    # EVOLVE_ICE_TEMP are read and inert), and so does the port
    ice_shelf = shelf_cfg = None
    if pf.get("ICE_SHELF", bool, False):
        shelf_cfg = ShelfCfg(
            thermo=IceShelfCfg(
                gamma_t=pf.get("SHELF_3EQ_GAMMA_T", float, 1e-4,
                               units="m s-1"),
                rho_ice=pf.get("DENSITY_ICE", float, 918.0,
                               units="kg m-3"),
                rho0=rho0),
            ssa=SSACfg(
                c_basal=pf.get("C_BASAL_FRICTION", float, 0.0,
                               units="Pa (m s-1)^-n"),
                n_basal=pf.get("BASAL_FRICTION_EXP", float, 1.0),
                coulomb=pf.get("USE_COULOMB_FRICTION", bool, False),
                cf_min_n=pf.get("CF_MinN", float, 1.0, units="Pa"),
                cf_post_peak=pf.get("CF_PostPeak", float, 1.0),
                cf_max=pf.get("CF_Max", float, 0.5)),
            dynamic=pf.get("DYNAMIC_SHELF", bool, False),
            g=g_earth,
            stress_frac=pf.get("SHELF_STRESS_FRACTION", float, 0.0),
            evolve_temp=pf.get("EVOLVE_ICE_TEMP", bool, False,
                               desc="advect/evolve the vertically "
                               "integrated ice temperature and feed "
                               "it back on the Glen rheology"),
            t_surf=pf.get("ICE_SURFACE_TEMP", float, -20.0, units="degC"),
            t_shelf_missing=pf.get("T_SHELF_MISSING", float, -10.0,
                                   units="degC"))
        icfg = pf.get("ICE_PROFILE_CONFIG", str, "channel")
        tfile = pf.get("ICE_THICKNESS_FILE", str, "")
        h_ice = init_shelf_thickness(
            icfg if not tfile else "file", grid,
            max_thick=pf.get("SHELF_MAX_THICKNESS", float, 500.0, units="m"),
            lon_extent=pf.get("SHELF_LENGTH_LON", float, 0.25 * lenlon),
            west=west,
            thick_file=os.path.join(pf.get("INPUTDIR", str, "."), tfile)
            if tfile else None,
            var=pf.get("ICE_THICKNESS_VARNAME", str, "thick"), halo=halo)
        covered = h_ice > shelf_cfg.min_thickness
        t_shelf = None
        if shelf_cfg.evolve_temp:
            t_shelf = torch.where(
                covered, torch.full_like(h_ice, pf.get(
                    "T_SHELF_INIT", float, -15.0, units="degC")),
                torch.full_like(h_ice, shelf_cfg.t_shelf_missing))
        ice_shelf = ShelfState(h_shelf=h_ice, area_frac=covered.to(dtype),
                               bed_elev=grid.bathyT, t_shelf=t_shelf)

    pf.module("MOM_state_initialization")
    thick_cfg = pf.get("THICKNESS_CONFIG", str, "uniform")
    init_from_z = pf.get("INIT_LAYERS_FROM_Z_FILE", bool, False)
    thick_lut = {k.lower(): v for k, v in thickness_registry.items()}
    if not init_from_z and thick_cfg not in ("uniform", "sigma") \
            and thick_cfg.lower() not in thick_lut:
        raise NotImplementedError(f"THICKNESS_CONFIG = {thick_cfg!r}: "
                                  "option not ported")
    shape = (nk, domain.njh, domain.nih)
    fields = {}
    T = S = None
    if init_from_z:
        # z-space initial T/S remapped straight onto the model's z*
        # target thicknesses (Z_INIT_ALE_REMAPPING)
        pf.module("MOM_initialize_layers_from_Z")
        zfile = os.path.join(
            pf.get("INPUTDIR", str, "."),
            pf.get("TEMP_SALT_Z_INIT_FILE", str, "temp_salt_z.nc"))
        pvar = pf.get("Z_INIT_FILE_PTEMP_VAR", str, "ptemp")
        svar = pf.get("Z_INIT_FILE_SALT_VAR", str, "salt")
        pf.get("Z_INIT_ALE_REMAPPING", bool, False,
               desc="remap straight to the model coordinate")
        T_zf, S_zf = (_drop_time(read_field(zfile, v)) for v in (pvar, svar))
        src_lon, src_lat, z_cent = (
            np.asarray(read_field(zfile, v), np.float64)
            for v in ("lon", "lat", "depth"))
        # the ALE_RESOLUTION z* levels (default uniform), cut by the
        # bottom
        res = pf.get("ALE_RESOLUTION", list, [max_depth / nk] * nk)
        z_nom = torch.as_tensor(np.concatenate([[0.0], np.cumsum(res)]),
                                **f64).reshape(-1, 1, 1)
        z_cap = torch.minimum(z_nom, grid.bathyT.double()[None])
        h = torch.clamp(z_cap[1:] - z_cap[:-1], min=vgrid.angstrom)
        T, S = temp_salt_from_z(T_zf, S_zf, src_lon, src_lat, z_cent,
                                grid.geoLonT, grid.geoLatT,
                                grid.bathyT.double(), h, vgrid.angstrom)
        T, S = domain.fill_halos((T.to(dtype), S.to(dtype)))
    elif thick_cfg.lower() in thick_lut:
        # the user initializer's context, read as the JAX builder reads it
        user_ctx2 = dict(
            user_ctx, grid=grid, vgrid=vgrid, domain=domain, eos=eos,
            thermo=thermo, nk_rho_varies=nk_rho_varies, p_ref=p_ref,
            coord_mode=pf.get("REGRIDDING_COORDINATE_MODE", str, "LAYER")
            if pf.get("USE_REGRIDDING", bool, False) else "LAYER",
            min_thickness=pf.get("MIN_THICKNESS", float, 1.0e-3, units="m"),
            t_ref=pf.get("T_REF", float, 10.0, units="degC"),
            s_ref=pf.get("S_REF", float, 35.0, units="ppt"))
        for k in _USER_IC_KEYS:
            if pf.has(k):
                user_ctx2[k.lower()] = pf.get(k, float)
        if thick_cfg.lower() == "neverworld" \
                and pf.has("INIT_THICKNESS_PROFILE"):
            user_ctx2["init_thickness_profile"] = pf.get(
                "INIT_THICKNESS_PROFILE", list, units="m")
        fields = thick_lut[thick_cfg.lower()](user_ctx2)
        h = torch.clamp(torch.as_tensor(fields["h"], **f64),
                        min=vgrid.angstrom)
    elif thick_cfg == "sigma":
        # terrain-following: the column split evenly
        h = torch.clamp((grid.bathyT.double() / nk).expand(shape),
                        min=vgrid.angstrom)
    else:
        # uniform nominal dz in depth, clipped by the local bathymetry
        z_nom = (torch.arange(nk + 1, **f64)
                 * (max_depth / nk)).reshape(-1, 1, 1)
        z_cap = torch.minimum(z_nom, grid.bathyT.double()[None])
        h = torch.clamp(z_cap[1:] - z_cap[:-1], min=vgrid.angstrom)
    h = domain.fill_halos(h.to(dtype))
    if thermo and not init_from_z:
        ts_cfg = pf.get("TS_CONFIG", str, "uniform")
        T0 = pf.get("T_REF", float, 10.0, units="degC")
        S0 = pf.get("S_REF", float, 35.0, units="ppt")
        one = torch.ones(shape, **f64)
        if ts_cfg == "uniform":
            T, S = T0 * one, S0 * one
        elif ts_cfg == "from_file":
            # layer T and S on the compute domain, halos copied from the
            # edge
            ts_file = os.path.join(pf.get("INPUTDIR", str, "."),
                                   pf.get("TS_FILE", str, "ts.nc"))
            T, S = (torch.as_tensor(np.pad(
                np.asarray(read_field(ts_file, pf.get(k, str, d))),
                ((0, 0), (halo, halo), (halo, halo)), mode="edge"), **f64)
                for k, d in (("TEMP_VAR", "PTEMP"), ("SALT_VAR", "SALT")))
        elif ts_cfg == "linear":
            T_range = pf.get("T_RANGE", float, 0.0, units="degC")
            S_range = pf.get("S_RANGE", float, 0.0, units="ppt")
            k_frac = (torch.arange(nk, **f64) + 0.5) / nk
            T = (T0 + T_range * (0.5 - k_frac)).reshape(-1, 1, 1) * one
            S = (S0 + S_range * (k_frac - 0.5)).reshape(-1, 1, 1) * one
        elif ts_cfg.lower() == thick_cfg.lower() and "T" in fields:
            # T and S come with the user initializer's thicknesses
            T, S = (torch.as_tensor(fields[k], **f64) for k in ("T", "S"))
        elif ts_cfg == "SCM_CVMix_tests":
            pf.module("SCM_CVMix_tests")
            # the L1 values are read, the profile takes the L2 ones
            pf.get("SCM_L1_TEMP", float, 20.0, units="degC")
            pf.get("SCM_L1_SALT", float, 35.0, units="ppt")
            T, S = scm_cvmix_ts(
                h.double(),
                t_mld=pf.get("SCM_TEMP_MLD", float, 0.0, units="m"),
                s_mld=pf.get("SCM_SALT_MLD", float, 0.0, units="m"),
                l2_temp=pf.get("SCM_L2_TEMP", float, 20.0, units="degC"),
                l2_salt=pf.get("SCM_L2_SALT", float, 35.0, units="ppt"),
                dtdz=pf.get("SCM_L2_DTDZ", float, 0.0, units="degC m-1"),
                dsdz=pf.get("SCM_L2_DSDZ", float, 0.0, units="ppt m-1"),
                min_temp=pf.get("SCM_L2_MINTEMP", float, 4.0,
                                units="degC"))
            pf.module("MOM_state_initialization")
        elif ts_cfg == "benchmark":
            T, S = (torch.as_tensor(a, **f64) for a in init_benchmark_ts(
                dict(user_ctx, grid=grid, vgrid=vgrid, eos=eos,
                     nk_rho_varies=nk_rho_varies, p_ref=p_ref, s_ref=S0),
                shape))
        elif ts_cfg.upper() == "ISOMIP":
            pf.module("ISOMIP_initialization")
            ctx_ts = dict(user_ctx, grid=grid)
            for k in ("ISOMIP_T_SUR", "ISOMIP_S_SUR", "ISOMIP_T_BOT",
                      "ISOMIP_S_BOT"):
                if pf.has(k):
                    ctx_ts[k.lower()] = pf.get(k, float)
            pf.module("MOM_state_initialization")
            T, S = (torch.as_tensor(a, **f64) for a in isomip_ts(ctx_ts, h))
        elif ts_cfg == "baroclinic_zone":
            # the BCZIC% block
            pf.module("baroclinic_zone_initialization")
            ctx_ts = dict(user_ctx, grid=grid, t_ref=T0, s_ref=S0)
            for key, name in (("bcz_dtdz", "BCZIC%DTDZ"),
                              ("bcz_delta_t", "BCZIC%DELTA_T"),
                              ("bcz_dtdx", "BCZIC%DTDX"),
                              ("bcz_dsdz", "BCZIC%DSDZ"),
                              ("bcz_delta_s", "BCZIC%DELTA_S"),
                              ("bcz_dsdx", "BCZIC%DSDX")):
                ctx_ts[key] = pf.get(name, float, 0.0)
            ctx_ts["bcz_l_zone"] = pf.get("BCZIC%L_ZONE", float, 0.5 * lenlat)
            pf.module("MOM_state_initialization")
            T, S = (torch.as_tensor(a, **f64)
                    for a in baroclinic_zone_ts(ctx_ts, h))
        else:
            raise NotImplementedError(f"TS_CONFIG = {ts_cfg!r}: option not "
                                      "ported")
        T, S = T.to(dtype), S.to(dtype)
    # the user initializer's velocities, unless VELOCITY_CONFIG sets them
    u0 = v0 = torch.zeros_like(h)
    if "u" in fields:
        u0 = torch.as_tensor(fields["u"], **dev)
    if "v" in fields:
        v0 = torch.as_tensor(fields["v"], **dev)
    vel_cfg = _one_of("VELOCITY_CONFIG",
                      pf.get("VELOCITY_CONFIG", str, "zero"),
                      ("zero", "uniform", "circular", "file"))
    if vel_cfg == "uniform":
        u0 = torch.full(shape, pf.get("INITIAL_U_CONST", float, 0.0,
                                      units="m s-1"), **dev)
        v0 = torch.full(shape, pf.get("INITIAL_V_CONST", float, 0.0,
                                      units="m s-1"), **dev)
    elif vel_cfg == "circular":
        # the azimuthal flow of the streamfunction psi(r) = A (1 -
        # cos(pi r)) / 2, r the normalized distance from the centre
        cmax = pf.get("CIRCULAR_MAX_U", float, 0.0, units="m s-1")
        lon0 = float(torch.min(grid.geoLonBu))
        lat0 = float(torch.min(grid.geoLatBu))
        len_lon = float(torch.max(grid.geoLonBu)) - lon0
        len_lat = float(torch.max(grid.geoLatBu)) - lat0
        xq = 2.0 * (grid.geoLonBu - lon0) / max(len_lon, 1e-30) - 1.0
        yq = 2.0 * (grid.geoLatBu - lat0) / max(len_lat, 1e-30) - 1.0
        r = torch.clamp(torch.sqrt(xq * xq + yq * yq), max=1.0)
        # the axis length in m: km axes, or ~111 km a degree
        unit_m = 1.0e3 if axis_units.startswith("k") else 111.0e3
        psi = 0.5 * (1.0 - torch.cos(math.pi * r)) \
            * (cmax * len_lon * unit_m / math.pi)
        u2d = (psi - jm1(psi)) / torch.clamp(grid.dyCu, min=1e-30)
        v2d = (im1(psi) - psi) / torch.clamp(grid.dxCv, min=1e-30)
        u0 = (u2d[None] * grid.mask2dCu).expand(shape) + 0.0
        v0 = (v2d[None] * grid.mask2dCv).expand(shape) + 0.0
    elif vel_cfg == "file":
        # velocities on the compute domain, zero halos, masked
        vfile = os.path.join(pf.get("INPUTDIR", str, "."),
                             pf.get("VELOCITY_FILE", str, "velocity.nc"))
        u0, v0 = (domain.pad(torch.as_tensor(
            _drop_time(read_field(vfile, pf.get(k, str, d))), **dev))
            for k, d in (("U_IC_VAR", "u"), ("V_IC_VAR", "v")))
        u0, v0 = u0 * grid.mask2dCu, v0 * grid.mask2dCv
    state = State(u=u0, v=v0, h=h, T=T, S=S)
    if pf.get("FRAZIL", bool, False) and T is not None:
        # the accumulated frazil is allocated up front, so that the state
        # (and its restarts) has the same fields from step 0
        state = state.replace(frazil=torch.zeros_like(h[0]))
    if ice_shelf is not None:
        # the free surface depressed into isostatic balance with the
        # ice's load, eta = -p_shelf / (rho0 g): each column scaled
        htot = torch.sum(state.h, dim=0)
        eta0 = -shelf_main.shelf_surface_pressure(shelf_cfg, ice_shelf) \
            / (rho0 * g_earth)
        target = torch.clamp(grid.bathyT + eta0, min=1e-3)
        scale = torch.where(htot > 0, target / torch.clamp(htot, min=1e-30),
                            1.0)
        state = state.replace(h=state.h * scale[None])

    pf.module("MOM_surface_forcing")
    sf_cfg = SurfaceForcingCfg(
        wind_config=pf.get("WIND_CONFIG", str, "zero"),
        taux_magnitude=pf.get("TAUX_MAGNITUDE", float, 0.1, units="Pa"),
        taux_const=pf.get("TAUX_CONST", float, 0.0, units="Pa"),
        taux_sin_amp=pf.get("TAUX_SIN_AMP", float, 0.0, units="Pa"),
        taux_cos_amp=pf.get("TAUX_COS_AMP", float, 0.0, units="Pa"),
        taux_n_pis=pf.get("TAUX_N_PIS", float, 1.0),
        buoy_config=pf.get("BUOY_CONFIG", str, "zero"),
        sensible_heat=pf.get("SENSIBLE_HEAT_FLUX", float, 0.0,
                             units="W m-2"),
        restore_sst=pf.get("RESTOREBUOY", bool, False),
        fluxconst=pf.get("FLUXCONST", float, 0.0, units="m day-1"),
        sst_north=pf.get("SST_NORTH", float, 5.0, units="degC"),
        sst_south=pf.get("SST_SOUTH", float, 25.0, units="degC"),
        sss_north=pf.get("SSS_NORTH", float, 35.0, units="ppt"),
        sss_south=pf.get("SSS_SOUTH", float, 35.0, units="ppt"),
        restore_sss=pf.has("SSS_NORTH") or pf.has("SSS_SOUTH"),
        rho0=rho0,
        cp=pf.get("C_P", float, 3991.86795711963, units="J kg-1 K-1"))
    indir = pf.get("INPUTDIR", str, ".")
    _one_of("WIND_CONFIG", sf_cfg.wind_config, _WINDS)
    forces_fn = fluxes_fn = db_fluxes_fn = None
    if sf_cfg.wind_config.lower() == "file":
        wind_file = os.path.join(indir, pf.get("WIND_FILE", str))
        x_var = pf.get("WINDSTRESS_X_VAR", str, "STRESS_X")
        y_var = pf.get("WINDSTRESS_Y_VAR", str, "STRESS_Y")
        # read but unused: ROADMAP.md "Reference faults", WIND_STAGGER
        pf.get("WIND_STAGGER", str, "C")
        forces_fn = wind_forcing_from_file(
            grid, wind_file, x_var, y_var,
            scale=pf.get("WINDSTRESS_SCALE", float, 1.0))
        forces = forces_fn(0.0)
        if not forces_fn.time_varying:
            forces_fn = None            # a static file wind is baked in
    elif sf_cfg.wind_config == "SCM_CVMix_tests":
        pf.module("SCM_CVMix_tests")
        pf.get("SCM_USE_WIND_STRESS", bool, True)
        forces = scm_wind(grid, pf.get("SCM_TAU_X", float, 0.0, units="Pa"),
                          pf.get("SCM_TAU_Y", float, 0.0, units="Pa"))
        pf.module("MOM_surface_forcing")
    elif sf_cfg.wind_config in ("ideal_hurr", "SCM_ideal_hurr"):
        pf.module("idealized_hurricane")
        hcfg = HurricaneCfg(
            rho_air=pf.get("IDL_HURR_RHO_AIR", float, 1.2, units="kg m-3"),
            p_ambient=pf.get("IDL_HURR_AMBIENT_PRESSURE", float, 101200.0,
                             units="Pa"),
            p_central=pf.get("IDL_HURR_CENTRAL_PRESSURE", float, 96800.0,
                             units="Pa"),
            rad_max_wind=pf.get("IDL_HURR_RAD_MAX_WIND", float, 50.0e3,
                                units="m"),
            max_windspeed=pf.get("IDL_HURR_MAX_WIND", float, 65.0,
                                 units="m s-1"),
            translation_spd=pf.get("IDL_HURR_TRAN_SPEED", float, 5.0,
                                   units="m s-1"),
            translation_dir=pf.get("IDL_HURR_TRAN_DIR", float, 180.0,
                                   units="deg"),
            x0=pf.get("IDL_HURR_X0", float, 0.0, units="m"),
            y0=pf.get("IDL_HURR_Y0", float, 0.0, units="m"),
            scm_mode=(sf_cfg.wind_config == "SCM_ideal_hurr")
            or pf.get("IDL_HURR_SCM", bool, False),
            br_bench=pf.get("IDL_HURR_SCM_BR_BENCH", bool, False),
            dy_from_center=pf.get("IDL_HURR_SCM_LOCY", float, 50.0e3,
                                  units="m"))
        pf.module("MOM_surface_forcing")
        forces_fn = idealized_hurricane_fn(hcfg, grid)
        forces = forces_fn(0.0)
    elif sf_cfg.wind_config == "dumbbell":
        pf.module("dumbbell_surface_forcing")
        db_cfg = DumbbellForcingCfg(
            slp_amplitude=pf.get("DUMBBELL_SLP_AMP", float, 10000.0,
                                 units="Pa"),
            slp_period=pf.get("DUMBBELL_SLP_PERIOD", float, 1.0,
                              units="days"),
            s_surf=pf.get("INITIAL_SSS", float, 34.0, units="ppt"),
            s_range=pf.get("INITIAL_S_RANGE", float, 2.0, units="ppt"),
            flux_const=sf_cfg.fluxconst if sf_cfg.restore_sst else 0.0,
            rho_restore=pf.get("RESTORE_FLUX_RHO", float, rho0,
                               units="kg m-3"),
            rotate=pf.get("DUMBBELL_ROTATION", bool, False))
        pf.module("MOM_surface_forcing")
        forces_fn, db_fluxes_fn = dumbbell_forcing(db_cfg, grid, west,
                                                   lenlon, south, lenlat)
        forces = forces_fn(0.0)
    else:
        forces = build_wind(sf_cfg, grid, south, lenlat)
    if thermo and sf_cfg.buoy_config not in ("zero", "NONE"):
        _one_of("BUOY_CONFIG", sf_cfg.buoy_config, _BUOYS)
        if sf_cfg.buoy_config == "const_heat":
            def fluxes_fn(state, t, _q=sf_cfg.sensible_heat, _g=grid):
                return Fluxes(sensible=torch.full_like(state.h[0], _q)
                              * _g.mask2dT)
        elif sf_cfg.buoy_config == "SCM_CVMix_tests":
            pf.module("SCM_CVMix_tests")
            use_hf = pf.get("SCM_USE_HEAT_FLUX", bool, False)
            use_ev = pf.get("SCM_USE_EVAPORATION", bool, False)
            use_sw = pf.get("SCM_USE_DIURNAL_SW", bool, False)
            fluxes_fn = scm_buoyancy_fn(
                grid,
                heat_flux=pf.get("SCM_HEAT_FLUX", float, 0.0,
                                 units="m degC s-1") if use_hf else 0.0,
                evaporation=pf.get("SCM_EVAPORATION", float, 0.0,
                                   units="m s-1") if use_ev else 0.0,
                max_sw=pf.get("SCM_DIURNAL_SW_MAX", float, 0.0,
                              units="m degC s-1") if use_sw else 0.0,
                rho_restore=pf.get("RESTORE_FLUX_RHO", float, rho0,
                                   units="kg m-3"),
                cp=sf_cfg.cp)
            pf.module("MOM_surface_forcing")
        elif sf_cfg.buoy_config == "BFB":
            pf.module("BFB_surface_forcing")
            fluxes_fn = bfb_buoyancy_fn(
                grid, sst_s=pf.get("SST_S", float, 20.0, units="degC"),
                sst_n=pf.get("SST_N", float, 10.0, units="degC"),
                lfr_slat=pf.get("LFR_SLAT", float, 20.0, units="degrees"),
                lfr_nlat=pf.get("LFR_NLAT", float, 40.0, units="degrees"),
                flux_const=sf_cfg.fluxconst if sf_cfg.restore_sst else 0.0,
                rho_restore=pf.get("RESTORE_FLUX_RHO", float, rho0,
                                   units="kg m-3"),
                cp=sf_cfg.cp)
            pf.module("MOM_surface_forcing")
        elif sf_cfg.buoy_config == "dumbbell":
            # the reservoirs' salinity restoring, built with the SLP
            # seesaw above
            if sf_cfg.wind_config != "dumbbell":
                raise ValueError("BUOY_CONFIG='dumbbell' requires "
                                 "WIND_CONFIG='dumbbell'")
            fluxes_fn = db_fluxes_fn
        elif sf_cfg.buoy_config == "file":
            files = {}
            for fld, param, default_var in _BUOY_FILE_FIELDS:
                if pf.has(param):
                    fpath = os.path.join(indir, pf.get(param, str))
                    files[fld] = (fpath, pf.get(
                        param.replace("_FILE", "_VAR"), str, default_var))
            if not files:
                raise ValueError("BUOY_CONFIG='file' but no *_FILE "
                                 "parameters were set")
            fluxes_fn = buoyancy_forcing_from_files(grid, files)
    # the case's data_table replaces forcing fields by file data or
    # constants
    data_override = DataOverride.build(
        os.path.join(pf.case_dir, "data_table"), grid, indir=indir)

    split_state = None
    if split and split_rk2b:
        split_state = init_split_b_state(domain, grid, vgrid, state)
    elif split:
        split_state = init_split_state(domain, grid, vgrid, state,
                                       horvisc_cfg=hv)

    pf.module("MOM_ALE")
    ale_cfg = None
    if use_regrid:
        mode = pf.get("REGRIDDING_COORDINATE_MODE", str, "Z*")
        res = pf.get("ALE_RESOLUTION", list, [])
        scheme = pf.get("REMAPPING_SCHEME", str, "PPM_H4")
        adapt_kw = {}
        if mode.upper().startswith("ADAPT"):
            adapt_kw = dict(
                adapt_time_ratio=pf.get("ADAPT_TIME_RATIO", float, 0.1),
                adapt_zoom=pf.get("ADAPT_ZOOM_DEPTH", float, 200.0,
                                  units="m"),
                adapt_zoom_coeff=pf.get("ADAPT_ZOOM_COEFF", float, 0.2),
                adapt_buoy_coeff=pf.get("ADAPT_BUOY_COEFF", float, 0.8),
                adapt_alpha=pf.get("ADAPT_ALPHA", float, 1.0),
                adapt_drho0=pf.get("ADAPT_DRHO0", float, 0.5,
                                   units="kg m-3"),
                adapt_do_min=pf.get("ADAPT_DO_MIN_DEPTH", bool, False))
        # hybgen unmixing ahead of a HYCOM1 regrid
        unmix_cfg = None
        if pf.get("HYBGEN_UNMIX", bool,
                  False) and mode.upper() in ("HYCOM1", "HYBRID"):
            unmix_cfg = HybgenUnmixCfg(
                hybiso=pf.get("HYBGEN_REMAP_DENSITY_MATCH", float, 0.01,
                              units="kg m-3"),
                qhybrlx=pf.get("HYBGEN_REGRID_RELAX", float, 0.25),
                fixlay=pf.get("HYBGEN_UNMIX_FIXLAY", int, 2),
                ref_pressure=p_ref)
        hybgen_kw = {}
        if mode.upper() == "HYBGEN":
            # the hybgen generator's parameters (the reference spells
            # PR0FILE with a zero)
            nomdz = res if res else [max_depth / nk] * nk
            dp0k = pf.get("HYBGEN_DEEP_DZ_PR0FILE", list, list(nomdz),
                          units="m")
            ds0k = pf.get("HYBGEN_SHALLOW_DZ_PR0FILE", list,
                          [0.1 * v for v in nomdz], units="m")
            hybgen_kw["hybgen"] = HybgenRegridCfg(
                dp0k=tuple(dp0k), ds0k=tuple(ds0k),
                nsigma=pf.get("HYBGEN_N_SIGMA", int, 0),
                dp00i=pf.get("HYBGEN_ISOPYCNAL_DZ_MIN", float, 1.0,
                             units="m"),
                qhybrlx=1.0 / max(pf.get("HYBGEN_RELAX_PERIOD", float, 4.0,
                                         units="timesteps"), 1.0),
                topiso_const=pf.get("HYBGEN_MIN_ISO_DEPTH", float, 0.0,
                                    units="m"),
                hybiso=pf.get("HYBGEN_REMAP_DENSITY_MATCH", float, 0.01,
                              units="kg m-3"),
                thkbot=pf.get("HYBGEN_BBL_THICKNESS", float, 6.0,
                              units="m"),
                min_thickness=pf.get("HYBGEN_MIN_THICKNESS", float, 1e-3,
                                     units="m"),
                rho_eps=pf.get("HYBGEN_DENSITY_EPSILON", float, 1e-11,
                               units="kg m-3"),
                h_thin=pf.get("HYBGEN_H_THIN", float, 1e-6, units="m"),
                dp_far_from_sfc=pf.get("HYBGEN_FAR_FROM_SURFACE", float,
                                       0.25, units="m"),
                dp_far_from_bot=pf.get("HYBGEN_FAR_FROM_BOTTOM", float,
                                       0.25, units="m"),
                min_dilate=pf.get("HYBGEN_REMAP_MIN_ZSTAR_DILATE", float,
                                  0.5),
                max_dilate=pf.get("HYBGEN_REMAP_MAX_ZSTAR_DILATE", float,
                                  2.0),
                ref_pressure=pf.get("P_REF", float, 2.0e7, units="Pa"))
        ale_cfg = ALECfg(
            regrid=RegridCfg(mode=mode, resolution=tuple(res),
                             min_thickness=pf.get("MIN_THICKNESS", float,
                                                  1e-3, units="m"),
                             **adapt_kw, **hybgen_kw),
            remap=RemapCfg(scheme=scheme),
            vel_remap=RemapCfg(scheme=pf.get("VELOCITY_REMAPPING_SCHEME",
                                             str, scheme)),
            hybgen_unmix=unmix_cfg,
            sequential_remap=pf.get(
                "ALE_SEQUENTIAL_REMAP", bool, False,
                desc="remap fields one at a time behind optimization "
                "barriers: slower, but caps the remap's live "
                "temporaries at one field (HBM lever for production "
                "grids)"),
            remap_band=pf.get(
                "ALE_REMAP_BAND", int, 0,
                desc="evaluate only the near-diagonal (dst,src) pairs "
                "of the per-step remap, |k-m|<=band; a violating step "
                "falls back to the full pair space (exact); 0 "
                "disables"),
            regrid_time_scale=pf.get("REGRID_TIME_SCALE", float, 0.0,
                                     units="s"),
            filter_shallow_depth=pf.get("REGRID_FILTER_SHALLOW_DEPTH",
                                        float, 0.0, units="m"),
            filter_deep_depth=pf.get("REGRID_FILTER_DEEP_DEPTH",
                                     float, 0.0, units="m"))
        # REGRID_ACCELERATE_INIT: the initial grid regridded
        # REGRID_ACCELERATE_ITERATIONS times toward the coordinate's
        # attractor, the state remapped once onto it, and the split
        # state made anew on the new grid
        if thermo and state.T is not None \
                and pf.get("REGRID_ACCELERATE_INIT", bool, False):
            n_acc = pf.get("REGRID_ACCELERATE_ITERATIONS", int, 1)
            fill = domain.fill_halos
            state = state.replace(h=fill(state.h), T=fill(state.T),
                                  S=fill(state.S))
            state, _, _ = ale_regrid_accelerated(grid, vgrid, state, ale_cfg,
                                                 n_acc, eos=eos)
            state = state.replace(h=fill(state.h), T=fill(state.T),
                                  S=fill(state.S))
            if split and split_rk2b:
                split_state = init_split_b_state(domain, grid, vgrid, state)
            elif split:
                split_state = init_split_state(domain, grid, vgrid, state,
                                               horvisc_cfg=hv)

    pf.module("MOM_set_diffusivity")
    use_lmd94 = pf.get("USE_LMD94", bool, False)
    use_pp81 = pf.get("USE_PP81", bool, False)
    shear_cfg = ShearMixingCfg(
        scheme="PP81" if use_pp81 else "LMD94",
        nu_zero=pf.get("NU_ZERO", float, 5e-3, units="m2 s-1"),
        ri_zero=pf.get("RI_ZERO", float, 0.8))
    bk_scheme = "bryan_lewis" if pf.get("BRYAN_LEWIS_DIFFUSIVITY", bool,
                                        False) else "constant"
    if use_bml and use_regrid:
        raise ValueError("BULKMIXEDLAYER = True requires layer mode; it "
                         "cannot be combined with USE_REGRIDDING = True "
                         "(use KPP or ePBL in ALE mode)")
    use_jackson = pf.get("USE_JACKSON_PARAM", bool, False)
    int_tide = pf.get("INT_TIDE_DISSIPATION", bool, False)
    geo_flux = pf.get("GEOTHERMAL_FLUX", float, 0.0, units="W m-2")
    if pf.get("DO_GEOTHERMAL", bool, False) and geo_flux == 0.0:
        # without a heat-flux file, GEOTHERMAL_SCALE is the uniform flux
        geo_flux = pf.get("GEOTHERMAL_SCALE", float, 0.0, units="W m-2")
    pen_sw_nbands = pf.get("PEN_SW_NBANDS", int, 0)
    use_epbl = pf.get("ENERGETICS_SFC_PBL", bool, False)
    dia_cfg = DiabaticCfg(
        diffusivity=DiffusivityCfg(
            kd=pf.get("KD", float, 0.0, units="m2 s-1"),
            kd_min=pf.get("KD_MIN", float, 0.0, units="m2 s-1"),
            kd_max=pf.get("KD_MAX", float, -1.0, units="m2 s-1"),
            bkgnd=BkgndMixingCfg(scheme=bk_scheme,
                                 kd=pf.get("KD", float, 0.0)),
            use_shear=use_lmd94 or use_pp81,
            shear=shear_cfg,
            prandtl_turb=pf.get("PRANDTL_TURB", float, 1.0,
                                desc="turbulent Prandtl number "
                                "converting shear-driven Kd into the "
                                "Kv_shear the dynamics' vertvisc "
                                "consumes "
                                "(MOM_set_viscosity.F90:2957)"),
            use_kappa_shear=use_jackson,
            kappa_shear=KappaShearCfg(
                rino_crit=pf.get("RINO_CRIT", float, 0.25),
                shearmix_rate=pf.get("SHEARMIX_RATE", float, 0.089),
                fri_curvature=pf.get("FRI_CURVATURE", float, -0.97),
                c_n=pf.get("TKE_N_DECAY_CONST", float, 0.24),
                c_s=pf.get("TKE_SHEAR_DECAY_CONST", float, 0.14),
                lam=pf.get("KAPPA_SHEAR_LAMBDA", float, 0.82),
                kd_max=pf.get("KAPPA_SHEAR_MAX", float, 1.0,
                              units="m2 s-1"),
                max_rino_it=pf.get("MAX_RINO_IT", int, 8)),
            use_conv=pf.get("USE_CVMIX_CONVECTION", bool, False),
            conv=ConvectionCfg(kd_conv=pf.get("KD_CONV", float, 1.0,
                                              units="m2 s-1")),
            use_ddiff=pf.get("DOUBLE_DIFFUSION", bool, False),
            use_tidal=int_tide,
            use_lotw_bbl=pf.get("USE_LOTW_BBL_DIFFUSIVITY", bool, False),
            use_user_kd=pf.get("USER_CHANGE_DIFFUSIVITY", bool, False),
            user_kd=_build_user_kd(pf, p_ref)
            if pf.get("USER_CHANGE_DIFFUSIVITY", bool, False) else None,
            bbl_effic=pf.get("BBL_EFFIC", float, 0.2),
            ml_radiation=pf.get("ML_RADIATION", bool, False),
            ml_rad_coeff=pf.get("ML_RAD_COEFF", float, 0.2),
            ml_rad_efold=pf.get("ML_RAD_EFOLD_COEFF", float, 2.0),
            ml_rad_kd_max=pf.get("ML_RAD_KD_MAX", float, 1e-3,
                                 units="m2 s-1"),
            tidal=TidalMixingCfg(
                gamma_itides=pf.get("GAMMA_ITIDES", float, 0.2),
                int_tide_decay_scale=pf.get("INT_TIDE_DECAY_SCALE", float,
                                            500.0, units="m"),
                profile=pf.get("INT_TIDE_PROFILE", str, "STLAURENT_02"),
                polzin_decay_scale=pf.get("POLZIN_DECAY_SCALE_FACTOR",
                                          float, 300.0, units="m")),
            tidal_energy_flux=pf.get("TIDAL_ENERGY_FLUX", float,
                                     1e-3 if int_tide else 0.0,
                                     units="W m-2")),
        use_kpp=pf.get("USE_KPP", bool, False),
        kpp=KPPCfg(ri_crit=pf.get("RI_CRIT", float, 0.3),
                   cv=pf.get("KPP_CV", float, 1.7)),
        use_epbl=use_epbl,
        epbl=EPBLCfg(mstar=pf.get("EPBL_MSTAR", float, 1.2),
                     use_mld_iteration=pf.get(
                         "USE_MLD_ITERATION", bool, True,
                         desc="iterate the ePBL MLD/mstar coupling "
                         "(MOM_energetic_PBL.F90:2252)"),
                     mld_iters=pf.get("EPBL_MLD_MAX_ITS", int, 3),
                     mstar_mode=pf.get("EPBL_MSTAR_MODE", int, 0),
                     nstar=pf.get("EPBL_NSTAR", float, 0.2),
                     tke_decay=pf.get("TKE_DECAY", float, 2.5)),
        rho0=rho0,
        gust_const=pf.get("GUST_CONST", float, 0.0, units="Pa",
                          desc="background gustiness added to |tau| "
                          "in the u* used by the boundary-layer "
                          "schemes (MOM_surface_forcing.F90:428)"),
        # PEN_SW_SCALE > 0 turns penetrating shortwave on and, without
        # PEN_SW_NBANDS, selects the single exponential band
        use_opacity=(pen_sw_nbands > 0
                     or pf.get("PEN_SW_SCALE", float, 0.0, units="m") > 0.0),
        opacity=OpacityCfg(
            scheme=("EXPONENTIAL"
                    if pf.get("PEN_SW_SCALE", float, 0.0) > 0.0
                    and pen_sw_nbands == 0
                    else pf.get("OPACITY_SCHEME", str, "JERLOV")),
            pen_sw_scale=pf.get("PEN_SW_SCALE", float, 15.0) or 15.0,
            pen_sw_frac=pf.get("PEN_SW_FRAC", float, 0.42),
            water_type={1: "I", 2: "IA", 3: "IB", 4: "II", 5: "III"}.get(
                pf.get("WATER_TYPE", int, 3), "IB"),
            chl=pf.get("CHL_CONC", float, 0.1, units="mg m-3"),
            correct_absorption_depth=pf.get("CORRECT_ABSORPTION_DEPTH",
                                            bool, False)),
        depth_limit_fluxes=pf.get("DEPTH_LIMIT_FLUXES", float, 0.0,
                                  units="m"),
        use_psurf_in_eos=pf.get("USE_PSURF_IN_EOS", bool, True),
        use_geothermal=geo_flux > 0.0,
        geothermal=GeothermalCfg(geothermal_flux=geo_flux, rho0=rho0),
        use_full_conv=pf.get("FULL_CONVECTION", bool, False),
        use_bml=use_bml,
        # the energetics of the bulk mixed layer are read whatever
        # BULKMIXEDLAYER says, as the JAX builder reads them
        bml=BulkMixedLayerCfg(
            mstar=pf.get("MSTAR", float, 1.2),
            nstar=pf.get("NSTAR", float, 0.15), rho0=rho0,
            bulk_ri=pf.get("BULK_RI_ML", float, 0.05,
                           desc="efficiency with which mean kinetic "
                           "energy released by mechanically forced "
                           "entrainment is converted to TKE "
                           "(MOM_bulk_mixed_layer.F90:3991)"),
            tke_decay=pf.get("TKE_DECAY", float, 2.5,
                             desc="ratio of the natural Ekman depth "
                             "to the TKE decay scale "
                             "(MOM_bulk_mixed_layer.F90:4000)"),
            hmix_min=pf.get("HMIX_MIN", float, 0.0, units="m"),
            omega_frac=pf.get("ML_OMEGA_FRAC", float, 0.0),
            omega=pf.get("OMEGA", float, 7.2921e-5, units="s-1")),
        use_entrain_diffusive=pf.get("ENTRAIN_DIFFUSIVE", bool,
                                     not use_regrid),
        entrain=EntrainDiffusiveCfg(
            max_ent_it=pf.get("MAX_ENT_IT", int, 5)),
        use_regularize=pf.get("REGULARIZE_SURFACE_LAYERS", bool, False),
        regularize=RegularizeLayersCfg(
            hmix_min=pf.get("HMIX_MIN", float, 0.0, units="m")),
        do_frazil=pf.get("FRAZIL", bool, False),
        frazil=FrazilCfg(rho0=rho0, g=g_earth,
                         cp=pf.get("C_P", float, 3991.86795711963,
                                   units="J kg-1 K-1"),
                         reclaim=pf.get("RECLAIM_FRAZIL", bool, True,
                                        desc="above-freezing surface "
                                        "water melts pending frazil "
                                        "before new frazil forms "
                                        "(make_frazil, "
                                        "MOM_diabatic_aux.F90:59)")),
        use_waves=pf.get("USE_WAVES", bool, False),
        waves=_build_waves_cfg(pf))
    pf.module("MOM_thickness_diffuse")
    thickness_diffuse_on = pf.get("THICKNESSDIFFUSE", bool, True)
    td_cfg = ThicknessDiffuseCfg(
        khth=(pf.get("KHTH", float, 0.0, units="m2 s-1")
              if thickness_diffuse_on else 0.0),
        khth_max=pf.get("KHTH_MAX", float, 0.0, units="m2 s-1"))
    pf.module("MOM_interface_filter")
    if_cfg = InterfaceFilterCfg(
        time_scale=pf.get("INTERFACE_FILTER_TIME_SCALE", float, 0.0,
                          units="s"))
    # the MEKE -> VarMix coefficient chain; every MEKE parameter is read
    # whatever USE_MEKE says, as the JAX builder reads them
    pf.module("MOM_MEKE")
    use_meke = pf.get("USE_MEKE", bool, False)
    meke_cfg = MEKECfg(
        frcoeff=pf.get("MEKE_FRCOEFF", float, 0.1),
        gmcoeff=pf.get("MEKE_GMCOEFF", float, 0.1),
        damping=pf.get("MEKE_DAMPING", float, 0.0, units="s-1"),
        cdrag=pf.get("MEKE_CDRAG", float, 0.003),
        cb=pf.get("MEKE_CB", float, 25.0),
        ct=pf.get("MEKE_CT", float, 50.0),
        cd_scale=pf.get("MEKE_CD_SCALE", float, 0.0),
        ks_coeff=pf.get("MEKE_KHCOEFF", float, 1.0),
        bgsrc=pf.get("MEKE_BGSRC", float, 0.0, units="W kg-1"),
        khmeke_fac=pf.get("MEKE_KHMEKE_FAC", float, 0.0),
        viscosity_coeff_ku=pf.get("MEKE_VISCOSITY_COEFF_KU", float, 0.0,
                                  units="nondim"),
        advection_factor=pf.get("MEKE_ADVECTION_FACTOR", float, 0.0),
        a_deform=pf.get("MEKE_ALPHA_DEFORM", float, 0.0),
        a_frict=pf.get("MEKE_ALPHA_FRICT", float, 0.0),
        a_rhines=pf.get("MEKE_ALPHA_RHINES", float, 0.0),
        a_eady=pf.get("MEKE_ALPHA_EADY", float, 0.0),
        a_grid=pf.get("MEKE_ALPHA_GRID", float, 0.0),
        l_fixed=pf.get("MEKE_FIXED_MIXING_LENGTH", float,
                       pf.get("MEKE_LSCALE", float, 1e4, units="m"),
                       units="m"),
        use_min_lscale=pf.get("MEKE_USE_MIN_LSCALE", bool, False),
        geometric=pf.get("MEKE_GEOMETRIC", bool, False),
        geometric_alpha=pf.get("MEKE_GEOMETRIC_ALPHA", float, 0.05))
    if use_meke and meke_cfg.viscosity_coeff_ku != 0.0 and not hv.laplacian:
        MOM_error(FATAL, "MEKE_VISCOSITY_COEFF_KU is true but LAPLACIAN is "
                  "false (MOM_MEKE.F90:1375)")
    pf.module("MOM_lateral_mixing_coeffs")
    # USE_VISBECK needs the VarMix slope machinery; both are read
    use_varmix_param = pf.get("USE_VARIABLE_MIXING", bool, False)
    use_visbeck = pf.get("USE_VISBECK", bool, False)
    use_varmix = use_varmix_param or use_visbeck
    varmix_cfg = VarMixCfg(
        use_variable_mixing=use_varmix,
        res_fn_power=pf.get("KH_RES_FN_POWER", int, 2),
        res_coef=pf.get("KH_RES_SCALE_COEF", float, 1.0),
        khth_slope_cff=pf.get("KHTH_SLOPE_CFF", float, 0.0),
        visbeck_l_scale=pf.get("VISBECK_L_SCALE", float, 0.0, units="m"),
        gill_equatorial_ld=pf.get("GILL_EQUATORIAL_LD", bool, True),
        interpolate_res_fn=pf.get("INTERPOLATE_RES_FN", bool, False),
        varmix_ktop=pf.get("VARMIX_KTOP", int, 2),
        use_stored_slopes=pf.get(
            "USE_STORED_SLOPES", bool, False,
            desc="Eady rate from true EOS isoneutral slopes instead "
            "of interface-height gradients "
            "(MOM_lateral_mixing_coeffs.F90:495)"))
    pf.module("MOM_mixed_layer_restrat")
    use_mle = pf.get("MIXEDLAYER_RESTRAT", bool, False)
    mle_cfg = MLRestratCfg(
        fox_kemper_ml_restrat_coef=pf.get("FOX_KEMPER_ML_RESTRAT_COEF",
                                          float, 20.0),
        ml_restrat_timescale=pf.get("ML_RESTRAT_TIMESCALE", float,
                                    86400.0, units="s"))
    pf.module("MOM_tracer_hor_diff")
    hordiff_cfg = TracerHorDiffCfg(
        khtr=pf.get("KHTR", float, 0.0, units="m2 s-1"),
        khtr_min=pf.get("KHTR_MIN", float, 0.0, units="m2 s-1"),
        khtr_max=pf.get("KHTR_MAX", float, -1.0, units="m2 s-1"),
        khtr_slope_cff=pf.get("KHTR_SLOPE_CFF", float, 0.0),
        diffuse_ml_to_interior=pf.get("DIFFUSE_ML_TO_INTERIOR", bool, False),
        ml_khtr_scale=pf.get("ML_KHTR_SCALE", float, 1.0),
        nkml=nkml, nkmb=nk_rho_varies, p_ref=p_ref)
    use_neutral = pf.get("USE_NEUTRAL_DIFFUSION", bool, False)
    neutral_cfg = NeutralDiffCfg(khtr=hordiff_cfg.khtr)
    n_dyn_per_therm = max(1, int(round(dt_therm / dt)))
    pf.module("MOM_sponge")
    sponge = _sponge_data(pf, domain, grid, vgrid, south=south,
                          lenlon=lenlon, max_depth=max_depth, **dev)

    # transports accumulate over n_dyn_per_therm dynamics steps, so the
    # tracer advection gets enough sweep pairs to exhaust the worst-case
    # accumulated face CFL (CFL_TRUNCATE per dynamics step) at max_cfl
    # a pass, plus a spare pass
    adv = TracerAdvectCfg()
    adv_cfg = dataclasses.replace(adv, n_sweep_pairs=max(2, int(math.ceil(
        n_dyn_per_therm * vv.cfl_trunc / adv.max_cfl))))
    pf.module("MOM_internal_tides")
    it_kw = _internal_tides(pf, domain, rho0, **dev)
    # stochastic physics: SPPT, SKEB and the STOCH_EOS pattern
    pf.module("MOM_stochastics")
    sppt_cfg = None
    do_sppt = pf.get("DO_SPPT", bool, False)
    do_skeb = pf.get("DO_SKEB", bool, False)
    use_stoch_eos = pf.get("STOCH_EOS", bool, False)
    if do_sppt or use_stoch_eos or do_skeb:
        sppt_cfg = StochasticsCfg(
            do_sppt=do_sppt,
            sppt_amplitude=pf.get("SPPT_AMPLITUDE", float, 0.5),
            decorr_steps=pf.get("SPPT_DECORR_STEPS", int, 48),
            smooth_passes=pf.get("SPPT_SMOOTH_PASSES", int, 4),
            do_skeb=do_skeb,
            skeb_npass=pf.get("SKEB_NPASS", int, 5,
                              desc="9-point smoother passes on the "
                              "SKEB dissipation estimate"),
            skeb_taper_width=pf.get("SKEB_TAPER_WIDTH", int, 4),
            skeb_amplitude=pf.get("SKEB_AMPLITUDE", float, 1.0))
    pf.module("MOM_hor_bnd_diffusion")
    use_hbd = pf.get("USE_HORIZONTAL_BOUNDARY_DIFFUSION", bool, False)
    hbd_cfg = None
    if use_hbd:
        hbd_cfg = HorBndDiffCfg(khtr_bnd=pf.get(
            "HBD_KHTR", float, pf.get("KHTR", float, 0.0, units="m2 s-1"),
            units="m2 s-1"))
    diabatic_first = pf.get("DIABATIC_FIRST", bool, False)
    thickness_diffuse_first = pf.get(
        "THICKNESSDIFFUSE_FIRST", bool, False,
        desc="diffuse thickness before the dynamics instead of after it "
        "(MOM.F90:1157,1297)")
    meke_khth_fac = pf.get("MEKE_KHTH_FAC", float, 0.0)
    meke_khtr_fac = pf.get("MEKE_KHTR_FAC", float, 0.0)
    ocean_cfg = OceanCfg(split=split, split_rk2b=split_rk2b,
                         split_cfg=split_cfg, unsplit_cfg=unsplit_cfg,
                         n_dyn_per_therm=n_dyn_per_therm,
                         diabatic_first=diabatic_first,
                         tracer_adv=adv_cfg, diabatic=dia_cfg, ale=ale_cfg,
                         thickness_diffuse=td_cfg,
                         thickness_diffuse_first=thickness_diffuse_first,
                         interface_filter=if_cfg,
                         thermo=thermo, adiabatic=adiabatic,
                         sponge=sponge,
                         use_meke=use_meke, meke=meke_cfg,
                         meke_khth_fac=meke_khth_fac,
                         meke_khtr_fac=meke_khtr_fac,
                         use_varmix=use_varmix, varmix=varmix_cfg,
                         resoln_scaled_kh=pf.get("RESOLN_SCALED_KH", bool,
                                                 False),
                         resoln_scaled_khth=pf.get("RESOLN_SCALED_KHTH",
                                                   bool, False),
                         resoln_scaled_khtr=pf.get("RESOLN_SCALED_KHTR",
                                                   bool, False),
                         use_mle=use_mle, mlrestrat=mle_cfg,
                         hordiff=hordiff_cfg, use_neutral=use_neutral,
                         neutral=neutral_cfg, use_hbd=use_hbd, hbd=hbd_cfg,
                         **it_kw, sppt=sppt_cfg, stoch_eos=use_stoch_eos,
                         sppt_seed=pf.get("SPPT_SEED", int, 12345))
    if use_meke:
        state = state.replace(meke=torch.zeros_like(state.h[0]) + pf.get(
            "MEKE_INIT", float, 1e-7, units="m2 s-2"))

    pf.module("MOM_tracer_flow_control")
    registry = TracerRegistry()
    tracers = {}
    # the packages in the JAX builder's order of registration, which the
    # z-space initialization and the restarts walk
    if pf.get("USE_IDEAL_AGE_TRACER", bool, False):
        tracers["age"] = ideal.register_ideal_age(registry, shape, **dev)
    if pf.get("USE_PSEUDO_SALT_TRACER", bool, False) and S is not None:
        tracers["pseudo_salt"] = ideal.register_pseudo_salt(registry, S)
    if pf.get("USE_REGIONAL_DYES", bool, False):
        tracers["dye1"] = ideal.register_regional_dye(
            registry, grid, shape,
            lon_range=(pf.get("DYE_SOURCE_MINLON", float, -1.0e30),
                       pf.get("DYE_SOURCE_MAXLON", float, 1.0e30)),
            lat_range=(pf.get("DYE_SOURCE_MINLAT", float, -1.0e30),
                       pf.get("DYE_SOURCE_MAXLAT", float, 1.0e30)))
    if pf.get("USE_DOME_TRACER", bool, False):
        tracers.update(ideal.register_dome_tracers(registry, shape, **dev))
    if num_dye > 0:
        tracers.update(ideal.register_dyed_obc_tracers(registry, shape,
                                                       num_dye, **dev))
    if pf.get("USE_BOUNDARY_IMPULSE_TRACER", bool, False):
        tracers["boundary_impulse"] = ideal.register_boundary_impulse(
            registry, shape, source_time=pf.get(
                "IMPULSE_SOURCE_TIME", float, 31536000.0, units="s"), **dev)
    if pf.get("USE_OIL_TRACER", bool, False):
        tracers["oil1"] = ideal.register_oil_tracer(
            registry, grid, shape,
            source_lon=pf.get("OIL_SOURCE_LONGITUDE", float, 0.0),
            source_lat=pf.get("OIL_SOURCE_LATITUDE", float, 0.0),
            source_k=pf.get("OIL_SOURCE_LAYER", int, 0),
            source_rate=pf.get("OIL_SOURCE_RATE", float, 1.0,
                               units="kg s-1"),
            decay_days=pf.get("OIL_DECAY_DAYS", float, 0.0, units="days"))
    if pf.get("USE_ADVECTION_TEST_TRACER", bool, False):
        tracers.update(ideal.register_advection_test(
            registry, grid, shape,
            x_origin=pf.get("ADVECTION_TEST_X_ORIGIN", float, 0.0),
            y_origin=pf.get("ADVECTION_TEST_Y_ORIGIN", float, 0.0),
            x_width=pf.get("ADVECTION_TEST_X_WIDTH", float, 0.0),
            y_width=pf.get("ADVECTION_TEST_Y_WIDTH", float, 0.0)))
    use_marbl = pf.get("USE_MARBL_TRACERS", bool, False)
    use_cfc = pf.get("USE_OCMIP2_CFC", bool, False)
    use_npzd = pf.get("USE_NPZD", bool, False)
    if use_cfc and not use_marbl:
        # standalone CFCs, each with its own column function; with MARBL
        # they ride the coupler's gas exchange instead
        tracers.update(register_cfcs(
            registry, shape,
            u10=pf.get("CFC_EXCHANGE_WIND", float, 8.0, units="m s-1"),
            pcfc11_atm=pf.get("PCFC11_ATM", float, 270.0e-12, units="atm"),
            pcfc12_atm=pf.get("PCFC12_ATM", float, 465.0e-12, units="atm"),
            **dev))
    if use_marbl or use_npzd:
        bgc, bgc_tracers = build_bgc_coupler(
            pf, grid, shape, registry, use_marbl=use_marbl,
            use_npzd=use_npzd, use_cfc_coupled=use_cfc and use_marbl, **dev)
        if bgc is not None:
            tracers.update(bgc_tracers)
            ocean_cfg = dataclasses.replace(ocean_cfg, bgc=bgc)
    # a z-space file variable named as a registered tracer gives that
    # tracer's initial state (regridded, remapped onto the layers)
    trz_file = pf.get("TRACER_Z_INIT_FILE", str, "")
    if trz_file and tracers:
        zpath = os.path.join(pf.get("INPUTDIR", str, "."), trz_file)
        zlon, zlat, zdep = (np.asarray(read_field(zpath, v), np.float64)
                            for v in ("lon", "lat", "depth"))
        znames = field_names(zpath)
        for tname in [n for n in tracers if n in znames]:
            trz = tracer_from_z(_drop_time(read_field(zpath, tname)), zlon,
                                zlat, zdep, grid.geoLonT, grid.geoLatT,
                                grid.bathyT.double(), state.h.double(),
                                vgrid.angstrom)
            tracers[tname] = domain.fill_halos(trz.to(dtype)) * grid.mask2dT
    # stale configurations fail with the reference's hint text
    check_obsolete_params(pf, skip=allow_obsolete)
    for name, ptype, default in _PARITY_POLICY:
        if pf.has(name):
            pf.get(name, ptype, default,
                   desc="accepted for reference-config parity; a "
                   "no-op by design (solver policy / IO naming "
                   "/ answer-date switch)")
    for name, ptype, default in _PARITY_UNIMPL:
        if pf.has(name):
            val = pf.get(name, ptype, default,
                         desc="WARNING: accepted but NOT IMPLEMENTED — this "
                         "reference option is not differentiated here "
                         "and results may differ from the reference")
            if val != default:
                MOM_error(WARNING, f"parameter {name}={val} accepted but not "
                          "implemented; behavior follows the default")
    default_only(pf, "PHASED_JIT", bool, False, module="MOM",
                 desc="run thermo steps as two executables "
                 "(dynamics, then tracer+thermo/ALE) to halve "
                 "peak HBM at production grid sizes")

    return Model(domain=domain, grid=grid, vgrid=vgrid, eos=eos,
                 cfg=ocean_cfg, forcing_cfg=sf_cfg, south=south,
                 lenlat=lenlat, forces=forces, registry=registry,
                 state=state, split=split_state, tracers=tracers or None,
                 dt=dt, dt_therm=dt_therm, dt_forcing=dt_forcing,
                 daymax=daymax, thermo=thermo, obc=obc,
                 obc_update_fn=obc_update_fn, forces_fn=forces_fn,
                 fluxes_fn=fluxes_fn, data_override=data_override,
                 ice_shelf=ice_shelf, shelf_cfg=shelf_cfg)
