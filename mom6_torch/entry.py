"""Model set-up of the port: configuration, forcing and initial state.

``build_full`` and ``FullModel.step_fn`` drive the full ocean step of
the benchmark configuration, bench.py's CONFIG (Z* ALE) with
BT_WIDE_HALO_PERIOD = 2 (the barotropic solve on the wide-halo march,
kernel K3m), or its layered variant (USE_REGRIDDING = False); see
``build_full``.

``build`` returns everything the slice-1 path, ``step_dyn_split_rk2``
alone, needs:

* 512x512 interior, 25 layers, halo 4 (25x520x520 arrays), reentrant
  in x with walls in y, 10 km cartesian spacing, flat bottom at
  4000 m, f0 = 1e-4, beta = 2e-11, VerticalGrid.uniform(gint=0.005);
* layered reduced-gravity pressure force (no equation of state);
* dt = 600 s, Kv = 1e-4, biharmonic Smagorinsky viscosity (0.06),
  BT_cont curves and the barotropic substep count from set_dtbt
  (27 at this depth and spacing);
* wind stress taux = 0.1 Pa on wet u faces;
* h = 4000/nk plus a seeded perturbation of a few metres, u = v = 0.

The tests build the same configuration at a few points and layers.
Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mom6_torch.ale.ale_main import ALECfg
from mom6_torch.ale.regridding import RegridCfg
from mom6_torch.ale.remapping import RemapCfg
from mom6_torch.core.barotropic import BarotropicCfg, set_dtbt
from mom6_torch.core.dynamics_split_rk2 import (SplitCfg, SplitDynState,
                                                init_split_state)
from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.grid import Grid, cartesian_grid
from mom6_torch.core.orchestrator import OceanCfg, step_ocean
from mom6_torch.core.pressure_force import PressureForceCfg
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import VertViscCfg
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.drivers.surface_forcing import (SurfaceForcingCfg,
                                                build_wind,
                                                buoyancy_restoring)
from mom6_torch.eos import EOS, make_eos
from mom6_torch.param.lateral.hor_visc import HorViscCfg
from mom6_torch.param.lateral.mixed_layer_restrat import MLRestratCfg
from mom6_torch.param.lateral.thickness_diffuse import ThicknessDiffuseCfg
from mom6_torch.param.vertical.bkgnd_mixing import BkgndMixingCfg
from mom6_torch.param.vertical.diabatic import DiabaticCfg
from mom6_torch.param.vertical.entrain_diffusive import EntrainDiffusiveCfg
from mom6_torch.param.vertical.kpp import KPPCfg
from mom6_torch.param.vertical.set_diffusivity import DiffusivityCfg
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer.advect import TracerAdvectCfg
from mom6_torch.tracer.hor_diff import TracerHorDiffCfg
from mom6_torch.tracer.ideal import register_ideal_age
from mom6_torch.tracer.registry import TracerRegistry

__all__ = ["Slice", "build", "FullModel", "build_full"]

DT = 600.0
DEPTH = 4000.0


@dataclasses.dataclass(frozen=True)
class Slice:
    domain: Domain
    grid: Grid
    vgrid: VerticalGrid
    cfg: SplitCfg
    state: State
    split: SplitDynState
    forces: MechForcing
    dt: float


def build(ni: int = 512, nj: int = 512, nk: int = 25, *, seed: int = 0,
          device="cuda", dtype: torch.dtype = torch.float32) -> Slice:
    """The slice's configuration with its initial state."""
    d = Domain(ni=ni, nj=nj, halo=4, reentrant_x=True, reentrant_y=False)
    g = cartesian_grid(d, lenlon_km=ni * 10.0, lenlat_km=nj * 10.0,
                       f0=1e-4, beta=2e-11, max_depth=DEPTH,
                       device=device, dtype=dtype)
    vg = VerticalGrid.uniform(nk=nk, gint=0.005, device=device,
                              dtype=dtype)
    nstep = set_dtbt(d, g, vg, BarotropicCfg(), DT)
    cfg = SplitCfg(vertvisc=VertViscCfg(kv=1e-4),
                   horvisc=HorViscCfg(biharmonic=True, smag_bi_const=0.06,
                                      dt=DT),
                   barotropic=BarotropicCfg(nstep=nstep))
    rng = np.random.default_rng(seed)
    h0 = DEPTH / nk + 2.0 * rng.standard_normal((nk, nj, ni))
    h = d.fill_halos(d.pad(torch.as_tensor(h0, dtype=dtype,
                                           device=device)))
    z = torch.zeros_like(h)
    state = State(u=z, v=z, h=h)
    split = init_split_state(d, g, vg, state)
    forces = MechForcing(taux=0.1 * g.mask2dCu)
    return Slice(d, g, vg, cfg, state, split, forces, DT)


DT_THERM = 1200.0


@dataclasses.dataclass
class FullModel:
    """The full step's configuration, forcing and initial state (the
    counterpart of the JAX package's ``Model`` for this configuration).
    ``step_fn`` returns the stepping driver."""
    domain: Domain
    grid: Grid
    vgrid: VerticalGrid
    eos: EOS
    cfg: OceanCfg
    forcing_cfg: SurfaceForcingCfg
    south: float                 # SOUTHLAT [km]
    lenlat: float                # LENLAT [km]
    forces: MechForcing
    registry: TracerRegistry
    state: State
    split: SplitDynState
    tracers: dict
    dt: float
    dt_therm: float

    def fluxes(self, state: State) -> Fluxes:
        """The buoyancy fluxes of BUOY_CONFIG = linear_restoring on the
        given state's surface temperature and salinity."""
        return buoyancy_restoring(self.forcing_cfg, self.grid, state.T[0],
                                  self.south, self.lenlat, sss=state.S[0])

    def step_fn(self):
        """The stepping driver ``step(state, split, tracers, n)`` with the
        cadence of the JAX package's ``Model.step_fn``: step n is a
        thermodynamic step when (n + 1) is a multiple of DT_THERM/DT,
        x_first alternates with the parity of n, the mass transports
        accumulate over the thermodynamic interval, and the boundary-
        layer depth and the shear viscosity carry from step to step.
        ``step.last_diags`` holds the last step's OceanDiags."""
        n_per = max(1, int(round(self.dt_therm / self.dt)))
        acc = {"u": None, "v": None, "mld": None, "kv": None}

        def step(state, split, tracers, n):
            do_thermo = (n + 1) % n_per == 0
            fl = self.fluxes(state) if do_thermo else None
            ua = acc["u"] if acc["u"] is not None \
                else torch.zeros_like(state.h)
            va = acc["v"] if acc["v"] is not None \
                else torch.zeros_like(state.h)
            st, sp, tr, diags = step_ocean(
                self.domain, self.grid, self.vgrid, state, split, tracers,
                self.forces, fl, self.dt, self.cfg, eos=self.eos,
                x_first=(n % 2 == 0), tracer_registry=self.registry,
                do_thermo=do_thermo, uhtr_accum=ua, vhtr_accum=va,
                mld_prev=acc["mld"], kv_shear_prev=acc["kv"],
                t=(n + 0.5) * self.dt)
            if diags.mld is not None:
                acc["mld"] = diags.mld
            if do_thermo:
                acc["u"] = acc["v"] = None
            else:
                acc["u"], acc["v"] = diags.uhtr, diags.vhtr
            step.last_diags = diags
            return st, sp, tr

        step.last_diags = None
        return step


def build_full(ni: int = 512, nj: int = 512, nk: int = 25, *,
               seed: int | None = None, regridding: bool = True,
               device="cuda", dtype: torch.dtype = torch.float32
               ) -> FullModel:
    """The full step of bench.py's CONFIG with BT_WIDE_HALO_PERIOD = 2, at
    ``ni`` x ``nj`` x ``nk`` with 10 km cells:

    * reentrant in x, walls in y, flat bottom at 4000 m, f0 = 1e-4,
      beta = 2e-11; layered vertical grid with no interface reduced
      gravity (GINT = 0), Boussinesq, Rho0 = 1035; EQN_OF_STATE = WRIGHT;
    * dt = 600 s, DT_THERM = 1200 s; split RK2 with BE = 0.6, PPM
      continuity, Sadourny energy Coriolis, the 5-point FV pressure
      force with PLM T/S reconstruction (RECONSTRUCT_FOR_PRESSURE, on
      with USE_REGRIDDING), Kv = 1e-4 with the dynamic BBL and quadratic
      drag, biharmonic Smagorinsky viscosity 0.06, BT_cont curves, nstep
      from set_dtbt (27 at 512x512) and the wide-halo march with
      period 2;
    * KD = 1e-5 background diffusivity, KPP, KHTH = 600 GM, MLE, PLM
      tracer advection with 3 pass pairs, KHTR = 600 along-layer
      diffusion, the ideal age tracer;
    * USE_REGRIDDING = True: Z* regridding (ALE_RESOLUTION empty, so
      uniform fractions of the deepest column; MIN_THICKNESS = 1e-3 m)
      and PPM_H4 remapping of tracers and velocities once a thermodynamic
      step, with no diffusive entrainment (ENTRAIN_DIFFUSIVE is off with
      USE_REGRIDDING);
    * WIND_CONFIG = gyres (0.1 Pa), BUOY_CONFIG = linear_restoring with
      FLUXCONST = 0.5 m/day toward SST 25 -> 5 degC south to north;
    * uniform layers of 4000/nk m at rest, TS_CONFIG = linear:
      T = 10 + 12 (0.5 - (k + 0.5)/nk) degC, S = 35 ppt, age = 0.

    ``regridding=False`` gives the layered variant, USE_REGRIDDING =
    False (bench.py's ``ale_regrid_remap`` probe): no ALE, diffusive
    entrainment on and no T/S reconstruction in the pressure force.

    With ``seed`` None the initial state is the configuration's own (at
    rest and horizontally uniform, as the JAX package builds it).  With
    an integer seed, numpy noise drawn from it is added (h +- 2 m,
    T +- 0.5 degC, u and v +- 0.05 m/s), the same numbers on every
    device, so that runs on two devices can be compared on fields that
    are not roundoff-sized in the first steps.  Runs on ``cuda`` unless
    the caller passes ``device="cpu"``."""
    lenlon, lenlat = ni * 10.0, nj * 10.0
    d = Domain(ni=ni, nj=nj, halo=4, reentrant_x=True, reentrant_y=False)
    g = cartesian_grid(d, lenlon_km=lenlon, lenlat_km=lenlat, f0=1e-4,
                       beta=2e-11, max_depth=DEPTH, device=device,
                       dtype=dtype)
    vg = VerticalGrid.uniform(nk=nk, device=device, dtype=dtype)
    nstep = set_dtbt(d, g, vg, BarotropicCfg(), DT)
    n_per = int(round(DT_THERM / DT))
    vv = VertViscCfg(kv=1e-4)
    split_cfg = SplitCfg(
        pressure=PressureForceCfg(quad_points=5, reconstruct=regridding),
        vertvisc=vv,
        horvisc=HorViscCfg(biharmonic=True, smag_bi_const=0.06, dt=DT),
        barotropic=BarotropicCfg(nstep=nstep, wide_halo_period=2))
    adv = TracerAdvectCfg()
    cfg = OceanCfg(
        split_cfg=split_cfg,
        tracer_adv=dataclasses.replace(adv, n_sweep_pairs=max(2, math.ceil(
            n_per * vv.cfl_trunc / adv.max_cfl))),
        diabatic=DiabaticCfg(
            diffusivity=DiffusivityCfg(kd=1e-5,
                                       bkgnd=BkgndMixingCfg(kd=1e-5)),
            use_kpp=True, kpp=KPPCfg(),
            use_entrain_diffusive=not regridding,
            entrain=EntrainDiffusiveCfg()),
        thickness_diffuse=ThicknessDiffuseCfg(khth=600.0),
        use_mle=True, mlrestrat=MLRestratCfg(),
        hordiff=TracerHorDiffCfg(khtr=600.0), n_dyn_per_therm=n_per,
        ale=ALECfg(regrid=RegridCfg(mode="Z*"), remap=RemapCfg("PPM_H4"),
                   vel_remap=RemapCfg("PPM_H4")) if regridding else None)
    fcfg = SurfaceForcingCfg(wind_config="gyres", taux_magnitude=0.1,
                             buoy_config="linear_restoring",
                             restore_sst=True, fluxconst=0.5)
    forces = build_wind(fcfg, g, 0.0, lenlat)

    # THICKNESS_CONFIG = uniform: nominal dz clipped by the bathymetry
    z_nom = (torch.arange(nk + 1, dtype=torch.float64, device=device)
             * (DEPTH / nk)).reshape(-1, 1, 1)
    z_cap = torch.minimum(z_nom, g.bathyT.double()[None])
    h = torch.clamp(z_cap[1:] - z_cap[:-1], min=vg.angstrom)
    h = d.fill_halos(h.to(dtype))
    shape = h.shape
    k_frac = (torch.arange(nk, dtype=torch.float64, device=device) + 0.5) \
        / nk
    T = (10.0 + 12.0 * (0.5 - k_frac)).reshape(-1, 1, 1) \
        * torch.ones(shape, dtype=torch.float64, device=device)
    S = torch.full(shape, 35.0, dtype=torch.float64, device=device)
    z = torch.zeros_like(h)
    state = State(u=z, v=z, h=h, T=T.to(dtype), S=S.to(dtype))
    if seed is not None:
        rng = np.random.default_rng(seed)

        def noisy(a, scale, mask=None):
            x = a + torch.as_tensor(
                scale * rng.standard_normal(tuple(a.shape)), dtype=dtype,
                device=device)
            return d.fill_halos(x if mask is None else x * mask)

        state = state.replace(h=noisy(state.h, 2.0), T=noisy(state.T, 0.5),
                              u=noisy(state.u, 0.05, g.mask2dCu),
                              v=noisy(state.v, 0.05, g.mask2dCv))
    registry = TracerRegistry()
    tracers = {"age": register_ideal_age(registry, shape, device=device,
                                         dtype=dtype)}
    split = init_split_state(d, g, vg, state, horvisc_cfg=split_cfg.horvisc)
    return FullModel(domain=d, grid=g, vgrid=vg, eos=make_eos("WRIGHT"),
                     cfg=cfg, forcing_cfg=fcfg, south=0.0, lenlat=lenlat,
                     forces=forces, registry=registry, state=state,
                     split=split, tracers=tracers, dt=DT, dt_therm=DT_THERM)
