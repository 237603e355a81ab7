"""Phase sequencing of one full ocean step: dynamics, thickness
diffusion, mixed-layer restratification, tracer advection and lateral
diffusion, column physics and ALE.

Counterpart of ``mom6_tpu.core.orchestrator`` (step_MOM /
step_MOM_tracer_dyn / step_MOM_thermo): the split RK2 dynamics
accumulate the mass transports; GM thickness diffusion (after the
dynamics, the reference default) and the MLE overturning add theirs; on
a thermodynamic step (the DT_THERM cadence, ``do_thermo``) T, S and the
passive tracers are advected with the transports accumulated over the
interval and diffused along layers, then the diabatic driver and the
tracers' column functions run, and last, with ``cfg.ale`` set
(USE_REGRIDDING), the ALE regrid/remap moves the state, the split
scheme's time-mean velocities and stored viscous accelerations onto the
new grid.  MEKE/VarMix, the interface filter, neutral and boundary
diffusion, sponges, internal tides, BGC, SPPT, the unsplit and RK2b
schemes, DIABATIC_FIRST and THICKNESSDIFFUSE_FIRST are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mom6_torch.ale.ale_main import ALECfg, ale_regrid_remap
from mom6_torch.core.dynamics_split_rk2 import SplitCfg, step_dyn_split_rk2
from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.grid import Grid
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.param.lateral.mixed_layer_restrat import (
    MLRestratCfg, mixed_layer_restrat)
from mom6_torch.param.lateral.thickness_diffuse import (
    ThicknessDiffuseCfg, thickness_diffuse)
from mom6_torch.param.vertical.diabatic import DiabaticCfg, diabatic
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer.advect import TracerAdvectCfg, advect_tracers
from mom6_torch.tracer.hor_diff import TracerHorDiffCfg, tracer_hordiff

__all__ = ["OceanCfg", "OceanDiags", "step_ocean"]

_UNPORTED = (("split", False, "SPLIT = False: unsplit dynamics"),
             ("split_rk2b", True, "SPLIT_RK2B"),
             ("thickness_diffuse_first", True, "THICKNESSDIFFUSE_FIRST"),
             ("diabatic_first", True, "DIABATIC_FIRST"),
             ("use_meke", True, "USE_MEKE"),
             ("use_varmix", True, "USE_VARIABLE_MIXING"),
             ("resoln_scaled_khth", True, "RESOLN_SCALED_KHTH"),
             ("resoln_scaled_kh", True, "RESOLN_SCALED_KH"),
             ("resoln_scaled_khtr", True, "RESOLN_SCALED_KHTR"),
             ("use_neutral", True, "USE_NEUTRAL_DIFFUSION"),
             ("use_hbd", True, "USE_HORIZONTAL_BOUNDARY_DIFFUSION"),
             ("stoch_eos", True, "STOCH_EOS"))


@dataclasses.dataclass(frozen=True)
class OceanCfg:
    split: bool = True
    split_rk2b: bool = False
    split_cfg: Optional[SplitCfg] = None
    tracer_adv: TracerAdvectCfg = TracerAdvectCfg()
    diabatic: DiabaticCfg = DiabaticCfg()
    thickness_diffuse: ThicknessDiffuseCfg = ThicknessDiffuseCfg()
    thickness_diffuse_first: bool = False
    ale: Optional[ALECfg] = None         # None: layered (no ALE)
    thermo: bool = True
    adiabatic: bool = False
    use_meke: bool = False
    use_varmix: bool = False
    resoln_scaled_khth: bool = False
    resoln_scaled_kh: bool = False
    resoln_scaled_khtr: bool = False
    use_mle: bool = False                # MIXEDLAYER_RESTRAT
    mlrestrat: MLRestratCfg = MLRestratCfg()
    hordiff: TracerHorDiffCfg = TracerHorDiffCfg()
    use_neutral: bool = False
    use_hbd: bool = False
    stoch_eos: bool = False
    n_dyn_per_therm: int = 1             # DT_THERM / DT
    diabatic_first: bool = False

    # sub-configurations of the JAX package's OceanCfg that only matter
    # when the named switch (not ported: it raises) is on
    _INERT = {"meke": "use_meke", "meke_khth_fac": "use_meke",
              "meke_khtr_fac": "use_meke", "varmix": "use_varmix",
              "neutral": "use_neutral", "hbd": "use_hbd",
              "sppt_seed": "stoch_eos"}


class OceanDiags(NamedTuple):
    uhtr: torch.Tensor            # accumulated transports [m3]
    vhtr: torch.Tensor
    truncs: torch.Tensor          # velocity truncations this step
    eta_av: torch.Tensor
    adv_residual: Optional[torch.Tensor] = None
    mld: Optional[torch.Tensor] = None   # KPP boundary-layer depth [m]


def _check(cfg: OceanCfg, kw: dict):
    for name, bad, what in _UNPORTED:
        if getattr(cfg, name) == bad:
            raise NotImplementedError(what)
    for name, val in kw.items():
        if val is not None:
            raise NotImplementedError(name)


def step_ocean(domain: Domain, grid: Grid, vgrid: VerticalGrid,
               state: State, split_state, tracers: dict | None,
               forces: MechForcing, fluxes: Optional[Fluxes], dt: float,
               cfg: OceanCfg, eos=None, x_first: bool = True,
               tracer_registry=None, do_thermo: bool = True,
               uhtr_accum=None, vhtr_accum=None, mld_prev=None,
               kv_shear_prev=None, t=None, obc=None, sponge_data=None,
               int_tide_en=None, sppt_pattern=None):
    """One full ocean step of length dt.  On steps with ``do_thermo``
    False the transports accumulate into the returned diags' uhtr/vhtr,
    which the caller passes back as uhtr_accum/vhtr_accum.  Returns
    (state, split_state, tracers, OceanDiags)."""
    _check(cfg, {"OBC: open boundary segments": obc,
                 "sponge": sponge_data,
                 "internal tides": int_tide_en,
                 "SPPT: stochastic physics": sppt_pattern})
    fill = domain.fill_halos

    kvs = None if kv_shear_prev is None else fill(kv_shear_prev, width=1)
    state, split_state, dd = step_dyn_split_rk2(
        domain, grid, vgrid, state, split_state, forces, dt, cfg.split_cfg,
        eos=eos, x_first=x_first, kv_shear=kvs)

    # thickness diffusion right after the dynamics (MOM.F90:1297-1307);
    # its transports ride into the tracer advection
    uh_param = vh_param = None
    if cfg.thickness_diffuse.khth > 0.0:
        td = thickness_diffuse(grid, vgrid, fill(state.h, width=2), dt,
                               cfg.thickness_diffuse)
        state = state.replace(h=fill(td.h))
        uh_param, vh_param = dt * td.uhD, dt * td.vhD

    # mixed-layer restratification on the previous boundary-layer depth
    if cfg.use_mle and cfg.thermo and state.T is not None:
        hh, tt, ss = fill((state.h, state.T, state.S), width=1)
        mle = mixed_layer_restrat(cfg.mlrestrat, grid, vgrid, hh, dt, T=tt,
                                  S=ss, eos=eos, hml=mld_prev)
        state = state.replace(h=fill(mle.h))
        if uh_param is None:
            uh_param, vh_param = dt * mle.uhml, dt * mle.vhml
        else:
            uh_param = uh_param + dt * mle.uhml
            vh_param = vh_param + dt * mle.vhml

    uhtr, vhtr = dd.uhtr, dd.vhtr
    if uh_param is not None:
        uhtr, vhtr = uhtr + uh_param, vhtr + vh_param
    if uhtr_accum is not None:
        uhtr, vhtr = uhtr_accum + uhtr, vhtr_accum + vhtr
    diags = OceanDiags(uhtr=uhtr, vhtr=vhtr, truncs=dd.truncs,
                       eta_av=dd.eta_av)
    if not do_thermo:
        return state, split_state, tracers, diags

    # tracer transport with the transports accumulated over the interval
    if cfg.thermo and state.T is not None:
        adv = {"T": state.T, "S": state.S}
        if tracers:
            adv.update(tracers)
        adv = fill(adv, width=2)
        he, uh2, vh2 = fill((state.h, uhtr, vhtr), width=2)
        adv, _, resid = advect_tracers(domain, grid, adv, he, uh2, vh2,
                                       cfg.tracer_adv, x_first=x_first)
        diags = diags._replace(adv_residual=resid)
        if cfg.hordiff.khtr > 0.0:
            adv, hh = fill((adv, state.h), width=1)
            adv = tracer_hordiff(domain, grid, adv, hh, dt, cfg.hordiff)
        state = state.replace(T=adv.pop("T"), S=adv.pop("S"))
        tracers = adv if adv else tracers
    elif tracers:
        raise NotImplementedError("passive tracers without T/S")

    # column physics, then ALE (thermo_and_ale)
    if cfg.thermo and not cfg.adiabatic:
        state, tracers, dia = diabatic(state, fluxes, dt, cfg.diabatic,
                                       tracers, vgrid=vgrid, eos=eos,
                                       forces=forces, grid=grid)
        if "mld" in dia:
            diags = diags._replace(mld=dia["mld"])
    if tracer_registry is not None and tracers:
        tracers = tracer_registry.apply_column_fns(
            tracers, state.h, dt, state=state, forces=forces, t=t)
    if cfg.ale is not None:
        state, split_state, tracers = _ale(domain, grid, vgrid, state,
                                           split_state, tracers, cfg, eos,
                                           dt)
    return state, split_state, tracers, diags


def _ale(domain, grid, vgrid, state, split_state, tracers, cfg, eos, dt):
    """The ALE regrid/remap of a thermodynamic step on halo-filled
    fields, the split auxiliaries u_av/v_av and diffu/diffv remapped as
    face fields and h_av refreshed (remap_dyn_split_RK2_aux_vars)."""
    fill = domain.fill_halos

    def filled(st):
        return st.replace(**fill({k: getattr(st, k)
                                  for k in ("h", "u", "v", "T", "S")
                                  if getattr(st, k) is not None}))

    aux_u = fill({"u_av": split_state.u_av, "diffu": split_state.diffu})
    aux_v = fill({"v_av": split_state.v_av, "diffv": split_state.diffv})
    # ALE runs once per thermo step, so the grid-motion filter
    # integrates over the thermo interval, not the dynamics dt
    state, tracers, _, aux_u, aux_v = ale_regrid_remap(
        grid, vgrid, filled(state), cfg.ale, eos=eos, tracers=tracers,
        aux_u=aux_u, aux_v=aux_v, dt=dt * cfg.n_dyn_per_therm)
    # every remapped field's halos are refreshed, not h's alone as in the
    # JAX package: a column of zero thickness (the halo rows beyond a
    # wall) remaps to NaN in float32, where the PPM_H4 edge weights
    # underflow; in float64 those halos already hold what the fill gives
    state = filled(state)
    split_state = dataclasses.replace(split_state, h_av=state.h,
                                      **fill({**aux_u, **aux_v}))
    return state, split_state, fill(tracers)
