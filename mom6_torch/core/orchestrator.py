"""Phase sequencing of one full ocean step: dynamics, thickness
diffusion, mixed-layer restratification, tracer advection and lateral
diffusion, column physics and ALE.

Counterpart of ``mom6_tpu.core.orchestrator`` (step_MOM /
step_MOM_tracer_dyn / step_MOM_thermo): the dynamics (split RK2, split
RK2b with ``split_rk2b``, or the unsplit RK3/RK2 step with ``split``
False) accumulate the mass transports; GM thickness diffusion (after the
dynamics, the reference default, or before them with
THICKNESSDIFFUSE_FIRST) and the MLE overturning add theirs; on a
thermodynamic step (the DT_THERM cadence, ``do_thermo``) T, S and the
passive tracers are advected with the transports accumulated over the
interval and diffused along layers, then the column physics run
(``thermo_and_ale``): the stochastic pattern advances (SPPT, STOCH_EOS),
the diabatic driver runs with its tendencies scaled by the pattern under
DO_SPPT, SKEB adds its velocity increment, the tracers' column functions
run, and last, with ``cfg.ale`` set (USE_REGRIDDING), the ALE
regrid/remap moves the state, the split scheme's time-mean velocities
and stored viscous accelerations onto the new grid (the RK2b and
unsplit schemes keep no such auxiliaries).  With DIABATIC_FIRST that
phase runs on the pre-dynamics state of a thermodynamic step instead,
and the dynamics still see the incoming pattern.
With open boundaries (``obc``) the split steppers take the segments,
and the tracer advection fills the halo beyond each open edge from the
tracer reservoirs (``obc_reservoirs``), keeps the boundary transports and
thicknesses through the halo fill and advances the reservoirs; the
unsplit step ignores ``obc``, the pattern and GME's inputs, as in the
JAX package.  Passive tracers without T/S are advected (and diffused)
alone.  MEKE/VarMix, the interface filter, neutral and boundary
diffusion, sponges, internal tides and BGC are not ported yet and raise
``NotImplementedError``.  The shear viscosity of a diabatic phase
(``kv_shear`` in the diags) feeds the next split RK2 dynamics step
(``kv_shear_prev``); the RK2b and unsplit steps take none, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mom6_torch.ale.ale_main import ALECfg, ale_regrid_remap
from mom6_torch.core.dynamics_split_rk2 import (SplitCfg, SplitDynState,
                                                step_dyn_split_rk2)
from mom6_torch.core.dynamics_split_rk2b import step_dyn_split_rk2b
from mom6_torch.core.dynamics_unsplit import UnsplitCfg, step_dyn_unsplit
from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.grid import Grid
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.param.lateral.mixed_layer_restrat import (
    MLRestratCfg, mixed_layer_restrat)
from mom6_torch.param.lateral.thickness_diffuse import (
    ThicknessDiffuseCfg, thickness_diffuse)
from mom6_torch.param.stochastic.stochastics import (StochasticsCfg,
                                                     apply_skeb, apply_sppt,
                                                     init_pattern,
                                                     step_pattern)
from mom6_torch.param.vertical.diabatic import DiabaticCfg, diabatic
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer.advect import TracerAdvectCfg, advect_tracers
from mom6_torch.tracer.hor_diff import TracerHorDiffCfg, tracer_hordiff

__all__ = ["OceanCfg", "OceanDiags", "step_ocean"]

_UNPORTED = (("use_meke", True, "USE_MEKE"),
             ("use_varmix", True, "USE_VARIABLE_MIXING"),
             ("resoln_scaled_khth", True, "RESOLN_SCALED_KHTH"),
             ("resoln_scaled_kh", True, "RESOLN_SCALED_KH"),
             ("resoln_scaled_khtr", True, "RESOLN_SCALED_KHTR"),
             ("use_neutral", True, "USE_NEUTRAL_DIFFUSION"),
             ("use_hbd", True, "USE_HORIZONTAL_BOUNDARY_DIFFUSION"))


@dataclasses.dataclass(frozen=True)
class OceanCfg:
    split: bool = True
    split_rk2b: bool = False
    split_cfg: Optional[SplitCfg] = None
    unsplit_cfg: Optional[UnsplitCfg] = None
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
    # SPPT/SKEB and STOCH_EOS's pattern (None: all three off)
    sppt: Optional[StochasticsCfg] = None
    sppt_seed: int = 12345               # SPPT_SEED
    stoch_eos: bool = False              # STOCH_EOS
    n_dyn_per_therm: int = 1             # DT_THERM / DT
    # DIABATIC_FIRST: the column physics and ALE before the dynamics
    diabatic_first: bool = False

    # sub-configurations of the JAX package's OceanCfg that only matter
    # when the named switch (not ported: it raises) is on
    _INERT = {"meke": "use_meke", "meke_khth_fac": "use_meke",
              "meke_khtr_fac": "use_meke", "varmix": "use_varmix",
              "neutral": "use_neutral", "hbd": "use_hbd"}


class OceanDiags(NamedTuple):
    uhtr: torch.Tensor            # accumulated transports [m3]
    vhtr: torch.Tensor
    truncs: torch.Tensor          # velocity truncations this step
    eta_av: Optional[torch.Tensor]   # None under unsplit dynamics
    adv_residual: Optional[torch.Tensor] = None
    mld: Optional[torch.Tensor] = None   # KPP/ePBL boundary-layer depth
    # the shear viscosity for the next dynamics step (kv_shear_prev)
    kv_shear: Optional[torch.Tensor] = None
    frazil: Optional[torch.Tensor] = None   # accumulated frazil [J m-2]
    # the stochastic pattern carry: a tensor, or {"sppt", "skeb"}
    sppt_pattern: object = None


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
               int_tide_en=None, sppt_pattern=None, obc_reservoirs=None):
    """One full ocean step of length dt.  On steps with ``do_thermo``
    False the transports accumulate into the returned diags' uhtr/vhtr,
    which the caller passes back as uhtr_accum/vhtr_accum.
    ``sppt_pattern``: the stochastic pattern carry of the previous thermo
    step (a tensor, or {"sppt", "skeb"} with SKEB), None at the start;
    the advanced carry comes back as the diags' ``sppt_pattern``.
    Returns (state, split_state, tracers, OceanDiags), and the advanced
    reservoirs fifth when ``obc_reservoirs`` is given."""
    _check(cfg, {"sponge": sponge_data,
                 "internal tides": int_tide_en})
    fill = domain.fill_halos

    def thermo_and_ale(state, split_state, tracers):
        """Column physics (with SPPT and SKEB), the tracers' column
        functions and ALE; returns the new (state, split_state, tracers)
        and the carries for the diags (frazil, mld, kv_shear,
        sppt_pattern)."""
        extras = {}
        if cfg.thermo and not cfg.adiabatic:
            if isinstance(sppt_pattern, dict):
                sp_prev = sppt_pattern.get("sppt")
                sk_prev = sppt_pattern.get("skeb")
            else:
                sp_prev, sk_prev = sppt_pattern, None
            skeb_on = cfg.sppt is not None and cfg.sppt.do_skeb
            sppt_on = cfg.sppt is not None and state.T is not None \
                and (cfg.sppt.do_sppt or cfg.stoch_eos)
            # the step index of the patterns' seeds, rounded half to even
            step_i = round((0.0 if t is None else t) / dt)
            like = dict(dtype=state.h.dtype, device=state.h.device)
            if sppt_on:
                # the AR(1) pattern: STOCH_EOS's multiplier in the next
                # dynamics, and with DO_SPPT the tendencies' factor
                pat = sp_prev if sp_prev is not None else init_pattern(
                    domain, cfg.sppt, cfg.sppt_seed, **like)
                pat = step_pattern(domain, cfg.sppt, pat, cfg.sppt_seed,
                                   step_i)
                sp_prev = pat
                if not skeb_on:
                    extras["sppt_pattern"] = pat
                sppt_on = cfg.sppt.do_sppt
                T_b, S_b = state.T, state.S
            state, tracers, dia = diabatic(state, fluxes, dt, cfg.diabatic,
                                           tracers, vgrid=vgrid, eos=eos,
                                           forces=forces, grid=grid)
            if sppt_on:
                state = state.replace(
                    T=T_b + apply_sppt(cfg.sppt, state.T - T_b, pat),
                    S=S_b + apply_sppt(cfg.sppt, state.S - S_b, pat))
            if skeb_on:
                # SKEB on a stream of its own
                skeb_seed = cfg.sppt_seed + 7919
                skp = sk_prev if sk_prev is not None else init_pattern(
                    domain, cfg.sppt, skeb_seed, **like)
                skp = step_pattern(domain, cfg.sppt, skp, skeb_seed, step_i)
                uf, vf = domain.fill_vector_halos(state.u, state.v, width=1)
                u2, v2 = apply_skeb(domain, grid, cfg.sppt, uf, vf, skp, dt)
                state = state.replace(u=fill(u2), v=fill(v2))
                extras["sppt_pattern"] = {"sppt": sp_prev, "skeb": skp}
            for k in ("frazil", "mld", "kv_shear"):
                if k in dia:
                    extras[k] = dia[k]
        if tracer_registry is not None and tracers:
            tracers = tracer_registry.apply_column_fns(
                tracers, state.h, dt, state=state, forces=forces, t=t)
        if cfg.ale is not None:
            state, split_state, tracers = _ale(domain, grid, vgrid, state,
                                               split_state, tracers, cfg,
                                               eos, dt)
        return state, split_state, tracers, extras

    def do_thickness_param(state):
        """GM thickness diffusion: the new state and its layer transports
        over dt (None without KHTH)."""
        if cfg.thickness_diffuse.khth <= 0.0:
            return state, None, None
        td = thickness_diffuse(grid, vgrid, fill(state.h, width=2), dt,
                               cfg.thickness_diffuse)
        return state.replace(h=fill(td.h)), dt * td.uhD, dt * td.vhD

    # DIABATIC_FIRST: the column physics and ALE on the pre-dynamics
    # state; their carries replace the late call's
    pre_extras = None
    if cfg.diabatic_first and do_thermo:
        state, split_state, tracers, pre_extras = thermo_and_ale(
            state, split_state, tracers)
    # THICKNESSDIFFUSE_FIRST: GM before the dynamics, after them otherwise
    if cfg.thickness_diffuse_first:
        state, uh_param, vh_param = do_thickness_param(state)

    # the dynamics see the incoming pattern, also under DIABATIC_FIRST
    stoch = sppt_pattern.get("sppt") if isinstance(sppt_pattern, dict) \
        else sppt_pattern
    if cfg.split and cfg.split_rk2b:
        state, split_state, dd = step_dyn_split_rk2b(
            domain, grid, vgrid, state, split_state, forces, dt,
            cfg.split_cfg, eos=eos, x_first=x_first, obc=obc, t=t,
            stoch_pattern=stoch)
    elif cfg.split:
        kvs = None if kv_shear_prev is None else fill(kv_shear_prev,
                                                      width=1)
        state, split_state, dd = step_dyn_split_rk2(
            domain, grid, vgrid, state, split_state, forces, dt,
            cfg.split_cfg, eos=eos, x_first=x_first, obc=obc, t=t,
            stoch_pattern=stoch, kv_shear=kvs)
    else:
        # the unsplit step takes neither the pattern nor GME's inputs
        state, dd = step_dyn_unsplit(domain, grid, vgrid, state, forces, dt,
                                     cfg.unsplit_cfg, eos=eos, t=t)

    if not cfg.thickness_diffuse_first:
        state, uh_param, vh_param = do_thickness_param(state)

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
                       eta_av=getattr(dd, "eta_av", None))
    def result(*out):
        return out + (obc_reservoirs,) if obc_reservoirs is not None \
            else out

    if not do_thermo:
        return result(state, split_state, tracers, diags)

    # tracer transport with the transports accumulated over the
    # interval: T and S with the passive tracers, or these alone
    with_ts = cfg.thermo and state.T is not None
    if with_ts or tracers:
        adv = dict(tracers or {})
        if with_ts:
            adv = {"T": state.T, "S": state.S, **adv}
        adv = fill(adv, width=2)
        if obc is not None and obc_reservoirs is not None:
            adv = obc.apply_tracer_reservoirs(adv, obc_reservoirs)
        he, uh2, vh2 = fill((state.h, uhtr, vhtr), width=2)
        if obc is not None:
            he, uh2, vh2 = obc.keep_boundary((state.h, uhtr, vhtr),
                                             (he, uh2, vh2))
        adv, _, resid = advect_tracers(domain, grid, adv, he, uh2, vh2,
                                       cfg.tracer_adv, x_first=x_first)
        diags = diags._replace(adv_residual=resid)
        if obc is not None and obc_reservoirs is not None:
            obc_reservoirs = obc.update_tracer_reservoirs(
                obc_reservoirs, adv, state.u, state.v, dt)
        if cfg.hordiff.khtr > 0.0:
            adv, hh = fill((adv, state.h), width=1)
            adv = tracer_hordiff(domain, grid, adv, hh, dt, cfg.hordiff)
        if with_ts:
            state = state.replace(T=adv.pop("T"), S=adv.pop("S"))
        tracers = adv if adv else tracers

    if pre_extras is not None:
        extras = pre_extras
    else:
        state, split_state, tracers, extras = thermo_and_ale(
            state, split_state, tracers)
    return result(state, split_state, tracers, diags._replace(**extras))


def _ale(domain, grid, vgrid, state, split_state, tracers, cfg, eos, dt):
    """The ALE regrid/remap of a thermodynamic step on halo-filled
    fields; under split RK2 the auxiliaries u_av/v_av and diffu/diffv
    are remapped as face fields and h_av refreshed
    (remap_dyn_split_RK2_aux_vars).  RK2b's increments and eta and the
    unsplit step carry nothing to remap."""
    fill = domain.fill_halos

    def filled(st):
        return st.replace(**fill({k: getattr(st, k)
                                  for k in ("h", "u", "v", "T", "S")
                                  if getattr(st, k) is not None}))

    # ALE runs once per thermo step, so the grid-motion filter
    # integrates over the thermo interval, not the dynamics dt
    if not isinstance(split_state, SplitDynState):
        state, tracers, _, _, _ = ale_regrid_remap(
            grid, vgrid, filled(state), cfg.ale, eos=eos, tracers=tracers,
            dt=dt * cfg.n_dyn_per_therm)
        return filled(state), split_state, fill(tracers)
    aux_u = fill({"u_av": split_state.u_av, "diffu": split_state.diffu})
    aux_v = fill({"v_av": split_state.v_av, "diffv": split_state.diffv})
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
