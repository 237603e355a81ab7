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
alone.  The lateral eddy parameterizations of the JAX package come
in its order: the VarMix resolution function and Eady rate, the
Visbeck and MEKE diffusivities into KHTH (RESOLN_SCALED_KHTH on the
faces), GM with the stratification's PE release feeding the MEKE
step, then the interface filter; the dynamics take the resolution
function (RESOLN_SCALED_KH) and MEKE's Ku; the tracers diffuse along
neutral surfaces (USE_NEUTRAL_DIFFUSION, in place of the along-layer
diffusion) or along layers with MEKE's and the Visbeck share of KHTR,
RESOLN_SCALED_KHTR and the mixed layer's epipycnal exchange, then near
the boundary inside the previous boundary-layer depth
(USE_HORIZONTAL_BOUNDARY_DIFFUSION); and the column physics start with
the internal-tide energy step, whose wave-drag loss replaces the
uniform tidal energy of the tidal mixing (``int_tide_en`` carries En
from one thermodynamic step to the next, the diags' ``int_tide_en``).
At the end of the column physics the sponges restore toward their
targets (``cfg.sponge``): the interface heights first (layered), then T
and S (remapped from their own grid under an ALE sponge), then u and v
toward rest (SPONGE_UV).  After the tracers' column functions the BGC
coupler (``cfg.bgc``, ``tracer/marbl_driver.py``) steps its packages
with the model time, the buoyancy fluxes and their shortwave.
The shear viscosity of a diabatic phase
(``kv_shear`` in the diags) feeds the next split RK2 dynamics step
(``kv_shear_prev``); the RK2b and unsplit steps take none, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
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
from mom6_torch.diagnostics.wave_speed import brunt_vaisala2, wave_speeds
from mom6_torch.param.lateral.interface_filter import (InterfaceFilterCfg,
                                                       interface_filter)
from mom6_torch.param.lateral.internal_tides import (InternalTidesCfg,
                                                     init_en,
                                                     step_internal_tides)
from mom6_torch.param.lateral.meke import (MEKECfg, meke_khth, meke_ku,
                                           meke_length_scales, step_meke)
from mom6_torch.param.lateral.mixed_layer_restrat import (
    MLRestratCfg, mixed_layer_restrat)
from mom6_torch.param.lateral.thickness_diffuse import (
    ThicknessDiffuseCfg, thickness_diffuse)
from mom6_torch.param.lateral.varmix import (VarMixCfg,
                                             calc_eady_rate,
                                             calc_resolution_function,
                                             visbeck_kh)
from mom6_torch.param.stochastic.stochastics import (StochasticsCfg,
                                                     apply_skeb, apply_sppt,
                                                     init_pattern,
                                                     step_pattern)
from mom6_torch.param.vertical.diabatic import DiabaticCfg, diabatic
from mom6_torch.param.vertical.sponge import apply_eta_sponge, apply_sponge
from mom6_torch.param.vertical.tidal_mixing import internal_tide_input
from mom6_torch.parallel.domain import Domain
from mom6_torch.parallel.stencil import ip1, jp1
from mom6_torch.tracer.advect import TracerAdvectCfg, advect_tracers
from mom6_torch.tracer.hor_bnd_diffusion import (HorBndDiffCfg,
                                                 hor_bnd_diffusion)
from mom6_torch.tracer.hor_diff import TracerHorDiffCfg, tracer_hordiff
from mom6_torch.tracer.neutral_diffusion import (NeutralDiffCfg,
                                                 neutral_diffusion)

__all__ = ["OceanCfg", "OceanDiags", "step_ocean"]

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
    interface_filter: InterfaceFilterCfg = InterfaceFilterCfg()
    ale: Optional[ALECfg] = None         # None: layered (no ALE)
    thermo: bool = True
    adiabatic: bool = False
    # the MEKE -> VarMix -> KHTH coefficient chain
    use_meke: bool = False               # USE_MEKE
    meke: MEKECfg = MEKECfg()
    meke_khth_fac: float = 0.0           # MEKE_KHTH_FAC
    meke_khtr_fac: float = 0.0           # MEKE_KHTR_FAC
    use_varmix: bool = False             # USE_VARIABLE_MIXING
    varmix: VarMixCfg = VarMixCfg()
    resoln_scaled_khth: bool = False     # RESOLN_SCALED_KHTH
    resoln_scaled_kh: bool = False       # RESOLN_SCALED_KH
    resoln_scaled_khtr: bool = False     # RESOLN_SCALED_KHTR
    use_mle: bool = False                # MIXEDLAYER_RESTRAT
    mlrestrat: MLRestratCfg = MLRestratCfg()
    hordiff: TracerHorDiffCfg = TracerHorDiffCfg()
    use_neutral: bool = False            # USE_NEUTRAL_DIFFUSION
    neutral: NeutralDiffCfg = NeutralDiffCfg()
    use_hbd: bool = False                # USE_HORIZONTAL_BOUNDARY_DIFFUSION
    hbd: Optional[HorBndDiffCfg] = None
    # the internal-tide energy (None: off), the barotropic tidal speed
    # UTIDE, the roughness variance TIDAL_ROUGHNESS_H2 and the
    # reflection maps ((njh, nih) tensors or None)
    int_tides: Optional[InternalTidesCfg] = None
    int_tide_utide: float = 0.0
    int_tide_h2: float = 2500.0
    int_tide_refl_angle: Optional[torch.Tensor] = None
    int_tide_refl_pref: Optional[torch.Tensor] = None
    int_tide_refl_dbl: Optional[torch.Tensor] = None
    # SPPT/SKEB and STOCH_EOS's pattern (None: all three off)
    sppt: Optional[StochasticsCfg] = None
    sppt_seed: int = 12345               # SPPT_SEED
    stoch_eos: bool = False              # STOCH_EOS
    n_dyn_per_therm: int = 1             # DT_THERM / DT
    # DIABATIC_FIRST: the column physics and ALE before the dynamics
    diabatic_first: bool = False
    # the sponge: {"idamp": (njh, nih) [s-1], "T"/"S": targets or None,
    # "ref_h": their own thicknesses (ALE sponge), "eta": interface
    # depth targets (layered), "uv": damp u and v toward rest}
    sponge: Optional[dict] = None
    # the BGC coupler (marbl_driver.BGCCoupler), None without BGC
    bgc: Optional[object] = None


def _sponge(state: State, sd: dict, dt: float) -> State:
    """The sponge phase: interface heights, then T and S, then u and v."""
    if sd.get("eta") is not None:
        # layered interface restoring; also without T and S
        state = state.replace(h=apply_eta_sponge(state.h, sd["idamp"], dt,
                                                 sd["eta"]))
    if state.T is not None and sd.get("T") is not None:
        damped = apply_sponge({"T": state.T, "S": state.S}, state.h,
                              sd["idamp"], dt, {"T": sd["T"], "S": sd["S"]},
                              ref_h=sd.get("ref_h"))
        state = state.replace(T=damped["T"], S=damped["S"])
    if sd.get("uv"):
        # SPONGE_UV: u and v toward rest at the faces' mean rates
        idu = 0.5 * (sd["idamp"] + ip1(sd["idamp"]))
        idv = 0.5 * (sd["idamp"] + jp1(sd["idamp"]))
        state = state.replace(u=state.u / (1.0 + dt * idu)[None],
                              v=state.v / (1.0 + dt * idv)[None])
    return state


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
    # the internal-tide energy (n_freq, n_mode, n_angle, njh, nih)
    int_tide_en: Optional[torch.Tensor] = None


def step_ocean(domain: Domain, grid: Grid, vgrid: VerticalGrid,
               state: State, split_state, tracers: dict | None,
               forces: MechForcing, fluxes: Optional[Fluxes], dt: float,
               cfg: OceanCfg, eos=None, x_first: bool = True,
               tracer_registry=None, do_thermo: bool = True,
               uhtr_accum=None, vhtr_accum=None, mld_prev=None,
               kv_shear_prev=None, t=None, obc=None,
               int_tide_en=None, sppt_pattern=None, obc_reservoirs=None):
    """One full ocean step of length dt.  On steps with ``do_thermo``
    False the transports accumulate into the returned diags' uhtr/vhtr,
    which the caller passes back as uhtr_accum/vhtr_accum.
    ``sppt_pattern``: the stochastic pattern carry of the previous thermo
    step (a tensor, or {"sppt", "skeb"} with SKEB), None at the start;
    the advanced carry comes back as the diags' ``sppt_pattern``.
    Returns (state, split_state, tracers, OceanDiags), and the advanced
    reservoirs fifth when ``obc_reservoirs`` is given."""
    fill = domain.fill_halos

    def thermo_and_ale(state, split_state, tracers):
        """Column physics (with SPPT and SKEB), the tracers' column
        functions and ALE; returns the new (state, split_state, tracers)
        and the carries for the diags (frazil, mld, kv_shear,
        sppt_pattern)."""
        extras = {}
        if cfg.thermo and not cfg.adiabatic:
            tidal_e2d = None
            if cfg.int_tides is not None:
                # the internal-tide energy step; its wave-drag loss is the
                # tidal mixing's energy
                tidal_e2d, extras["int_tide_en"] = _internal_tides(
                    domain, grid, vgrid, state, cfg, eos, dt, int_tide_en)
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
                                           forces=forces, grid=grid,
                                           tidal_energy_2d=tidal_e2d)
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
        if cfg.sponge is not None:
            state = _sponge(state, cfg.sponge, dt)
        if tracer_registry is not None and tracers:
            tracers = tracer_registry.apply_column_fns(
                tracers, state.h, dt, state=state, forces=forces, t=t)
            if cfg.bgc is not None:
                tracers = cfg.bgc.column_physics(
                    tracers, state.h, state.T, state.S, dt, t=t,
                    fluxes=fluxes,
                    sw=fluxes.sw if fluxes is not None else None)
        if cfg.ale is not None:
            state, split_state, tracers = _ale(domain, grid, vgrid, state,
                                               split_state, tracers, cfg,
                                               eos, dt)
        return state, split_state, tracers, extras

    def do_thickness_param(state):
        """GM thickness diffusion (with MEKE's step on its PE release)
        and the interface filter: the new state and their layer
        transports over dt (None without either)."""
        uh_param = vh_param = None
        if cfg.thickness_diffuse.khth > 0.0 or khth_2d is not None:
            h = fill(state.h, width=2)
            kh2 = fill(khth_2d, width=2) if khth_2d is not None else None
            gp_int = None
            if use_meke and state.T is not None and eos is not None:
                # the interface reduced gravities N^2 dz of the actual
                # stratification, for the GM energy source of MEKE
                tt, ss = fill((state.T, state.S), width=2)
                n2 = brunt_vaisala2(vgrid, h, tt, ss, eos)
                zed = torch.zeros_like(h[:1])
                gp_int = torch.cat([zed, n2 * (0.5 * (h[:-1] + h[1:])), zed],
                                   dim=0)
            ru = rv = None
            if res_u is not None:
                ru, rv = fill((res_u, res_v), width=2)
            td = thickness_diffuse(grid, vgrid, h, dt, cfg.thickness_diffuse,
                                   khth_2d=kh2, gprime_int=gp_int, res_u=ru,
                                   res_v=rv)
            state = state.replace(h=fill(td.h))
            uh_param, vh_param = dt * td.uhD, dt * td.vhD
            if use_meke:
                hsum = torch.sum(h, dim=0) + 1e-30
                u_bt = torch.sum(0.5 * (h + ip1(h)) * state.u, dim=0) / hsum
                v_bt = torch.sum(0.5 * (h + jp1(h)) * state.v, dim=0) / hsum
                meke_new = step_meke(cfg.meke, grid,
                                     fill(state.meke, width=1), dt,
                                     gm_work=td.gm_work, rd_dx=rd_dx, sn=sn,
                                     u_bt=u_bt, v_bt=v_bt)
                state = state.replace(meke=fill(meke_new))
        elif use_meke:
            meke_new = step_meke(cfg.meke, grid, fill(state.meke, width=1),
                                 dt, rd_dx=rd_dx, sn=sn)
            state = state.replace(meke=fill(meke_new))
        if cfg.interface_filter.time_scale > 0.0:
            hf, uhF, vhF = interface_filter(domain, grid, vgrid,
                                            fill(state.h, width=2), dt,
                                            cfg.interface_filter)
            state = state.replace(h=fill(hf))
            uh_param = dt * uhF if uh_param is None else uh_param + dt * uhF
            vh_param = dt * vhF if vh_param is None else vh_param + dt * vhF
        return state, uh_param, vh_param

    # DIABATIC_FIRST: the column physics and ALE on the pre-dynamics
    # state; their carries replace the late call's
    pre_extras = None
    if cfg.diabatic_first and do_thermo:
        state, split_state, tracers, pre_extras = thermo_and_ale(
            state, split_state, tracers)
    # the MEKE -> VarMix -> KHTH chain: the resolution function, the Eady
    # rate, and the Visbeck and MEKE shares of the 2-D KHTH
    use_meke = cfg.use_meke and state.meke is not None
    khth_2d = res_fn = rd_dx = sn = vm = None
    if cfg.use_varmix:
        vm = calc_resolution_function(cfg.varmix, grid, vgrid, state.h,
                                      state.T, state.S, eos)
        res_fn, rd_dx = vm.res_fn, vm.rd_dx
    if (cfg.use_varmix and cfg.varmix.khth_slope_cff > 0.0) or (
            use_meke and (cfg.meke.geometric or cfg.meke.a_eady > 0.0)):
        hh, tt, ss = fill((state.h, state.T, state.S), width=1)
        sn = calc_eady_rate(cfg.varmix, grid, vgrid, hh, tt, ss, eos)
    if cfg.use_varmix and cfg.varmix.khth_slope_cff > 0.0:
        khth_2d = cfg.thickness_diffuse.khth + visbeck_kh(cfg.varmix, grid,
                                                          sn)
    if use_meke and cfg.meke_khth_fac > 0.0:
        base = khth_2d if khth_2d is not None \
            else cfg.thickness_diffuse.khth
        khth_2d = base + cfg.meke_khth_fac * meke_khth(cfg.meke, state.meke,
                                                        sn=sn)
    res_u = res_v = None
    if res_fn is not None and cfg.resoln_scaled_khth:
        res_u, res_v = vm.res_fn_u, vm.res_fn_v
        if khth_2d is None:
            khth_2d = cfg.thickness_diffuse.khth * torch.ones_like(res_fn)

    # THICKNESSDIFFUSE_FIRST: GM before the dynamics, after them otherwise
    if cfg.thickness_diffuse_first:
        state, uh_param, vh_param = do_thickness_param(state)

    # the viscosity inputs: the resolution function (RESOLN_SCALED_KH)
    # and MEKE's Ku
    kh_scale = kh_extra = None
    if cfg.resoln_scaled_kh and res_fn is not None:
        kh_scale = fill(res_fn, width=2)
    if use_meke and cfg.meke.viscosity_coeff_ku != 0.0:
        lmix, _, _ = meke_length_scales(
            cfg.meke, grid, state.meke,
            torch.clamp(grid.bathyT, min=cfg.meke.min_depth), rd_dx=rd_dx,
            sn=sn)
        kh_extra = fill(meke_ku(cfg.meke, state.meke, lmix=lmix), width=2)

    # the dynamics see the incoming pattern, also under DIABATIC_FIRST
    stoch = sppt_pattern.get("sppt") if isinstance(sppt_pattern, dict) \
        else sppt_pattern
    if cfg.split and cfg.split_rk2b:
        state, split_state, dd = step_dyn_split_rk2b(
            domain, grid, vgrid, state, split_state, forces, dt,
            cfg.split_cfg, eos=eos, x_first=x_first, obc=obc, t=t,
            stoch_pattern=stoch, kh_scale=kh_scale, kh_extra=kh_extra)
    elif cfg.split:
        kvs = None if kv_shear_prev is None else fill(kv_shear_prev,
                                                      width=1)
        state, split_state, dd = step_dyn_split_rk2(
            domain, grid, vgrid, state, split_state, forces, dt,
            cfg.split_cfg, eos=eos, x_first=x_first, obc=obc, t=t,
            stoch_pattern=stoch, kh_scale=kh_scale, kh_extra=kh_extra,
            kv_shear=kvs)
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
        if with_ts:
            adv = _lateral_tracer_diffusion(domain, grid, vgrid, state, adv,
                                            cfg, eos, dt, use_meke, mld_prev)
        elif cfg.hordiff.khtr > 0.0:
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


def _internal_tides(domain, grid, vgrid, state, cfg, eos, dt, en):
    """The internal-tide energy step on the modal speeds and near-bottom
    N of the state: (the wave-drag loss [W m-2], the new En)."""
    fill = domain.fill_halos
    itc = cfg.int_tides
    hf = fill(state.h)
    tt = fill(state.T) if state.T is not None else None
    ss = fill(state.S) if state.S is not None else None
    nb = torch.sqrt(torch.clamp(brunt_vaisala2(vgrid, hf, tt, ss, eos)[-1],
                                min=0.0))
    cn = wave_speeds(vgrid, hf, tt, ss, eos, n_mode=itc.n_mode)
    tke_in = internal_tide_input(cfg.int_tide_utide,
                                 math.sqrt(cfg.int_tide_h2), nb,
                                 rho0=vgrid.Rho0,
                                 kappa_itides=itc.kappa_itides)
    if en is None:
        en = init_en(itc, state.h.shape[1:], device=state.h.device,
                     dtype=state.h.dtype)
    itr = step_internal_tides(itc, domain, grid, en, cn, dt, tke_in, nb,
                              torch.sum(hf, dim=0),
                              u_bt2=cfg.int_tide_utide ** 2,
                              h2_rough=cfg.int_tide_h2,
                              refl_angle=cfg.int_tide_refl_angle,
                              refl_pref=cfg.int_tide_refl_pref,
                              refl_dbl=cfg.int_tide_refl_dbl)
    return itr.itidal_loss, itr.En


def _lateral_tracer_diffusion(domain, grid, vgrid, state, adv, cfg, eos, dt,
                              use_meke, mld_prev):
    """The lateral diffusion of T, S and the passive tracers ``adv``
    after their advection: along neutral surfaces, or along layers (with
    MEKE's and the Visbeck share of KHTR, RESOLN_SCALED_KHTR and the
    mixed layer's epipycnal exchange), then near the boundary inside the
    previous boundary-layer depth ``mld_prev``."""
    fill = domain.fill_halos
    hd = cfg.hordiff
    meke_tr = use_meke and cfg.meke_khtr_fac > 0.0
    if cfg.use_neutral and cfg.neutral.khtr > 0.0:
        adv, hh = fill((adv, state.h), width=2)
        adv = neutral_diffusion(domain, grid, vgrid, adv, hh, adv["T"],
                                adv["S"], eos, dt, cfg.neutral)
    elif hd.khtr > 0.0 or meke_tr or hd.khtr_slope_cff > 0.0:
        ktr2 = tr_res_u = tr_res_v = tr_add_u = tr_add_v = None
        if hd.khtr_slope_cff > 0.0:
            # the Visbeck face term cff L^2 SN
            sn_tr = calc_eady_rate(cfg.varmix, grid, vgrid, fill(state.h),
                                   fill(state.T), fill(state.S), eos)
            sn_tr = fill(sn_tr, width=2)
            L2 = cfg.varmix.visbeck_l_scale ** 2 \
                if cfg.varmix.visbeck_l_scale > 0.0 else grid.areaT
            cffL2sn = hd.khtr_slope_cff * L2 * sn_tr
            tr_add_u = 0.5 * (cffL2sn + ip1(cffL2sn))
            tr_add_v = 0.5 * (cffL2sn + jp1(cffL2sn))
        if cfg.resoln_scaled_khtr and cfg.use_varmix:
            # the h-point resolution function averaged to the faces
            rfh = fill(calc_resolution_function(
                cfg.varmix, grid, vgrid, state.h, state.T, state.S,
                eos).res_fn, width=2)
            tr_res_u = 0.5 * (rfh + ip1(rfh))
            tr_res_v = 0.5 * (rfh + jp1(rfh))
        if meke_tr:
            ktr2 = fill(hd.khtr + cfg.meke_khtr_fac
                        * meke_khth(cfg.meke, state.meke), width=1)
        adv, hh = fill((adv, state.h), width=1)
        rho_ml = None
        if hd.diffuse_ml_to_interior and hd.nkmb > 0 and eos is not None:
            # the coordinate density of the mixed-layer and buffer water
            rho_ml = eos.density(adv["T"][:hd.nkmb], adv["S"][:hd.nkmb],
                                 hd.p_ref)
        adv = tracer_hordiff(domain, grid, adv, hh, dt, hd, khtr_2d=ktr2,
                             res_u=tr_res_u, res_v=tr_res_v,
                             add_u=tr_add_u, add_v=tr_add_v,
                             rho_ml=rho_ml, rlay=vgrid.Rlay)
    if cfg.use_hbd and mld_prev is not None:
        adv, hh, bldh = fill((adv, state.h, mld_prev), width=1)
        adv = hor_bnd_diffusion(domain, grid, adv, hh, bldh, dt, cfg.hbd)
    return adv


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
