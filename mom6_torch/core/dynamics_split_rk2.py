"""Split barotropic/baroclinic RK2 dynamics step.

Counterpart of ``mom6_tpu.core.dynamics_split_rk2``
(step_MOM_dyn_split_RK2):

  PREDICTOR: pressure force on h; Coriolis/advection on the previous
  time-mean velocities and transports; BT_cont curves; btstep; the
  predicted velocities with implicit vertical viscosity; continuity
  over the full dt with the predictor's mean barotropic transports.

  CORRECTOR: pressure force on the predicted h; horizontal viscosity
  and Coriolis/advection on the time-mean state; btstep; the new
  velocities with vertical viscosity and truncation; continuity to
  h(n+1) and the next time-mean velocities.

The continuity sweeps, the BT_cont fit and the barotropic subcycle go
through the dispatching wrappers: hand-written CUDA kernels on CUDA
tensors, their plain PyTorch versions on CPU tensors.  With T/S and an
equation of state the pressure force and pbce take in-situ densities.
The tidal/SAL geopotential (``cfg.tides_fn``) is evaluated once a step
from the mass-consistent free surface; BEGW weights the corrector's
pressure force between h and the predicted thickness.  With open
boundaries (``obc``) every halo fill is followed by the extension
through the open edges, the BT_cont curves are off (linear barotropic
transports), the barotropic solver applies the Flather radiation, the
horizontal viscosity the OBC flags, and the new velocities take the
Orlanski radiation after the vertical viscosity.  With STOCH_EOS
(``cfg.stoch_eos_a`` and a ``stoch_pattern``) both pressure-force calls
multiply the Stanley variance by exp(a pattern); with USE_GME the
horizontal viscosity takes the barotropic velocities and column
thickness of the incoming time-mean state.  ``kh_scale`` (the VarMix
resolution function, RESOLN_SCALED_KH) and ``kh_extra`` (MEKE's Ku) go
to the corrector's horizontal viscosity, and ``kv_shear`` (the shear
viscosity of the last diabatic phase) to every vertical viscosity.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from mom6_torch.core.barotropic import BarotropicCfg, btstep
from mom6_torch.core.continuity_cuda import (continuity_ppm_cuda,
                                             set_up_bt_cont_cuda)
from mom6_torch.core.continuity_ppm import ContinuityCfg
from mom6_torch.core.coriolis_adv import CoriolisCfg, coriolis_adv
from mom6_torch.core.forcing import MechForcing
from mom6_torch.core.grid import Grid
from mom6_torch.core.pressure_force import (PressureForceCfg,
                                            interface_heights,
                                            pressure_force)
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import (VertViscCfg, set_viscous_bbl,
                                           surface_ustar, vertvisc,
                                           vertvisc_coef,
                                           vertvisc_limit_vel,
                                           vertvisc_remnant)
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.param.lateral.hor_visc import (HorViscCfg,
                                               horizontal_viscosity)
from mom6_torch.parallel.domain import Domain
from mom6_torch.parallel.stencil import ip1, jp1

__all__ = ["SplitCfg", "SplitDynState", "SplitDiags", "init_split_state",
           "step_dyn_split_rk2"]


@dataclasses.dataclass(frozen=True)
class SplitCfg:
    be: float = 0.6                  # BE predictor weight
    begw: float = 0.0                # BEGW gravity-wave weight
    continuity: ContinuityCfg = ContinuityCfg()
    coriolis: CoriolisCfg = CoriolisCfg()
    pressure: PressureForceCfg = PressureForceCfg()
    vertvisc: VertViscCfg = VertViscCfg()
    horvisc: HorViscCfg = HorViscCfg()
    barotropic: BarotropicCfg = BarotropicCfg()
    # (eta, t) -> tidal + SAL geopotential height anomaly [m], or None
    tides_fn: object = None
    # STOCH_EOS: STANLEY_A, the exponent's factor of the Stanley variance
    # multiplier exp(a pattern); 0 disables
    stoch_eos_a: float = 0.0


@dataclasses.dataclass(frozen=True)
class SplitDynState:
    """Auxiliary prognostic state of the split scheme."""
    u_av: torch.Tensor
    v_av: torch.Tensor
    h_av: torch.Tensor
    uh: torch.Tensor
    vh: torch.Tensor
    eta: torch.Tensor          # free surface [m]
    diffu: torch.Tensor        # previous corrector's hor. viscosity
    diffv: torch.Tensor


class SplitDiags(NamedTuple):
    uh: torch.Tensor
    vh: torch.Tensor
    uhtr: torch.Tensor
    vhtr: torch.Tensor
    truncs: torch.Tensor
    eta_av: torch.Tensor


def init_split_state(domain: Domain, grid: Grid, vgrid: VerticalGrid,
                     state: State, horvisc_cfg: HorViscCfg | None = None
                     ) -> SplitDynState:
    """Bootstrap the split state from the instantaneous state; with
    ``horvisc_cfg`` diffu/diffv start from one horizontal_viscosity
    evaluation, otherwise zeros."""
    e = interface_heights(vgrid, state.h, grid.bathyT)
    z = torch.zeros_like(state.h)
    diffu = diffv = z
    if horvisc_cfg is not None:
        u, v, h = domain.fill_halos((state.u, state.v, state.h))
        diffu, diffv = horizontal_viscosity(grid, u, v, h, horvisc_cfg)
    return SplitDynState(u_av=state.u, v_av=state.v, h_av=state.h,
                         uh=z, vh=z, eta=e[0], diffu=diffu, diffv=diffv)


def stoch_eos_multiplier(cfg: SplitCfg, stoch_pattern):
    """STOCH_EOS: exp(STANLEY_A pattern), the multiplier of the Stanley
    variance, or None without it."""
    if cfg.stoch_eos_a == 0.0 or stoch_pattern is None:
        return None
    return torch.exp(cfg.stoch_eos_a * stoch_pattern)


def gme_inputs(cfg: SplitCfg, h_av, u_av, v_av) -> dict:
    """USE_GME: the thickness-weighted barotropic velocities and the
    column thickness of the time-mean state, as keywords of
    ``horizontal_viscosity``; empty without GME."""
    if not cfg.horvisc.use_gme:
        return {}
    h_u = 0.5 * (h_av + ip1(h_av))
    h_v = 0.5 * (h_av + jp1(h_av))
    return dict(u_bt=torch.sum(h_u * u_av, dim=0)
                / (torch.sum(h_u, dim=0) + 1e-30),
                v_bt=torch.sum(h_v * v_av, dim=0)
                / (torch.sum(h_v, dim=0) + 1e-30),
                htot=torch.sum(h_av, dim=0))


def halo_fill(domain: Domain, obc):
    """The steppers' halo fill: ``Domain.fill_halos`` on a nest of
    fields, followed with open boundaries by the extension through the
    open edges."""
    if obc is None:
        return domain.fill_halos_group

    def fill(f, width=None):
        return obc.extend(domain.fill_halos(f, width=width))
    return fill


def tidal_geopotential(cfg, eta, t):
    """The step's tidal + SAL geopotential height from the
    mass-consistent free surface, None without tides."""
    if cfg.tides_fn is None:
        return None
    return cfg.tides_fn(eta, 0.0 if t is None else t)


def viscosity_solve(grid: Grid, cfg: SplitCfg, h, bbl, ustar, forces,
                    rho0: float, u, v, dt_v, kv_int=None):
    """The implicit vertical viscosity of a split step on (u, v) over
    ``dt_v``: (u, v, (visc_rem_u, visc_rem_v)) from one set of
    coefficients; ``kv_int`` as in ``vertvisc_coef``."""
    coefs = vertvisc_coef(grid, u, v, h, kv_int, cfg=cfg.vertvisc, bbl=bbl,
                          ustar=ustar)
    u, v = vertvisc(grid, u, v, h, coefs, dt_v, forces.taux, forces.tauy,
                    rho0, direct_stress=cfg.vertvisc.direct_stress,
                    hmix_stress=cfg.vertvisc.hmix_stress)
    return u, v, vertvisc_remnant(grid, coefs, dt_v)


def corrector_thickness(cfg: SplitCfg, h, hp):
    """The thickness of the corrector's pressure force: hp, or with BEGW
    (1 - begw) h + begw hp."""
    if cfg.begw != 0.0:
        return (1.0 - cfg.begw) * h + cfg.begw * hp
    return hp


def step_dyn_split_rk2(domain: Domain, grid: Grid, vgrid: VerticalGrid,
                       state: State, split: SplitDynState,
                       forces: MechForcing, dt: float, cfg: SplitCfg,
                       eos=None, x_first: bool = True, obc=None,
                       t=None, stoch_pattern=None, kh_scale=None,
                       kh_extra=None, kv_shear=None,
                       ) -> tuple[State, SplitDynState, SplitDiags]:
    """One split RK2 dynamics step (step_MOM_dyn_split_RK2).  ``kv_shear``:
    the shear-driven interface viscosity of the last diabatic phase,
    added to KV in every vertical viscosity of the step."""
    fill = halo_fill(domain, obc)
    rho0 = vgrid.Rho0

    ((u, v), h, (u_av, v_av), h_av, eta) = fill(
        ((state.u, state.v), state.h, (split.u_av, split.v_av),
         split.h_av, split.eta))
    uh, vh = fill((split.uh, split.vh), width=2)
    e_tidal = tidal_geopotential(cfg, eta, t)
    varT_mult = stoch_eos_multiplier(cfg, stoch_pattern)
    gme_kw = gme_inputs(cfg, h_av, u_av, v_av)

    def run_continuity(uu, vv, hh, uhbt, vhbt, vr_u, vr_v):
        return continuity_ppm_cuda(grid, vgrid, uu, vv, hh, dt,
                                   cfg.continuity, uhbt, vhbt, vr_u, vr_v,
                                   x_first=x_first)

    # ---- PREDICTOR ----
    diffu, diffv = fill((split.diffu, split.diffv))
    T, S = state.T, state.S
    pf = pressure_force(grid, vgrid, h, T, S, eos,
                        p_atm=forces.p_surf, cfg=cfg.pressure,
                        e_tidal=e_tidal, varT_mult=varT_mult)
    ca = coriolis_adv(grid, u_av, v_av, h_av, uh, vh, cfg.coriolis)
    u_bc_accel = (ca.CAu + pf.PFu) + diffu
    v_bc_accel = (ca.CAv + pf.PFv) + diffv

    dt_pred = dt * cfg.be
    kv_int = None if kv_shear is None else cfg.vertvisc.kv + kv_shear
    bbl = set_viscous_bbl(grid, u, v, h, cfg.vertvisc, vgrid, T, S, eos)
    ustar = surface_ustar(grid, rho0, forces) \
        if cfg.vertvisc.visc_ml_mode else None
    viscosity = functools.partial(viscosity_solve, grid, cfg, h, bbl, ustar,
                                  forces, rho0, kv_int=kv_int)

    coefs = vertvisc_coef(grid, u_av, v_av, h, kv_int, cfg=cfg.vertvisc,
                          bbl=bbl, ustar=ustar)
    visc_rem_u, visc_rem_v = vertvisc_remnant(grid, coefs, dt_pred)

    eta_cor = grid.mask2dT * ((torch.sum(h, dim=0) - grid.bathyT) - eta)
    bt_cont = None
    uhbt_in = vhbt_in = None
    # open faces take the linear transports Datu*ubt: the curves would
    # anchor to layered transports that the Flather faces override
    use_bt_cont = cfg.barotropic.use_bt_cont and obc is None
    if use_bt_cont:
        bt_cont = set_up_bt_cont_cuda(grid, vgrid, u, v, h, dt,
                                      cfg.continuity, visc_rem_u,
                                      visc_rem_v)
        uhbt_in = torch.sum(uh, dim=0)
        vhbt_in = torch.sum(vh, dim=0)

    bt = btstep(domain, grid, vgrid, u, v, eta, h,
                u_bc_accel, v_bc_accel, pf.pbce, u_av, v_av, dt,
                cfg.barotropic, visc_rem_u, visc_rem_v,
                forces.taux, forces.tauy, eta_pf=pf.eta_pf, obc=obc,
                bt_cont=bt_cont, eta_cor=eta_cor,
                uhbt_in=uhbt_in, vhbt_in=vhbt_in)

    up = grid.mask2dCu * (u + dt_pred * (u_bc_accel + bt.accel_layer_u))
    vp = grid.mask2dCv * (v + dt_pred * (v_bc_accel + bt.accel_layer_v))
    up, vp, vr = viscosity(up, vp, dt_pred)
    ((up, vp), (visc_rem_u, visc_rem_v)) = fill(((up, vp), vr))

    res = run_continuity(up, vp, h, bt.uhbtav, bt.vhbtav,
                         visc_rem_u, visc_rem_v)
    (hp, (uh, vh), (u_av, v_av)) = fill(
        (res.h, (res.uh, res.vh), (res.u_cor, res.v_cor)))
    h_av = 0.5 * (h + hp)

    # ---- CORRECTOR ----
    pf = pressure_force(grid, vgrid, corrector_thickness(cfg, h, hp), T, S,
                        eos, p_atm=forces.p_surf, cfg=cfg.pressure,
                        e_tidal=e_tidal, varT_mult=varT_mult)
    diffu, diffv = horizontal_viscosity(grid, u_av, v_av, h_av,
                                        cfg.horvisc, obc=obc, **gme_kw,
                                        kh_scale=kh_scale, kh_extra=kh_extra)
    ca = coriolis_adv(grid, u_av, v_av, h_av, uh, vh, cfg.coriolis)
    u_bc_accel = (ca.CAu + pf.PFu) + diffu
    v_bc_accel = (ca.CAv + pf.PFv) + diffv
    if use_bt_cont:
        uhbt_in = torch.sum(uh, dim=0)
        vhbt_in = torch.sum(vh, dim=0)
    bt = btstep(domain, grid, vgrid, u, v, eta, h,
                u_bc_accel, v_bc_accel, pf.pbce, u_av, v_av, dt,
                cfg.barotropic, visc_rem_u, visc_rem_v,
                forces.taux, forces.tauy, eta_pf=pf.eta_pf, obc=obc,
                bt_cont=bt_cont, eta_cor=eta_cor,
                uhbt_in=uhbt_in, vhbt_in=vhbt_in)

    u_new = grid.mask2dCu * (u + dt * (u_bc_accel + bt.accel_layer_u))
    v_new = grid.mask2dCv * (v + dt * (v_bc_accel + bt.accel_layer_v))
    u_new, v_new, vr = viscosity(u_new, v_new, dt)
    u_new, v_new, truncs = vertvisc_limit_vel(grid, u_new, v_new, dt,
                                              cfg.vertvisc)
    if obc is not None:
        u_new = obc.radiate_u(u_new, u, dt=dt)
        v_new = obc.radiate_v(v_new, v, dt=dt)
    ((u_new, v_new), (visc_rem_u, visc_rem_v)) = fill(((u_new, v_new), vr))

    res = run_continuity(u_new, v_new, h, bt.uhbtav, bt.vhbtav,
                         visc_rem_u, visc_rem_v)
    (h_new, (uh, vh), (u_av, v_av)) = fill(
        (res.h, (res.uh, res.vh), (res.u_cor, res.v_cor)))

    new_state = state.replace(u=u_new, v=v_new, h=h_new)
    new_split = SplitDynState(u_av=u_av, v_av=v_av,
                              h_av=0.5 * (h + h_new), uh=uh, vh=vh,
                              eta=bt.eta, diffu=diffu, diffv=diffv)
    diags = SplitDiags(uh=uh, vh=vh, uhtr=dt * uh, vhtr=dt * vh,
                       truncs=truncs, eta_av=bt.eta_av)
    return new_state, new_split, diags
