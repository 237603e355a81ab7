"""Split RK2b dynamics: the restart-lean variant of the split scheme.

Counterpart of ``mom6_tpu.core.dynamics_split_rk2b``
(step_MOM_dyn_split_RK2b).  The prognostic velocities are the
time-filtered ones, u_av in ``State.u``; the instantaneous velocities are
rebuilt each step as u_inst = u_av - du_av_inst * visc_rem from one
persistent 2D barotropic increment, the Newton correction du_cor of the
previous step's final continuity call.  The predictor's Coriolis terms
take transports from a continuity call on (u_av, v_av, h) at the head of
the step, so uh/vh do not persist either.

Sequence: head continuity; pressure force on h; Coriolis/advection and
horizontal viscosity on u_av; visc_rem over dt; u_inst; the eta
mass-source correction; BT_cont curves on u_inst and the anchor
transports of continuity(u_inst); btstep; the predictor velocities with
vertical viscosity and continuity over dt matched to the mean barotropic
transports; the corrector's pressure force, Coriolis and viscosity on the
predicted state; btstep; the new velocities with vertical viscosity and
truncation; the final continuity, matched again, which gives h(n+1),
the new u_av and the new increments.

On CUDA tensors the four continuity calls are kernel K1 (two sweeps
each: the head and anchor calls untargeted, the predictor and final
calls transport-matched), the curve fit is K2 and the barotropic
subcycles K3, or K3m on the wide-halo march.  Tides/SAL, BEGW and the
vertical-friction options enter as in the split RK2 step, and so do
open boundaries (``obc``: extended halo fills, no BT_cont curves, the
Flather radiation in the subcycle, the OBC viscosity flags), with the
Orlanski radiation on the new filtered velocities, and so do STOCH_EOS
and GME (its inputs from the head continuity's time-mean thickness and
u_av), and so do ``kh_scale`` and ``kh_extra`` (both horizontal
viscosities); a shear viscosity raises ``NotImplementedError``, as
the JAX step takes none.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mom6_torch.core.barotropic import btstep
from mom6_torch.core.continuity_cuda import (continuity_ppm_cuda,
                                             set_up_bt_cont_cuda)
from mom6_torch.core.coriolis_adv import coriolis_adv
from mom6_torch.core.dynamics_split_rk2 import (SplitCfg, SplitDiags,
                                                halo_fill,
                                                corrector_thickness,
                                                gme_inputs,
                                                stoch_eos_multiplier,
                                                tidal_geopotential,
                                                viscosity_solve)
from mom6_torch.core.forcing import MechForcing
from mom6_torch.core.grid import Grid
from mom6_torch.core.pressure_force import interface_heights, pressure_force
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import (set_viscous_bbl, surface_ustar,
                                           vertvisc_coef,
                                           vertvisc_limit_vel,
                                           vertvisc_remnant)
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.param.lateral.hor_visc import horizontal_viscosity
from mom6_torch.parallel.domain import Domain

__all__ = ["SplitBDynState", "init_split_b_state", "step_dyn_split_rk2b"]


@dataclasses.dataclass(frozen=True)
class SplitBDynState:
    """Auxiliary state of the RK2b scheme: the 2D filtered-minus-
    instantaneous barotropic velocity increments and the free surface."""
    du_av_inst: torch.Tensor   # (njh, nih) at u faces
    dv_av_inst: torch.Tensor   # (njh, nih) at v faces
    eta: torch.Tensor          # free surface [m]


def init_split_b_state(domain: Domain, grid: Grid, vgrid: VerticalGrid,
                       state: State) -> SplitBDynState:
    """Cold start: zero increments (u_inst == u_av) and the
    mass-consistent free surface."""
    e = interface_heights(vgrid, state.h, grid.bathyT)
    z2 = torch.zeros_like(state.h[0])
    return SplitBDynState(du_av_inst=z2, dv_av_inst=z2, eta=e[0])


def step_dyn_split_rk2b(domain: Domain, grid: Grid, vgrid: VerticalGrid,
                        state: State, split: SplitBDynState,
                        forces: MechForcing, dt: float, cfg: SplitCfg,
                        eos=None, x_first: bool = True, obc=None,
                        t=None, stoch_pattern=None, kh_scale=None,
                        kh_extra=None, kv_shear=None,
                        ) -> tuple[State, SplitBDynState, SplitDiags]:
    """One RK2b dynamics step.  ``state.u/v`` are the filtered
    velocities; returns them updated with the new increments, eta and
    the step's transports."""
    if kv_shear is not None:
        # the JAX package's RK2b step takes no shear viscosity
        raise NotImplementedError("kv_shear: the RK2b step takes no "
                                  "shear-driven viscosity")
    fill = halo_fill(domain, obc)
    rho0 = vgrid.Rho0
    T, S = state.T, state.S

    def continuity(uu, vv, uhbt=None, vhbt=None, vr_u=None, vr_v=None):
        return continuity_ppm_cuda(grid, vgrid, uu, vv, h, dt,
                                   cfg.continuity, uhbt, vhbt, vr_u, vr_v,
                                   x_first=x_first)

    def barotropic(u_bc_accel, v_bc_accel, pf, u_av_b, v_av_b, uhbt_in,
                   vhbt_in):
        return btstep(domain, grid, vgrid, u_inst, v_inst, eta, h,
                      u_bc_accel, v_bc_accel, pf.pbce, u_av_b, v_av_b, dt,
                      cfg.barotropic, visc_rem_u, visc_rem_v, forces.taux,
                      forces.tauy, eta_pf=pf.eta_pf, obc=obc, bt_cont=bt_cont,
                      eta_cor=eta_cor, uhbt_in=uhbt_in, vhbt_in=vhbt_in)

    (u_av, v_av), h, eta, du_i, dv_i = fill(
        ((state.u, state.v), state.h, split.eta, split.du_av_inst,
         split.dv_av_inst))
    e_tidal = tidal_geopotential(cfg, eta, t)
    varT_mult = stoch_eos_multiplier(cfg, stoch_pattern)

    # head continuity: transports and thicknesses for the predictor's
    # Coriolis terms
    res = continuity(u_av, v_av)
    hp0 = fill(res.h)
    uh, vh = fill((res.uh, res.vh), width=2)
    h_av = 0.5 * (h + hp0)
    gme_kw = gme_inputs(cfg, h_av, u_av, v_av)

    # ---- PREDICTOR ----
    pf = pressure_force(grid, vgrid, h, T, S, eos, p_atm=forces.p_surf,
                        cfg=cfg.pressure, e_tidal=e_tidal,
                        varT_mult=varT_mult)
    diffu, diffv = horizontal_viscosity(grid, u_av, v_av, h_av, cfg.horvisc,
                                        obc=obc, **gme_kw, kh_scale=kh_scale,
                                        kh_extra=kh_extra)
    ca = coriolis_adv(grid, u_av, v_av, h_av, uh, vh, cfg.coriolis)
    u_bc_accel = (ca.CAu + pf.PFu) + diffu
    v_bc_accel = (ca.CAv + pf.PFv) + diffv

    # the BBL and the full-dt viscous remnant rebuild the instantaneous
    # velocities
    bbl = set_viscous_bbl(grid, u_av, v_av, h, cfg.vertvisc, vgrid, T, S,
                          eos)
    ustar = surface_ustar(grid, rho0, forces) \
        if cfg.vertvisc.visc_ml_mode else None
    viscosity = functools.partial(viscosity_solve, grid, cfg, h, bbl, ustar,
                                  forces, rho0)

    coefs = vertvisc_coef(grid, u_av, v_av, h, cfg=cfg.vertvisc, bbl=bbl,
                          ustar=ustar)
    visc_rem_u, visc_rem_v = fill(vertvisc_remnant(grid, coefs, dt))
    u_inst, v_inst = fill((grid.mask2dCu * (u_av - du_i[None] * visc_rem_u),
                           grid.mask2dCv * (v_av - dv_i[None] * visc_rem_v)))

    # the eta mass-source correction
    eta_cor = grid.mask2dT * ((torch.sum(h, dim=0) - grid.bathyT) - eta)

    bt_cont = None
    uhbt_in = vhbt_in = None
    # open faces take the linear transports (as in step_dyn_split_rk2)
    use_bt_cont = cfg.barotropic.use_bt_cont and obc is None
    if use_bt_cont:
        bt_cont = set_up_bt_cont_cuda(grid, vgrid, u_inst, v_inst, h, dt,
                                      cfg.continuity, visc_rem_u,
                                      visc_rem_v)
        # the anchor transports of continuity(u_inst)
        res = continuity(u_inst, v_inst)
        uhbt_in = torch.sum(res.uh, dim=0)
        vhbt_in = torch.sum(res.vh, dim=0)
    bt = barotropic(u_bc_accel, v_bc_accel, pf, u_av, v_av, uhbt_in,
                    vhbt_in)

    dt_pred = dt * cfg.be
    up = grid.mask2dCu * (u_inst + dt_pred * (u_bc_accel + bt.accel_layer_u))
    vp = grid.mask2dCv * (v_inst + dt_pred * (v_bc_accel + bt.accel_layer_v))
    up, vp, vr = viscosity(up, vp, dt_pred)
    (up, vp), (visc_rem_u, visc_rem_v) = fill(((up, vp), vr))

    res = continuity(up, vp, bt.uhbtav, bt.vhbtav, visc_rem_u, visc_rem_v)
    hp, (uh, vh), (u_av_p, v_av_p) = fill(
        (res.h, (res.uh, res.vh), (res.u_cor, res.v_cor)))
    h_av = 0.5 * (h + hp)

    # ---- CORRECTOR ----
    pf = pressure_force(grid, vgrid, corrector_thickness(cfg, h, hp), T, S,
                        eos, p_atm=forces.p_surf, cfg=cfg.pressure,
                        e_tidal=e_tidal, varT_mult=varT_mult)
    diffu, diffv = horizontal_viscosity(grid, u_av_p, v_av_p, h_av,
                                        cfg.horvisc, obc=obc, **gme_kw,
                                        kh_scale=kh_scale, kh_extra=kh_extra)
    ca = coriolis_adv(grid, u_av_p, v_av_p, h_av, uh, vh, cfg.coriolis)
    u_bc_accel = (ca.CAu + pf.PFu) + diffu
    v_bc_accel = (ca.CAv + pf.PFv) + diffv
    if use_bt_cont:
        uhbt_in = torch.sum(uh, dim=0)
        vhbt_in = torch.sum(vh, dim=0)
    bt = barotropic(u_bc_accel, v_bc_accel, pf, u_av_p, v_av_p, uhbt_in,
                    vhbt_in)

    u_new = grid.mask2dCu * (u_inst + dt * (u_bc_accel + bt.accel_layer_u))
    v_new = grid.mask2dCv * (v_inst + dt * (v_bc_accel + bt.accel_layer_v))
    u_new, v_new, vr = viscosity(u_new, v_new, dt)
    u_new, v_new, truncs = vertvisc_limit_vel(grid, u_new, v_new, dt,
                                              cfg.vertvisc)
    (u_new, v_new), (visc_rem_u, visc_rem_v) = fill(((u_new, v_new), vr))

    # final continuity: h(n+1), the transports, the new filtered
    # velocities and the new filtered-minus-instantaneous increments
    res = continuity(u_new, v_new, bt.uhbtav, bt.vhbtav, visc_rem_u,
                     visc_rem_v)
    u_cor, v_cor = res.u_cor, res.v_cor
    if obc is not None:
        # the Orlanski radiation of the filtered velocities
        u_cor = obc.radiate_u(u_cor, u_av, dt=dt)
        v_cor = obc.radiate_v(v_cor, v_av, dt=dt)
    h_new, (uh, vh), (u_av, v_av) = fill(
        (res.h, (res.uh, res.vh), (u_cor, v_cor)))
    new_split = SplitBDynState(du_av_inst=res.du_cor, dv_av_inst=res.dv_cor,
                               eta=bt.eta)
    diags = SplitDiags(uh=uh, vh=vh, uhtr=dt * uh, vhtr=dt * vh,
                       truncs=truncs, eta_av=bt.eta_av)
    return state.replace(u=u_av, v=v_av, h=h_new), new_split, diags
