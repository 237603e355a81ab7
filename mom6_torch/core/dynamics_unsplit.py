"""Unsplit dynamics: the 3-stage RK3 and the 2-stage RK2 steps.

Counterpart of ``mom6_tpu.core.dynamics_unsplit`` (step_MOM_dyn_unsplit
and its RK2 variant).  There is no barotropic/baroclinic splitting: the
short dynamics step resolves the free surface itself.  With
dt_pred = dt/3 (RK3) or dt/2 (RK2):

  1. hp = h advanced dt/2 with (u, v); the horizontal viscosity
     increment; accelerations on h_av = (h + hp)/2; up = u + dt_pred (PF
     + CA); implicit vertical viscosity;
  2. (RK3 only) h advanced another dt/2 from hp with (up, vp);
     accelerations on the mid thickness; upp = u + dt/2 (PF + CA);
     vertical viscosity;
  3. h(n+1) from hp with (upp, vpp); accelerations on (h(n+1) + hp)/2;
     u(n+1) = u + dt (PF + CA); vertical viscosity and truncation.

The continuity calls match no barotropic transport: on CUDA tensors
each is two untargeted sweeps of kernel K1 (``continuity_cuda.py``).
The tidal/SAL geopotential (``cfg.tides_fn``) is taken once a step from
the free surface of the step's start.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.continuity_cuda import continuity_ppm_cuda
from mom6_torch.core.continuity_ppm import ContinuityCfg
from mom6_torch.core.coriolis_adv import CoriolisCfg, coriolis_adv
from mom6_torch.core.forcing import MechForcing
from mom6_torch.core.grid import Grid
from mom6_torch.core.pressure_force import PressureForceCfg, pressure_force
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import (VertViscCfg, set_viscous_bbl,
                                           surface_ustar,
                                           vertvisc, vertvisc_coef,
                                           vertvisc_limit_vel)
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.param.lateral.hor_visc import (HorViscCfg,
                                               horizontal_viscosity)
from mom6_torch.parallel.domain import Domain

__all__ = ["UnsplitCfg", "DynDiags", "step_dyn_unsplit"]


@dataclasses.dataclass(frozen=True)
class UnsplitCfg:
    continuity: ContinuityCfg = ContinuityCfg()
    coriolis: CoriolisCfg = CoriolisCfg()
    pressure: PressureForceCfg = PressureForceCfg()
    vertvisc: VertViscCfg = VertViscCfg()
    horvisc: HorViscCfg = HorViscCfg()
    scheme: str = "RK3"              # RK3 or RK2
    # (eta, t) -> tidal + SAL geopotential height anomaly [m], or None
    tides_fn: object = None


class DynDiags(NamedTuple):
    uh: torch.Tensor
    vh: torch.Tensor
    uhtr: torch.Tensor      # transports accumulated for tracer advection
    vhtr: torch.Tensor
    truncs: torch.Tensor


def step_dyn_unsplit(domain: Domain, grid: Grid, vgrid: VerticalGrid,
                     state: State, forces: MechForcing, dt: float,
                     cfg: UnsplitCfg, eos=None, t=None
                     ) -> tuple[State, DynDiags]:
    """One unsplit dynamics step (RK3 or RK2 by ``cfg.scheme``)."""
    if cfg.scheme not in ("RK3", "RK2"):
        raise ValueError(f"unsplit scheme {cfg.scheme!r}")
    fill = domain.fill_halos
    rho0 = vgrid.Rho0
    T, S = state.T, state.S
    # the tidal geopotential from the free surface of the step's start
    e_tidal = None
    if cfg.tides_fn is not None:
        e_tidal = cfg.tides_fn(torch.sum(state.h, dim=0) - grid.bathyT,
                               0.0 if t is None else t)

    def continuity(uu, vv, hh):
        return continuity_ppm_cuda(grid, vgrid, uu, vv, hh, 0.5 * dt,
                                   cfg.continuity)

    def accel(uu, vv, h_av, uh, vh):
        ca = coriolis_adv(grid, uu, vv, h_av, uh, vh, cfg.coriolis)
        pf = pressure_force(grid, vgrid, h_av, T, S, eos,
                            p_atm=forces.p_surf, cfg=cfg.pressure,
                            e_tidal=e_tidal)
        return ca.CAu + pf.PFu, ca.CAv + pf.PFv

    def viscosity(uu, vv, h_face, dt_v):
        coefs = vertvisc_coef(grid, uu, vv, h_face, cfg=cfg.vertvisc,
                              bbl=bbl, ustar=ustar)
        return vertvisc(grid, uu, vv, h_face, coefs, dt_v, forces.taux,
                        forces.tauy, rho0,
                        direct_stress=cfg.vertvisc.direct_stress,
                        hmix_stress=cfg.vertvisc.hmix_stress)

    (u, v), h = fill(((state.u, state.v), state.h))
    if T is not None:
        T, S = fill((T, S))
    dv = horizontal_viscosity(grid, u, v, h, cfg.horvisc)

    # --- stage 1 ---
    res = continuity(u, v, h)
    hp, (uh, vh) = fill((res.h, (res.uh, res.vh)))
    h_av = 0.5 * (h + hp)
    u, v = fill((u + dt * dv.diffu * grid.mask2dCu,
                 v + dt * dv.diffv * grid.mask2dCv))
    uhtr = 0.5 * dt * uh
    vhtr = 0.5 * dt * vh

    dt_pred = dt / 3.0 if cfg.scheme == "RK3" else 0.5 * dt
    CAu, CAv = accel(u, v, h_av, uh, vh)
    up = grid.mask2dCu * (u + dt_pred * CAu)
    vp = grid.mask2dCv * (v + dt_pred * CAv)
    bbl = set_viscous_bbl(grid, u, v, h, cfg.vertvisc, vgrid)
    ustar = surface_ustar(grid, rho0, forces) \
        if cfg.vertvisc.visc_ml_mode else None
    up, vp = fill(viscosity(up, vp, h_av, dt_pred))

    if cfg.scheme == "RK3":
        # --- stage 2 ---
        res = continuity(up, vp, hp)
        h_av2, (uh, vh) = fill((res.h, (res.uh, res.vh)))
        h_av = 0.5 * (hp + h_av2)
        CAu, CAv = accel(up, vp, h_av, uh, vh)
        upp = grid.mask2dCu * (u + 0.5 * dt * CAu)
        vpp = grid.mask2dCv * (v + 0.5 * dt * CAv)
        upp, vpp = fill(viscosity(upp, vpp, hp, 0.5 * dt))
    else:
        upp, vpp = up, vp

    # --- final stage ---
    res = continuity(upp, vpp, hp)
    h_new, (uh, vh) = fill((res.h, (res.uh, res.vh)))
    uhtr = uhtr + 0.5 * dt * uh
    vhtr = vhtr + 0.5 * dt * vh
    h_av = 0.5 * (h_new + hp)
    CAu, CAv = accel(upp, vpp, h_av, uh, vh)
    u_new = grid.mask2dCu * (u + dt * CAu)
    v_new = grid.mask2dCv * (v + dt * CAv)
    u_new, v_new = viscosity(u_new, v_new, h_av, dt)
    u_new, v_new, truncs = vertvisc_limit_vel(grid, u_new, v_new, dt,
                                              cfg.vertvisc)
    u_new, v_new = fill((u_new, v_new))
    return (state.replace(u=u_new, v=v_new, h=h_new),
            DynDiags(uh=uh, vh=vh, uhtr=uhtr, vhtr=vhtr, truncs=truncs))
