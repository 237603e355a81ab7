"""Ice-shelf stepping and its coupling to the ocean (counterpart of
``mom6_tpu.ice_shelf.shelf_main``): the basal pressure on the ocean's
surface, the three-equation melt fluxes, the stress shielding, and the
shelf's own step (flotation, SSA velocities, flux-limited upwind
thickness advection, the calving front's advance into empty cells, the
melt sink and optionally the vertically averaged ice temperature).  The
shelf-only driver (``drivers/shelf_solo.py``) loops ``step_shelf``
alone.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mom6_torch.core.grid import Grid
from mom6_torch.framework.io import read_field
from mom6_torch.ice_shelf.dynamics import (SSACfg, glen_a_arrhenius,
                                           ssa_velocity_solve)
from mom6_torch.ice_shelf.thermo import (IceShelfCfg, shelf_draft,
                                         three_equation_melt)
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["ShelfCfg", "ShelfState", "ShelfStepResult", "update_grounding",
           "init_shelf_thickness", "step_shelf", "shelf_surface_pressure",
           "shelf_fluxes"]

_EPS = 1e-20


@dataclasses.dataclass(frozen=True)
class ShelfCfg:
    thermo: IceShelfCfg = IceShelfCfg()
    ssa: SSACfg = SSACfg()
    dynamic: bool = False         # DYNAMIC_SHELF (read; see step_shelf)
    g: float = 9.8
    # water column below which a cell counts as grounded [m]
    ground_min_col: float = 1e-3
    # the front advances: inflow into empty cells builds partial cover
    advance_front: bool = True
    # the fraction of the wind stress that reaches the ocean under the
    # shelf (0: fully shielded)
    stress_frac: float = 0.0
    min_thickness: float = 1e-3   # [m] the shelf's presence threshold
    # the vertically averaged ice temperature: advected with the ice,
    # warmed by accumulation at t_surf and the melt at the base's
    # freezing point; it sets Glen's rate factor (glen_a_arrhenius)
    evolve_temp: bool = False
    t_surf: float = -20.0         # surface air temperature [degC]
    adot: float = 0.1 / (365.0 * 86400.0)   # accumulation [m s-1 ice]
    t_shelf_missing: float = -10.0          # T_SHELF_MISSING [degC]
    t_freeze_base: float = -1.9   # basal freezing temperature [degC]


@dataclasses.dataclass(frozen=True)
class ShelfState:
    h_shelf: torch.Tensor                   # ice thickness [m] (njh, nih)
    # the ice-covered fraction of each cell (partial cells at the
    # calving front); None: full wherever h_shelf passes the threshold
    area_frac: Optional[torch.Tensor] = None
    # the bed's depth below sea level (positive down) for the flotation
    # test; None: deep water, all afloat
    bed_elev: Optional[torch.Tensor] = None
    # the vertically averaged ice temperature [degC]; None: isothermal
    t_shelf: Optional[torch.Tensor] = None

    def mask(self, min_thickness: float = 1e-3):
        return (self.h_shelf > min_thickness).to(self.h_shelf.dtype)

    def full_mask(self, min_thickness: float = 1e-3):
        """1 where the cell is wholly ice-covered: only full cells
        export ice (partial cells fill first)."""
        m = self.mask(min_thickness)
        if self.area_frac is None:
            return m
        return m * (self.area_frac >= 1.0 - 1e-9).to(m.dtype)


def update_grounding(cfg: ShelfCfg, state: ShelfState,
                     ocean_col_thick=None):
    """(od_av, ground_frac): a cell is grounded where the ice's draft
    rho_i/rho_w h exceeds the bed depth, or, given
    ``ocean_col_thick``, where the water column under the shelf has
    vanished."""
    rr = cfg.ssa.rho_ice / cfg.ssa.rho_sw
    if ocean_col_thick is not None:
        od = ocean_col_thick
    elif state.bed_elev is not None:
        od = state.bed_elev - rr * state.h_shelf
    else:
        return None, torch.zeros_like(state.h_shelf)
    grounded = (od < cfg.ground_min_col).to(state.h_shelf.dtype) \
        * state.mask(cfg.min_thickness)
    return torch.clamp(od, min=0.0), grounded


def init_shelf_thickness(config: str, grid: Grid, max_thick: float,
                         lon_extent: float, west: float = 0.0,
                         thick_file: str | None = None,
                         var: str = "thick", halo: int = 4):
    """The initial thickness on the grid's device and dtype: 'channel'
    tapers linearly from ``max_thick`` at ``west`` to zero at ``west +
    lon_extent``; 'file' reads an (nj, ni) field, its edge copied into
    the halo."""
    dev = dict(device=grid.bathyT.device, dtype=grid.bathyT.dtype)
    if config == "file":
        arr = np.asarray(read_field(thick_file, var), np.float64)
        return torch.as_tensor(np.pad(arr, halo, mode="edge"), **dev)
    if config == "channel":
        lon = grid.geoLonT.detach().cpu().double().numpy()
        frac = np.clip((lon - west) / max(lon_extent, 1e-30), 0.0, 1.0)
        mask = grid.mask2dT.detach().cpu().double().numpy()
        return torch.as_tensor(max_thick * (1.0 - frac) * mask, **dev)
    raise ValueError(f"Unknown SHELF_THICKNESS_CONFIG '{config}'")


class ShelfStepResult(NamedTuple):
    state: ShelfState
    u: torch.Tensor
    v: torch.Tensor


def step_shelf(domain, grid: Grid, state: ShelfState, cfg: ShelfCfg,
               dt: float, melt=None, u0=None, v0=None,
               ocean_col_thick=None,
               residuals: list | None = None) -> ShelfStepResult:
    """One shelf step: the flotation test, the SSA velocities (with the
    basal friction over grounded ice and, with a temperature, Glen's
    rate factor from it), upwind thickness fluxes limited so that no
    cell exports more than it holds and only full cells export, the
    front's advance into empty and partial cells, the melt sink
    [kg m-2 s-1] and, with ``cfg.evolve_temp``, the temperature carried
    by the same fluxes.  ``residuals`` goes to the SSA solve."""
    h = state.h_shelf
    mask = state.mask(cfg.min_thickness)
    area = state.area_frac if state.area_frac is not None else mask
    bed, tsh = state.bed_elev, state.t_shelf
    fills = [h, mask, area] + ([bed] if bed is not None else []) \
        + ([tsh] if tsh is not None else [])
    out = domain.fill_halos(tuple(fills))
    h, mask, area = out[0], out[1], out[2]
    k = 3
    if bed is not None:
        bed = out[k]
        k += 1
    if tsh is not None:
        tsh = out[k]
    st = ShelfState(h_shelf=h, area_frac=area, bed_elev=bed, t_shelf=tsh)

    _, ground_frac = update_grounding(cfg, st, ocean_col_thick)
    a2d = None
    if tsh is not None:
        a2d = glen_a_arrhenius(tsh, a_ref=cfg.ssa.glen_a)
    res = ssa_velocity_solve(cfg.ssa, grid, h, mask, u0=u0, v0=v0,
                             ground_frac=ground_frac, bed_elev=bed,
                             a_glen_2d=a2d, residuals=residuals)
    u, v = domain.fill_halos((res.u, res.v))

    full = st.full_mask(cfg.min_thickness)
    # face velocities; only full cells export
    u_f = 0.5 * (u + ip1(u)) * grid.mask2dCu
    v_f = 0.5 * (v + jp1(v)) * grid.mask2dCv
    east, north = u_f > 0.0, v_f > 0.0
    up_full_x = torch.where(east, full, ip1(full))
    up_full_y = torch.where(north, full, jp1(full))
    h_up_x = torch.where(east, h, ip1(h)) * up_full_x
    h_up_y = torch.where(north, h, jp1(h)) * up_full_y
    fx = u_f * h_up_x * grid.dyCu
    fy = v_f * h_up_y * grid.dxCv

    # positivity: a cell's outgoing fluxes scaled so that no more leaves
    # than it holds; a face takes its upwind cell's limiter
    out_x = torch.clamp(fx, min=0.0) + torch.clamp(-im1(fx), min=0.0)
    out_y = torch.clamp(fy, min=0.0) + torch.clamp(-jm1(fy), min=0.0)
    avail = h * grid.areaT / dt
    lim = torch.clamp(avail / torch.clamp(out_x + out_y, min=_EPS), max=1.0)
    lim = domain.fill_halos(lim)
    fx = fx * torch.where(east, lim, ip1(lim))
    fy = fy * torch.where(north, lim, jp1(lim))

    div = ((fx - im1(fx)) + (fy - jm1(fy))) * grid.IareaT * dt
    h_new = (h - div) * grid.mask2dT

    if cfg.advance_front:
        # empty and partial cells: inflow builds partial volume at the
        # inflow-weighted thickness of the cells it comes from
        fin_e = torch.clamp(-fx, min=0.0)
        fin_w = torch.clamp(im1(fx), min=0.0)
        fin_n = torch.clamp(-fy, min=0.0)
        fin_s = torch.clamp(jm1(fy), min=0.0)
        tot_in = (fin_e + fin_w) + (fin_n + fin_s)
        href_num = (fin_e * ip1(h) + fin_w * im1(h)
                    + fin_n * jp1(h) + fin_s * jm1(h))
        h_ref = href_num / torch.clamp(tot_in, min=_EPS)
        not_full = (1.0 - full) * grid.mask2dT
        vol = (area * h + tot_in * dt * grid.IareaT) * not_full
        # a partial cell keeps its own reference thickness
        h_ref = torch.where(area > 0.0, h, h_ref)
        h_ref = torch.clamp(h_ref, min=cfg.min_thickness)
        new_frac = torch.clamp(vol / h_ref, max=1.0)
        # a filled cell carries its whole volume as thickness
        filled = (vol >= h_ref * (1.0 - 1e-9)).to(h.dtype)
        h_part = torch.where(filled > 0, vol,
                             torch.where(new_frac > 0, h_ref, 0.0))
        h_new = torch.where(not_full > 0, h_part, h_new)
        area_new = torch.where(
            not_full > 0, torch.maximum(filled, new_frac),
            torch.ones_like(area) * (h_new > cfg.min_thickness))
    else:
        area_new = (h_new > cfg.min_thickness).to(h.dtype)

    if melt is not None:
        h_new = h_new - (melt / cfg.thermo.rho_ice) * dt
    h_new = torch.clamp(h_new, min=0.0)
    area_new = torch.where(h_new > cfg.min_thickness, area_new, 0.0)

    t_new = tsh
    if tsh is not None and cfg.evolve_temp:
        # (hT)_t = -div(u h T) + (adot T_surf - mdot T_freeze) / rho_i
        # with the thickness's limited fluxes; T is recovered against
        # the advective thickness (the front's bookkeeping moves volume,
        # not temperature)
        ftx = fx * torch.where(east, tsh, ip1(tsh))
        fty = fy * torch.where(north, tsh, jp1(tsh))
        th = tsh * h - ((ftx - im1(ftx)) + (fty - jm1(fty))) \
            * grid.IareaT * dt
        melt_i = (melt / cfg.thermo.rho_ice) if melt is not None else 0.0
        h_adv = torch.clamp((h - div) * grid.mask2dT - melt_i * dt,
                            min=0.0)
        h_div = torch.clamp(h_adv, min=cfg.min_thickness)
        t_adv = th / h_div
        t_adv = t_adv + dt * (cfg.adot * cfg.t_surf
                              - melt_i * cfg.t_freeze_base) / h_div * mask
        t_new = torch.where((h_new > cfg.min_thickness)
                            & (h_adv > cfg.min_thickness),
                            t_adv, cfg.t_shelf_missing)
        t_new = torch.clamp(t_new, min=-60.0, max=0.0)

    return ShelfStepResult(
        state=ShelfState(h_shelf=h_new, area_frac=area_new,
                         bed_elev=state.bed_elev, t_shelf=t_new),
        u=u, v=v)


def shelf_surface_pressure(cfg: ShelfCfg, state: ShelfState):
    """The pressure of the ice on the ocean's surface [Pa]."""
    return cfg.thermo.rho_ice * cfg.g * state.h_shelf


def shelf_fluxes(cfg: ShelfCfg, state: ShelfState, T_top, S_top):
    """The basal melt's (heat [W m-2, negative cools], freshwater
    [kg m-2 s-1], melt rate [kg m-2 s-1]) under the shelf's footprint,
    from the top layer's T and S."""
    mask = state.mask(cfg.min_thickness)
    _, p_b = shelf_draft(cfg.thermo, state.h_shelf)
    m = three_equation_melt(cfg.thermo, T_top, S_top, p_b, shelf_mask=mask)
    return m.heat_flux, m.fw_flux, m.melt
