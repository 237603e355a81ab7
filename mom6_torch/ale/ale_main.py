"""ALE orchestration: regrid, then remap the state conservatively.

Counterpart of ``mom6_tpu.ale.ale_main``: build the new vertical grid
from the evolved state, then remap the tracers on cell columns and the
velocities on face columns, whose source and target thicknesses are the
means of the two adjacent cell columns.  With ``hybgen_unmix`` the
deepest inflated layer of each column is unmixed toward its target
density before the regrid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_torch.ale.hybgen_unmix import HybgenUnmixCfg, hybgen_unmix
from mom6_torch.ale.regridding import RegridCfg, build_grid
from mom6_torch.ale.remapping import (RemapCfg, remap_column_means,
                                      remap_column_means_banded)
from mom6_torch.core.grid import Grid
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.stencil import ip1, jp1

__all__ = ["ALECfg", "ale_regrid_remap", "ale_regrid_accelerated"]


@dataclasses.dataclass(frozen=True)
class ALECfg:
    regrid: RegridCfg = RegridCfg()
    remap: RemapCfg = RemapCfg()
    vel_remap: RemapCfg = RemapCfg(scheme="PPM_H4")
    # grid-motion time filter (REGRID_TIME_SCALE and
    # REGRID_FILTER_SHALLOW/DEEP_DEPTH): 0 disables
    regrid_time_scale: float = 0.0
    filter_shallow_depth: float = 0.0
    filter_deep_depth: float = 0.0
    # ALE_SEQUENTIAL_REMAP: remap the fields of a group one at a time
    # instead of stacked into one call (fewer live temporaries)
    sequential_remap: bool = False
    # ALE_REMAP_BAND: only the (target interface, source cell) pairs
    # with |k - m| <= band, the full remap where that misses; 0 disables
    remap_band: int = 0
    # hybgen unmixing before the regrid (HYBGEN_UNMIX); None disables
    hybgen_unmix: Optional[HybgenUnmixCfg] = None


def _filter_grid_motion(cfg: ALECfg, h_old, h_new, dt: float):
    """Time-filtered interface motion: weight 1 above the shallow filter
    depth, dt/(tau+dt) below the deep one, a cubic blend between,
    applied to the interface depths."""
    tau = cfg.regrid_time_scale
    w_deep = dt / (tau + dt)
    z_old = torch.cat([torch.zeros_like(h_old[:1]),
                       torch.cumsum(h_old, dim=0)], dim=0)
    z_new = torch.cat([torch.zeros_like(h_new[:1]),
                       torch.cumsum(h_new, dim=0)], dim=0)
    zs, zd = cfg.filter_shallow_depth, cfg.filter_deep_depth
    if zd > zs:
        frac = torch.clamp((z_old - zs) / max(zd - zs, 1e-30), 0.0, 1.0)
    else:
        frac = (z_old > zs).to(h_old.dtype)
    s = frac * frac * (3.0 - 2.0 * frac)
    w = 1.0 - s * (1.0 - w_deep)
    z_f = torch.cummax(z_old + w * (z_new - z_old), dim=0).values
    z_f = torch.cat([z_f[:-1], z_new[-1:]], dim=0)      # pin the bottom
    return torch.clamp(z_f[1:] - z_f[:-1], min=0.0)


def _remap_group(cfg: ALECfg, h_src, fields, h_dst, rcfg: RemapCfg):
    """Every field of a group sharing one (h_src, h_dst) column pair:
    stacked on a new axis into one remap call, or one call each with
    ALE_SEQUENTIAL_REMAP."""
    if cfg.remap_band > 0:
        def remap(hs, f, hd):
            return remap_column_means_banded(hs, f, hd, cfg.remap_band,
                                             rcfg)
    else:
        def remap(hs, f, hd):
            return remap_column_means(hs, f, hd, rcfg)
    if not fields:
        return []
    if cfg.sequential_remap or len(fields) == 1:
        return [remap(h_src, f, h_dst) for f in fields]
    out = remap(h_src[:, None], torch.stack(fields, dim=1), h_dst[:, None])
    return list(out.unbind(1))


def ale_regrid_remap(grid: Grid, vgrid: VerticalGrid, state: State,
                     cfg: ALECfg, eos=None, tracers: dict | None = None,
                     aux_u: dict | None = None, aux_v: dict | None = None,
                     dt: float = 0.0):
    """One ALE step: (state, tracers) on h onto the new grid.

    ``aux_u``/``aux_v`` are extra face fields remapped with the velocity
    face-thickness rule (the split scheme's u_av/v_av and diffu/diffv).
    Returns (new_state, new_tracers, h_new, aux_u, aux_v)."""
    if (cfg.hybgen_unmix is not None and eos is not None
            and state.T is not None):
        h_u, T_u, S_u, tr_u = hybgen_unmix(state.h, state.T, state.S,
                                           tracers, eos, vgrid.Rlay,
                                           cfg.hybgen_unmix)
        state = state.replace(h=h_u, T=T_u, S=S_u)
        if tracers is not None:
            tracers = tr_u
    h = state.h
    h_new = build_grid(cfg.regrid, h, grid.bathyT, state.T, state.S, eos,
                       rlay=vgrid.Rlay, rho0=vgrid.Rho0, g=vgrid.g_Earth,
                       mask2dT=grid.mask2dT)
    if cfg.regrid_time_scale > 0.0 and dt > 0.0:
        h_new = _filter_grid_motion(cfg, h, h_new, dt)

    names, fields = [], []
    if state.T is not None:
        names += ["__T", "__S"]
        fields += [state.T, state.S]
    for k, v in (tracers or {}).items():
        names.append(k)
        fields.append(v)
    t_out = dict(zip(names, _remap_group(cfg, h, fields, h_new,
                                         cfg.remap)))
    T_new = t_out.pop("__T", None)
    S_new = t_out.pop("__S", None)
    new_tracers = t_out if tracers is not None else None

    # velocities on face columns (ALE_remap_set_h_vel)
    h_u_src, h_u_dst = 0.5 * (h + ip1(h)), 0.5 * (h_new + ip1(h_new))
    h_v_src, h_v_dst = 0.5 * (h + jp1(h)), 0.5 * (h_new + jp1(h_new))
    u_out = [f * grid.mask2dCu for f in _remap_group(
        cfg, h_u_src, [state.u, *(aux_u or {}).values()], h_u_dst,
        cfg.vel_remap)]
    v_out = [f * grid.mask2dCv for f in _remap_group(
        cfg, h_v_src, [state.v, *(aux_v or {}).values()], h_v_dst,
        cfg.vel_remap)]
    aux_u_new = None if aux_u is None else dict(zip(aux_u, u_out[1:]))
    aux_v_new = None if aux_v is None else dict(zip(aux_v, v_out[1:]))
    new_state = state.replace(u=u_out[0], v=v_out[0], h=h_new, T=T_new,
                              S=S_new)
    return new_state, new_tracers, h_new, aux_u_new, aux_v_new


def ale_regrid_accelerated(grid: Grid, vgrid: VerticalGrid, state: State,
                           cfg: ALECfg, n_itt: int, eos=None,
                           tracers: dict | None = None):
    """Iterated regridding for the initial state
    (REGRID_ACCELERATE_INIT): regrid ``n_itt`` times carrying working
    copies of h, T and S, then remap the whole original state once from
    the original grid onto the final one.  Returns (new_state,
    new_tracers, h_final)."""
    h_orig = h = state.h
    T, S = state.T, state.S
    for _ in range(max(n_itt, 1)):
        h_new = build_grid(cfg.regrid, h, grid.bathyT, T, S, eos,
                           rlay=vgrid.Rlay, rho0=vgrid.Rho0,
                           g=vgrid.g_Earth, mask2dT=grid.mask2dT)
        if T is not None:
            out = remap_column_means(h[:, None], torch.stack([T, S], dim=1),
                                     h_new[:, None], cfg.remap)
            T, S = out[:, 0], out[:, 1]
        h = h_new
    names, fields = [], []
    if state.T is not None:
        names += ["__T", "__S"]
        fields += [state.T, state.S]
    for k, v in (tracers or {}).items():
        names.append(k)
        fields.append(v)
    outs = {}
    if fields:
        rem = remap_column_means(h_orig[:, None], torch.stack(fields, dim=1),
                                 h[:, None], cfg.remap)
        outs = dict(zip(names, rem.unbind(1)))
    u_new = remap_column_means(0.5 * (h_orig + ip1(h_orig)), state.u,
                               0.5 * (h + ip1(h)), cfg.vel_remap) \
        * grid.mask2dCu
    v_new = remap_column_means(0.5 * (h_orig + jp1(h_orig)), state.v,
                               0.5 * (h + jp1(h)), cfg.vel_remap) \
        * grid.mask2dCv
    new_state = state.replace(h=h, u=u_new, v=v_new, T=outs.pop("__T", None),
                              S=outs.pop("__S", None))
    return new_state, (outs if tracers is not None else None), h
