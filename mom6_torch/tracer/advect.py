"""Tracer advection by accumulated mass transports.

Counterpart of ``mom6_tpu.tracer.advect``: directionally split upwind
advection with the monotonized PLM reconstruction inside the upwind
cell, the swept-volume CFL entering the face value, and the cell
volume updated alongside the tracers so a uniform tracer stays exactly
uniform.  A fixed number of alternating x/y pass pairs each moves at
most ``max_cfl`` of the upwind cell, as the JAX package does in place
of the reference's ``domore`` re-sweeps.  Only the PLM scheme is
ported; PPM:H3 raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["TracerAdvectCfg", "advect_tracers"]

_H_NEGLECT = 1e-30


@dataclasses.dataclass(frozen=True)
class TracerAdvectCfg:
    scheme: str = "PLM"        # TRACER_ADVECTION_SCHEME
    n_sweep_pairs: int = 2     # alternating x/y pass pairs
    max_cfl: float = 0.45      # per-face transported fraction limit


def _plm_face(t, mask, m1, p1, move, pos, cfl, face_mask):
    """move * (upwind PLM face value over the swept volume) along the
    axis of the shifts m1/p1."""
    t_up = m1(t)
    t_dn = p1(t)
    s_c = 0.5 * (t_dn - t_up)
    s_l = t - t_up
    s_r = t_dn - t
    slp = torch.sign(s_c) * torch.minimum(
        torch.abs(s_c), 2.0 * torch.minimum(torch.abs(s_l), torch.abs(s_r)))
    slp = torch.where(s_l * s_r > 0.0, slp, 0.0)
    slp = slp * mask * m1(mask) * p1(mask)
    t_face = torch.where(pos, t + 0.5 * slp * (1.0 - cfl),
                         p1(t) - 0.5 * p1(slp) * (1.0 - cfl))
    return move * t_face * face_mask


def _sweep(grid: Grid, tracers, hvol, rem, frac, x: bool):
    """One pass in x (``x``) or y: move min(remaining, CFL-limited)
    transport; returns (tracers, hvol, remaining transport)."""
    mask = grid.mask2dT
    m1, p1 = (im1, ip1) if x else (jm1, jp1)
    face_mask = grid.mask2dCu if x else grid.mask2dCv
    pos = rem > 0.0
    vol_up = torch.where(pos, hvol, p1(hvol))
    move = torch.clamp(rem, -frac * p1(hvol), frac * hvol)
    cfl = torch.abs(move) / (vol_up + _H_NEGLECT)
    flux = {name: _plm_face(t, mask, m1, p1, move, pos, cfl, face_mask)
            for name, t in tracers.items()}
    hvol_new = hvol - (move * face_mask - m1(move * face_mask))
    new = {}
    for name, t in tracers.items():
        tv = t * hvol - (flux[name] - m1(flux[name]))
        new[name] = torch.where(mask > 0, tv / (hvol_new + _H_NEGLECT), t)
    return new, hvol_new, rem - move * face_mask


def advect_tracers(domain, grid: Grid, tracers: dict, h_end, uhtr, vhtr,
                   cfg: TracerAdvectCfg = TracerAdvectCfg(),
                   x_first: bool = True):
    """Advect ``tracers`` by the accumulated transports uhtr/vhtr [m3]
    through faces, ending at thickness h_end.  Returns (new_tracers,
    h_out, resid) with resid the largest un-swept face transport as a
    fraction of its upwind cell volume (a 0-d tensor)."""
    if cfg.scheme != "PLM":
        raise NotImplementedError(f"TRACER_ADVECTION_SCHEME {cfg.scheme}")
    hvol = (h_end * grid.areaT + (uhtr - im1(uhtr))
            + (vhtr - jm1(vhtr)))
    uh_rem, vh_rem = uhtr, vhtr
    ts = dict(tracers)
    frac = cfg.max_cfl
    for _ in range(cfg.n_sweep_pairs):
        if x_first:
            ts, hvol, uh_rem = _sweep(grid, ts, hvol, uh_rem, frac, True)
            ts = domain.fill_halos(ts, width=2)
            hvol, uh_rem = domain.fill_halos((hvol, uh_rem), width=2)
            ts, hvol, vh_rem = _sweep(grid, ts, hvol, vh_rem, frac, False)
        else:
            ts, hvol, vh_rem = _sweep(grid, ts, hvol, vh_rem, frac, False)
            ts = domain.fill_halos(ts, width=2)
            hvol, vh_rem = domain.fill_halos((hvol, vh_rem), width=2)
            ts, hvol, uh_rem = _sweep(grid, ts, hvol, uh_rem, frac, True)
        ts = domain.fill_halos(ts, width=2)
        hvol, uh_rem, vh_rem = domain.fill_halos((hvol, uh_rem, vh_rem),
                                                 width=2)
    h_out = hvol / grid.areaT
    vol_up_x = torch.where(uh_rem > 0.0, hvol, ip1(hvol))
    vol_up_y = torch.where(vh_rem > 0.0, hvol, jp1(hvol))
    resid = torch.maximum(
        torch.max(torch.abs(uh_rem) / (vol_up_x + _H_NEGLECT)),
        torch.max(torch.abs(vh_rem) / (vol_up_y + _H_NEGLECT)))
    return ts, h_out, resid
