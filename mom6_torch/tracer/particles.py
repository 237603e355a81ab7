"""Lagrangian particles (drifters).

Counterpart of ``mom6_tpu.tracer.particles``: particle positions in
fractional global cell units, advected by bilinearly interpolated layer
velocities with a midpoint (RK2) step, wrapped across reentrant edges
and clamped at walls; every particle at once, by gathers with advanced
indexing.  Positions are float64 whatever the model's dtype, as the JAX
package keeps them under x64.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.domain import Domain

__all__ = ["Particles", "init_particles", "advect_particles"]


@dataclasses.dataclass(frozen=True)
class Particles:
    x: torch.Tensor        # fractional global i-coordinate (cell units)
    y: torch.Tensor        # fractional global j-coordinate
    k: torch.Tensor        # layer index (int32)


def init_particles(xs, ys, ks=None, *, device="cuda") -> Particles:
    """Particles at (xs, ys) in cell units, in layers ``ks`` (0 when
    None)."""
    x = torch.as_tensor(xs, dtype=torch.float64, device=device)
    y = torch.as_tensor(ys, dtype=torch.float64, device=device)
    k = torch.zeros(x.shape, dtype=torch.int32, device=device) \
        if ks is None else torch.as_tensor(ks, device=device).to(torch.int32)
    return Particles(x=x, y=y, k=k)


def _interp(domain: Domain, f, p: Particles, ox: float, oy: float):
    """Bilinear interpolation of the layer field ``f`` (nk, njh, nih) at
    the particles, its point (i, j) sitting at (i + ox, j + oy) in
    global cell units; indices clipped to the padded array."""
    H = domain.halo
    xs = p.x - ox
    ys = p.y - oy
    i0 = torch.floor(xs).to(torch.int64)
    j0 = torch.floor(ys).to(torch.int64)
    fx = xs - i0
    fy = ys - j0
    fk = f[p.k.to(torch.int64)]
    n = torch.arange(p.x.shape[0], device=p.x.device)

    def at(jj, ii):
        jj = torch.clamp(jj + H, 0, f.shape[-2] - 1)
        ii = torch.clamp(ii + H, 0, f.shape[-1] - 1)
        return fk[n, jj, ii].to(torch.float64)

    v00 = at(j0, i0)
    v01 = at(j0, i0 + 1)
    v10 = at(j0 + 1, i0)
    v11 = at(j0 + 1, i0 + 1)
    return ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01
            + (1 - fx) * fy * v10 + fx * fy * v11)


def _interp_u(domain: Domain, u, p: Particles):
    """u at the particles: u[j, i] sits on the east face of cell (i, j),
    at (i + 1, j + 0.5)."""
    return _interp(domain, u, p, 1.0, 0.5)


def _interp_v(domain: Domain, v, p: Particles):
    """v at the particles: v[j, i] sits on the north face, at
    (i + 0.5, j + 1)."""
    return _interp(domain, v, p, 0.5, 1.0)


def advect_particles(domain: Domain, grid: Grid, p: Particles, u, v,
                     dt: float) -> Particles:
    """One midpoint (RK2) step in cell units: the interpolated
    velocities over the spacings dxT and dyT of the cell that holds the
    particle."""
    H = domain.halo

    def vel(pp: Particles):
        us = _interp_u(domain, u, pp)
        vs = _interp_v(domain, v, pp)
        ic = torch.clamp(torch.floor(pp.x).to(torch.int64) + H, 0,
                         grid.dxT.shape[-1] - 1)
        jc = torch.clamp(torch.floor(pp.y).to(torch.int64) + H, 0,
                         grid.dxT.shape[-2] - 1)
        return (us / grid.dxT[jc, ic].to(torch.float64),
                vs / grid.dyT[jc, ic].to(torch.float64))

    cu1, cv1 = vel(p)
    mid = _wrap(domain, Particles(x=p.x + 0.5 * dt * cu1,
                                  y=p.y + 0.5 * dt * cv1, k=p.k))
    cu2, cv2 = vel(mid)
    return _wrap(domain, Particles(x=p.x + dt * cu2, y=p.y + dt * cv2,
                                   k=p.k))


def _wrap(domain: Domain, p: Particles) -> Particles:
    """Positions wrapped across reentrant edges, clamped at walls."""
    x, y = p.x, p.y
    if domain.reentrant_x:
        x = torch.remainder(x, domain.ni)
    else:
        x = torch.clamp(x, 0.0, float(domain.ni))
    if domain.reentrant_y:
        y = torch.remainder(y, domain.nj)
    else:
        y = torch.clamp(y, 0.0, float(domain.nj))
    return Particles(x=x, y=y, k=p.k)
