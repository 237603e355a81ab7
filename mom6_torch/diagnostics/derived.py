"""Derived diagnostic fields.

Counterpart of ``mom6_tpu.diagnostics.derived``: relative vorticity at
the corners, speed and kinetic energy at h points, thickness-weighted
column averages and the sea-surface height.
"""

from __future__ import annotations

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["relative_vorticity_z", "speed", "kinetic_energy",
           "column_average", "sea_surface_height"]


def relative_vorticity_z(grid: Grid, u, v):
    """The relative vorticity at the corner points."""
    dvdx = ip1(grid.dyCv * v) - grid.dyCv * v
    dudy = jp1(grid.dxCu * u) - grid.dxCu * u
    return grid.mask2dBu * (dvdx - dudy) * grid.IareaBu


def speed(u, v):
    """|u| at h points."""
    u_h = 0.5 * (u + im1(u))
    v_h = 0.5 * (v + jm1(v))
    return torch.sqrt(u_h * u_h + v_h * v_h)


def kinetic_energy(grid: Grid, u, v):
    """The kinetic energy per unit mass at h points (the area-weighted
    form)."""
    au2 = grid.areaCu * u * u
    av2 = grid.areaCv * v * v
    return ((au2 + im1(au2)) + (av2 + jm1(av2))) * 0.25 * grid.IareaT


def column_average(f, h):
    """The thickness-weighted vertical average."""
    return torch.sum(f * h, dim=0) / (torch.sum(h, dim=0) + 1e-30)


def sea_surface_height(grid: Grid, h):
    return torch.sum(h, dim=0) - grid.bathyT
