"""Porous topographic barriers, plain PyTorch.

Counterpart of ``mom6_tpu.core.porous_barriers``: a face partly blocked
by unresolved sills exposes only a fraction of its area to the flow.
Each face carries the (Dmin, Dmax, Davg) statistics of its subgrid
bathymetry as heights (negative down); the open face area below an
interface height follows the Adcroft fit of calc_por_layer, and a
layer's open fraction is the difference of that area across the layer
over the layer's thickness.  Every interface and face is evaluated at
once with ``where`` chains, formula for formula as the JAX package.

Kernel K1 (``continuity_cuda.py``) takes these fractions as one more
layered input of a sweep; the wrapper computes them here.
"""

from __future__ import annotations

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, jp1

__all__ = ["cumulative_open_area", "porous_widths_layer",
           "porous_widths_from_h"]

_EPS = 1e-14


def cumulative_open_area(D_min, D_max, D_avg, eta):
    """A(eta): the open width-integral of a face below the interface
    height ``eta`` (calc_por_layer).  D_min is the deepest subgrid
    point, D_max the shallowest crest."""
    rng = torch.clamp(D_max - D_min, min=_EPS)
    m = torch.clamp((D_avg - D_min) / rng, 1e-12, 1.0 - 1e-12)
    zeta = torch.clamp((eta - D_min) / rng, 0.0, 1.0)
    low = rng * ((1.0 - m) * zeta ** (1.0 / (1.0 - m)))
    high = rng * (zeta - m + m * (1.0 - zeta) ** (1.0 / m))
    mid = torch.where(m < 0.5, low, high)
    return torch.where(eta <= D_min, 0.0,
                       torch.where(eta > D_max, eta - D_avg, mid))


def porous_widths_layer(grid: Grid, e, stagger: str = "U"):
    """Per-layer open fractions (nk, njh, nih) of the U or V faces from
    the interface heights ``e`` (nk+1, njh, nih) at T points; None when
    the grid has no subgrid data for that stagger."""
    if stagger == "U":
        Dmin, Dmax, Davg = (grid.porous_DminU, grid.porous_DmaxU,
                            grid.porous_DavgU)
        e_face = 0.5 * (e + ip1(e))
    else:
        Dmin, Dmax, Davg = (grid.porous_DminV, grid.porous_DmaxV,
                            grid.porous_DavgV)
        e_face = 0.5 * (e + jp1(e))
    if Davg is None:
        return None
    A = cumulative_open_area(Dmin[None], Dmax[None], Davg[None], e_face)
    dh = torch.clamp(e_face[:-1] - e_face[1:], min=_EPS)
    return torch.clamp((A[:-1] - A[1:]) / dh, 0.0, 1.0)


def _heights_from_top(grid: Grid, h):
    """e[K] = (sum(h) - bathyT) - sum_{l<K} h_l, K = 0..nk."""
    eta = torch.sum(h, dim=0) - grid.bathyT
    return eta[None] - torch.cat(
        [torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)], dim=0)


def porous_widths_from_h(grid: Grid, h, staggers: str = "UV"):
    """(porU, porV): the open fractions of the faces of ``staggers``
    from the layer thicknesses; an entry is None when not asked for or
    when the grid has no subgrid topography at that stagger."""
    want = [s for s in staggers
            if getattr(grid, f"porous_Davg{s}") is not None]
    if not want:
        return None, None
    e = _heights_from_top(grid, h)
    return tuple(porous_widths_layer(grid, e, s) if s in want else None
                 for s in "UV")
