"""Stanley et al. (2020) subgrid temperature variance for the EOS.

Counterpart of ``mom6_tpu.core.stoch_eos``: ``calc_varT`` (MOM_calc_varT)
is a stencil over the halo-filled temperature, and the density
correction rho += 0.5 varT d2rho/dT2 that the finite-volume pressure
force takes with USE_STANLEY_PGF uses the second temperature derivative
of the EOS density by nested forward-mode ``torch.func.jvp``, as the
JAX package takes it by nested ``jax.jvp`` (so the EOS code stays free
of in-place writes).  With STOCH_EOS the pressure force multiplies the
variance by exp(STANLEY_A pattern), the pattern the SPPT machinery
carries (``param/stochastic/stochastics.py``); the split steppers form
that multiplier.
"""

from __future__ import annotations

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["calc_varT", "density_second_dT2", "stanley_density"]

_H_SUB = 1e-20


def calc_varT(grid: Grid, h, T, stanley_coeff: float):
    """varT = c ((dx dT/dx)^2 + (dy dT/dy)^2) from centred-mean gradients,
    damped by the min/max thickness ratio of the 5-point stencil
    (MOM_calc_varT).  h and T need one valid halo ring."""
    dTdx = (grid.mask2dCu * grid.IdxCu * (ip1(T) - T)
            + im1(grid.mask2dCu * grid.IdxCu) * (T - im1(T)))
    dTdy = (grid.mask2dCv * grid.IdyCv * (jp1(T) - T)
            + jm1(grid.mask2dCv * grid.IdyCv) * (T - jm1(T)))
    dTdi2 = (0.5 * grid.dxT * dTdx) ** 2
    dTdj2 = (0.5 * grid.dyT * dTdy) ** 2
    hl = [h * grid.mask2dT, im1(h) * im1(grid.mask2dCu),
          ip1(h) * grid.mask2dCu, jm1(h) * jm1(grid.mask2dCv),
          jp1(h) * grid.mask2dCv]
    hmin = hmax = hl[0]
    for x in hl[1:]:
        hmin = torch.minimum(hmin, x)
        hmax = torch.maximum(hmax, x)
    return stanley_coeff * (dTdi2 + dTdj2) * hmin / (hmax + _H_SUB)


def density_second_dT2(eos, T, S, p):
    """d2rho/dT2, elementwise, by forward-over-forward autodiff of the
    EOS density."""
    def d1(t):
        return torch.func.jvp(lambda tt: eos.density(tt, S, p), (t,),
                              (torch.ones_like(t),))[1]
    return torch.func.jvp(d1, (T,), (torch.ones_like(T),))[1]


def stanley_density(eos, T, S, p, varT):
    """rho(T, S, p) + 0.5 varT d2rho/dT2."""
    return eos.density(T, S, p) + 0.5 * varT * density_second_dT2(
        eos, T, S, p)
