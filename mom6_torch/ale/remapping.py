"""Conservative vertical remapping between column grids.

Counterpart of ``mom6_tpu.ale.remapping``: every source cell carries a
polynomial reconstruction, the depth integral of the column is
evaluated at every target interface (the containing source cell found
by dense comparisons against the source interfaces, over all columns at
once), and the target cell means are differences of that integral.
Exactly conservative when the column totals agree, which the regridding
guarantees.

Schemes (REMAPPING_SCHEME): PCM, PLM, PPM_H4, PPM_IH4, PPM_CW,
PQM_IH4IH3 and PQM_IH6IH5, and the HYCOM schemes PLM_HYBGEN (a
thickness-weighted limited slope), WENO_HYBGEN (the WENO-reconciled
parabola) and PPM_HYBGEN (PPM on the WENO edges).

Every function takes (nk, ...) tensors with the layer axis first and
keeps the JAX package's operation order: the small linear systems are
solved by the same unpivoted elimination, the column recursions run as
k loops in k order, and integer powers multiply as ``lax.integer_pow``
does, so float64 results agree with ``mom6_tpu`` to rounding.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["RemapCfg", "Reconstruction", "remap_column_means",
           "remap_column_means_banded", "reconstruct", "edge_values_h2",
           "edge_values_h4", "edge_values_ih4", "edge_values_ih6",
           "edge_slopes_ih3", "edge_slopes_ih5", "interface_positions"]

_H_NEGLECT = 1e-30


@dataclasses.dataclass(frozen=True)
class RemapCfg:
    scheme: str = "PPM_H4"        # REMAPPING_SCHEME
    boundary_extrap: bool = False  # REMAP_BOUNDARY_EXTRAP
    force_monotonic: bool = True


class Reconstruction(NamedTuple):
    """Per-cell polynomial u(xi) = sum c_n xi^n, xi in [0, 1] downward
    (up to quartic for PQM)."""
    c0: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    c3: Optional[torch.Tensor] = None
    c4: Optional[torch.Tensor] = None

    def cell_mean(self):
        m = self.c0 + 0.5 * self.c1 + self.c2 / 3.0
        if self.c3 is not None:
            m = m + 0.25 * self.c3 + 0.2 * self.c4
        return m

    def integral_to(self, xi):
        """The integral of u from 0 to xi (a fraction of the cell's
        thickness integral)."""
        r = (self.c0 * xi + 0.5 * self.c1 * xi * xi
             + self.c2 * xi * xi * xi / 3.0)
        if self.c3 is not None:
            x4 = xi * xi * xi * xi
            r = r + 0.25 * self.c3 * x4 + 0.2 * self.c4 * x4 * xi
        return r


def _ipow(x, n: int):
    """x**n by binary exponentiation, the multiplication order of
    ``lax.integer_pow`` (``torch.pow`` rounds some powers differently)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _kcol(n: int, like: torch.Tensor):
    """arange(n) shaped to broadcast along the layer axis of ``like``."""
    return torch.arange(n, device=like.device).reshape(
        (-1,) + (1,) * (like.dim() - 1))


def _clip(x, lo, hi):
    """jnp.clip: the upper bound wins where lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _shift_k(f, n):
    """Shift along the leading (layer) axis with edge clamping."""
    nk = f.shape[0]
    idx = torch.clamp(torch.arange(nk, device=f.device) + n, 0, nk - 1)
    return f[idx]


def edge_values_h2(h, u):
    """2nd-order thickness-weighted edge values at interfaces 0..nk."""
    hk = h + _H_NEGLECT
    h_up = _shift_k(hk, -1)
    u_up = _shift_k(u, -1)
    eint = (u_up * hk + u * h_up) / (hk + h_up)
    return torch.cat([u[0:1], eint[1:], u[-1:]], dim=0)


def _iface_cells(f, off):
    """Cell value f[K+off] as an interface-indexed (nk+1, ...) tensor
    with edge clamping (only interior interfaces use the clamps)."""
    nk = f.shape[0]
    idx = torch.clamp(torch.arange(nk + 1, device=f.device) + off, 0,
                      nk - 1)
    return f[idx]


def _gauss_unrolled(a, b):
    """Gaussian elimination without pivoting of an n x n system per
    point, as elementwise arithmetic: ``a`` is an n x n nested list of
    broadcastable tensors, ``b`` a list of n.  The moment systems solved
    here are well conditioned once widths are normalized by the stencil
    mean.  Returns the solution as a list."""
    n = len(b)
    a = [row[:] for row in a]
    b = list(b)
    for k in range(n):
        inv = 1.0 / a[k][k]
        for j in range(k + 1, n):
            a[k][j] = a[k][j] * inv
        b[k] = b[k] * inv
        for i in range(k + 1, n):
            f = a[i][k]
            for j in range(k + 1, n):
                a[i][j] = a[i][j] - f * a[k][j]
            b[i] = b[i] - f * b[k]
    x = [None] * n
    for i in reversed(range(n)):
        xi = b[i]
        for j in range(i + 1, n):
            xi = xi - a[i][j] * x[j]
        x[i] = xi
    return x


def _solve4(A, B):
    """4x4 case of ``_gauss_unrolled`` on stacked tensors A (4, 4, ...)
    and B (4, ...)."""
    return tuple(_gauss_unrolled(
        [[A[i, j] for j in range(4)] for i in range(4)],
        [B[i] for i in range(4)]))


def _cumsum0(x):
    """Interfaces 0..n of cells x: a zero, then the running sum."""
    return torch.cat([torch.zeros_like(x[:1]), torch.cumsum(x, dim=0)],
                     dim=0)


# An integral-cubic boundary value further than this many times the range
# of its 4 cells (plus a relative slack of their magnitude: this, or that
# many rounding errors of the dtype, whichever is larger) outside that
# range counts as amplified.  A well-conditioned fit overshoots by a few
# ranges at most, and a column of 4 equal cells keeps its fit in fp32.
_AMPLIFIED = 1.0e3
_AMPLIFIED_REL = 1.0e-8


def _boundary_cubic(h, u, bottom: bool):
    """Edge values at the outermost two interfaces from an integral
    cubic fit over the 4 cells nearest the boundary, on positions
    normalized by the 4-cell depth.  Returns (e_edge, e_next)."""
    if bottom:
        hh, uu = h.flip(0)[:4], u.flip(0)[:4]
    else:
        hh, uu = h[:4], u[:4]
    tot = torch.sum(hh, dim=0) + _H_NEGLECT
    dz = torch.clamp(hh / tot[None], min=1e-10)
    x = _cumsum0(dz)                                       # (5, ...)
    xi, xip = x[:-1], x[1:]
    A = torch.stack([torch.stack([
        (_ipow(xip[i], j + 1) - _ipow(xi[i], j + 1)) / (j + 1)
        for j in range(4)], dim=0) for i in range(4)], dim=0)
    B = uu * dz
    C0, C1, C2, C3 = _solve4(A, B)
    x1 = x[1]
    e0, e1 = C0, C0 + x1 * (C1 + x1 * (C2 + x1 * C3))
    # Two nearly coincident thin cells make the moment matrix itself
    # near singular (its leading minors stay regular, so pivoting cannot
    # help): the solve returns 0/0 or an edge value amplified far past
    # the cells' range.  Such columns take the h2 estimates instead.  A
    # value is kept where |e - mid| <= lim, with mid and 2 rad the
    # cells' midrange and range (max(|lo|, |hi|) = |mid| + rad); NaN
    # fails the comparison.
    lo, hi = torch.aminmax(uu, dim=0)
    mid, rng = 0.5 * (hi + lo), hi - lo
    rel = max(_AMPLIFIED_REL, _AMPLIFIED * torch.finfo(u.dtype).eps)
    lim = torch.add(rel * mid.abs(), rng, alpha=0.5 * (1.0 + rel)
                    + _AMPLIFIED)
    keep = ((e0 - mid).abs() <= lim) & ((e1 - mid).abs() <= lim)
    hk0, hk1 = hh[0] + _H_NEGLECT, hh[1] + _H_NEGLECT
    e1_h2 = (uu[0] * hk1 + uu[1] * hk0) / (hk1 + hk0)
    return torch.where(keep, e0, uu[0]), torch.where(keep, e1, e1_h2)


def _pin(e, nk, rows):
    """``e`` with interface rows replaced: ``rows`` maps K to a
    (...)-shaped value."""
    K = _kcol(nk + 1, e)
    for k, val in rows.items():
        e = torch.where(K == k, val[None], e)
    return e


def edge_values_h4(h, u):
    """4th-order explicit edge estimates on a non-uniform grid, with
    integral-cubic boundary closures at the outer two interfaces on each
    end (the h2 estimate for columns of fewer than 4 cells)."""
    nk = h.shape[0]
    if nk < 4:
        return edge_values_h2(h, u)
    hn = torch.clamp(h, min=_H_NEGLECT)
    h0, h1, h2, h3 = (_iface_cells(hn, o) for o in (-2, -1, 0, 1))
    um2, um1, u0, up1 = (_iface_cells(u, o) for o in (-2, -1, 0, 1))
    I_h12 = 1.0 / (h1 + h2)
    I_den_et2 = 1.0 / (((h0 + h1) + h2) * (h0 + h1))
    I_h012 = (h0 + h1) * I_den_et2
    I_den_et3 = 1.0 / ((h1 + (h2 + h3)) * (h2 + h3))
    I_h123 = (h2 + h3) * I_den_et3
    et1 = ((1.0 + (h1 * I_h012 + (h0 + h1) * I_h123))
           * I_h12 * (h2 * (h2 + h3)) * um1
           + (1.0 + (h2 * I_h123 + (h2 + h3) * I_h012))
           * I_h12 * (h1 * (h0 + h1)) * u0)
    et2 = (h1 * (h2 * (h2 + h3)) * I_den_et2) * (um1 - um2)
    et3 = (h2 * (h1 * (h0 + h1)) * I_den_et3) * (u0 - up1)
    e4 = (et1 + (et2 + et3)) / ((h0 + h1) + (h2 + h3))
    top0, top1 = _boundary_cubic(h, u, bottom=False)
    bot0, bot1 = _boundary_cubic(h, u, bottom=True)
    K = _kcol(nk + 1, e4)
    e = torch.where((K >= 2) & (K <= nk - 2), e4, 0.0)
    return _pin(e, nk, {0: top0, 1: top1, nk - 1: bot1, nk: bot0})


def _thomas_interfaces(lo, dg, up, rhs):
    """A tridiagonal solve along the leading (interface) axis, forward
    then back substitution as k loops."""
    n = rhs.shape[0]
    cp = dp = torch.zeros_like(rhs[0])
    cps, dps = [], []
    for k in range(n):
        denom = dg[k] - lo[k] * cp
        cp = up[k] / denom
        dp = (rhs[k] - lo[k] * dp) / denom
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(rhs[0])
    xs = [None] * n
    for k in reversed(range(n)):
        x = dps[k] - cps[k] * x
        xs[k] = x
    return torch.stack(xs, dim=0)


def _dirichlet_ends(nk, lo, dg, up, rhs, top, bot):
    """Boundary rows of an interface system pinned to ``top`` and
    ``bot``."""
    K = _kcol(nk + 1, rhs)
    edge = (K == 0) | (K == nk)
    lo = torch.where(edge, 0.0, lo)
    up = torch.where(edge, 0.0, up)
    dg = torch.where(edge, 1.0, dg)
    return lo, dg, up, _pin(rhs, nk, {0: top, nk: bot})


def edge_values_ih4(h, u):
    """Implicit 4th-order edge values: a tridiagonal system over the
    column interfaces with integral-cubic boundary values."""
    nk = h.shape[0]
    if nk < 4:
        return edge_values_h2(h, u)
    hn = torch.clamp(h, min=_H_NEGLECT)
    h0, h1 = _iface_cells(hn, -1), _iface_cells(hn, 0)
    u0, u1 = _iface_cells(u, -1), _iface_cells(u, 0)
    I_h2 = 1.0 / _ipow(h0 + h1, 2)
    alpha = (h1 * h1) * I_h2
    beta = (h0 * h0) * I_h2
    abmix = (h0 * h1) * I_h2
    a = 2.0 * alpha * (alpha + 2.0 * beta + 3.0 * abmix)
    b = 2.0 * beta * (beta + 2.0 * alpha + 3.0 * abmix)
    rhs = a * u0 + b * u1
    top0, _ = _boundary_cubic(h, u, bottom=False)
    bot0, _ = _boundary_cubic(h, u, bottom=True)
    return _thomas_interfaces(*_dirichlet_ends(
        nk, alpha, torch.ones_like(alpha), beta, rhs, top0, bot0))


def _boundary_fit(h, u, n: int, bottom: bool):
    """Integral polynomial fit over the ``n`` cells nearest a column
    boundary: the coefficients C[0..n-1] in the boundary-anchored
    coordinate normalized by the n-cell depth, and that depth."""
    if bottom:
        hh, uu = h.flip(0)[:n], u.flip(0)[:n]
    else:
        hh, uu = h[:n], u[:n]
    tot = torch.sum(hh, dim=0) + _H_NEGLECT
    dz = torch.clamp(hh / tot[None], min=1e-10)
    x = _cumsum0(dz)
    xi, xip = x[:-1], x[1:]
    A = [[(_ipow(xip[i], j + 1) - _ipow(xi[i], j + 1)) / (j + 1)
          for j in range(n)] for i in range(n)]
    B = [uu[i] * dz[i] for i in range(n)]
    return _gauss_unrolled(A, B), tot


def edge_slopes_ih3(h, u):
    """Implicit 3rd-order edge slopes: a diagonally dominant tridiagonal
    over the column interfaces with cubic boundary slopes.  Returns the
    physical slopes du/dh at the nk+1 interfaces."""
    nk = h.shape[0]
    hn = torch.clamp(h, min=_H_NEGLECT)
    if nk < 4:
        h0, h1 = _iface_cells(hn, -1), _iface_cells(hn, 0)
        s = 2.0 * (_iface_cells(u, 0) - _iface_cells(u, -1)) / (h0 + h1)
        K = _kcol(nk + 1, s)
        return torch.where((K == 0) | (K == nk), 0.0, s)
    h0r, h1r = _iface_cells(hn, -1), _iface_cells(hn, 0)
    I_h = 1.0 / (h0r + h1r)
    h0 = h0r * I_h
    h1 = h1r * I_h
    h0h1 = h0 * h1
    I_d = 1.0 / (1.0 + h0h1)
    lo = (h0h1 - h1 * h1 * h1) * I_d
    up = (h0h1 - h0 * h0 * h0) * I_d
    rhs = 12.0 * (h0h1 * I_d) * ((_iface_cells(u, 0)
                                  - _iface_cells(u, -1)) * I_h)
    Ct, tot_t = _boundary_fit(hn, u, 4, bottom=False)
    Cb, tot_b = _boundary_fit(hn, u, 4, bottom=True)
    return _thomas_interfaces(*_dirichlet_ends(
        nk, lo, torch.ones_like(lo), up, rhs, Ct[1] / tot_t,
        -Cb[1] / tot_b))


def _q3(ha, hb):
    """((hb+ha)^3 - ha^3)/hb, the cumulative cubic moment factor of the
    White & Adcroft (2009) interior systems."""
    return 3.0 * ha * ha + hb * (3.0 * ha + hb)


def _q4(ha, hb):
    return 4.0 * _ipow(ha, 3) + hb * (6.0 * ha * ha
                                      + hb * (4.0 * ha + hb))


def _q5(ha, hb):
    return 5.0 * _ipow(ha, 4) + hb * (10.0 * _ipow(ha, 3) + hb * (
        10.0 * ha * ha + hb * (5.0 * ha + hb)))


def _q6(ha, hb):
    return 6.0 * _ipow(ha, 5) + hb * (15.0 * _ipow(ha, 4) + hb * (
        20.0 * _ipow(ha, 3) + hb * (15.0 * ha * ha
                                    + hb * (6.0 * ha + hb))))


def _powers(x):
    """[x, x^2, x^3, x^4, x^5]."""
    return [x, x * x, _ipow(x, 3), _ipow(x, 4), _ipow(x, 5)]


def _wa6_value_system(h0, h1, h2, h3, kind: str):
    """The 6-equation White & Adcroft (2009) moment system for one
    interface's implicit edge value: unknowns (alpha, beta, a, b, c, d)
    of alpha*e_{K-1} + e_K + beta*e_{K+1} = a*u0 + b*u1 + c*u2 + d*u3
    over the 4-cell stencil.  ``kind``: 'interior', 'right' (the second
    row) or 'left' (the second-to-last row)."""
    one = torch.ones_like(h0)
    zero = torch.zeros_like(h0)
    _, h1_2, h1_3, h1_4, h1_5 = _powers(h1)
    _, h2_2, h2_3, h2_4, h2_5 = _powers(h2)
    if kind == "interior":
        al = [one, -2.0 * h1, 3.0 * h1_2, -4.0 * h1_3, 5.0 * h1_4,
              -6.0 * h1_5]
        be = [one, 2.0 * h2, 3.0 * h2_2, 4.0 * h2_3, 5.0 * h2_4,
              6.0 * h2_5]
        rhs = [-one, zero, zero, zero, zero, zero]
    elif kind == "right":
        hb = _powers(h0 + h1)
        al = [one, -2.0 * hb[0], 3.0 * hb[1], -4.0 * hb[2],
              5.0 * hb[3], -6.0 * hb[4]]
        be = [one, zero, zero, zero, zero, zero]
        rhs = [-one, 2.0 * h1, -3.0 * h1_2, 4.0 * h1_3, -5.0 * h1_4,
               6.0 * h1_5]
    else:
        hb = _powers(h2 + h3)
        al = [one, zero, zero, zero, zero, zero]
        be = [one, 2.0 * hb[0], 3.0 * hb[1], 4.0 * hb[2],
              5.0 * hb[3], 6.0 * hb[4]]
        rhs = [-one, -2.0 * h2, -3.0 * h2_2, -4.0 * h2_3,
               -5.0 * h2_4, -6.0 * h2_5]
    a_col = [-one, 2.0 * h1 + h0, -_q3(h1, h0), _q4(h1, h0),
             -_q5(h1, h0), _q6(h1, h0)]
    b_col = [-one, h1, -h1_2, h1_3, -h1_4, h1_5]
    c_col = [-one, -h2, -h2_2, -h2_3, -h2_4, -h2_5]
    d_col = [-one, -(2.0 * h2 + h3), -_q3(h2, h3), -_q4(h2, h3),
             -_q5(h2, h3), -_q6(h2, h3)]
    # unknowns ordered (a, beta, d, c, alpha, b), as the JAX package
    # orders them for the largest worst-case pivot
    A = [[a_col[j], be[j], d_col[j], c_col[j], al[j], b_col[j]]
         for j in range(6)]
    x = _gauss_unrolled(A, rhs)
    return [x[4], x[1], x[0], x[5], x[3], x[2]]


def _wa6_slope_system(h0, h1, h2, h3, kind: str):
    """The 6-equation system for one interface's implicit edge slope:
    alpha*s_{K-1} + s_K + beta*s_{K+1} = a*u0 + ..., with s in units of
    [u] per unit of the (normalized) widths given."""
    one = torch.ones_like(h0)
    zero = torch.zeros_like(h0)
    two = 2.0 * one
    _, h1_2, h1_3, h1_4, h1_5 = _powers(h1)
    _, h2_2, h2_3, h2_4, h2_5 = _powers(h2)
    if kind == "interior":
        al = [zero, two, 6.0 * h1, -12.0 * h1_2, 20.0 * h1_3,
              -30.0 * h1_4]
        be = [zero, two, -6.0 * h2, -12.0 * h2_2, -20.0 * h2_3,
              -30.0 * h2_4]
        rhs = [zero, -two, zero, zero, zero, zero]
    elif kind == "right":
        hb = _powers(h0 + h1)
        al = [zero, two, 6.0 * hb[0], -12.0 * hb[1], 20.0 * hb[2],
              -30.0 * hb[3]]
        be = [zero, two, zero, zero, zero, zero]
        rhs = [zero, -two, -6.0 * h1, 12.0 * h1_2, -20.0 * h1_3,
               30.0 * h1_4]
    else:
        hb = _powers(h2 + h3)
        al = [zero, two, zero, zero, zero, zero]
        be = [zero, two, -6.0 * hb[0], -12.0 * hb[1], -20.0 * hb[2],
              -30.0 * hb[3]]
        rhs = [zero, -two, 6.0 * h2, 12.0 * h2_2, 20.0 * h2_3,
               30.0 * h2_4]
    a_col = [one, 2.0 * h1 + h0, _q3(h1, h0), -_q4(h1, h0),
             _q5(h1, h0), -_q6(h1, h0)]
    b_col = [one, h1, h1_2, -h1_3, h1_4, -h1_5]
    c_col = [one, -h2, h2_2, h2_3, h2_4, h2_5]
    d_col = [one, -(2.0 * h2 + h3), _q3(h2, h3), _q4(h2, h3),
             _q5(h2, h3), _q6(h2, h3)]
    # unknowns ordered (c, a, d, beta, alpha, b), as the JAX package
    # orders them (the natural order meets a zero pivot on uniform grids)
    A = [[c_col[j], a_col[j], d_col[j], be[j], al[j], b_col[j]]
         for j in range(6)]
    x = _gauss_unrolled(A, rhs)
    return [x[4], x[3], x[1], x[5], x[0], x[2]]


def _wa6_tridiag(h, u, slopes: bool):
    """Assemble and solve the White & Adcroft interface tridiagonal for
    implicit h6 edge values or h5 edge slopes, on stencil widths
    normalized by their 4-cell mean, with Dirichlet rows from 6-cell
    quintic integral fits."""
    nk = h.shape[0]
    hmin_frac = 1e-4 if slopes else 1e-5
    system = _wa6_slope_system if slopes else _wa6_value_system

    def stencil(hs, kind):
        h0r, h1r, h2r, h3r = hs
        tot = (h0r + h1r) + (h2r + h3r)
        hmin = torch.clamp(hmin_frac * tot, min=_H_NEGLECT)
        s = 0.25 * tot + _H_NEGLECT
        quad = [torch.maximum(x, hmin) / s for x in (h0r, h1r, h2r, h3r)]
        return system(*quad, kind), s

    # interior rows over all interfaces; rows 0, 1, nk-1 and nk are
    # replaced below
    hs_int = [_iface_cells(h, o) for o in (-2, -1, 0, 1)]
    us_int = [_iface_cells(u, o) for o in (-2, -1, 0, 1)]
    C, s_int = stencil(hs_int, "interior")
    lo, up = C[0], C[1]
    rhs = C[2] * us_int[0] + C[3] * us_int[1] + C[4] * us_int[2] \
        + C[5] * us_int[3]
    if slopes:
        rhs = rhs / s_int

    def biased(cells, kind):
        Cb, s = stencil([h[c] for c in cells], kind)
        uc = [u[c] for c in cells]
        r = Cb[2] * uc[0] + Cb[3] * uc[1] + Cb[4] * uc[2] + Cb[5] * uc[3]
        if slopes:
            r = r / s
        return Cb[0], Cb[1], r

    right = biased([0, 1, 2, 3], "right")
    left = biased([nk - 4, nk - 3, nk - 2, nk - 1], "left")
    shape = torch.broadcast_shapes(lo.shape, up.shape, rhs.shape)
    lo, up, rhs = (torch.broadcast_to(x, shape).clone()
                   for x in (lo, up, rhs))
    for row, (lo_b, up_b, rhs_b) in ((1, right), (nk - 1, left)):
        lo[row], up[row], rhs[row] = lo_b, up_b, rhs_b

    Ct, tot_t = _boundary_fit(h, u, 6, bottom=False)
    Cb, tot_b = _boundary_fit(h, u, 6, bottom=True)
    if slopes:
        top_val, bot_val = Ct[1] / tot_t, -Cb[1] / tot_b
    else:
        top_val, bot_val = Ct[0], Cb[0]
    return _thomas_interfaces(*_dirichlet_ends(
        nk, lo, torch.ones_like(lo), up, rhs, top_val, bot_val))


def edge_values_ih6(h, u):
    """Implicit 6th-order edge values (the ih4 values for columns of
    fewer than 6 cells)."""
    if h.shape[0] < 6:
        return edge_values_ih4(h, u)
    return _wa6_tridiag(torch.clamp(h, min=_H_NEGLECT), u, slopes=False)


def edge_slopes_ih5(h, u):
    """Implicit 5th-order edge slopes du/dh at the nk+1 interfaces (the
    ih3 slopes for columns of fewer than 6 cells)."""
    if h.shape[0] < 6:
        return edge_slopes_ih3(h, u)
    return _wa6_tridiag(torch.clamp(h, min=_H_NEGLECT), u, slopes=True)


def _hybgen_plm_slope(h, u, thin=1e-10):
    """The PLM slope times h with hybgen's thickness weighting: the
    smallest of the centred and the two one-sided differences where they
    agree in sign, 0 at an extremum, in the end cells and in cells no
    thicker than ``thin``."""
    dp = torch.clamp(h, min=thin)
    u_up, u_dn = _shift_k(u, -1), _shift_k(u, 1)
    qcen = dp / (dp + 0.5 * (_shift_k(dp, -1) + _shift_k(dp, 1)))
    ztop = 2.0 * (u - u_up)
    zbot = 2.0 * (u_dn - u)
    zcen = qcen * (u_dn - u_up)
    slope = torch.sign(zbot) * torch.minimum(
        zcen.abs(), torch.minimum(zbot.abs(), ztop.abs()))
    slope = torch.where(ztop * zbot > 0.0, slope, 0.0)
    K = _kcol(h.shape[0], h)
    slope = torch.where((K == 0) | (K == h.shape[0] - 1), 0.0, slope)
    return torch.where(h <= thin, 0.0, slope)


def _hybgen_weno_edges(h, u, thin=1e-10):
    """The WENO-reconciled parabola's edge values (eL, eR): each cell's
    edge estimates from its limited one-sided slopes, each interface's
    value a blend of its two cells' estimates by their smoothness
    weights, and a final monotonic adjustment within each cell.  End
    cells, cells no thicker than ``thin`` and cells at an extremum are
    constant."""
    nk = h.shape[0]
    dp = torch.clamp(h, min=thin)
    pcm = h <= thin
    dpm1, dpp1 = _shift_k(dp, -1), _shift_k(dp, 1)
    qdpkm = 1.0 / (dpm1 + dp)
    qdpkmkp = 1.0 / (dpm1 + dp + dpp1)
    dpkm2kp = dpm1 + 2.0 * dp + dpp1
    # the slopes at the interfaces above and below each cell
    sl_above = qdpkm * (u - _shift_k(u, -1))
    K = _kcol(nk, h)
    sl_below = torch.where(K == nk - 1, sl_above, _shift_k(sl_above, 1))
    use_pcm = (sl_above * sl_below < 0.0) | pcm | (K == 0) | (K == nk - 1)
    seh1 = dp * sl_below
    seh2 = dp * sl_above
    q01 = dpkm2kp * sl_below
    q02 = dpkm2kp * sl_above
    seh1 = torch.where(seh1.abs() > q02.abs(), q02, seh1)
    seh2 = torch.where(seh2.abs() > q01.abs(), q01, seh2)
    curv = (seh1 - seh2) * qdpkmkp
    q001 = seh1 - curv * dpp1
    q002 = seh2 + curv * dpm1
    eR0 = torch.where(use_pcm, u, u + q001)
    eL0 = torch.where(use_pcm, u, u - q002)
    w1, w2 = 2.0 * q001 - q002, 2.0 * q002 - q001
    zw1 = torch.where(use_pcm, 0.0, w1 * w1)
    zw2 = torch.where(use_pcm, 0.0, w2 * w2)
    # each interface's value from its two cells' estimates
    min_ratio = 1e-8
    tot = zw1 + _shift_k(zw2, -1)
    wt1 = torch.where(tot <= 0.0, 0.5,
                      torch.clamp(zw1 / torch.clamp(tot, min=1e-300),
                                  min_ratio, 1.0 - min_ratio))
    val_edge = wt1 * _shift_k(eR0, -1) + (1.0 - wt1) * eL0
    val_below = torch.where(K == nk - 1, 2.0 * u - val_edge,
                            _shift_k(val_edge, 1))
    # the monotonic adjustment within each cell (an if/elif chain)
    q01 = val_below - u
    q02 = u - val_edge
    bad = q01 * q02 < 0.0
    q01z = torch.where(bad, 0.0, q01)
    q02z = torch.where(bad, 0.0, q02)
    c1 = (~bad) & (q01z.abs() > (2.0 * q02z).abs())
    c2 = (~bad) & (~c1) & (q02z.abs() > (2.0 * q01z).abs())
    q01f = torch.where(c1, 2.0 * q02z, q01z)
    q02f = torch.where(c2, 2.0 * q01z, q02z)
    return (torch.where(use_pcm, u, u - q02f),
            torch.where(use_pcm, u, u + q01f))


def _limit_edges(u, eL, eR):
    """Bound edge values between adjacent cell means."""
    u_up = _shift_k(u, -1)
    u_dn = _shift_k(u, 1)
    return (_clip(eL, torch.minimum(u, u_up), torch.maximum(u, u_up)),
            _clip(eR, torch.minimum(u, u_dn), torch.maximum(u, u_dn)))


def _ppm_limit(u, eL, eR):
    """PPM monotonic limiter (CW84 style)."""
    eL, eR = _limit_edges(u, eL, eR)
    dh = eR - eL
    curv = 6.0 * u - 3.0 * (eL + eR)
    pc = (eR - u) * (u - eL) <= 0.0
    eL2 = torch.where(pc, u, torch.where(dh * curv > dh * dh,
                                         3.0 * u - 2.0 * eR, eL))
    eR2 = torch.where(pc, u, torch.where(dh * curv < -dh * dh,
                                         3.0 * u - 2.0 * eL2, eR))
    return eL2, eR2


def _pqm_limit_full(h, u, eL, eR, dL, dR):
    """The full PQM limiter: limited van Leer slope consistency,
    extremum flattening, inflexion-point analysis of the quartic's
    second derivative, and the collapse of inflexion points onto the
    edge on the smoother side.  Slopes dL/dR are per unit xi (physical
    slope times h).  Boundary cells reduce to PCM."""
    nk = u.shape[0]
    u_l, u_r = _shift_k(u, -1), _shift_k(u, 1)
    h_l, h_r = _shift_k(h, -1), _shift_k(h, 1)
    eps = _H_NEGLECT
    sig_l = 2.0 * (u - u_l) * h / (h + eps)
    sig_c = 2.0 * (u_r - u_l) * h / (h_l + 2.0 * h + h_r + eps)
    sig_r = 2.0 * (u_r - u) * h / (h + eps)
    slope = torch.where(
        sig_l * sig_r > 0.0,
        torch.sign(sig_c) * torch.minimum(
            sig_l.abs(), torch.minimum(sig_c.abs(), sig_r.abs())), 0.0)
    dL = torch.where(dL * slope <= 0.0, slope, dL)
    dR = torch.where(dR * slope <= 0.0, slope, dR)
    extremum = (eR - u) * (u - eL) <= 0.0

    b = dL
    c = 30.0 * u - 12.0 * eR - 18.0 * eL + 1.5 * (dR - 3.0 * dL)
    d = -60.0 * u + (6.0 * dL - 4.0 * dR) + 28.0 * eR + 32.0 * eL
    e = 30.0 * u + 2.5 * (dR - dL) - 15.0 * (eL + eR)
    # inflexion points: roots of u'' = 6e xi^2 + 3d xi + c
    al1, al2, al3 = 6.0 * e, 3.0 * d, c
    rho = al2 * al2 - 4.0 * al1 * al3
    sq = torch.sqrt(torch.clamp(rho, min=0.0))
    safe1 = torch.where(al1 != 0.0, al1, 1.0)
    x1 = 0.5 * (-al2 - sq) / safe1
    x2 = 0.5 * (-al2 + sq) / safe1

    def grad(x):
        return ((4.0 * e * x + 3.0 * d) * x + 2.0 * c) * x + b

    in1 = (x1 >= 0.0) & (x1 <= 1.0)
    in2 = (x2 >= 0.0) & (x2 <= 1.0)
    bad1 = grad(x1) * slope < 0.0
    bad2 = grad(x2) * slope < 0.0
    quad = (al1 != 0.0) & (rho >= 0.0)
    bad_q = quad & ((in1 & in2 & (bad1 | bad2)) | (in1 & ~in2 & bad1)
                    | (~in1 & in2 & bad2))
    # degenerate (linear u'') case
    xl = -al3 / torch.where(al2 != 0.0, al2, 1.0)
    bad_l = (al1 == 0.0) & (al2 != 0.0) & (xl >= 0.0) & (xl <= 1.0) \
        & (grad(xl) * slope < 0.0)
    bad = (bad_q | bad_l) & ~extremum
    to_left = sig_l.abs() < sig_r.abs()

    # both inflexion points collapsed onto the left edge
    dL_L = (10.0 * u - 2.0 * eR - 8.0 * eL) / 3.0
    dR_L = -10.0 * u + 6.0 * eR + 4.0 * eL
    badL_l = dL_L * slope < 0.0
    badL_r = dR_L * slope < 0.0
    eR_L = torch.where(badL_l, 5.0 * u - 4.0 * eL, eR)
    eL_L = torch.where(~badL_l & badL_r, 0.5 * (5.0 * u - 3.0 * eR), eL)
    dL_L2 = torch.where(badL_l, 0.0, torch.where(
        badL_r, 10.0 * (-u + eR) / 3.0, dL_L))
    dR_L2 = torch.where(badL_l, 20.0 * (u - eL),
                        torch.where(badL_r, 0.0, dR_L))

    # both inflexion points collapsed onto the right edge
    dR_R = (-10.0 * u + 8.0 * eR + 2.0 * eL) / 3.0
    dL_R = 10.0 * u - 4.0 * eR - 6.0 * eL
    badR_l = dL_R * slope < 0.0
    badR_r = dR_R * slope < 0.0
    eR_R = torch.where(badR_l, 0.5 * (5.0 * u - 3.0 * eL), eR)
    eL_R = torch.where(~badR_l & badR_r, 5.0 * u - 4.0 * eR, eL)
    dL_R2 = torch.where(badR_l, 0.0, torch.where(
        badR_r, 20.0 * (-u + eR), dL_R))
    dR_R2 = torch.where(badR_l, 10.0 * (u - eL) / 3.0,
                        torch.where(badR_r, 0.0, dR_R))

    def pick(lft, rgt, keep):
        return torch.where(bad, torch.where(to_left, lft, rgt), keep)

    eL2 = pick(eL_L, eL_R, eL)
    eR2 = pick(eR_L, eR_R, eR)
    dL2 = pick(dL_L2, dL_R2, dL)
    dR2 = pick(dR_L2, dR_R2, dR)

    # extremum flattening overrides; boundary cells reduce to PCM
    K = _kcol(nk, u)
    pcm = extremum | (K == 0) | (K == nk - 1)
    z = torch.zeros_like(u)
    return (torch.where(pcm, u, eL2), torch.where(pcm, u, eR2),
            torch.where(pcm, z, dL2), torch.where(pcm, z, dR2))


def _mean_edges(eL, eR):
    """Interface values from the cells' own edges: the outer edges kept,
    each interior interface the mean of its two cells' edges."""
    return torch.cat([eL[:1], 0.5 * (eR[:-1] + eL[1:]), eR[-1:]], dim=0)


def reconstruct(h, u, cfg: RemapCfg) -> Reconstruction:
    """Per-cell polynomials over xi in [0, 1] (top to bottom of a
    cell)."""
    scheme = cfg.scheme.upper()
    if scheme == "PCM":
        z = torch.zeros_like(u)
        return Reconstruction(c0=u, c1=z, c2=z)
    if scheme == "PLM":
        u_up, u_dn = _shift_k(u, -1), _shift_k(u, 1)
        s_c = 0.5 * (u_dn - u_up)
        s_l = u - u_up
        s_r = u_dn - u
        slope = torch.sign(s_c) * torch.minimum(
            s_c.abs(), 2.0 * torch.minimum(s_l.abs(), s_r.abs()))
        slope = torch.where(s_l * s_r > 0.0, slope, 0.0)
        return Reconstruction(c0=u - 0.5 * slope, c1=slope,
                              c2=torch.zeros_like(u))
    if scheme == "PLM_HYBGEN":
        slope = _hybgen_plm_slope(h, u)
        return Reconstruction(c0=u - 0.5 * slope, c1=slope,
                              c2=torch.zeros_like(u))
    if scheme == "WENO_HYBGEN":
        eL, eR = _hybgen_weno_edges(h, u)
        u6 = 6.0 * u - 3.0 * (eL + eR)
        return Reconstruction(c0=eL, c1=(eR - eL) + u6, c2=-u6)
    if scheme in ("PQM_IH4IH3", "PQM_IH6IH5"):
        # White & Adcroft (2008) piecewise quartic, pinned by the cell
        # mean, the edge values and the edge slopes
        if scheme == "PQM_IH6IH5":
            edges, slopes = edge_values_ih6(h, u), edge_slopes_ih5(h, u)
        else:
            edges, slopes = edge_values_ih4(h, u), edge_slopes_ih3(h, u)
        if cfg.force_monotonic:
            edges = _mean_edges(*_limit_edges(u, edges[:-1], edges[1:]))
        eL, eR = edges[:-1], edges[1:]
        dL = slopes[:-1] * h
        dR = slopes[1:] * h
        if cfg.force_monotonic:
            eL, eR, dL, dR = _pqm_limit_full(h, u, eL, eR, dL, dR)
        a2 = 30.0 * u - 12.0 * eR - 18.0 * eL + 1.5 * (dR - 3.0 * dL)
        a3 = -60.0 * u + (6.0 * dL - 4.0 * dR) + 28.0 * eR + 32.0 * eL
        a4 = 30.0 * u + 2.5 * (dR - dL) - 15.0 * (eL + eR)
        return Reconstruction(c0=eL, c1=dL, c2=a2, c3=a3, c4=a4)
    if scheme in ("PPM_H4", "PPM_IH4", "PPM_CW", "PPM_HYBGEN"):
        if scheme == "PPM_CW":
            edges = edge_values_h2(h, u)
        elif scheme == "PPM_IH4":
            edges = edge_values_ih4(h, u)
        elif scheme == "PPM_HYBGEN":
            edges = _mean_edges(*_hybgen_weno_edges(h, u))
        else:
            edges = edge_values_h4(h, u)
        eL, eR = edges[:-1], edges[1:]
        if cfg.force_monotonic:
            eL, eR = _ppm_limit(u, eL, eR)
        # u(xi) = eL + (dU + u6) xi - u6 xi^2
        dU = eR - eL
        u6 = 6.0 * u - 3.0 * (eL + eR)
        return Reconstruction(c0=eL, c1=dU + u6, c2=-u6)
    raise ValueError(f"Unknown REMAPPING_SCHEME '{cfg.scheme}'")


def interface_positions(h):
    """Downward positions of interfaces: z[0] = 0, z[K] = sum of h_l for
    l < K."""
    return _cumsum0(h)


def _column_integral_at(h_src, rec: Reconstruction, z_eval):
    """I(z), the integral of u from the surface to each position of
    ``z_eval`` (m, ...), as two disjoint reductions over the source
    cells on the (m, nk, ...) pair space:

        I(z) = sum_k cellint_k [z_{k+1} <= z]
             + sum_k [z_k <= z < z_{k+1}] h_k F_k(xi)

    Vanished layers (z_k == z_{k+1}) never pass the inside test and
    add nothing, so shared interfaces need no tie-breaking."""
    zs = interface_positions(h_src)
    hk = h_src + _H_NEGLECT
    cell_int = h_src * rec.cell_mean()
    total_z = zs[-1]
    z = torch.minimum(torch.clamp(z_eval, min=0.0), total_z[None])
    zb = z[:, None]
    zk = zs[:-1][None]
    zk1 = zs[1:][None]
    done = (zk1 <= zb).to(z.dtype)
    inside = ((zk <= zb) & (zb < zk1)).to(z.dtype)
    I_done = torch.sum(done * cell_int[None], dim=1)
    xi = torch.clamp((zb - zk) / hk[None], 0.0, 1.0)
    partial = hk[None] * rec.integral_to(xi)
    I_part = torch.sum(inside * partial, dim=1)
    return I_done + I_part


def _finish(I, h_src, h_dst):
    """Target cell means from the integral at the target interfaces;
    vanished target cells take the value of the cell above (the top cell
    keeps its own)."""
    u_dst = (I[1:] - I[:-1]) / (h_dst + _H_NEGLECT)
    tiny = h_dst <= 1e-9 * (torch.sum(h_src, dim=0, keepdim=True)
                            + _H_NEGLECT)
    return torch.where(tiny, _shift_k(u_dst, -1), u_dst)


def remap_column_means_banded(h_src, u_src, h_dst, band: int,
                              cfg: RemapCfg = RemapCfg()):
    """The remap of ``remap_column_means`` evaluated only on the
    near-diagonal (target interface m, source cell k) pairs,
    |k - m| <= band (ALE_REMAP_BAND).  Exact: when any clipped interface
    finds no containing cell within the band, the whole call returns the
    full remap instead, as the JAX package's ``lax.cond`` does."""
    rec = reconstruct(h_src, u_src, cfg)
    zs = interface_positions(h_src)
    hk = h_src + _H_NEGLECT
    cell_int = h_src * rec.cell_mean()
    cumint0 = _cumsum0(cell_int)
    total_z = zs[-1]
    z_dst = interface_positions(h_dst)
    M = z_dst.shape[0]
    nk = h_src.shape[0]
    z = torch.minimum(torch.clamp(z_dst, min=0.0), total_z[None])
    coeffs = [c for c in rec if c is not None]
    I = torch.zeros_like(z)
    matched = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for off in range(-band, band + 1):
        ks = np.arange(M) + off
        valid = (ks >= 0) & (ks < nk)
        if not valid.any():
            continue
        idx = torch.as_tensor(np.clip(ks, 0, nk - 1), device=z.device)
        vmask = torch.as_tensor(valid, device=z.device).reshape(
            (M,) + (1,) * (z.dim() - 1))
        zk, zk1, hkk = zs[idx], zs[idx + 1], hk[idx]
        inside = (zk <= z) & (z < zk1) & vmask
        xi = torch.clamp((z - zk) / hkk, 0.0, 1.0)
        rloc = Reconstruction(*[c[idx] for c in coeffs])
        part = hkk * rloc.integral_to(xi)
        I = I + torch.where(inside, cumint0[idx] + part, 0.0)
        matched = matched | inside
    # interfaces clipped to the column bottom: the full-column integral
    at_bottom = z >= total_z[None]
    I = torch.where(at_bottom, cumint0[-1][None], I)
    matched = matched | at_bottom
    if bool(torch.all(matched)):
        return _finish(I, h_src, h_dst)
    return remap_column_means(h_src, u_src, h_dst, cfg)


def remap_column_means(h_src, u_src, h_dst, cfg: RemapCfg = RemapCfg()):
    """Conservative remap of cell means from (h_src, u_src) onto h_dst.

    All tensors (nk, ...) with broadcastable trailing dims; the column
    totals of h_src and h_dst should agree (tails are clamped).  Returns
    u_dst, vanished target cells filled from the cell above."""
    rec = reconstruct(h_src, u_src, cfg)
    I = _column_integral_at(h_src, rec, interface_positions(h_dst))
    return _finish(I, h_src, h_dst)
