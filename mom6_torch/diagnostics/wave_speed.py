"""Buoyancy frequency at interfaces and baroclinic gravity-wave speeds
(counterpart of ``mom6_tpu.diagnostics.wave_speed``).

* ``brunt_vaisala2``: N^2 at the interior interfaces;
* ``wave_speed_wkb``: the first-mode speed as the WKB integral
  c1 = (1/pi) int N dz (the resolution function of VarMix);
* ``wave_speeds``: the modal speeds c_1..c_n of the discrete
  interface-displacement eigenproblem, each from a fixed count of
  shifted inverse iterations (a Thomas solve per iteration, k order as
  the JAX package's scans) and a Rayleigh quotient (the internal tides).
"""

from __future__ import annotations

import math

import torch

__all__ = ["brunt_vaisala2", "wave_speed_wkb", "wave_speeds"]

_H_NEGLECT = 1e-20


def brunt_vaisala2(vgrid, h, T=None, S=None, eos=None, p_int=None):
    """N^2 at the interior interfaces (nk-1, ...), from the EOS's
    derivatives at the interface's mean T, S and the hydrostatic
    pressure, or from the layers' target densities without an EOS;
    floored at 0."""
    g = vgrid.g_Earth
    rho0 = vgrid.Rho0
    if T is not None and eos is not None:
        if p_int is None:
            zs = torch.cumsum(h, dim=0)
            p_int = rho0 * g * zs[:-1]
        T_i = 0.5 * (T[:-1] + T[1:])
        S_i = 0.5 * (S[:-1] + S[1:])
        dRdT, dRdS = eos.density_derivs(T_i, S_i, p_int)
        drho = dRdT * (T[1:] - T[:-1]) + dRdS * (S[1:] - S[:-1])
    else:
        rl = vgrid.Rlay.reshape((-1,) + (1,) * (h.dim() - 1))
        drho = (rl[1:] - rl[:-1]).expand(h[1:].shape)
    dz = 0.5 * (h[:-1] + h[1:]) + _H_NEGLECT
    n2 = (g / rho0) * drho / dz
    return torch.clamp(n2, min=0.0)


def wave_speed_wkb(vgrid, h, T=None, S=None, eos=None):
    """First-mode speed c1 ~ (1/pi) int N dz per column (...,)."""
    n2 = brunt_vaisala2(vgrid, h, T, S, eos)
    dz = 0.5 * (h[:-1] + h[1:])
    return torch.sum(torch.sqrt(n2) * dz, dim=0) / math.pi


def _thomas_rows(lo, dg, up, rhs):
    """Per-column tridiagonal solve along the leading axis: rows k of
    (lo, dg, up) multiply x[k-1], x[k], x[k+1]."""
    n = rhs.shape[0]
    cps, dps = [], []
    cp = dp = torch.zeros_like(rhs[0])
    for k in range(n):
        inv = 1.0 / (dg[k] - lo[k] * cp)
        cp, dp = up[k] * inv, (rhs[k] - lo[k] * dp) * inv
        cps.append(cp)
        dps.append(dp)
    xs = [None] * n
    x = torch.zeros_like(rhs[0])
    for k in range(n - 1, -1, -1):
        x = dps[k] - cps[k] * x
        xs[k] = x
    return torch.stack(xs)


def wave_speeds(vgrid, h, T=None, S=None, eos=None, n_mode: int = 1,
                iters: int = 10, c_min: float = 1e-3):
    """Baroclinic mode speeds c_1..c_n_mode per column (n_mode, ...).

    Interface displacements e solve A e = (1/c^2) e with the
    tridiagonal A_K = [-1/(g'_K h_k-1), (1/h_k-1 + 1/h_k)/g'_K,
    -1/(g'_K h_k)]; each mode runs ``iters`` shifted inverse
    iterations from the WKB estimate c_wkb/m and a mode-m sine, then
    a Rayleigh quotient on the unshifted operator.  Columns whose WKB
    speed is below ``c_min`` give 0."""
    nk = h.shape[0]
    if nk < 2:
        return torch.zeros((n_mode,) + tuple(h.shape[1:]), dtype=h.dtype,
                           device=h.device)
    n2 = brunt_vaisala2(vgrid, h, T, S, eos)
    dz_i = 0.5 * (h[:-1] + h[1:])
    gp = torch.clamp(n2 * dz_i, min=1e-12)
    h_up = torch.clamp(h[:-1], min=_H_NEGLECT)
    h_dn = torch.clamp(h[1:], min=_H_NEGLECT)
    lo = -1.0 / (gp * h_up)
    up = -1.0 / (gp * h_dn)
    dg = (1.0 / h_up + 1.0 / h_dn) / gp
    c_wkb = torch.sum(torch.sqrt(n2) * dz_i, dim=0) / math.pi
    ok = c_wkb > c_min
    c_safe = torch.where(ok, c_wkb, 1.0)

    nf = nk - 1
    K = torch.arange(nf, dtype=h.dtype, device=h.device).reshape(
        (-1,) + (1,) * (h.dim() - 1))
    out = []
    for m in range(1, n_mode + 1):
        sigma = ((m / c_safe) ** 2)[None]
        x = torch.sin(m * math.pi * (K + 1.0) / nk) + 0.0 * gp
        for _ in range(iters):
            x = _thomas_rows(lo, dg - sigma, up, x)
            x = x / (torch.sqrt(torch.sum(x * x, dim=0))[None] + _H_NEGLECT)
        Ax = dg * x
        Ax = torch.cat([Ax[:1], Ax[1:] + lo[1:] * x[:-1]], dim=0)
        Ax = torch.cat([Ax[:-1] + up[:-1] * x[1:], Ax[-1:]], dim=0)
        lam = torch.sum(x * Ax, dim=0) / (torch.sum(x * x, dim=0)
                                          + _H_NEGLECT)
        out.append(torch.where(ok & (lam > 0.0),
                               1.0 / torch.sqrt(torch.clamp(lam, min=1e-30)),
                               0.0))
    return torch.stack(out)
