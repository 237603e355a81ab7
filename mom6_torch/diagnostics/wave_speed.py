"""Buoyancy frequency at interfaces (counterpart of ``brunt_vaisala2`` in
``mom6_tpu.diagnostics.wave_speed``); the wave-speed estimators of that
module come with the lateral parameterizations that use them."""

from __future__ import annotations

import torch

__all__ = ["brunt_vaisala2"]

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
