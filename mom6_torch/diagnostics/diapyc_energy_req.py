"""The energy that a diapycnal mixing needs (a diagnostic).

Counterpart of ``mom6_tpu.diagnostics.diapyc_energy_req``: the energy
needed to carry out a diffusivity profile over a time step is the
potential energy it adds.  T and S go through the model's implicit
vertical diffusion (``tracer_vertdiff``) and the difference of

    PE = -g sum_k rho_k z_k h_k      [J m-2]

(z the layer centre's depth, positive down; rho at zero pressure)
after and before is returned, positive where mixing raises the centre
of mass.
"""

from __future__ import annotations

import torch

from mom6_torch.tracer.vertdiff import tracer_vertdiff

__all__ = ["diapyc_energy_req"]


def _pe(h, T, S, eos, g):
    z_c = torch.cumsum(h, dim=0) - 0.5 * h
    rho = eos.density(T, S, torch.zeros_like(T))
    return -g * torch.sum(rho * z_c * h, dim=0)


def diapyc_energy_req(h, T, S, kd_int, dt, eos, g=9.81):
    """The energy per unit area [J m-2] that ``kd_int`` (nk+1, nj, ni)
    needs over ``dt`` on the columns h, T, S (nk, nj, ni)."""
    pe0 = _pe(h, T, S, eos, g)
    T2 = tracer_vertdiff(T, h, kd_int, dt)
    S2 = tracer_vertdiff(S, h, kd_int, dt)
    return _pe(h, T2, S2, eos, g) - pe0
