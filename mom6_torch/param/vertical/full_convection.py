"""Full convective adjustment (counterpart of
``mom6_tpu.param.vertical.full_convection``): sweeps that homogenize T
and S, thickness-weighted, across every statically unstable interface of
one parity (alternating odd and even interfaces, so that no two updates
touch the same layer); 2 nk^2 sweeps unless set.  The sweeps stop once
no interface of any column is unstable: every later sweep would find
the same derivatives of the same state and change nothing, so the
result is the fixed count's, bit for bit, at the cost of one host sync
a sweep (a column that never settles still runs the full count)."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["FullConvectionCfg", "full_convection"]

_EPS = 1e-20


@dataclasses.dataclass(frozen=True)
class FullConvectionCfg:
    n_sweeps: int = 0            # 0: 2 nk^2


def _mix_pairs(T, S, hw, unstable, parity):
    """Homogenize the unstable pairs (k, k+1) of the given parity,
    thickness-weighted by ``hw``."""
    act = unstable & parity

    def mixed(a):
        m = (a[:-1] * hw[:-1] + a[1:] * hw[1:]) / (hw[:-1] + hw[1:])
        out = torch.cat([torch.where(act, m, a[:-1]), a[-1:]], dim=0)
        return torch.cat([out[:1], torch.where(act, m, out[1:])], dim=0)

    return mixed(T), mixed(S)


def full_convection(cfg: FullConvectionCfg, T, S, h, eos, p_int=None):
    """The convectively adjusted (T, S)."""
    if p_int is None:
        p_int = torch.zeros_like(h[1:])
    nk = T.shape[0]
    n_sweeps = cfg.n_sweeps or 2 * nk ** 2
    hw = h + _EPS
    k = torch.arange(nk - 1, device=T.device).reshape(
        (-1,) + (1,) * (T.dim() - 1))
    parities = (k % 2 == 0, k % 2 == 1)
    for n in range(n_sweeps):
        T_i = 0.5 * (T[:-1] + T[1:])
        S_i = 0.5 * (S[:-1] + S[1:])
        dRdT, dRdS = eos.density_derivs(T_i, S_i, p_int)
        unstable = (dRdT * (T[1:] - T[:-1]) + dRdS * (S[1:] - S[:-1])) < 0.0
        if not bool(unstable.any()):
            break
        T, S = _mix_pairs(T, S, hw, unstable, parities[n % 2])
    return T, S
