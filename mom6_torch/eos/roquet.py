"""Roquet et al. (2015) polyTEOS-10 equations of state.

Counterpart of ``mom6_tpu.eos.roquet``: the 55-term density polynomial
(ROQUET_RHO) and the 55-term specific-volume polynomial (ROQUET_SPV) of
Roquet, Madec, McDougall & Barker (2015, Ocean Modelling 90, 29), in
conservative temperature [degC], absolute salinity [g kg-1] and
pressure [Pa].  The published coefficients are tabulated raw; the
variables are scaled before the powers (T by 1/40 degC, p by 1e-8 Pa to
kbar), so a float32 run does not overflow in p^6.  Each polynomial is
evaluated by ``poly.Poly3`` in about twenty kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.eos.base import EOS
from mom6_torch.eos.poly import Poly3

__all__ = ["RoquetRhoEOS", "RoquetSpVEOS"]

_PA2KB = 1.0e-8
_I_TS = 0.025
_RDELTAS = 32.0
_R1_S0 = 0.875 / 35.16504

# raw coefficients keyed (zs_power, T_power, p_power)
_EOS = {
    (0, 0, 0): 8.0189615746e+02, (1, 0, 0): 8.6672408165e+02,
    (2, 0, 0): -1.7864682637e+03, (3, 0, 0): 2.0375295546e+03,
    (4, 0, 0): -1.2849161071e+03, (5, 0, 0): 4.3227585684e+02,
    (6, 0, 0): -6.0579916612e+01,
    (0, 1, 0): 2.6010145068e+01, (1, 1, 0): -6.5281885265e+01,
    (2, 1, 0): 8.1770425108e+01, (3, 1, 0): -5.6888046321e+01,
    (4, 1, 0): 1.7681814114e+01, (5, 1, 0): -1.9193502195,
    (0, 2, 0): -3.7074170417e+01, (1, 2, 0): 6.1548258127e+01,
    (2, 2, 0): -6.0362551501e+01, (3, 2, 0): 2.9130021253e+01,
    (4, 2, 0): -5.4723692739,
    (0, 3, 0): 2.1661789529e+01, (1, 3, 0): -3.3449108469e+01,
    (2, 3, 0): 1.9717078466e+01, (3, 3, 0): -3.1742946532,
    (0, 4, 0): -8.3627885467, (1, 4, 0): 1.1311538584e+01,
    (2, 4, 0): -5.3563304045,
    (0, 5, 0): 5.4048723791e-01, (1, 5, 0): 4.8169980163e-01,
    (0, 6, 0): -1.9083568888e-01,
    (0, 0, 1): 1.9681925209e+01, (1, 0, 1): -4.2549998214e+01,
    (2, 0, 1): 5.0774768218e+01, (3, 0, 1): -3.0938076334e+01,
    (4, 0, 1): 6.6051753097,
    (0, 1, 1): -1.3336301113e+01, (1, 1, 1): -4.4870114575,
    (2, 1, 1): 5.0042598061, (3, 1, 1): -6.5399043664e-01,
    (0, 2, 1): 6.7080479603, (1, 2, 1): 3.5063081279,
    (2, 2, 1): -1.8795372996,
    (0, 3, 1): -2.4649669534, (1, 3, 1): -5.5077101279e-01,
    (0, 4, 1): 5.5927935970e-01,
    (0, 0, 2): 2.0660924175, (1, 0, 2): -4.9527603989,
    (2, 0, 2): 2.5019633244,
    (0, 1, 2): 2.0564311499, (1, 1, 2): -2.1311365518e-01,
    (0, 2, 2): -1.2419983026,
    (0, 0, 3): -2.3342758797e-02, (1, 0, 3): -1.8507636718e-02,
    (0, 1, 3): 3.7969820455e-01,
}

# T&S-independent pressure polynomial rho00p = sum R0n zp^(n+1)
_R0 = [4.6494977072e+01, -5.2099962525, 2.2601900708e-01,
       6.4326772569e-02, 1.5616995503e-02, -1.7243708991e-03]


# SpV polynomial (Roquet et al. 2015 polyTEOS10-55t specific-volume fit),
# keyed (zs_power, T_power, p_power); the SpV fit uses rdeltaS = 24
# where rho uses 32
_SPV_RDELTAS = 24.0
_SPV = {
    (0, 0, 0): 1.0772899069e-03, (1, 0, 0): -3.1263658781e-04,
    (2, 0, 0): 6.7615860683e-04, (3, 0, 0): -8.6127884515e-04,
    (4, 0, 0): 5.9010812596e-04, (5, 0, 0): -2.1503943538e-04,
    (6, 0, 0): 3.2678954455e-05,
    (0, 1, 0): -1.4949652640e-05, (1, 1, 0): 3.1866349188e-05,
    (2, 1, 0): -3.8070687610e-05, (3, 1, 0): 2.9818473563e-05,
    (4, 1, 0): -1.0011321965e-05, (5, 1, 0): 1.0751931163e-06,
    (0, 2, 0): 2.7546851539e-05, (1, 2, 0): -3.6597334199e-05,
    (2, 2, 0): 3.4489154625e-05, (3, 2, 0): -1.7663254122e-05,
    (4, 2, 0): 3.5965131935e-06,
    (0, 3, 0): -1.6506828994e-05, (1, 3, 0): 2.4412359055e-05,
    (2, 3, 0): -1.4606740723e-05, (3, 3, 0): 2.3293406656e-06,
    (0, 4, 0): 6.7896174634e-06, (1, 4, 0): -8.7951832993e-06,
    (2, 4, 0): 4.4249040774e-06,
    (0, 5, 0): -7.2535743349e-07, (1, 5, 0): -3.4680559205e-07,
    (0, 6, 0): 1.9041365570e-07,
    (0, 0, 1): -1.6889436589e-05, (1, 0, 1): 2.1106556158e-05,
    (2, 0, 1): -2.1322804368e-05, (3, 0, 1): 1.7347655458e-05,
    (4, 0, 1): -4.3209400767e-06,
    (0, 1, 1): 1.5355844621e-05, (1, 1, 1): 2.0914122241e-06,
    (2, 1, 1): -5.7751479725e-06, (3, 1, 1): 1.0767234341e-06,
    (0, 2, 1): -9.6659393016e-06, (1, 2, 1): -7.0686982208e-07,
    (2, 2, 1): 1.4488066593e-06,
    (0, 3, 1): 3.1134283336e-06, (1, 3, 1): 7.9562529879e-08,
    (0, 4, 1): -5.6590253863e-07,
    (0, 0, 2): 1.0500241168e-06, (1, 0, 2): 1.9600661704e-06,
    (2, 0, 2): -2.1666693382e-06,
    (0, 1, 2): -3.8541359685e-06, (1, 1, 2): 1.0157632247e-06,
    (0, 2, 2): 1.7178343158e-06,
    (0, 0, 3): -4.1503454190e-07, (1, 0, 3): 3.5627020989e-07,
    (0, 1, 3): -1.1293871415e-07,
}

# T&S-independent pressure polynomial SpV00p = sum V0n zp^(n+1)
_V0 = [-4.4015007269e-05, 6.9232335784e-06, -7.5004675975e-07,
       1.7009109288e-08, -1.6884162004e-08, 1.9613503930e-09]



def _with_p(coefs: dict, p_only: list) -> dict:
    """The coefficients with the pressure-only polynomial folded in at
    (0, 0, n + 1)."""
    out = dict(coefs)
    for n, c in enumerate(p_only):
        out[(0, 0, n + 1)] = out.get((0, 0, n + 1), 0.0) + c
    return out


_RHO_POLY = Poly3(_with_p(_EOS, _R0))
_SPV_POLY = Poly3(_with_p(_SPV, _V0))


@dataclasses.dataclass(frozen=True)
class RoquetRhoEOS(EOS):
    name = "ROQUET_RHO"

    def density(self, T, S, p, rho_ref: float = 0.0):
        zs = torch.sqrt(torch.abs(S + _RDELTAS) * _R1_S0)
        return _RHO_POLY(zs, T * _I_TS, p * _PA2KB) - rho_ref


@dataclasses.dataclass(frozen=True)
class RoquetSpVEOS(RoquetRhoEOS):
    """Specific-volume-native variant: density is the reciprocal of the
    SpV polynomial, and every derivative comes from the base class's
    forward-mode autodiff."""
    name = "ROQUET_SPV"

    def spec_vol(self, T, S, p, spv_ref: float = 0.0):
        zs = torch.sqrt(torch.abs(S + _SPV_RDELTAS) * _R1_S0)
        return _SPV_POLY(zs, T * _I_TS, p * _PA2KB) - spv_ref

    def density(self, T, S, p, rho_ref: float = 0.0):
        if rho_ref == 0.0:
            return 1.0 / self.spec_vol(T, S, p)
        # the anomaly without cancellation: with sv = 1/rho_ref + dsv,
        # 1/sv - rho_ref = -rho_ref^2 dsv / (rho_ref dsv + 1)
        spv_anom = self.spec_vol(T, S, p, spv_ref=1.0 / rho_ref)
        return -(rho_ref ** 2) * spv_anom / (rho_ref * spv_anom + 1.0)
