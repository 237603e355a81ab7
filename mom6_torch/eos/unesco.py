"""UNESCO (1981) / Jackett & McDougall (1995) equation of state.

Counterpart of ``mom6_tpu.eos.unesco``:
rho(T, S, p) = rho0(T, S) * ks / (ks − p_bar), with the 15-term 1-bar
density polynomial and the 26-term secant bulk modulus fit (published
coefficients of Jackett & McDougall 1995, J. Atmos. Ocean. Tech. 12,
381).  T is potential temperature [degC], S practical salinity [PSU],
p pressure [Pa] (converted to bars internally).
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.eos.base import EOS

__all__ = ["UnescoEOS"]

# 1-bar density fit rho0 [kg m-3]
R00, R01, R02 = 999.842594, 6.793952e-2, -9.095290e-3
R03, R04, R05 = 1.001685e-4, -1.120083e-6, 6.536332e-9
R10, R11, R12 = 0.824493, -4.0899e-3, 7.6438e-5
R13, R14 = -8.2467e-7, 5.3875e-9
R60, R61, R62 = -5.72466e-3, 1.0227e-4, -1.6546e-6
R20 = 4.8314e-4
# secant bulk modulus fit [bar]
S000, S010, S020 = 1.965933e4, 1.444304e2, -1.706103
S030, S040 = 9.648704e-3, -4.190253e-5
S100, S110, S120, S130 = 52.84855, -3.101089e-1, 6.283263e-3, -5.084188e-5
S600, S610, S620 = 3.886640e-1, 9.085835e-3, -4.619924e-4
S001, S011, S021, S031 = 3.186519, 2.212276e-2, -2.984642e-4, 1.956415e-6
S101, S111, S121 = 6.704388e-3, -1.847318e-4, 2.059331e-7
S601 = 1.480266e-4
S002, S012, S022 = 2.102898e-4, -1.202016e-5, 1.394680e-7
S102, S112, S122 = -2.040237e-6, 6.128773e-8, 6.207323e-10


@dataclasses.dataclass(frozen=True)
class UnescoEOS(EOS):
    name = "UNESCO"

    def _parts(self, T, S, p):
        p1 = p * 1.0e-5                 # Pa → bar
        t1 = T
        s1 = torch.clamp(S, min=0.0)
        s12 = torch.sqrt(s1)
        sig0 = (t1 * (R01 + t1 * (R02 + t1 * (R03 + t1 * (R04 + t1 * R05))))
                + s1 * ((R10 + t1 * (R11 + t1 * (R12 + t1 * (R13 + t1 * R14))))
                        + (s12 * (R60 + t1 * (R61 + t1 * R62)) + s1 * R20)))
        rho0 = R00 + sig0
        ks = ((S000 + (t1 * (S010 + t1 * (S020 + t1 * (S030 + t1 * S040)))
                       + s1 * ((S100 + t1 * (S110 + t1 * (S120 + t1 * S130)))
                               + s12 * (S600 + t1 * (S610 + t1 * S620)))))
              + p1 * ((S001 + (t1 * (S011 + t1 * (S021 + t1 * S031))
                               + s1 * ((S101 + t1 * (S111 + t1 * S121))
                                       + s12 * S601)))
                      + p1 * (S002 + (t1 * (S012 + t1 * S022)
                                      + s1 * (S102 + t1 * (S112
                                                           + t1 * S122))))))
        return rho0, ks, p1

    def density(self, T, S, p, rho_ref: float = 0.0):
        # forward-mode derivatives in S are NaN at S = 0 (0 times the
        # infinite slope of sqrt), as in the JAX package
        rho0, ks, p1 = self._parts(T, S, p)
        return rho0 * ks / (ks - p1) - rho_ref
