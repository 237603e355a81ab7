"""Jackett et al. (2006) rational-function equation of state.

Counterpart of ``mom6_tpu.eos.jackett06``: the 25-coefficient rational
fit of Jackett, McDougall, Feistel, Wright & Griffies (2006, J. Atmos.
Ocean. Tech. 23, 1709): rho = (RN000 + num(T,S,p)) / (1 + den(T,S,p)).
T potential temperature [degC], S practical salinity [PSU], p [Pa].
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.eos.base import EOS

__all__ = ["Jackett06EOS"]

RN000 = 9.9984085444849347e+02
RN001 = 1.1798263740430364e-06
RN002 = -2.5862187075154352e-16
RN010 = 7.3471625860981584e+00
RN020 = -5.3211231792841769e-02
RN021 = 9.8920219266399117e-12
RN022 = -3.2921414007960662e-20
RN030 = 3.6492439109814549e-04
RN100 = 2.5880571023991390e+00
RN101 = 4.6996642771754730e-10
RN110 = -6.7168282786692355e-03
RN200 = 1.9203202055760151e-03
RD001 = 6.7103246285651894e-10
RD010 = 7.2815210113327091e-03
RD013 = -9.1534417604289062e-30
RD020 = -4.4787265461983921e-05
RD030 = 3.3851002965802430e-07
RD032 = -2.4461698007024582e-25
RD040 = 1.3651202389758572e-10
RD100 = 1.7632126669040377e-03
RD110 = -8.8066583251206474e-06
RD130 = -1.8832689434804897e-10
RD600 = 5.7463776745432097e-06
RD620 = 1.4716275472242334e-09


@dataclasses.dataclass(frozen=True)
class Jackett06EOS(EOS):
    name = "JACKETT_06"

    def density(self, T, S, p, rho_ref: float = 0.0):
        # forward-mode derivatives in S are NaN at S = 0, as in the JAX
        # package
        S = torch.clamp(S, min=0.0)
        s12 = torch.sqrt(S)
        T2 = T * T
        num = ((T * (RN010 + T * (RN020 + T * RN030))
                + S * (RN100 + (T * RN110 + S * RN200)))
               + p * (RN001 + ((T2 * RN021 + S * RN101)
                               + p * (RN002 + T2 * RN022))))
        den = 1.0 + ((T * (RD010 + T * (RD020 + T * (RD030 + T * RD040)))
                      + S * (RD100 + (T * (RD110 + T2 * RD130)
                                      + s12 * (RD600 + T2 * RD620))))
                     + p * (RD001 + p * T * (T2 * RD032 + p * RD013)))
        return ((RN000 - rho_ref) + (num - rho_ref * (den - 1.0))) / den
