"""Wright (1997) rational-function equation of state.

Counterpart of ``mom6_tpu.eos.wright``:

    alpha0(T,S) = a0 + a1*T + a2*S
    p0(T,S)     = b0 + b4*S + T*(b1 + T*(b2 + b3*T) + b5*S)
    lambda(T,S) = c0 + c4*S + T*(c1 + T*(c2 + c3*T) + c5*S)
    rho(T,S,p)  = (p + p0) / (lambda + alpha0*(p + p0))

with the full-range ("WRIGHT_FULL") and reduced-range ("WRIGHT_RED")
coefficient sets; the legacy "WRIGHT" form uses the reduced set.
"""

from __future__ import annotations

import dataclasses

from mom6_torch.eos.base import EOS

__all__ = ["WrightEOS", "WrightFullEOS", "WrightRedEOS"]

# (a0 a1 a2, b0 b1 b2 b3 b4 b5, c0 c1 c2 c3 c4 c5)
_COEFS = {
    "WRIGHT_FULL": (
        (7.133718e-4, 2.724670e-7, -1.646582e-7),
        (5.613770e8, 3.600337e6, -3.727194e4, 1.660557e2, 6.844158e5,
         -8.389457e3),
        (1.609893e5, 8.427815e2, -6.931554, 3.869318e-2, -1.664201e2,
         -2.765195),
    ),
    "WRIGHT_RED": (
        (7.057924e-4, 3.480336e-7, -1.112733e-7),
        (5.790749e8, 3.516535e6, -4.002714e4, 2.084372e2, 5.944068e5,
         -9.643486e3),
        (1.704853e5, 7.904722e2, -7.984422, 5.140652e-2, -2.302158e2,
         -3.079464),
    ),
}
_COEFS["WRIGHT"] = _COEFS["WRIGHT_RED"]


@dataclasses.dataclass(frozen=True)
class _WrightBase(EOS):
    variant: str = "WRIGHT_RED"

    def _parts(self, T, S):
        (a0, a1, a2), (b0, b1, b2, b3, b4, b5), (c0, c1, c2, c3, c4, c5) = \
            _COEFS[self.variant]
        al0 = (a0 + a1 * T) + a2 * S
        p0 = (b0 + b4 * S) + T * (b1 + T * (b2 + b3 * T) + b5 * S)
        lam = (c0 + c4 * S) + T * (c1 + T * (c2 + c3 * T) + c5 * S)
        return al0, p0, lam

    def density(self, T, S, p, rho_ref: float = 0.0):
        al0, p0, lam = self._parts(T, S)
        pp = p + p0
        rho = pp / (lam + al0 * pp)
        return rho - rho_ref

    def spec_vol(self, T, S, p, spv_ref: float = 0.0):
        al0, p0, lam = self._parts(T, S)
        pp = p + p0
        return (al0 - spv_ref) + lam / pp

    def density_derivs(self, T, S, p):
        (a0, a1, a2), (b0, b1, b2, b3, b4, b5), (c0, c1, c2, c3, c4, c5) = \
            _COEFS[self.variant]
        al0, p0, lam = self._parts(T, S)
        pp = p + p0
        denom = lam + al0 * pp
        I_denom2 = 1.0 / (denom * denom)
        dp0_dT = b1 + T * (2.0 * b2 + 3.0 * b3 * T) + b5 * S
        dlam_dT = c1 + T * (2.0 * c2 + 3.0 * c3 * T) + c5 * S
        dp0_dS = b4 + b5 * T
        dlam_dS = c4 + c5 * T
        drho_dT = (dp0_dT * denom
                   - pp * (dlam_dT + a1 * pp + al0 * dp0_dT)) * I_denom2
        drho_dS = (dp0_dS * denom
                   - pp * (dlam_dS + a2 * pp + al0 * dp0_dS)) * I_denom2
        return drho_dT, drho_dS

    def compressibility(self, T, S, p):
        al0, p0, lam = self._parts(T, S)
        pp = p + p0
        denom = lam + al0 * pp
        return lam / (denom * denom)


@dataclasses.dataclass(frozen=True)
class WrightEOS(_WrightBase):
    variant: str = "WRIGHT"
    name = "WRIGHT"


@dataclasses.dataclass(frozen=True)
class WrightFullEOS(_WrightBase):
    variant: str = "WRIGHT_FULL"
    name = "WRIGHT_FULL"


@dataclasses.dataclass(frozen=True)
class WrightRedEOS(_WrightBase):
    variant: str = "WRIGHT_RED"
    name = "WRIGHT_RED"
