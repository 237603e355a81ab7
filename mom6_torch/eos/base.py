"""EOS interface (counterpart of ``mom6_tpu.eos.base``): density and
specific volume with first and second derivatives; derivatives a
subclass does not write out come from forward-mode ``torch.func.jvp``,
as the JAX package takes them from ``jax.jvp``."""

from __future__ import annotations

import torch

__all__ = ["EOS"]


def _jvp(fn, x):
    """d fn / dx along a unit tangent, elementwise."""
    return torch.func.jvp(fn, (x,), (torch.ones_like(x),))[1]


class EOS:
    """Base equation of state: rho(T, S, p)."""

    name = "?"

    def density(self, T, S, p, rho_ref: float = 0.0):
        """In-situ density [kg m-3] minus ``rho_ref``."""
        raise NotImplementedError

    def spec_vol(self, T, S, p, spv_ref: float = 0.0):
        return 1.0 / self.density(T, S, p) - spv_ref

    def density_derivs(self, T, S, p):
        """(drho_dT, drho_dS), by forward-mode autodiff unless
        overridden."""
        return (_jvp(lambda t: self.density(t, S, p), T),
                _jvp(lambda s: self.density(T, s, p), S))

    def compressibility(self, T, S, p):
        """drho_dp [s2 m-2], by autodiff unless overridden."""
        return _jvp(lambda q: self.density(T, S, q), p)

    def density_second_derivs(self, T, S, p):
        """(drho_dS_dS, drho_dS_dT, drho_dT_dT, drho_dS_dP, drho_dT_dP)
        by nested forward-mode autodiff of ``density``."""
        def dT(t, s, q):
            return _jvp(lambda tt: self.density(tt, s, q), t)

        def dS(t, s, q):
            return _jvp(lambda ss: self.density(t, ss, q), s)

        return (_jvp(lambda s: dS(T, s, p), S),
                _jvp(lambda t: dS(t, S, p), T),
                _jvp(lambda t: dT(t, S, p), T),
                _jvp(lambda q: dS(T, S, q), p),
                _jvp(lambda q: dT(T, S, q), p))
