"""Trivariate polynomials of the equations of state as a few launches.

The Roquet and TEOS-10 fits are sums of 55 to 75 terms
``c_ijk x^i y^j z^k``.  Summed term by term in eager PyTorch that is
about seven kernels a term.  Here the powers of y and z are built once,
the products ``y^j z^k`` of the (j, k) pairs that occur are stacked, one
matrix product with the coefficients gives the polynomial of each power
of x, and Horner's rule in x adds them up: about twenty kernels a call,
whatever the number of terms.  The order of the sums differs from the
term-by-term form, so results agree with it to rounding, not bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch._C._functorch import maybe_current_level

__all__ = ["Poly3"]


class Poly3:
    """``sum c_ijk x^i y^j z^k`` over the keys (i, j, k) of ``coefs``;
    ``y`` is a tensor, ``x`` and ``z`` tensors or numbers that broadcast
    against it."""

    def __init__(self, coefs: dict):
        n_x = max(i for i, _, _ in coefs) + 1
        pairs = sorted({(j, k) for _, j, k in coefs})
        mat = np.zeros((n_x, len(pairs)))
        for (i, j, k), c in coefs.items():
            mat[i, pairs.index((j, k))] += c
        self._mat = mat
        self._j = np.array([j for j, _ in pairs])
        self._k = np.array([k for _, k in pairs])
        self._cache = {}

    def _consts(self, like: torch.Tensor):
        """The coefficient matrix and the (j, k) indices on ``like``'s
        device, kept per dtype and device.  A tensor made inside a
        ``torch.func`` transform belongs to it, so they are kept only
        when made outside one."""
        key = (like.dtype, like.device)
        if key in self._cache:
            return self._cache[key]
        consts = tuple(torch.as_tensor(a, dtype=t, device=like.device)
                       for a, t in ((self._mat, like.dtype),
                                    (self._j, torch.long),
                                    (self._k, torch.long)))
        if maybe_current_level() is None:
            self._cache[key] = consts
        return consts

    @staticmethod
    def _powers(v, n: int):
        pw = [torch.ones_like(v)]
        for _ in range(1, n):
            pw.append(pw[-1] * v)
        return torch.stack(pw, dim=0)

    def __call__(self, x, y, z):
        x, z = (torch.as_tensor(v, dtype=y.dtype, device=y.device)
                for v in (x, z))
        x, y, z = torch.broadcast_tensors(x, y, z)
        mat, jidx, kidx = self._consts(y)
        mono = (self._powers(y, int(self._j.max()) + 1)[jidx]
                * self._powers(z, int(self._k.max()) + 1)[kidx])
        g = (mat @ mono.reshape(mono.shape[0], -1)).reshape(
            (mat.shape[0],) + tuple(y.shape))
        out = g[-1]
        for i in range(mat.shape[0] - 2, -1, -1):
            out = torch.addcmul(g[i], x, out)
        return out
