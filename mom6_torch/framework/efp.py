"""Order-invariant (reproducing) global sums via extended fixed point.

Counterpart of ``mom6_tpu.framework.efp`` on int64 tensors: each
float64 value is decomposed exactly into ``NLIMB`` signed int64 limbs in
base ``2**LIMB_BITS`` (limb 0 the least significant, scale
``2**EXP_MIN``); integer limb sums are associative, so any summation
order on the card or the CPU gives the same limbs, bit for bit the
limbs of the JAX package for the same input.  The limbs→float
reconstruction is exact Python big-int arithmetic on the host.

The port has int64 on every device, so a float32 field is summed by
widening it to float64 first, which is exact.  The JAX package's
``efp_sum32`` (its int32 path for a TPU without 64-bit integers) is not
needed and not ported.

Dynamic range: values with ``|x| < 2**EXP_MAX`` are represented with an
absolute resolution of ``2**EXP_MIN``; larger magnitudes are clamped.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NLIMB", "efp_sum", "efp_sum_layers", "efp_to_float",
           "efp_limbs_to_float_ingraph"]

NLIMB = 6
LIMB_BITS = 32
EXP_MIN = -116                     # scale of limb 0 = 2**EXP_MIN
EXP_MAX = EXP_MIN + NLIMB * LIMB_BITS   # 76: max representable magnitude


def _limbs(x: torch.Tensor, dims) -> torch.Tensor:
    """(NLIMB, ...) int64 limb sums of float64 ``x`` over ``dims``."""
    lim = 2.0 ** (EXP_MAX - 1)
    x = torch.clamp(x.to(torch.float64), -lim, lim)
    # decompose |x| and carry the sign on the limbs: flooring a negative
    # value at a scale larger than |x| would give q = -1 and a remainder
    # ~scale whose low bits fall below float64 precision
    sign = torch.where(x < 0, -1, 1).to(torch.int64)
    r = torch.abs(x)
    limbs = []
    for l in range(NLIMB - 1, -1, -1):
        scale = 2.0 ** (EXP_MIN + LIMB_BITS * l)
        q = torch.floor(r / scale)
        r = r - q * scale
        # each element becomes int64 before the sum: a float64 sum of
        # many limbs of magnitude ~2**32 would leave the exact range
        limbs.append(torch.sum(sign * q.to(torch.int64), dim=dims))
    return torch.stack(limbs[::-1])


def efp_sum(x: torch.Tensor, mask: torch.Tensor | None = None
            ) -> torch.Tensor:
    """int64[NLIMB] limbs of the sum of ``x`` (optionally times the 0/1
    ``mask``)."""
    x = x.to(torch.float64)
    if mask is not None:
        x = x * mask.to(x.dtype)
    return _limbs(x, tuple(range(x.ndim)))


def efp_sum_layers(x: torch.Tensor) -> torch.Tensor:
    """Per-layer sums: (nk, nj, ni) → int64[NLIMB, nk] limbs."""
    return _limbs(x, tuple(range(1, x.ndim)))


def efp_limbs_to_float_ingraph(limbs: torch.Tensor) -> torch.Tensor:
    """Limbs → float64 on the limbs' device: a fixed-order weighted sum
    of the limbs, so the result is as order-invariant as the limbs."""
    tot = torch.zeros(limbs.shape[1:], dtype=torch.float64,
                      device=limbs.device)
    for l in range(NLIMB - 1, -1, -1):
        tot = tot + limbs[l].to(torch.float64) * 2.0 ** (
            EXP_MIN + LIMB_BITS * l)
    return tot


def efp_to_float(limbs) -> float:
    """Exact limbs → float64 on the host (Python big-int arithmetic)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    limbs = np.asarray(limbs)
    total = 0
    for l in range(NLIMB):
        total += int(limbs[l]) << (LIMB_BITS * l)
    return float(total) * (2.0 ** EXP_MIN)
