"""Field checksums for debugging and invariance tests.

Counterpart of ``mom6_tpu.framework.checksums`` (MOM_checksums): the
statistics of a field over the compute domain, namely the bit count
(the total population count of its IEEE representation, float64 counted
as two 32-bit halves), the minimum, the maximum and the mean.  The bit
count, minimum and maximum equal the JAX package's bit for bit.  The
mean divides the exact sum (``framework/efp.py``) by the point count,
so it is the same on the card and the CPU whatever the summation
order; the JAX package sums in the field's dtype in XLA's order, and
the two means differ by that sum's rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.framework.efp import efp_sum, efp_to_float
from mom6_torch.parallel.domain import Domain

__all__ = ["Chksum", "chksum", "chksum_arrays", "hchksum_str", "is_nan"]


@dataclasses.dataclass(frozen=True)
class Chksum:
    bitcount: int
    vmin: float
    vmax: float
    mean: float

    def __str__(self):
        return (f"bits={self.bitcount} min={self.vmin:.17g} "
                f"max={self.vmax:.17g} mean={self.mean:.17g}")


def popcount32(w):
    """Set bits of each uint32 word held in an int64 tensor."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return (w * 0x01010101 & 0xFFFFFFFF) >> 24


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The total population count of x's IEEE words (int64 scalar)."""
    if x.dtype not in (torch.float64, torch.float32):
        x = x.to(torch.float32)
    words = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.sum(popcount32(words))


def chksum_arrays(domain: Domain, f: torch.Tensor):
    """The checksum's pieces on the field's device: (bitcount, min, max,
    efp limbs of the sum, count)."""
    x = domain.interior(f)
    return _bits(x), torch.min(x), torch.max(x), efp_sum(x), x.numel()


def chksum(domain: Domain, f: torch.Tensor) -> Chksum:
    bc, mn, mx, limbs, n = chksum_arrays(domain, f)
    return Chksum(int(bc), float(mn), float(mx), efp_to_float(limbs) / n)


def hchksum_str(domain: Domain, f: torch.Tensor, name: str) -> str:
    return f"{name}: {chksum(domain, f)}"


def is_nan(domain: Domain, f: torch.Tensor) -> bool:
    return bool(torch.isnan(domain.interior(f)).any())
