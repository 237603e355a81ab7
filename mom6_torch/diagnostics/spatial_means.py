"""Area- and volume-weighted global means.

Counterpart of ``mom6_tpu.diagnostics.spatial_means``: every sum is the
order-invariant extended-fixed-point sum (``framework/efp.py``), so a
mean is the same on the card and on the CPU; on one device there is no
reduction across ranks to add.
"""

from __future__ import annotations

import numpy as np

from mom6_torch.core.grid import Grid
from mom6_torch.framework.efp import efp_sum, efp_to_float
from mom6_torch.parallel.domain import Domain

__all__ = ["global_area_mean", "global_volume_mean", "global_layer_mean"]


def _gsum(x) -> float:
    return efp_to_float(efp_sum(x))


def global_area_mean(domain: Domain, grid: Grid, f2d) -> float:
    w = grid.areaT * grid.mask2dT
    num = _gsum(domain.interior(f2d * w))
    den = _gsum(domain.interior(w))
    return num / max(den, 1e-300)


def global_volume_mean(domain: Domain, grid: Grid, f3d, h) -> float:
    w = grid.areaT * grid.mask2dT
    num = _gsum(domain.interior(f3d * h * w))
    den = _gsum(domain.interior(h * w))
    return num / max(den, 1e-300)


def global_layer_mean(domain: Domain, grid: Grid, f3d, h) -> np.ndarray:
    """Each layer's volume-weighted mean, an (nk,) numpy array."""
    w = grid.areaT * grid.mask2dT
    out = np.zeros(f3d.shape[0])
    for k in range(f3d.shape[0]):
        num = _gsum(domain.interior(f3d[k] * h[k] * w))
        den = _gsum(domain.interior(h[k] * w))
        out[k] = num / max(den, 1e-300)
    return out
