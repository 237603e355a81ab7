"""Horizontal regridding of lat-lon source data onto the model grid.

Counterpart of ``mom6_tpu.initialization.horizontal_regrid`` (MOM6's
MOM_horizontal_regridding): bilinear interpolation from a regular source
grid with nearest-edge extrapolation outside its extent, and the fill of
masked (land or missing-value) source points, first by creeping values
in from valid neighbours and then by Laplacian relaxation of the filled
points.  Both run once at initialization, on tensors of ``device`` in
float64 with the JAX package's operand order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bilinear_regrid", "fill_missing"]

_F64 = torch.float64


def _as64(a, device):
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=_F64, device=device)


def _nbrs(a: torch.Tensor, const: float = 0.0):
    """(E, W, N, S) neighbours of (..., ny, nx), padded with ``const``
    outside the domain (closed edges)."""
    ap = torch.nn.functional.pad(a, (1, 1, 1, 1), value=const)
    return (ap[..., 1:-1, 2:], ap[..., 1:-1, :-2],
            ap[..., 2:, 1:-1], ap[..., :-2, 1:-1])


# the Laplacian relaxation of filled points: its coefficient, the
# largest change at which it stops, and its most passes
_RELAX, _TOL, _N_ITER = 0.25, 1e-8, 10000


def fill_missing(field, valid, *, device="cuda") -> torch.Tensor:
    """Missing points of ``field`` (where ``valid`` is False) filled:
    each pass, a missing point next to valid ones takes the mean of
    those, until none is left or no more can be reached (those take the
    mean of the valid data); then the filled points relax by Laplacian
    smoothing, the valid data held fixed, until the largest change is at
    most 1e-8 or after 10,000 passes."""
    f = _as64(field, device)
    valid = torch.as_tensor(np.asarray(valid) if not torch.is_tensor(valid)
                            else valid, device=device).bool().expand(f.shape)
    if bool(valid.all()):
        return f
    if not bool(valid.any()):
        raise ValueError("fill_missing: no valid source points")
    fill = ~valid
    zero = torch.zeros((), dtype=_F64, device=device)
    f = torch.where(valid, f, zero)

    # creeping fill
    good = valid.clone()
    remaining = fill.clone()
    for _ in range(f.shape[-1] + f.shape[-2]):
        if not bool(remaining.any()):
            break
        gE, gW, gN, gS = _nbrs(good.to(_F64))
        fE, fW, fN, fS = _nbrs(f)
        ngood = (gE + gW) + (gN + gS)
        nb = ((gE * fE + gW * fW) + (gN * fN + gS * fS)) \
            / torch.clamp(ngood, min=1.0)
        newly = remaining & (ngood > 0)
        f = torch.where(newly, nb, f)
        good = good | newly
        remaining = remaining & ~newly
    if bool(remaining.any()):
        # cut off from all valid data
        f = torch.where(remaining, f[valid].mean(), f)

    # Laplacian relaxation of the filled points
    wE, wW, wN, wS = _nbrs(torch.ones_like(f))
    wsum = (wS + wN) + (wW + wE)
    for _ in range(_N_ITER):
        fE, fW, fN, fS = _nbrs(f)
        chg = _RELAX * (((wS * fS + wN * fN) + (wW * fW + wE * fE))
                        - wsum * f)
        chg = torch.where(fill, chg, zero)
        f = f + chg
        if float(chg.abs().max()) <= _TOL:
            break
    return f


def _axis_weights(src_c: np.ndarray, dst_c: np.ndarray):
    n = src_c.size
    if n == 1:
        i0 = np.zeros(dst_c.shape, np.intp)
        return i0, i0, np.zeros(dst_c.shape)
    sign = 1.0 if src_c[-1] >= src_c[0] else -1.0
    c = sign * src_c
    d = sign * dst_c
    i1 = np.clip(np.searchsorted(c, d), 1, n - 1)
    i0 = i1 - 1
    w = (d - c[i0]) / (c[i1] - c[i0])
    return i0, i1, np.clip(w, 0.0, 1.0)


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().to("cpu", _F64).numpy()
    return np.asarray(a, np.float64)


def bilinear_regrid(src, src_lon, src_lat, dst_lon, dst_lat, *,
                    device=None) -> torch.Tensor:
    """Bilinear interpolation of ``src`` (..., ny, nx), sampled at the
    monotonic 1-D ``src_lon``/``src_lat``, to the points
    ``dst_lon``/``dst_lat`` (broadcast to one 2-D shape); points outside
    the source extent take the nearest edge.  The weights are computed
    on the host, the sums on ``device`` (default: the device of ``src``
    when it is a tensor, else the CPU)."""
    if device is None:
        device = src.device if torch.is_tensor(src) else "cpu"
    s = _as64(src, device)
    dlon, dlat = np.broadcast_arrays(_host(dst_lon), _host(dst_lat))
    ix0, ix1, wx = _axis_weights(_host(src_lon), dlon)
    iy0, iy1, wy = _axis_weights(_host(src_lat), dlat)
    t = [torch.as_tensor(a, device=device) for a in (ix0, ix1, iy0, iy1)]
    wx, wy = _as64(wx, device), _as64(wy, device)
    f00, f01 = s[..., t[2], t[0]], s[..., t[2], t[1]]
    f10, f11 = s[..., t[3], t[0]], s[..., t[3], t[1]]
    return ((1 - wy) * ((1 - wx) * f00 + wx * f01)
            + wy * ((1 - wx) * f10 + wx * f11))
