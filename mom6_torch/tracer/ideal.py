"""Idealized tracer packages (counterpart of ``mom6_tpu.tracer.ideal``):
the ideal ventilation age, a passive copy of salinity, regional dyes,
the dyed open-boundary tracers, the DOME depth-band dyes, a surface
impulse, a point-source oil tracer with decay and the advection-test
shapes.  Each returns its initial field(s) and registers its metadata,
with a column function where the package has per-step physics."""

from __future__ import annotations

import math

import numpy as np
import torch

from mom6_torch.tracer.registry import TracerMeta, TracerRegistry

__all__ = ["register_ideal_age", "register_pseudo_salt",
           "register_regional_dye", "register_dyed_obc_tracers",
           "register_dome_tracers", "register_boundary_impulse",
           "register_oil_tracer", "register_advection_test",
           "age_column"]

_YEAR = 365.0 * 86400.0


def _set_top(tr, top):
    """``tr`` with its surface layer replaced by ``top``."""
    return torch.cat([top.expand_as(tr[:1]), tr[1:]], dim=0)


def age_column(tr, h, dt, **ctx):
    """The age tracer's column physics: every cell ages by dt [years],
    the surface layer is reset to 0 (ideal_age_example)."""
    tr = tr + dt / _YEAR
    return torch.cat([torch.zeros_like(tr[:1]), tr[1:]], dim=0)


def register_ideal_age(reg: TracerRegistry, shape, *, device,
                       dtype: torch.dtype) -> torch.Tensor:
    """Register the ideal age [years]; returns its zero initial field."""
    reg.register(TracerMeta(name="age", longname="ideal age", units="yr",
                            column_fn=age_column))
    return torch.zeros(shape, device=device, dtype=dtype)


def register_pseudo_salt(reg: TracerRegistry, S0) -> torch.Tensor:
    """A passive copy of salinity; its drift from S measures spurious
    numerical mixing.  Returns a copy of ``S0``."""
    reg.register(TracerMeta(name="pseudo_salt",
                            longname="passive salinity copy", units="ppt"))
    return S0.clone()


def register_regional_dye(reg: TracerRegistry, grid, shape,
                          lon_range=(0.0, 1e18), lat_range=(0.0, 1e18),
                          name: str = "dye1") -> torch.Tensor:
    """A unit dye in every layer inside a lon/lat box, 0 elsewhere and on
    land."""
    inbox = ((grid.geoLonT >= lon_range[0]) & (grid.geoLonT <= lon_range[1])
             & (grid.geoLatT >= lat_range[0])
             & (grid.geoLatT <= lat_range[1]))
    one = torch.ones(shape, device=grid.mask2dT.device,
                     dtype=grid.mask2dT.dtype)
    reg.register(TracerMeta(name=name, longname="regional dye",
                            units="nondim"))
    return torch.where(inbox[None], 1.0, 0.0) * one * grid.mask2dT


def register_dyed_obc_tracers(reg: TracerRegistry, shape, n_dye: int, *,
                              device, dtype: torch.dtype) -> dict:
    """dye_01..dye_NN, initially zero; each open-boundary segment
    supplies a unit concentration of its own dye."""
    out = {}
    for m in range(1, n_dye + 1):
        name = f"dye_{m:02d}"
        reg.register(TracerMeta(name=name,
                                longname=f"dyed_obc tracer {m:02d}",
                                units="nondim"))
        out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out


def register_dome_tracers(reg: TracerRegistry, shape, n_dye: int = 2, *,
                          device, dtype: torch.dtype) -> dict:
    """DOME-class depth-band dyes: dye d is 1 in its band of nk // n_dye
    layers (the last takes the rest) and 0 elsewhere.  Returns
    {name: field}."""
    nk = shape[0]
    out = {}
    per = max(nk // max(n_dye, 1), 1)
    for d in range(n_dye):
        k0, k1 = d * per, (d + 1) * per if d < n_dye - 1 else nk
        tr = torch.zeros(shape, device=device, dtype=dtype)
        tr[k0:k1] = 1.0
        name = f"dome_dye{d + 1}"
        reg.register(TracerMeta(name=name,
                                longname=f"DOME layer dye {d + 1}",
                                units="nondim"))
        out[name] = tr
    return out


def register_boundary_impulse(reg: TracerRegistry, shape,
                              source_time: float = 31536000.0, *, device,
                              dtype: torch.dtype) -> torch.Tensor:
    """A surface impulse for transit-time distributions: the surface
    layer is held at 1 while the model time is inside the source window
    (IMPULSE_SOURCE_TIME), then released.  Without a time the layer is
    held at 1."""
    def impulse_col(tr, h, dt, t=None, **ctx):
        if t is None:
            return _set_top(tr, torch.ones_like(tr[:1]))
        active = float(t < source_time)
        return _set_top(tr, (active * 1.0 + (1.0 - active) * tr[0])[None])
    reg.register(TracerMeta(name="boundary_impulse",
                            longname="surface impulse", units="nondim",
                            column_fn=impulse_col))
    return torch.zeros(shape, device=device, dtype=dtype)


def register_oil_tracer(reg: TracerRegistry, grid, shape,
                        source_lon: float, source_lat: float,
                        source_k: int = 0, source_rate: float = 1.0,
                        decay_days: float = 0.0,
                        name: str = "oil1") -> torch.Tensor:
    """Point-source oil with first-order decay: OIL_SOURCE_RATE [kg s-1]
    enters the ocean cell nearest (OIL_SOURCE_LONGITUDE,
    OIL_SOURCE_LATITUDE) in layer OIL_SOURCE_LAYER and decays with
    OIL_DECAY_DAYS.  The concentration is kg m-3; the source divides by
    the evolving cell volume, so the injected mass is exact.  The source
    cell is found once, here."""
    lon = grid.geoLonT.detach().cpu().double().numpy()
    lat = grid.geoLatT.detach().cpu().double().numpy()
    mask = grid.mask2dT.detach().cpu().double().numpy()
    d2 = (lon - source_lon) ** 2 + (lat - source_lat) ** 2 \
        + 1e30 * (1.0 - mask)
    jj, ii = np.unravel_index(np.argmin(d2), d2.shape)
    onehot = torch.zeros(shape[1:], device=grid.areaT.device,
                         dtype=grid.areaT.dtype)
    onehot[jj, ii] = 1.0
    gamma = 0.0 if decay_days <= 0.0 else 1.0 / (decay_days * 86400.0)
    k = min(max(source_k, 0), shape[0] - 1)

    def oil_col(tr, h, dt, **ctx):
        tr = tr * math.exp(-gamma * dt)
        dc = (source_rate * dt) / (grid.areaT * torch.clamp(h[k], min=1e-3))
        return torch.cat([tr[:k], (tr[k] + dc * onehot)[None], tr[k + 1:]],
                         dim=0)
    reg.register(TracerMeta(name=name, longname="oil tracer",
                            units="kg m-3", column_fn=oil_col))
    return torch.zeros(shape, device=grid.areaT.device,
                       dtype=grid.areaT.dtype)


def register_advection_test(reg: TracerRegistry, grid, shape,
                            x_origin: float, y_origin: float,
                            x_width: float, y_width: float) -> dict:
    """The advection-test shapes: a flat cylinder (``tr_cyl``) and a
    cosine bell (``tr_bell``) of one footprint, in every layer; origin
    and widths in the grid's axis units."""
    dx = (grid.geoLonT - x_origin) / max(x_width, 1e-30)
    dy = (grid.geoLatT - y_origin) / max(y_width, 1e-30)
    r = torch.sqrt(dx * dx + dy * dy)
    cyl = torch.where(r <= 1.0, 1.0, 0.0) * grid.mask2dT
    bell = torch.where(r <= 1.0, 0.5 * (1.0 + torch.cos(
        math.pi * torch.clamp(r, max=1.0))), 0.0) * grid.mask2dT
    out = {}
    for nm, f2d in (("tr_cyl", cyl), ("tr_bell", bell)):
        reg.register(TracerMeta(name=nm, longname=f"advection test {nm}",
                                units="nondim"))
        out[nm] = f2d[None].expand(shape).clone()
    return out
