"""Offline tracer transport (counterpart of ``mom6_tpu.tracer.offline``):
tracers advanced from stored mass transports and end-of-interval
thicknesses, e.g. an earlier online run's, without the dynamics, the
usual way to spin up BGC tracers.  Each offline step advects with the
interval's transports, diffuses vertically with stored diffusivities
when given, then runs the registry's column functions."""

from __future__ import annotations

import dataclasses

from mom6_torch.core.grid import Grid
from mom6_torch.tracer.advect import TracerAdvectCfg, advect_tracers
from mom6_torch.tracer.vertdiff import tracer_vertdiff

__all__ = ["OfflineCfg", "step_offline"]


@dataclasses.dataclass(frozen=True)
class OfflineCfg:
    tracer_adv: TracerAdvectCfg = TracerAdvectCfg(n_sweep_pairs=3)
    dt_offline: float = 86400.0


def step_offline(domain, grid: Grid, tracers: dict, h_end, uhtr, vhtr,
                 kd_int, cfg: OfflineCfg, registry=None,
                 x_first: bool = True):
    """One offline step.  ``uhtr``/``vhtr`` are the transports [m3]
    accumulated over ``cfg.dt_offline`` and ``h_end`` the thickness at
    the interval's end (the thickness before the transports is
    reconstructed inside ``advect_tracers``); ``kd_int`` (nk+1, ...) the
    interface diffusivities or None.  Returns (tracers, h_end)."""
    tracers = domain.fill_halos(tracers, width=2)
    h_end, uhtr, vhtr = domain.fill_halos((h_end, uhtr, vhtr), width=2)
    tracers, h_end, _resid = advect_tracers(domain, grid, tracers, h_end,
                                            uhtr, vhtr, cfg.tracer_adv,
                                            x_first=x_first)
    if kd_int is not None:
        tracers = {k: tracer_vertdiff(v, h_end, kd_int, cfg.dt_offline)
                   for k, v in tracers.items()}
    if registry is not None:
        tracers = registry.apply_column_fns(tracers, h_end, cfg.dt_offline)
    return tracers, h_end
