"""Time axes of external data files and their interpolation.

The port's own copy of the part of ``mom6_tpu.framework.interp_external``
that the open-boundary segment data needs: ``time_unit_seconds`` and
``find_time`` read a NetCDF-3 variable's time axis, and
``ExternalField`` interpolates stacked time levels linearly to a model
time, wrapping a climatological (modulo) axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["ExternalField", "find_time", "time_unit_seconds"]

_UNIT_S = {
    "s": 1.0, "sec": 1.0, "second": 1.0, "seconds": 1.0,
    "min": 60.0, "minute": 60.0, "minutes": 60.0,
    "h": 3600.0, "hr": 3600.0, "hour": 3600.0, "hours": 3600.0,
    "d": 86400.0, "day": 86400.0, "days": 86400.0,
    "yr": 365.0 * 86400.0, "year": 365.0 * 86400.0,
    "years": 365.0 * 86400.0,
}
_TIME_NAMES = ("time", "Time", "TIME", "t")


def time_unit_seconds(units: str) -> float:
    """Seconds per unit of a CF-style time ``units`` string ("days since
    1900-1-1" -> 86400); the epoch is the run's time origin."""
    word = units.strip().split()[0].lower() if units.strip() else "s"
    return _UNIT_S.get(word, 1.0)


def find_time(nc, var) -> tuple[Optional[int], np.ndarray,
                                Optional[float]]:
    """(axis, times [s], period [s] or None) of the time dimension of
    ``var`` in the open file ``nc``; (None, [0], None) without one."""
    for ax, dname in enumerate(var.dimensions):
        if dname in _TIME_NAMES or dname.lower().startswith("time"):
            period = None
            if dname in nc.variables:
                tv = nc.variables[dname]
                units = getattr(tv, "units", b"")
                if isinstance(units, bytes):
                    units = units.decode()
                mult = time_unit_seconds(units)
                tvals = np.asarray(tv[:], dtype=np.float64) * mult
                modulo = getattr(tv, "modulo", None)
                if modulo is not None:
                    try:
                        period = mult * float(
                            modulo if not isinstance(modulo, bytes)
                            else modulo.decode())
                    except ValueError:
                        # a blank modulo: wrap over the sampled span plus
                        # one mean interval
                        dt = (np.diff(tvals).mean()
                              if tvals.size > 1 else 1.0)
                        period = float(tvals[-1] - tvals[0] + dt)
            else:
                tvals = np.arange(var.shape[ax], dtype=np.float64)
            return ax, tvals, period
    return None, np.zeros(1), None


@dataclasses.dataclass(frozen=True)
class ExternalField:
    """Stacked time levels ``data`` (nt, ...) at ``times`` [s]; with
    ``period`` [s] the axis wraps modulo the period."""
    data: torch.Tensor
    times: np.ndarray
    period: Optional[float] = None

    def at(self, t: float) -> torch.Tensor:
        """Linear interpolation to the model time ``t`` [s]."""
        data, times = self.data, np.asarray(self.times, np.float64)
        if data.shape[0] == 1:
            return data[0]
        if self.period is not None:
            t = float(np.mod(t - times[0], self.period) + times[0])
            times = np.concatenate([times, [times[0] + self.period]])
            data = torch.cat([data, data[:1]], dim=0)
        i1 = int(np.clip(np.searchsorted(times, t, side="right"), 1,
                         len(times) - 1))
        t0, t1 = times[i1 - 1], times[i1]
        w = float(np.clip((t - t0) / max(t1 - t0, 1e-30), 0.0, 1.0))
        return (1.0 - w) * data[i1 - 1] + w * data[i1]
