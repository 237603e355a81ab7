"""Time axes of external data files and their interpolation.

The port's own copy of ``mom6_tpu.framework.interp_external``:
``time_unit_seconds`` and ``find_time`` read a NetCDF-3 variable's time
axis, ``ExternalField`` interpolates stacked time levels linearly to a
model time, wrapping a climatological (modulo) axis, and
``load_external_field`` reads a 2-D (+ time) forcing variable onto the
model grid: every record is loaded once, regridded bilinearly from the
file's own lon/lat where it is not on the grid, halo-padded and stacked
on the device.  The open-boundary segment data, the file wind and
buoyancy forcing and the data override read through it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["ExternalField", "find_time", "load_external_field",
           "time_unit_seconds"]

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
        nt = data.shape[0]
        if nt == 1:
            return data[0]
        if self.period is not None:
            # the first record again at t0 + period
            t = float(np.mod(t - times[0], self.period) + times[0])
            times = np.concatenate([times, [times[0] + self.period]])
        i1 = int(np.clip(np.searchsorted(times, t, side="right"), 1,
                         len(times) - 1))
        t0, t1 = times[i1 - 1], times[i1]
        w = float(np.clip((t - t0) / max(t1 - t0, 1e-30), 0.0, 1.0))
        return (1.0 - w) * data[i1 - 1] + w * data[i1 % nt]

    @property
    def static(self) -> bool:
        return self.data.shape[0] == 1


def _coord_1d(nc, names):
    for n in names:
        if n in nc.variables and np.asarray(nc.variables[n][:]).ndim == 1:
            return np.asarray(nc.variables[n][:], dtype=np.float64)
    return None


def load_external_field(path: str, name: str, grid=None,
                        stagger: str = "T", scale: float = 1.0
                        ) -> ExternalField:
    """The variable ``name`` of ``path`` as an ExternalField on the model
    grid's points of ``stagger`` (T, U or V), on the grid's device and in
    its dtype.  A field of the compute domain's
    shape is halo-padded by edge copies, one of the padded shape is
    taken as it is, and any other is regridded bilinearly from the
    file's 1-D lon/lat.  Without ``grid`` the records are returned as
    read, on the CPU."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as nc:
        if name not in nc.variables:
            raise KeyError(f"variable '{name}' not in {path}; have: "
                           + ", ".join(sorted(nc.variables)))
        var = nc.variables[name]
        taxis, times, period = find_time(nc, var)
        arr = np.array(var[:], dtype=np.float64)
        src_lon = _coord_1d(nc, ("lon", "longitude", "xh", "grid_x_T",
                                 "LON", "x"))
        src_lat = _coord_1d(nc, ("lat", "latitude", "yh", "grid_y_T",
                                 "LAT", "y"))
    if taxis is None:
        arr = arr[None]
    elif taxis != 0:
        arr = np.moveaxis(arr, taxis, 0)
    if arr.ndim != 3:
        raise ValueError(f"{name}: expected 2D(+time) field, got shape "
                         f"{arr.shape}")
    device, dtype = "cpu", torch.float64
    if grid is not None:
        device = grid.mask2dT.device
        H = grid.domain.halo
        nj, ni = (n - 2 * H for n in grid.mask2dT.shape[-2:])
        dst_lon, dst_lat = {"T": (grid.geoLonT, grid.geoLatT),
                            "U": (grid.geoLonCu, grid.geoLatCu),
                            "V": (grid.geoLonCv, grid.geoLatCv),
                            }[stagger.upper()]
        if arr.shape[-2:] == (nj, ni):
            out = torch.from_numpy(np.pad(arr, ((0, 0), (H, H), (H, H)),
                                          mode="edge"))
        elif arr.shape[-2:] == tuple(dst_lon.shape):
            out = torch.from_numpy(arr)
        else:
            if src_lon is None or src_lat is None:
                raise ValueError(
                    f"{name}: shape {arr.shape[-2:]} does not match the "
                    f"({nj},{ni}) compute domain and the file has no 1D "
                    "lon/lat coordinates to regrid from")
            from mom6_torch.initialization.horizontal_regrid import \
                bilinear_regrid
            out = bilinear_regrid(arr, src_lon, src_lat, dst_lon, dst_lat,
                                  device="cpu")
        dtype = grid.mask2dT.dtype
    else:
        out = torch.from_numpy(arr)
    if scale != 1.0:
        out = out * scale
    return ExternalField(
        data=out.to(device=device, dtype=dtype),
        times=np.asarray(times, np.float64), period=period)
