"""Diagnostics mediator: registration, time averaging, file output.

Counterpart of ``mom6_tpu.framework.diag`` (MOM_diag_mediator and the
FMS ``diag_table`` dialect: a title line, a base-date line, then file and
field lines).  Fields are copied to the host when posted; everything
after that is the JAX package's numpy code, so the two packages write
the same files from the same posts.  ``flush`` writes the time means and
the last snapshots to a NetCDF-3 file (``scipy.io.netcdf_file``), or,
under DIAG_AS_CHKSUM, appends one line per post to ``chksum_diag``:
``module.name: mean= min= max= bits=`` with the statistics of the finite
values in ``.17g`` and the bit count of the ``nan_to_num`` bytes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from mom6_torch.parallel.domain import Domain

__all__ = ["DiagMediator", "parse_diag_table"]


def _host(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def parse_diag_table(text: str):
    """FMS diag_table → (title, files: {name: freq}, fields: list of
    (module, field, outname, file, time_method))."""
    lines = [ln.strip() for ln in text.splitlines()
             if ln.strip() and not ln.strip().startswith("#")]
    title = lines[0].strip('"') if lines else "diag"
    files: dict[str, dict] = {}
    fields = []
    for ln in lines[1:]:
        parts = [p.strip().strip('"') for p in ln.split(",")]
        if len(parts) >= 6 and parts[0] and not parts[0][0].isdigit():
            if parts[1].lstrip("-").isdigit():
                # file line: "name", freq, "units", ...
                files[parts[0]] = {"freq": int(parts[1])}
            else:
                # field line: "module","field","outname","file","all","mean|none"...
                fields.append((parts[0], parts[1], parts[2], parts[3],
                               parts[5] if len(parts) > 5 else "none"))
    return title, files, fields


@dataclasses.dataclass
class _DiagField:
    id: int
    module: str
    name: str
    units: str
    longname: str
    requested: bool
    time_method: str = "none"       # "mean" or "none" (point)
    accum: Optional[np.ndarray] = None
    weight: float = 0.0
    # cell measure (area [m2]) + land mask attached at registration
    # (the reference's axes_grp cell measures / masks,
    # MOM_diag_mediator.F90:3275+); both on the computational domain
    area: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    # horizontal downsample factor (the reference's ^N diag files)
    downsample: int = 1
    # 'mean' (intensive, area-weighted) or 'sum' (extensive) coarsening
    cell_method: str = "mean"


class DiagMediator:
    """Register/post named diagnostics; write netCDF-3 or checksums."""

    def __init__(self, domain: Domain, directory: str = ".",
                 diag_table_text: str | None = None,
                 as_chksum: bool = False):
        self.domain = domain
        self.directory = directory
        self.as_chksum = as_chksum
        self._fields: dict[int, _DiagField] = {}
        self._byname: dict[tuple, int] = {}
        self._next_id = 1
        self._requested = None          # None → request everything
        self._snapshots: dict[str, list] = {}
        if diag_table_text is not None:
            _, _, entries = parse_diag_table(diag_table_text)
            self._requested = {(m, f): (out, meth)
                               for m, f, out, _file, meth in entries}
        self._chksum_lines: list[str] = []

    # -- registration (register_diag_field) ---------------------------
    def register(self, module: str, name: str, units: str = "",
                 longname: str = "", area=None, mask=None,
                 downsample: int = 1, cell_method: str = "mean") -> int:
        """``area``/``mask``: cell measure [m2] and 0/1 land mask on
        the computational domain (halo-padded arrays accepted) —
        masked points are excluded from means and written as NaN;
        ``downsample``: horizontal coarsening factor (the reference's
        ^N downsampled diag files); ``cell_method``: 'mean' coarsens
        area-weighted (intensive), 'sum' conserves totals
        (extensive)."""
        key = (module, name)
        if key in self._byname:
            return self._byname[key]
        requested = (self._requested is None
                     or key in self._requested)
        meth = "none"
        if self._requested is not None and key in self._requested:
            meth = self._requested[key][1]
        fid = self._next_id if requested else -1
        if requested:
            self._next_id += 1

            def _int2d(a):
                if a is None:
                    return None
                a = _host(a)
                d = self.domain
                if a.shape[-2:] == (d.njh, d.nih):
                    a = d.interior(a)
                return np.asarray(a, np.float64)

            self._fields[fid] = _DiagField(
                id=fid, module=module, name=name, units=units,
                longname=longname, requested=True, time_method=meth,
                area=_int2d(area), mask=_int2d(mask),
                downsample=max(1, int(downsample)),
                cell_method=cell_method)
            self._byname[key] = fid
        return fid

    @staticmethod
    def _coarsen(arr, n: int, area, mask, method: str):
        """Horizontal downsample by factor n (downsample_diag_field,
        MOM_diag_mediator.F90): area-and-mask-weighted block means for
        intensive fields, block sums for extensive ones."""
        nj, ni = arr.shape[-2], arr.shape[-1]
        njc, nic = nj // n, ni // n
        a = arr[..., :njc * n, :nic * n].reshape(
            arr.shape[:-2] + (njc, n, nic, n))
        w = np.ones((nj, ni)) if area is None else area
        if mask is not None:
            w = w * mask
        w = w[:njc * n, :nic * n].reshape(njc, n, nic, n)
        a = np.where(w > 0, np.nan_to_num(a), 0.0)  # masked = NaN·0
        if method == "sum":
            return a.sum(axis=(-3, -1))
        ws = w.sum(axis=(-3, -1))
        return (a * w).sum(axis=(-3, -1)) / np.where(ws > 0, ws,
                                                     np.nan)

    # -- posting (post_data) ------------------------------------------
    def post(self, fid: int, data, weight: float = 1.0):
        if fid <= 0:
            return
        f = self._fields[fid]
        arr = _host(self.domain.interior(data))
        if f.mask is not None and arr.shape[-2:] == f.mask.shape:
            arr = np.where(f.mask > 0, arr, np.nan)
        if f.downsample > 1:
            arr = self._coarsen(arr, f.downsample, f.area, f.mask,
                                f.cell_method)
        if self.as_chksum:
            finite = arr[np.isfinite(arr)]
            if finite.size == 0:      # fully-masked field: all zeros
                finite = np.zeros(1, arr.dtype)
            bits = int(np.unpackbits(np.frombuffer(
                np.nan_to_num(arr).tobytes(), dtype=np.uint8)).sum())
            self._chksum_lines.append(
                f"{f.module}.{f.name}: mean={finite.mean():.17g} "
                f"min={finite.min():.17g} max={finite.max():.17g} "
                f"bits={bits}")
            return
        if f.time_method == "mean":
            if f.accum is None:
                f.accum = weight * np.nan_to_num(
                    arr.astype(np.float64))
            else:
                f.accum = f.accum + weight * np.nan_to_num(arr)
            f.weight += weight
        else:
            self._snapshots.setdefault(f"{f.module}.{f.name}", []).append(arr)

    def area_mean(self, fid: int, data) -> float:
        """Area-weighted, mask-aware spatial mean of a 2D field using
        the field's registered cell measure (the axes-grp area
        weighting of post-processed reference diagnostics)."""
        f = self._fields[fid]
        arr = _host(self.domain.interior(data))
        w = np.ones_like(arr) if f.area is None else f.area
        if f.mask is not None:
            w = w * f.mask
        return float((arr * w).sum() / max(w.sum(), 1e-300))

    # -- output --------------------------------------------------------
    def flush(self, filename: str = "diags.nc", time_value: float = 0.0):
        """Write accumulated means + snapshots; reset accumulators."""
        if self.as_chksum:
            path = os.path.join(self.directory, "chksum_diag")
            with open(path, "a") as fh:
                for ln in self._chksum_lines:
                    fh.write(ln + "\n")
            self._chksum_lines.clear()
            return path
        from scipy.io import netcdf_file
        path = os.path.join(self.directory, filename)
        with netcdf_file(path, "w") as nc:
            nc.createDimension("time", 1)
            tv = nc.createVariable("time", "d", ("time",))
            tv[:] = [time_value]
            dims_known: dict[tuple, tuple] = {}

            def ncdims(shape):
                if shape in dims_known:
                    return dims_known[shape]
                names = []
                for ax, n in enumerate(shape):
                    nm = f"dim{len(dims_known)}_{ax}"
                    nc.createDimension(nm, n)
                    names.append(nm)
                dims_known[shape] = tuple(names)
                return dims_known[shape]

            for f in self._fields.values():
                if f.accum is not None and f.weight > 0:
                    mean = f.accum / f.weight
                    var = nc.createVariable(
                        f"{f.module}_{f.name}", "d",
                        ("time",) + ncdims(mean.shape))
                    var[0] = mean
                    var.units = f.units.encode()
                    f.accum, f.weight = None, 0.0
            for name, snaps in self._snapshots.items():
                arr = snaps[-1]
                var = nc.createVariable(
                    name.replace(".", "_"), "d",
                    ("time",) + ncdims(arr.shape))
                var[0] = arr
            self._snapshots.clear()
        return path
