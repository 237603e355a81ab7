"""NetCDF-3 fields read and written through ``scipy.io.netcdf_file``.

The port's own copy of the part of ``mom6_tpu.framework.io`` that it
needs: ``read_field`` (the TOPO_AT_VEL file of SUBGRID_TOPO_AT_VEL, the
open-boundary segment data) and ``write_fields`` for the files a run
makes itself, with named dimensions and attributes where asked.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_field", "write_fields"]


def read_field(path: str, name: str) -> np.ndarray:
    """The variable ``name`` of a NetCDF-3 file, in native byte order."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r") as nc:
        if name not in nc.variables:
            raise KeyError(f"variable '{name}' not in {path}; available: "
                           + ", ".join(sorted(nc.variables)))
        arr = np.array(nc.variables[name][:])
    return arr.astype(arr.dtype.newbyteorder("="))


def write_fields(path: str, fields: dict,
                 dims: dict | None = None,
                 attrs: dict | None = None) -> None:
    """Named arrays to a NetCDF-3 file.  ``dims`` names a field's
    dimensions (a time axis must be called ``time`` for the readers to
    find it); every other extent gets one generated dimension.
    ``attrs`` gives a field's attributes (``units``, ``long_name``)."""
    from scipy.io import netcdf_file
    dims = dims or {}
    attrs = attrs or {}
    with netcdf_file(path, "w") as nc:
        made = {}
        for name, arr in fields.items():
            arr = np.asarray(arr)
            want = dims.get(name, ())
            names = []
            for ax, n in enumerate(arr.shape):
                if ax < len(want):
                    dn = want[ax]
                    if dn not in nc.dimensions:
                        nc.createDimension(dn, n)
                else:
                    if n not in made:
                        made[n] = f"dim_{len(made)}_{n}"
                        nc.createDimension(made[n], n)
                    dn = made[n]
                names.append(dn)
            var = nc.createVariable(name, arr.dtype.newbyteorder("="),
                                    tuple(names))
            var[:] = arr
            for k, v in attrs.get(name, {}).items():
                setattr(var, k, v.encode() if isinstance(v, str) else v)
