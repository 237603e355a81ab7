"""NetCDF-3 fields read and written through ``scipy.io.netcdf_file``.

The port's own copy of the part of ``mom6_tpu.framework.io`` that it
needs: ``read_field`` (the TOPO_AT_VEL file of SUBGRID_TOPO_AT_VEL) and
a plain ``write_fields`` for the files a run makes itself.
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


def write_fields(path: str, fields: dict) -> None:
    """Named arrays to a NetCDF-3 file, one dimension per distinct
    extent."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "w") as nc:
        dims = {}
        for name, arr in fields.items():
            arr = np.asarray(arr)
            names = []
            for n in arr.shape:
                if n not in dims:
                    dims[n] = f"dim_{len(dims)}_{n}"
                    nc.createDimension(dims[n], n)
                names.append(dims[n])
            var = nc.createVariable(name, arr.dtype.newbyteorder("="),
                                    tuple(names))
            var[:] = arr
