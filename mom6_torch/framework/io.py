"""NetCDF-3 fields read and written through ``scipy.io.netcdf_file``.

The port's own copy of the part of ``mom6_tpu.framework.io`` that it
needs: ``read_field``/``read_fields`` (topography, grids, initial and
sponge profiles, forcing, the open-boundary segment data),
``read_attrs`` (a file's global attributes), ``field_names``, and
``write_fields`` for the files a run makes itself, with named
dimensions and attributes where asked.  The decomposed writers of the
JAX package wait for a multi-device port.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_field", "read_fields", "read_attrs", "field_names",
           "write_fields"]


def read_field(path: str, name: str) -> np.ndarray:
    """The variable ``name`` of a NetCDF-3 file, in native byte order."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r") as nc:
        if name not in nc.variables:
            raise KeyError(f"variable '{name}' not in {path}; available: "
                           + ", ".join(sorted(nc.variables)))
        arr = np.array(nc.variables[name][:])
    return arr.astype(arr.dtype.newbyteorder("="))


def read_fields(path: str, names) -> dict:
    """The named variables of a NetCDF-3 file."""
    return {n: read_field(path, n) for n in names}


def read_attrs(path: str) -> dict:
    """The global attributes of a NetCDF-3 file."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r") as nc:
        return dict(nc._attributes)


def field_names(path: str) -> list:
    """The variable names of a NetCDF-3 file, sorted."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r") as nc:
        return sorted(nc.variables)


def write_fields(path: str, fields: dict,
                 dims: dict | None = None,
                 attrs: dict | None = None,
                 global_attrs: dict | None = None) -> None:
    """Named arrays to a NetCDF-3 file.  ``dims`` names a field's
    dimensions (a time axis must be called ``time`` for the readers to
    find it); every other extent gets one generated dimension.
    ``attrs`` gives a field's attributes (``units``, ``long_name``),
    ``global_attrs`` the file's."""
    from scipy.io import netcdf_file
    dims = dims or {}
    attrs = attrs or {}
    with netcdf_file(path, "w") as nc:
        for k, v in (global_attrs or {}).items():
            setattr(nc, k, v.encode() if isinstance(v, str) else v)
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
