"""Data override: model forcing fields replaced from a ``data_table``.

Counterpart of ``mom6_tpu.framework.data_override`` (the FMS
data_override of MOM6's caps).  A ``data_table`` in the case directory
lists fields to replace by file data, interpolated in time, or by
constants::

    "OCN", "taux",  "u_flux", "INPUT/forcing.nc", .false., 1.0
    "OCN", "sw",    "",       "",                 .false., 50.0

The columns are the grid name, the model field, the file variable, the
file path, the on-grid flag (anything else means bilinear regridding
from the file's lon/lat) and a scale factor.  An empty path means a
constant equal to the factor.  ``DataOverride.mech``/``fluxes`` apply
the overrides at a model time on top of the configured forcing.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from mom6_torch.core.forcing import Fluxes
from mom6_torch.framework.interp_external import (ExternalField,
                                                  load_external_field)

__all__ = ["DataOverride", "parse_data_table"]

_MECH_FIELDS = ("taux", "tauy", "p_surf")
_FLUX_FIELDS = ("sw", "lw", "latent", "sensible", "evap", "lprec",
                "fprec", "salt_flux")
# the model-name aliases of the reference's caps
_ALIASES = {"u_flux": "taux", "v_flux": "tauy", "sw_flux": "sw",
            "lw_flux": "lw", "t_flux": "sensible", "q_flux": "evap",
            "salt_flx": "salt_flux"}


def parse_data_table(text: str) -> list:
    """The data_table's rows as dicts (gridname, field, file_var, path,
    ongrid, factor); lines starting with # are comments."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 6:
            continue
        unq = [re.sub(r'^["\']|["\']$', "", p) for p in parts]
        ongrid = unq[4].lower() in (".true.", "true", "t", ".t.")
        try:
            factor = float(unq[5])
        except ValueError:
            factor = 1.0
        rows.append(dict(gridname=unq[0].upper(), field=unq[1],
                         file_var=unq[2], path=unq[3], ongrid=ongrid,
                         factor=factor))
    return rows


@dataclasses.dataclass
class DataOverride:
    """The overrides of the ocean grid: model field name ->
    ExternalField or constant."""
    fields: dict

    @classmethod
    def build(cls, table_path: str, grid, indir: str = "."
              ) -> Optional["DataOverride"]:
        """The overrides of ``table_path`` on ``grid`` (None without the
        file or without an ocean row of a known field)."""
        if not os.path.exists(table_path):
            return None
        with open(table_path) as fh:
            rows = parse_data_table(fh.read())
        fields = {}
        for r in rows:
            if r["gridname"] not in ("OCN", "OCEAN"):
                continue
            name = _ALIASES.get(r["field"], r["field"])
            if name not in _MECH_FIELDS + _FLUX_FIELDS:
                continue
            if not r["path"]:
                fields[name] = float(r["factor"])
                continue
            path = r["path"]
            if not os.path.isabs(path):
                path = os.path.join(indir, path)
            stag = {"taux": "U", "tauy": "V"}.get(name, "T")
            fields[name] = load_external_field(
                path, r["file_var"] or r["field"], grid=grid, stagger=stag,
                scale=r["factor"])
        return cls(fields=fields) if fields else None

    def _value(self, name, t, like):
        f = self.fields[name]
        if isinstance(f, ExternalField):
            return f.at(t)
        return torch.full_like(like, f)

    def mech(self, forces, t, grid):
        """``forces`` with the mechanical fields overridden at time
        ``t`` [s], masked to their points."""
        repl = {}
        masks = {"taux": grid.mask2dCu, "tauy": grid.mask2dCv,
                 "p_surf": grid.mask2dT}
        for name in _MECH_FIELDS:
            if name in self.fields:
                like = getattr(forces, name)
                if like is None:
                    like = grid.mask2dT * 0.0
                repl[name] = self._value(name, t, like) * masks[name]
        return dataclasses.replace(forces, **repl) if repl else forces

    def fluxes(self, fluxes, t, grid):
        """``fluxes`` (or empty Fluxes) with the buoyancy fields
        overridden at time ``t`` [s], masked to the ocean."""
        if fluxes is None:
            fluxes = Fluxes()
        repl = {}
        for name in _FLUX_FIELDS:
            if name in self.fields:
                like = getattr(fluxes, name)
                if like is None:
                    like = grid.mask2dT * 0.0
                repl[name] = self._value(name, t, like) * grid.mask2dT
        return dataclasses.replace(fluxes, **repl) if repl else fluxes
