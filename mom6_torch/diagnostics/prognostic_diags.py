"""The standard prognostic diagnostics: registration and posting.

Counterpart of ``mom6_tpu.diagnostics.prognostic_diags``: u, v, h, temp,
salt, SSH and KE under the module ``ocean_model``, their ``_z``
variants remapped onto NK_ZSPACE uniform z levels down to the deepest
column (``framework/diag_remap.py``; u and v with face-averaged
thicknesses) and the ``_rho`` variants on the vertical grid's target
densities.  The solo driver posts them at each stats interval; a field
the diag_table does not ask for costs nothing (its id is -1).
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.ale.remapping import remap_column_means
from mom6_torch.framework.diag import DiagMediator
from mom6_torch.framework.diag_remap import (DiagRemapCfg,
                                             build_rho_thickness,
                                             build_z_thickness, remap_to_z)
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["PrognosticDiags"]

MODULE = "ocean_model"


@dataclasses.dataclass
class PrognosticDiags:
    med: DiagMediator
    remap_cfg: DiagRemapCfg | None = None
    _h_z: torch.Tensor | None = None
    _ids: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(med: DiagMediator, grid, vgrid, max_depth: float,
               nz_diag: int | None = None) -> "PrognosticDiags":
        cfg = DiagRemapCfg.uniform(nz_diag or max(vgrid.nk, 1), max_depth)
        d = PrognosticDiags(med=med, remap_cfg=cfg,
                            _h_z=build_z_thickness(cfg, grid.bathyT))
        r = med.register
        ids = d._ids
        ids["u"] = r(MODULE, "u", "m s-1", "Zonal velocity")
        ids["v"] = r(MODULE, "v", "m s-1", "Meridional velocity")
        ids["h"] = r(MODULE, "h", "m", "Layer thickness")
        ids["temp"] = r(MODULE, "temp", "degC", "Potential temperature")
        ids["salt"] = r(MODULE, "salt", "psu", "Salinity")
        ids["SSH"] = r(MODULE, "SSH", "m", "Sea surface height")
        ids["KE"] = r(MODULE, "KE", "m2 s-2", "Kinetic energy per mass")
        for nm in ("u_z", "v_z", "temp_z", "salt_z"):
            ids[nm] = r(MODULE, nm, "", nm + " on z levels")
        for nm in ("temp_rho", "salt_rho", "h_rho"):
            ids[nm] = r(MODULE, nm, "", nm + " on rho layers")
        return d

    def any_requested(self) -> bool:
        return any(fid > 0 for fid in self._ids.values())

    def post_state(self, grid, vgrid, state, weight: float = 1.0, eos=None):
        """Post the prognostic fields of one diag interval."""
        ids, med = self._ids, self.med
        med.post(ids["u"], state.u, weight)
        med.post(ids["v"], state.v, weight)
        med.post(ids["h"], state.h, weight)
        if state.T is not None:
            med.post(ids["temp"], state.T, weight)
            med.post(ids["salt"], state.S, weight)
        med.post(ids["SSH"], torch.sum(state.h, dim=0) - grid.bathyT,
                 weight)
        if ids["KE"] > 0:
            u2 = 0.5 * (state.u ** 2 + im1(state.u) ** 2)
            v2 = 0.5 * (state.v ** 2 + jm1(state.v) ** 2)
            med.post(ids["KE"], 0.5 * (u2 + v2), weight)
        h, h_z = state.h, self._h_z
        zfields = {"u_z": (state.u, 0.5 * (h + ip1(h)),
                           0.5 * (h_z + ip1(h_z))),
                   "v_z": (state.v, 0.5 * (h + jp1(h)),
                           0.5 * (h_z + jp1(h_z)))}
        if state.T is not None:
            zfields.update(temp_z=(state.T, h, h_z),
                           salt_z=(state.S, h, h_z))
        for nm, (f, hsrc, hdst) in zfields.items():
            if ids[nm] > 0:
                med.post(ids[nm], remap_to_z(f, hsrc, hdst, self.remap_cfg),
                         weight)
        want_rho = any(ids[nm] > 0 for nm in ("temp_rho", "salt_rho",
                                              "h_rho"))
        if want_rho and state.T is not None and eos is not None \
                and vgrid.Rlay is not None:
            h_rho = build_rho_thickness(vgrid.Rlay, h, grid.bathyT,
                                        state.T, state.S, eos,
                                        rho0=vgrid.Rho0, g=vgrid.g_Earth)
            for nm, f in (("temp_rho", state.T), ("salt_rho", state.S)):
                if ids[nm] > 0:
                    out = remap_column_means(h, f, h_rho + 1e-30,
                                             self.remap_cfg.remap)
                    med.post(ids[nm], torch.where(
                        h_rho > 1e-6, out, torch.full_like(out,
                                                           float("nan"))),
                        weight)
            if ids["h_rho"] > 0:
                med.post(ids["h_rho"], h_rho, weight)
