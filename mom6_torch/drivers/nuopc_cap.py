"""A NUOPC/CMEPS-shaped ocean cap.

Counterpart of ``mom6_tpu.drivers.nuopc_cap``: the interface contract of
the reference's cap (the CMEPS standard field names it advertises, the
advertise, realize, advance and finalize lifecycle, the packing of the
import state and the extraction of the export state), so that a coupler
written in Python drives the ocean as CESM and UFS drive the reference.
The port keeps its own copy of the field names.
"""

from __future__ import annotations

import torch

from mom6_torch.drivers.ocean_model import (IceOceanBoundary,
                                            _step_interval,
                                            extract_surface_state,
                                            ocean_model_init)
from mom6_torch.framework.restart import save_restart
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["MOM6Cap", "IMPORT_FIELDS", "EXPORT_FIELDS"]

# the CMEPS import names the reference's cap advertises
IMPORT_FIELDS = (
    "Fioi_salt", "Foxx_taux", "Foxx_tauy", "Foxx_sen", "Foxx_evap",
    "Foxx_lwnet", "Foxx_swnet_vdr", "Foxx_swnet_vdf",
    "Foxx_swnet_idr", "Foxx_swnet_idf", "Faxa_rain", "Faxa_snow",
    "Sa_pslv", "Foxx_rofl", "Foxx_rofi",
)
# and its export names
EXPORT_FIELDS = (
    "So_omask", "So_t", "So_s", "So_u", "So_v", "So_dhdx", "So_dhdy",
    "Fioo_q", "So_bldepth",
)


class MOM6Cap:
    """advertise -> realize -> (import_fields -> advance ->
    export_fields)* -> finalize."""

    def __init__(self):
        self.model = None
        self._state = None
        self._split = None
        self._tracers = None
        self._iob = IceOceanBoundary()
        self._n0 = 0
        self._frazil = None
        self._mld = None

    def advertise(self) -> dict:
        """The fields the ocean imports and exports."""
        return {"import": list(IMPORT_FIELDS),
                "export": list(EXPORT_FIELDS)}

    def realize(self, param_sources=None, text=None, *, device="cuda",
                dtype: torch.dtype = torch.float64):
        """Build the ocean component (``ocean_model_init``); on ``cuda``
        unless ``device="cpu"``."""
        self.model = ocean_model_init(param_sources, text=text,
                                      device=device, dtype=dtype)
        self._state = self.model.state
        self._split = self.model.split
        self._tracers = self.model.tracers
        return self

    def import_fields(self, fields: dict):
        """Pack the import state: the four shortwave bands summed in
        order, and rain, snow, liquid and frozen runoff summed into
        lprec in that order."""
        g = fields.get
        sw_parts = [g(n) for n in ("Foxx_swnet_vdr", "Foxx_swnet_vdf",
                                   "Foxx_swnet_idr", "Foxx_swnet_idf")]
        sw = None
        if any(p is not None for p in sw_parts):
            sw = sum(p for p in sw_parts if p is not None)
        lprec = g("Faxa_rain")
        for extra in ("Faxa_snow", "Foxx_rofl", "Foxx_rofi"):
            if g(extra) is not None:
                lprec = g(extra) if lprec is None else lprec + g(extra)
        self._iob = IceOceanBoundary(
            u_flux=g("Foxx_taux"), v_flux=g("Foxx_tauy"),
            t_flux=g("Foxx_sen"), q_flux=g("Foxx_evap"), sw_flux=sw,
            lw_flux=g("Foxx_lwnet"), lprec=lprec,
            salt_flux=g("Fioi_salt"), p_surf=g("Sa_pslv"))
        return self

    def advance(self, dt_coupling: float):
        """One coupling interval under the imported fluxes: round
        (dt_coupling / DT) thermodynamic steps (at least one), x_first
        alternating over the cap's whole run; the last step's frazil and
        boundary-layer depth are kept for the export."""
        self._state, self._split, self._tracers, diags, nsteps = \
            _step_interval(self.model, self._iob, self._state, self._split,
                           self._tracers, dt_coupling, self._n0)
        if diags.frazil is not None:
            self._frazil = diags.frazil
        if diags.mld is not None:
            self._mld = diags.mld
        self._n0 += nsteps
        return self

    def export_fields(self) -> dict:
        """The export state: the ocean mask, the surface state, the sea
        level's slopes at h points (the mean of the two faces'
        differences over IdxCu and IdyCv), and the last step's frazil and
        boundary-layer depth (zeros before the first advance or without
        them)."""
        m = self.model
        sfc = extract_surface_state(m, self._state)
        g = m.grid
        eta = sfc.sea_lev
        dhdx = 0.5 * ((ip1(eta) - eta) * g.IdxCu
                      + (eta - im1(eta)) * im1(g.IdxCu)) * g.mask2dT
        dhdy = 0.5 * ((jp1(eta) - eta) * g.IdyCv
                      + (eta - jm1(eta)) * jm1(g.IdyCv)) * g.mask2dT
        zero = torch.zeros_like(eta)
        return {"So_omask": g.mask2dT, "So_t": sfc.sst, "So_s": sfc.sss,
                "So_u": sfc.u, "So_v": sfc.v, "So_dhdx": dhdx,
                "So_dhdy": dhdy,
                "Fioo_q": self._frazil if self._frazil is not None
                else zero,
                "So_bldepth": self._mld if self._mld is not None else zero}

    def finalize(self, path=None):
        """Write the state and split state to the restart ``path`` (in
        the layout either package restores)."""
        if path is not None:
            save_restart(path, {"state": self._state, "split": self._split})
        return self
