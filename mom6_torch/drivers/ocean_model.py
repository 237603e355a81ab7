"""The coupled model's ocean component.

Counterpart of ``mom6_tpu.drivers.ocean_model``: the lifecycle a
coupler drives (``ocean_model_init``, ``update_ocean_model``), the
conversion of the ice-ocean boundary fluxes into the step's forcing,
and ``extract_surface_state``, the SST, SSS, surface currents and sea
level exported to the coupler.  The model runs on ``cuda`` unless the
caller passes ``device="cpu"``, and raises when there is no card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.orchestrator import step_ocean
from mom6_torch.core.pressure_force import interface_heights
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import Model, build_model
from mom6_torch.parallel.stencil import im1, jm1

__all__ = ["IceOceanBoundary", "SurfaceState", "ocean_model_init",
           "update_ocean_model", "extract_surface_state"]


@dataclasses.dataclass(frozen=True)
class IceOceanBoundary:
    """The fluxes a coupler hands the ocean: halo-padded (njh, nih)
    tensors or None."""
    u_flux: Optional[torch.Tensor] = None     # zonal stress [Pa]
    v_flux: Optional[torch.Tensor] = None     # meridional stress [Pa]
    t_flux: Optional[torch.Tensor] = None     # sensible heat [W m-2]
    q_flux: Optional[torch.Tensor] = None     # evaporation [kg m-2 s-1]
    sw_flux: Optional[torch.Tensor] = None    # shortwave [W m-2]
    lw_flux: Optional[torch.Tensor] = None    # longwave [W m-2]
    lprec: Optional[torch.Tensor] = None      # liquid water [kg m-2 s-1]
    salt_flux: Optional[torch.Tensor] = None  # [kg m-2 s-1 of salt]
    p_surf: Optional[torch.Tensor] = None     # surface pressure [Pa]
    # the gas-exchange fields of the BGC packages (atmospheric partial
    # pressures, winds, ice fraction) under their registry names
    gas_fields: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class SurfaceState:
    """What the ocean exports to the coupler, at h points."""
    sst: torch.Tensor
    sss: torch.Tensor
    u: torch.Tensor          # surface currents averaged onto h points
    v: torch.Tensor
    sea_lev: torch.Tensor


def ocean_model_init(param_sources: list[str] | None = None,
                     text: str | None = None, *, device="cuda",
                     dtype: torch.dtype = torch.float64) -> Model:
    """Build the ocean component from MOM_input files and/or text; the
    parameters nothing reads are left to the coupler's audit."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    pf = ParamFile(*(param_sources or []), text=text)
    model = build_model(pf, device=device, dtype=dtype)
    pf.close(fatal_unused=False)
    return model


def _iob_to_forcing(iob: IceOceanBoundary, grid):
    """(MechForcing, Fluxes) of the boundary fluxes, as they come."""
    forces = MechForcing(taux=iob.u_flux, tauy=iob.v_flux, p_surf=iob.p_surf)
    fluxes = Fluxes(sw=iob.sw_flux, lw=iob.lw_flux, sensible=iob.t_flux,
                    evap=iob.q_flux, lprec=iob.lprec,
                    salt_flux=iob.salt_flux, gas_fields=iob.gas_fields)
    return forces, fluxes


def _step_interval(model: Model, iob: IceOceanBoundary, state, split_state,
                   tracers, dt_coupling: float, n0: int):
    """round(dt_coupling / DT) steps (at least one) under the boundary
    fluxes, each thermodynamic, x first when n0 + n is even.  Returns
    (state, split_state, tracers, the last step's diagnostics, the
    number of steps)."""
    forces, fluxes = _iob_to_forcing(iob, model.grid)
    nsteps = max(1, int(round(dt_coupling / model.dt)))
    for n in range(nsteps):
        state, split_state, tracers, diags = step_ocean(
            model.domain, model.grid, model.vgrid, state, split_state,
            tracers, forces, fluxes, model.dt, model.cfg, eos=model.eos,
            x_first=((n0 + n) % 2 == 0), tracer_registry=model.registry,
            obc=model.obc)
    return state, split_state, tracers, diags, nsteps


def update_ocean_model(model: Model, iob: IceOceanBoundary, state,
                       split_state, tracers, dt_coupling: float,
                       n0: int = 0):
    """Advance the ocean by one coupling interval (``_step_interval``).
    Returns (state, split_state, tracers, SurfaceState)."""
    state, split_state, tracers, _, _ = _step_interval(
        model, iob, state, split_state, tracers, dt_coupling, n0)
    return state, split_state, tracers, extract_surface_state(model, state)


def extract_surface_state(model: Model, state) -> SurfaceState:
    """The top layer's T and S, its velocities averaged onto h points
    and the free surface, masked to the ocean."""
    g, vg = model.grid, model.vgrid
    e = interface_heights(vg, state.h, g.bathyT)
    sst = state.T[0] if state.T is not None else torch.zeros_like(e[0])
    sss = state.S[0] if state.S is not None else torch.zeros_like(e[0])
    u_h = 0.5 * (state.u[0] + im1(state.u[0]))
    v_h = 0.5 * (state.v[0] + jm1(state.v[0]))
    return SurfaceState(sst=sst * g.mask2dT, sss=sss * g.mask2dT,
                        u=u_h * g.mask2dT, v=v_h * g.mask2dT,
                        sea_lev=e[0] * g.mask2dT)
