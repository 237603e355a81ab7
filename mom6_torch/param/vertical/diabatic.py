"""Diabatic (column physics) driver.

Counterpart of ``mom6_tpu.param.vertical.diabatic`` on the branches the
full step takes: set_diffusivity; the KPP boundary layer driven by the
wind's u* and the surface buoyancy flux; applyBoundaryFluxesInOut;
implicit vertical diffusion of T, S and the passive tracers; and, in
layered mode, diffusive entrainment moving the interfaces.  ePBL, the
bulk mixed layer, surface-layer regularization, geothermal heating,
full convection, frazil, opacity and waves are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.state import State
from mom6_torch.param.vertical.diabatic_aux import apply_boundary_fluxes
from mom6_torch.param.vertical.entrain_diffusive import (
    EntrainDiffusiveCfg, entrainment_diffusive)
from mom6_torch.param.vertical.kpp import KPPCfg, kpp_coefficients
from mom6_torch.param.vertical.set_diffusivity import (DiffusivityCfg,
                                                       set_diffusivity)
from mom6_torch.parallel.stencil import ip1, jp1
from mom6_torch.tracer.vertdiff import tracer_vertdiff

__all__ = ["DiabaticCfg", "diabatic"]

_CP = 3991.86795711963      # J kg-1 K-1
_UNPORTED = (("use_epbl", "ENERGETICS_SFC_PBL: energetic PBL"),
             ("use_bml", "BULKMIXEDLAYER: bulk mixed layer"),
             ("use_regularize", "REGULARIZE_SURFACE_LAYERS"),
             ("use_geothermal", "GEOTHERMAL: geothermal heating"),
             ("use_full_conv", "full convective adjustment"),
             ("do_frazil", "FRAZIL: frazil formation"),
             ("use_opacity", "opacity: penetrating shortwave"),
             ("use_waves", "USE_WAVES: Langmuir enhancement"))


@dataclasses.dataclass(frozen=True)
class DiabaticCfg:
    diffusivity: DiffusivityCfg = DiffusivityCfg()
    use_kpp: bool = False          # USE_KPP
    kpp: KPPCfg = KPPCfg()
    rho0: float = 1035.0
    gust_const: float = 0.0        # GUST_CONST [Pa]
    pen_sw_frac: float = 0.42
    depth_limit_fluxes: float = 0.0
    use_entrain_diffusive: bool = False
    entrain: EntrainDiffusiveCfg = EntrainDiffusiveCfg()
    use_epbl: bool = False
    use_bml: bool = False
    use_regularize: bool = False
    use_geothermal: bool = False
    use_full_conv: bool = False
    do_frazil: bool = False
    use_opacity: bool = False
    use_waves: bool = False

    # sub-configurations of the JAX package's DiabaticCfg that only
    # matter when the named switch (not ported: it raises) is on
    _INERT = {"epbl": "use_epbl", "opacity": "use_opacity",
              "use_psurf_in_eos": "do_frazil", "frazil": "do_frazil",
              "geothermal": "use_geothermal", "full_conv": "use_full_conv",
              "bml": "use_bml", "regularize": "use_regularize",
              "waves": "use_waves"}


def _surface_buoyancy_flux(fluxes, T, S, eos, rho0, g):
    """Destabilizing-positive surface buoyancy flux [m2 s-3] from the net
    heat and salt fluxes."""
    zero = torch.zeros_like(T[0])
    heat = zero
    for f in (fluxes.sw, fluxes.lw, fluxes.latent, fluxes.sensible):
        if f is not None:
            heat = heat + f
    f_t = heat / (rho0 * _CP)
    f_s = zero
    if fluxes.salt_flux is not None:
        f_s = f_s + fluxes.salt_flux * (1000.0 / rho0)
    massin = zero
    for f in (fluxes.lprec, fluxes.fprec):
        if f is not None:
            massin = massin + f
    if fluxes.evap is not None:
        massin = massin - fluxes.evap
    f_s = f_s - S[0] * massin / rho0
    drdt, drds = eos.density_derivs(T[0], S[0], zero)
    return (g / rho0) * (drdt * f_t + drds * f_s)


def diabatic(state: State, fluxes: Optional[Fluxes], dt: float,
             cfg: DiabaticCfg, tracers: dict | None = None, vgrid=None,
             eos=None, forces: MechForcing | None = None, grid=None):
    """Apply surface fluxes and implicit vertical mixing to T/S/tracers
    (and diffusive entrainment to h).  Returns (new_state, new_tracers,
    dia) with ``dia`` holding ``kd_int`` and, with KPP, ``mld``."""
    for name, what in _UNPORTED:
        if getattr(cfg, name):
            raise NotImplementedError(what)
    h = state.h
    T, S = state.T, state.S
    g = vgrid.g_Earth if vgrid is not None else 9.8
    dres = set_diffusivity(h, cfg.diffusivity,
                           lat=grid.geoLatT if grid is not None else None)
    kd_int = dres.kd_int

    ustar = torch.zeros_like(h[0])
    buoy_flux = torch.zeros_like(h[0])
    if forces is not None and forces.taux is not None:
        tauy = forces.tauy if forces.tauy is not None \
            else 0.0 * forces.taux
        tau_h = torch.sqrt((0.5 * (forces.taux + ip1(forces.taux))) ** 2
                           + (0.5 * (tauy + jp1(tauy))) ** 2)
        ustar = torch.sqrt((tau_h + cfg.gust_const) / cfg.rho0)
    if fluxes is not None and T is not None and eos is not None:
        buoy_flux = _surface_buoyancy_flux(fluxes, T, S, eos, cfg.rho0, g)

    mld = None
    if cfg.use_kpp and vgrid is not None:
        kpp = kpp_coefficients(cfg.kpp, state.u, state.v, h, T, S, eos,
                               cfg.rho0, vgrid.g_Earth, ustar=ustar,
                               buoy_flux=buoy_flux)
        kd_int = kd_int + kpp.kd_int
        mld = kpp.bld

    if fluxes is not None and T is not None:
        bf = apply_boundary_fluxes(
            h, T, S, fluxes, dt, cfg.rho0, cp=_CP,
            pen_sw_frac=cfg.pen_sw_frac,
            angstrom=vgrid.angstrom if vgrid is not None else 1e-10,
            depth_limit_fluxes=cfg.depth_limit_fluxes)
        h, T, S = bf.h, bf.T, bf.S

    if T is not None:
        T = tracer_vertdiff(T, h, kd_int, dt)
        S = tracer_vertdiff(S, h, kd_int, dt)
    new_tracers = tracers
    if tracers is not None:
        new_tracers = {k: tracer_vertdiff(v, h, kd_int, dt)
                       for k, v in tracers.items()}

    if cfg.use_entrain_diffusive:
        trs = dict(new_tracers) if new_tracers else {}
        if T is not None:
            trs = {"_T": T, "_S": S, **trs}
        h, trs, _ = entrainment_diffusive(
            cfg.entrain, h, kd_int, dt, trs or None,
            gprime=vgrid.g_prime if vgrid is not None else None)
        if trs:
            T = trs.pop("_T", T)
            S = trs.pop("_S", S)
            new_tracers = trs if new_tracers else new_tracers

    dia = {"kd_int": kd_int}
    if mld is not None:
        dia["mld"] = mld
    return state.replace(h=h, T=T, S=S), new_tracers, dia
