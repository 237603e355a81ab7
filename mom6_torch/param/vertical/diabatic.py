"""Diabatic (column physics) driver.

Counterpart of ``mom6_tpu.param.vertical.diabatic``, in its order:
set_diffusivity (background, shear and kappa-shear, convection, the
bottom boundary layer, mixed-layer radiation, tidal, double diffusion
and user mixing); the Langmuir enhancement of the boundary-layer
mixing (USE_WAVES); the KPP or ePBL boundary layer driven by the wind's
u* and the surface buoyancy flux; applyBoundaryFluxesInOut, with the
opacity bands under penetrating shortwave; geothermal heating; implicit
vertical diffusion of T, S (with double diffusion's salt excess) and
the passive tracers; full convection; frazil; and, in layer mode, the
bulk mixed layer, diffusive entrainment and the regularization of
near-vanished surface layers moving the interfaces.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import surface_ustar
from mom6_torch.param.vertical.bulk_mixed_layer import (BulkMixedLayerCfg,
                                                        bulk_mixed_layer)
from mom6_torch.param.vertical.diabatic_aux import (FrazilCfg,
                                                    apply_boundary_fluxes,
                                                    make_frazil)
from mom6_torch.param.vertical.energetic_pbl import EPBLCfg, energetic_pbl
from mom6_torch.param.vertical.entrain_diffusive import (
    EntrainDiffusiveCfg, entrainment_diffusive)
from mom6_torch.param.vertical.full_convection import (FullConvectionCfg,
                                                       full_convection)
from mom6_torch.param.vertical.geothermal import (GeothermalCfg,
                                                  geothermal_heating)
from mom6_torch.param.vertical.kpp import KPPCfg, kpp_coefficients
from mom6_torch.param.vertical.opacity import OpacityCfg
from mom6_torch.param.vertical.regularize_layers import (
    RegularizeLayersCfg, regularize_layers)
from mom6_torch.param.vertical.set_diffusivity import (DiffusivityCfg,
                                                       set_diffusivity)
from mom6_torch.param.waves.wave_interface import (WavesCfg,
                                                   langmuir_enhancement,
                                                   langmuir_number,
                                                   stokes_profile)
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1
from mom6_torch.tracer.vertdiff import tracer_vertdiff

__all__ = ["DiabaticCfg", "diabatic"]

_CP = 3991.86795711963      # J kg-1 K-1


@dataclasses.dataclass(frozen=True)
class DiabaticCfg:
    diffusivity: DiffusivityCfg = DiffusivityCfg()
    use_kpp: bool = False          # USE_KPP
    kpp: KPPCfg = KPPCfg()
    use_epbl: bool = False         # ENERGETICS_SFC_PBL
    epbl: EPBLCfg = EPBLCfg()
    rho0: float = 1035.0
    gust_const: float = 0.0        # GUST_CONST [Pa]
    use_opacity: bool = False      # PEN_SW_NBANDS > 0 or PEN_SW_SCALE > 0
    opacity: OpacityCfg = OpacityCfg()
    pen_sw_frac: float = 0.42
    depth_limit_fluxes: float = 0.0   # DEPTH_LIMIT_FLUXES [m]
    use_psurf_in_eos: bool = True  # USE_PSURF_IN_EOS
    use_geothermal: bool = False   # GEOTHERMAL_FLUX > 0
    geothermal: GeothermalCfg = GeothermalCfg()
    use_full_conv: bool = False    # FULL_CONVECTION
    full_conv: FullConvectionCfg = FullConvectionCfg()
    use_bml: bool = False          # BULKMIXEDLAYER
    bml: BulkMixedLayerCfg = BulkMixedLayerCfg()
    use_entrain_diffusive: bool = False
    entrain: EntrainDiffusiveCfg = EntrainDiffusiveCfg()
    use_regularize: bool = False   # REGULARIZE_SURFACE_LAYERS
    regularize: RegularizeLayersCfg = RegularizeLayersCfg()
    do_frazil: bool = False        # FRAZIL
    frazil: FrazilCfg = FrazilCfg()
    use_waves: bool = False        # USE_WAVES
    waves: Optional[WavesCfg] = None


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


def _absf_h(grid):
    """|f| at h points: the mean of the four surrounding corners."""
    fq = torch.abs(grid.CoriolisBu)
    return 0.25 * ((fq + im1(jm1(fq))) + (im1(fq) + jm1(fq)))


def _with_ts(T, S, tracers):
    trs = dict(tracers) if tracers else {}
    if T is not None:
        trs = {"_T": T, "_S": S, **trs}
    return trs


def _split_ts(trs, T, S, tracers):
    if trs:
        T = trs.pop("_T", T)
        S = trs.pop("_S", S)
        tracers = trs if tracers else tracers
    return T, S, tracers


def diabatic(state: State, fluxes: Optional[Fluxes], dt: float,
             cfg: DiabaticCfg, tracers: dict | None = None, vgrid=None,
             eos=None, forces: MechForcing | None = None, grid=None,
             tidal_energy_2d=None, mld_prev=None):
    """Apply the column physics to the state and the tracers.  Returns
    (new_state, new_tracers, dia) with ``dia`` holding ``kd_int``, and
    ``mld`` with KPP or ePBL, ``frazil`` with FRAZIL (also in the new
    state) and ``kv_shear`` (the next dynamics step's shear viscosity)
    with shear mixing.  ``mld_prev``: the previous mixed layer depth,
    for ML_RADIATION."""
    h = state.h
    T, S = state.T, state.S
    g = vgrid.g_Earth if vgrid is not None else 9.8
    ustar_sfc = None
    if cfg.diffusivity.ml_radiation and forces is not None \
            and grid is not None and vgrid is not None:
        ustar_sfc = surface_ustar(grid, vgrid.Rho0, forces)
    dres = set_diffusivity(h, cfg.diffusivity, vgrid=vgrid, u=state.u,
                           v=state.v, T=T, S=S, eos=eos,
                           lat=grid.geoLatT if grid is not None else None,
                           tidal_energy_2d=tidal_energy_2d,
                           ustar=ustar_sfc, mld=mld_prev)
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

    lang_enh = None
    if cfg.use_waves and cfg.waves is not None:
        # the Li et al. (2016) factor from the wind's empirical Stokes
        # drift, U10 from tau continuity across the surface
        st = stokes_profile(cfg.waves, h, u10=800.0 * ustar)
        lang_enh = langmuir_enhancement(langmuir_number(ustar, st.us0))

    mld = None
    if cfg.use_kpp and vgrid is not None:
        kpp = kpp_coefficients(cfg.kpp, state.u, state.v, h, T, S, eos,
                               cfg.rho0, vgrid.g_Earth, ustar=ustar,
                               buoy_flux=buoy_flux)
        kd_bl = kpp.kd_int
        if lang_enh is not None:
            kd_bl = kd_bl * lang_enh[None]
        kd_int = kd_int + kd_bl
        mld = kpp.bld
    elif cfg.use_epbl and vgrid is not None:
        ep = energetic_pbl(cfg.epbl, h, T, S, eos, cfg.rho0, vgrid.g_Earth,
                           dt, ustar=ustar, buoy_flux=buoy_flux,
                           absf=_absf_h(grid) if grid is not None else None)
        kd_bl = ep.kd_int
        if lang_enh is not None:
            kd_bl = kd_bl * lang_enh[None]
        kd_int = kd_int + kd_bl
        mld = ep.mld

    if fluxes is not None and T is not None:
        bf = apply_boundary_fluxes(
            h, T, S, fluxes, dt, cfg.rho0, cp=_CP,
            opacity_cfg=cfg.opacity if cfg.use_opacity else None,
            pen_sw_frac=cfg.pen_sw_frac,
            angstrom=vgrid.angstrom if vgrid is not None else 1e-10,
            depth_limit_fluxes=cfg.depth_limit_fluxes)
        h, T, S = bf.h, bf.T, bf.S

    if cfg.use_geothermal and T is not None:
        T = geothermal_heating(cfg.geothermal, T, h, dt)

    if T is not None:
        T = tracer_vertdiff(T, h, kd_int, dt)
        kd_S = kd_int if dres.kd_extra_S is None \
            else kd_int + dres.kd_extra_S
        S = tracer_vertdiff(S, h, kd_S, dt)
    new_tracers = tracers
    if tracers is not None:
        new_tracers = {k: tracer_vertdiff(v, h, kd_int, dt)
                       for k, v in tracers.items()}

    if cfg.use_full_conv and T is not None and eos is not None:
        T, S = full_convection(cfg.full_conv, T, S, h, eos)

    frazil = None
    if cfg.do_frazil and T is not None:
        psurf = forces.p_surf if (cfg.use_psurf_in_eos
                                  and forces is not None) else None
        T, frazil = make_frazil(
            cfg.frazil, h, T, S,
            angstrom=vgrid.angstrom if vgrid is not None else 1e-10,
            p_surf=psurf, frazil_prev=state.frazil)

    if cfg.use_bml and T is not None and eos is not None:
        u_h = v_h = absf = None
        if state.u is not None and cfg.bml.bulk_ri > 0.0:
            u_h = 0.5 * (im1(state.u) + state.u)
            v_h = 0.5 * (jm1(state.v) + state.v)
        if grid is not None and cfg.bml.tke_decay > 0.0:
            absf = _absf_h(grid)
        h, T, S, new_tracers, _ = bulk_mixed_layer(
            cfg.bml, h, T, S, eos, ustar, buoy_flux, dt,
            tracers=new_tracers, u=u_h, v=v_h, absf=absf)
    if cfg.use_entrain_diffusive:
        h, trs, _ = entrainment_diffusive(
            cfg.entrain, h, kd_int, dt, _with_ts(T, S, new_tracers) or None,
            gprime=vgrid.g_prime if vgrid is not None else None)
        T, S, new_tracers = _split_ts(trs, T, S, new_tracers)
    if cfg.use_regularize:
        h, trs = regularize_layers(cfg.regularize, h,
                                   _with_ts(T, S, new_tracers) or None)
        T, S, new_tracers = _split_ts(trs, T, S, new_tracers)

    dia = {"kd_int": kd_int}
    if mld is not None:
        dia["mld"] = mld
    out = state.replace(h=h, T=T, S=S)
    if frazil is not None:
        dia["frazil"] = frazil
        out = out.replace(frazil=frazil)
    if dres.kv_shear is not None:
        dia["kv_shear"] = dres.kv_shear
    return out, new_tracers, dia
