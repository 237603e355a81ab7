"""The MARBL-shaped biogeochemistry coupler (counterpart of
``mom6_tpu.tracer.marbl_driver``): what the ocean model owns of a BGC
package's coupling, with the packages' interior math plugged in:

* per-tracer surface fluxes: gas exchange with Schmidt-number and
  solubility piston velocities scaled by the open-water fraction, river
  and atmospheric-deposition inputs, and virtual fluxes from the salt
  flux (DIC_SALT_RATIO-style ratios);
* an iron-like bottom source spread over BOT_FLUX_MIX_THICKNESS;
* the packages' interior tendencies, particulate sinking, restoring
  toward climatologies remapped from a file's z-grid to the current
  columns with a 3-D inverse timescale, then a positivity clip.

File forcing is ``ExternalField``s (records stacked on the device,
interpolated at the model time); the surface fluxes enter the top
layer directly or, when interface diffusivities are given, through
the implicit vertical diffusion's surface-flux boundary condition.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mom6_torch.ale.remapping import remap_column_means
from mom6_torch.framework.interp_external import (ExternalField,
                                                  load_external_field)
from mom6_torch.framework.io import field_names, read_field
from mom6_torch.tracer.cfc import SCHMIDT, cfc_solubility
from mom6_torch.tracer.registry import TracerMeta, TracerRegistry
from mom6_torch.tracer.vertdiff import tracer_vertdiff

__all__ = ["GasSpec", "BGCTracerSpec", "BGCForcing", "BGCForcingSources",
           "RestoringData", "BGCPackageBase", "CFCPackage",
           "MARBLBaseBioPackage", "BGCCoupler", "build_bgc_coupler"]

_H_NEG = 1e-20
# river-flux file variables, one per tracer (RIV_FLUX_FILE)
_RIVER_TRACERS = ("no3", "po4", "sio3", "fe", "dic", "alk", "doc")


@dataclasses.dataclass(frozen=True)
class GasSpec:
    """Air-sea gas exchange: ``schmidt`` (a, b, c, d) with
    Sc = a - bT + cT^2 - dT^3 (T degC), ``solubility(T, S)`` [mol m-3
    atm-1], the forcing field ``atm_field`` of the atmospheric partial
    pressure [atm] and the OCMIP2 coefficient ``piston_coeff`` [cm hr-1
    per (m s-1)^2]."""
    schmidt: tuple
    solubility: Callable
    atm_field: str
    piston_coeff: float = 0.31

    def flux(self, c_surf, T, S, u10, patm, open_frac):
        """The flux into the ocean [conc m s-1]."""
        a, b, c, d = self.schmidt
        sc = a - T * (b - T * (c - T * d))
        kw = self.piston_coeff * u10 * u10 * torch.sqrt(
            660.0 / torch.clamp(sc, min=1.0)) * (0.01 / 3600.0)
        c_sat = self.solubility(T, S) * patm
        return open_frac * kw * (c_sat - c_surf)


@dataclasses.dataclass(frozen=True)
class BGCTracerSpec:
    """How one BGC tracer couples: its gas exchange, the forcing fields
    of its river input and deposition [conc m s-1], its salt-flux ratio
    (the flux gains ratio * salt_flux / Rho0), its bottom source field,
    whether it is restored, and its sinking speed [m s-1]."""
    name: str
    units: str = "mmol m-3"
    longname: str = ""
    init: float = 0.0
    gas: Optional[GasSpec] = None
    river_field: Optional[str] = None
    dep_field: Optional[str] = None
    salt_ratio: float = 0.0
    bottom_field: Optional[str] = None
    restore: bool = False
    sinking: float = 0.0


@dataclasses.dataclass(frozen=True)
class BGCForcing:
    """The forcing of one BGC call: the 10 m wind speed [m s-1], the
    open-water fraction and {name: 2-D field}."""
    u10: torch.Tensor
    open_frac: torch.Tensor
    fields: dict


class BGCForcingSources:
    """The forcing sources, constants or ``ExternalField``s; ``at(t,
    like)`` resolves them at the model time ``t`` [s] on tensors shaped
    like ``like``."""

    def __init__(self, u10=8.0, ice_frac=0.0):
        self.sources: dict = {}
        self.u10 = u10
        self.ice_frac = ice_frac

    def add(self, name, value):
        self.sources[name] = value

    def add_file(self, name, path, var, grid, scale=1.0):
        self.sources[name] = load_external_field(path, var, grid=grid,
                                                 scale=scale)

    @staticmethod
    def _resolve(v, t, like):
        if isinstance(v, ExternalField):
            return v.at(t)
        return torch.zeros_like(like) + v

    def at(self, t: float, like) -> BGCForcing:
        fields = {n: self._resolve(v, t, like)
                  for n, v in self.sources.items()}
        u10 = self._resolve(self.u10, t, like)
        ice = self._resolve(self.ice_frac, t, like)
        return BGCForcing(u10=u10,
                          open_frac=torch.clamp(1.0 - ice, 0.0, 1.0),
                          fields=fields)


@dataclasses.dataclass(frozen=True)
class RestoringData:
    """Climatologies on a fixed z-grid and their inverse timescale:
    ``clim`` {name: (nz_file, njh, nih)}, ``dz`` (nz_file,) the file's
    layer thicknesses, ``i_tau`` (nz_file, njh, nih) [s-1]."""
    clim: dict
    dz: torch.Tensor
    i_tau: torch.Tensor

    def tendencies(self, tracers: dict, h) -> dict:
        """I_tau (clim - tr) of every restored tracer of ``tracers``:
        i_tau and the climatologies stacked on a new axis and carried
        onto the columns ``h`` by one conservative remap."""
        names = [n for n in tracers if n in self.clim]
        if not names:
            return {}
        src = torch.stack([self.i_tau] + [self.clim[n] for n in names],
                          dim=1)
        dzf = self.dz.reshape((-1,) + (1,) * (src.dim() - 1)).expand(
            src.shape)
        dst = remap_column_means(dzf, src, h[:, None])
        itau_h = torch.clamp(dst[:, 0], min=0.0)
        return {n: itau_h * (dst[:, 1 + i] - tracers[n])
                for i, n in enumerate(names)}


class BGCPackageBase:
    """A BGC package: its tracers (``specs``) and their interior
    tendencies."""
    name = "bgc"

    def specs(self) -> Sequence[BGCTracerSpec]:
        raise NotImplementedError

    def interior_tendencies(self, tracers: dict, h, T, S, irr,
                            forcing: BGCForcing) -> dict:
        """dc/dt [conc s-1] of some of the package's tracers."""
        return {}


@dataclasses.dataclass(frozen=True)
class CFCPackage(BGCPackageBase):
    """CFC-11 and CFC-12 as a gas-exchange-only package of the
    coupler."""
    pcfc11_atm: float = 270.0e-12
    pcfc12_atm: float = 465.0e-12
    piston_coeff: float = 0.31
    name: str = "OCMIP2_CFC"

    def specs(self):
        out = []
        for nm, gas, patm in (("cfc11", "CFC11", self.pcfc11_atm),
                              ("cfc12", "CFC12", self.pcfc12_atm)):
            sol = (lambda T, S, _g=gas:
                   cfc_solubility(_g, T, S) * 1e3)   # mol m-3 atm-1
            out.append(BGCTracerSpec(
                name=nm, units="mol m-3", longname=f"{nm} mole conc",
                gas=GasSpec(schmidt=SCHMIDT[gas], solubility=sol,
                            atm_field=f"p{nm}_atm",
                            piston_coeff=self.piston_coeff)))
        return out

    def default_forcing(self):
        return {"pcfc11_atm": self.pcfc11_atm,
                "pcfc12_atm": self.pcfc12_atm}


def _o2_solubility(T, S):
    """The Garcia and Gordon (1992) O2 saturation fit, as mol m-3 per atm
    of O2 partial pressure."""
    Ts = torch.log((298.15 - T) / (273.15 + T))
    A = (5.80871, 3.20291, 4.17887, 5.10006, -9.86643e-2, 3.80369)
    B = (-7.01577e-3, -7.70028e-3, -1.13864e-2, -9.51519e-3)
    lnc = (A[0] + Ts * (A[1] + Ts * (A[2] + Ts * (A[3] + Ts
           * (A[4] + Ts * A[5]))))
           + S * (B[0] + Ts * (B[1] + Ts * (B[2] + Ts * B[3])))
           - 2.75915e-7 * S * S)
    cstar = torch.exp(lnc)                  # umol kg-1 at 1 atm moist air
    return cstar * 1.025e-3 / 0.20946       # -> mol m-3 atm(O2)-1


def _co2_solubility(T, S):
    """The Weiss (1974) CO2 solubility K0 [mol l-1 atm-1] as mol m-3
    atm-1."""
    tk = (T + 273.15) / 100.0
    lnk = (-58.0931 + 90.5069 / tk + 22.2940 * torch.log(tk)
           + S * (0.027766 - tk * (0.025888 - 0.0050578 * tk)))
    return torch.exp(lnk) * 1e3


@dataclasses.dataclass(frozen=True)
class MARBLBaseBioPackage(BGCPackageBase):
    """A compact base-bio interior model with MARBL's coupling footprint:
    the river-flux tracer list, O2 and DIC gas exchange, dust iron
    deposition, the sediment iron flux and nutrient restoring over a
    reduced NPZD-class cycle of NO3, PO4, SiO3, Fe, DIC, ALK, O2, DOC
    and a sinking POC."""
    name: str = "MARBL_tracers"
    growth_rate: float = 1.0 / 86400.0
    remin_rate: float = 0.1 / 86400.0
    k_no3: float = 0.25                     # half saturation [mmol m-3]
    k_po4: float = 0.03
    k_fe: float = 3.0e-4
    k_light: float = 25.0                   # light e-folding depth [m]
    r_p2n: float = 1.0 / 16.0               # P:N Redfield
    r_si2n: float = 1.0
    r_fe2n: float = 3.0e-5
    r_c2n: float = 117.0 / 16.0
    r_o2n: float = 170.0 / 16.0
    atm_co2: float = 284.7e-6               # ATM_CO2_CONST [atm]
    atm_o2: float = 0.20946                 # O2 mole fraction [atm]

    def specs(self):
        # Wanninkhof (2014) Schmidt fits, truncated at the cubic
        o2_gas = GasSpec(schmidt=(1920.4, 135.6, 5.2122, 0.10939),
                         solubility=_o2_solubility, atm_field="atm_o2")
        co2_gas = GasSpec(schmidt=(2116.8, 136.25, 4.7353, 0.092307),
                          solubility=_co2_solubility, atm_field="atm_co2")
        mk = BGCTracerSpec
        return (
            mk("no3", longname="nitrate", init=20.0, river_field="riv_no3",
               dep_field="ndep", restore=True),
            mk("po4", longname="phosphate", init=1.5, river_field="riv_po4",
               restore=True),
            mk("sio3", longname="silicate", init=30.0,
               river_field="riv_sio3", restore=True),
            mk("fe", longname="dissolved iron", init=6e-4,
               river_field="riv_fe", dep_field="dust_fe",
               bottom_field="fesedflux"),
            mk("dic", longname="dissolved inorganic carbon",
               units="mmol m-3", init=2000.0, gas=co2_gas,
               river_field="riv_dic", salt_ratio=0.0),
            mk("alk", longname="alkalinity", units="meq m-3", init=2300.0,
               river_field="riv_alk", salt_ratio=0.0),
            mk("o2", longname="dissolved oxygen", init=200.0, gas=o2_gas),
            mk("doc", longname="dissolved organic carbon", init=40.0,
               river_field="riv_doc"),
            mk("poc", longname="particulate organic carbon", init=0.0,
               sinking=10.0 / 86400.0),
        )

    def interior_tendencies(self, tracers, h, T, S, irr, forcing):
        no3, po4, fe = tracers["no3"], tracers["po4"], tracers["fe"]
        doc, poc, o2 = tracers["doc"], tracers["poc"], tracers["o2"]
        # light limitation from the surface irradiance profile
        z_mid = torch.cumsum(h, dim=0) - 0.5 * h
        light = irr if irr is not None else torch.exp(-z_mid / self.k_light)
        lim = torch.minimum(torch.minimum(
            no3 / (no3 + self.k_no3), po4 / (po4 + self.k_po4)),
            fe / (fe + self.k_fe))
        uptake = self.growth_rate * light * torch.clamp(lim, min=0.0) \
            * torch.clamp(no3, min=0.0)             # mmolN m-3 s-1
        remin_doc = self.remin_rate * torch.clamp(doc, min=0.0) / self.r_c2n
        remin_poc = self.remin_rate * torch.clamp(poc, min=0.0) / self.r_c2n
        # O2-limited remineralization (no anoxic consumption)
        o2_lim = o2 / (o2 + 5.0)
        remin = (remin_doc + remin_poc) * o2_lim
        dn = remin - uptake
        return {
            "no3": dn,
            "po4": self.r_p2n * dn,
            "sio3": self.r_si2n * dn,
            "fe": self.r_fe2n * dn,
            "dic": self.r_c2n * dn,
            "alk": -dn,
            "o2": self.r_o2n * (uptake - remin),
            "doc": self.r_c2n * (0.6 * uptake - remin_doc * o2_lim),
            "poc": self.r_c2n * (0.4 * uptake - remin_poc * o2_lim),
        }

    def default_forcing(self):
        return {"atm_co2": self.atm_co2, "atm_o2": self.atm_o2}


def _set_top(tr, top):
    return torch.cat([top[None], tr[1:]], dim=0)


@dataclasses.dataclass
class BGCCoupler:
    """Drives the BGC packages through every coupling channel; the step
    calls ``column_physics`` after the tracers' column functions."""
    packages: list
    forcing_sources: BGCForcingSources
    restoring: Optional[RestoringData] = None
    bot_flux_mix_thickness: float = 1.0e-3   # BOT_FLUX_MIX_THICKNESS [m]
    rho0: float = 1035.0

    def __post_init__(self):
        self._specs = {}
        for p in self.packages:
            for s in p.specs():
                if s.name in self._specs:
                    raise ValueError(f"BGC tracer '{s.name}' declared "
                                     "by two packages")
                self._specs[s.name] = s
            dfl = getattr(p, "default_forcing", None)
            if dfl:
                for k, v in dfl().items():
                    self.forcing_sources.sources.setdefault(k, v)

    def register(self, registry: TracerRegistry, shape, *, device,
                 dtype: torch.dtype) -> dict:
        """Register every package tracer; returns their uniform initial
        fields."""
        out = {}
        for s in self._specs.values():
            registry.register(TracerMeta(name=s.name,
                                         longname=s.longname or s.name,
                                         units=s.units))
            out[s.name] = torch.full(shape, s.init, device=device,
                                     dtype=dtype)
        return out

    def column_physics(self, tracers: dict, h, T, S, dt, t=None,
                       fluxes=None, kd_int=None, sw=None, **_):
        """One BGC step of ``dt``: the surface fluxes, applied directly to
        the top layer (or through the implicit vertical diffusion with
        ``kd_int``), the bottom sources, the interior tendencies, the
        sinking and the restoring, then the positivity clip."""
        t = 0.0 if t is None else t
        like = h[0]
        forcing = self.forcing_sources.at(t, like)
        f = forcing.fields
        u10 = forcing.u10
        open_frac = forcing.open_frac
        # a coupler's gas fields take precedence over the packages' own
        gf = getattr(fluxes, "gas_fields", None) \
            if fluxes is not None else None
        if gf:
            f = {**f, **{k: v for k, v in gf.items()
                         if k not in ("u10", "ice_frac")}}
            if "u10" in gf:
                u10 = gf["u10"]
            if "ice_frac" in gf:
                open_frac = torch.clamp(1.0 - gf["ice_frac"], 0.0, 1.0)
        out = dict(tracers)

        T0 = T[0] if T is not None else torch.zeros_like(like) + 15.0
        S0 = S[0] if S is not None else torch.zeros_like(like) + 35.0
        salt_flux = getattr(fluxes, "salt_flux", None) \
            if fluxes is not None else None

        # the depths of the layer bottoms, for the bottom sources
        z_bot = torch.cumsum(h, dim=0)
        depth = z_bot[-1]

        for name, s in self._specs.items():
            tr = out.get(name)
            if tr is None:
                continue
            stf = torch.zeros_like(like)
            if s.gas is not None:
                patm = f.get(s.gas.atm_field, 0.0)
                if not torch.is_tensor(patm):
                    patm = torch.zeros_like(like) + patm
                stf = stf + s.gas.flux(tr[0], T0, S0, u10, patm, open_frac)
            if s.river_field and s.river_field in f:
                stf = stf + f[s.river_field]
            if s.dep_field and s.dep_field in f:
                stf = stf + f[s.dep_field]
            if s.salt_ratio and salt_flux is not None:
                stf = stf + s.salt_ratio * salt_flux / self.rho0
            if kd_int is not None:
                tr = tracer_vertdiff(tr, h, kd_int, dt, sfc_flux=stf)
            else:
                tr = _set_top(tr, tr[0] + dt * stf / (h[0] + _H_NEG))
            if s.bottom_field and s.bottom_field in f:
                bf = f[s.bottom_field]
                thick = max(self.bot_flux_mix_thickness, _H_NEG)
                # each layer's share of the bottom mixing zone
                top_in = torch.clamp(depth - thick, min=0.0)
                ov = torch.clamp(z_bot - top_in, min=0.0) \
                    - torch.clamp((z_bot - h) - top_in, min=0.0)
                wsum = torch.sum(ov, dim=0) + _H_NEG
                tr = tr + dt * bf * ov / (wsum * (h + _H_NEG))
            out[name] = tr

        irr = None
        if sw is not None:
            z_mid = z_bot - 0.5 * h
            irr = (sw / torch.clamp(torch.max(sw), min=1.0)) \
                * torch.exp(-z_mid / 25.0)
        for p in self.packages:
            tend = p.interior_tendencies(dict(out), h, T, S, irr, forcing)
            for name, dcdt in tend.items():
                if name in out:
                    out[name] = out[name] + dt * dcdt

        # particulate sinking: upwind, conservative, nothing out the bottom
        for name, s in self._specs.items():
            if s.sinking and name in out:
                tr = out[name]
                flux = s.sinking * torch.clamp(tr, min=0.0)
                flux = torch.cat([flux[:-1], torch.zeros_like(flux[-1:])],
                                 dim=0)
                div = torch.cat([torch.zeros_like(flux[:1]), flux[:-1]],
                                dim=0) - flux
                out[name] = tr + dt * div / (h + _H_NEG)

        if self.restoring is not None:
            rest = self.restoring.tendencies(
                {n: out[n] for n, s in self._specs.items()
                 if s.restore and n in out}, h)
            for name, tnd in rest.items():
                out[name] = out[name] + dt * tnd

        for name in self._specs:
            if name in out:
                out[name] = torch.clamp(out[name], min=0.0)
        return out


def _pad_to(arr: torch.Tensor, shape) -> torch.Tensor:
    """A (nz, nj, ni) file field edge-padded to the (., njh, nih) model
    shape."""
    pj = (shape[-2] - arr.shape[-2]) // 2
    pi = (shape[-1] - arr.shape[-1]) // 2
    if pj > 0 or pi > 0:
        arr = F.pad(arr, (pi, pi, pj, pj), mode="replicate")
    return arr


def build_bgc_coupler(pf, grid, shape, registry, use_marbl: bool,
                      use_npzd: bool, use_cfc_coupled: bool, *, device,
                      dtype: torch.dtype):
    """The coupler and its tracers' initial fields from MOM_input, as the
    JAX builder reads them; (None, {}) without a package."""
    from mom6_torch.tracer.bgc_interface import NPZDPackage
    packages = []
    if use_marbl:
        packages.append(MARBLBaseBioPackage(
            atm_co2=pf.get("ATM_CO2_CONST", float, 284.7e-6, units="atm")))
    if use_npzd:
        packages.append(NPZDPackage())
    if use_cfc_coupled:
        packages.append(CFCPackage(
            pcfc11_atm=pf.get("PCFC11_ATM", float, 270.0e-12, units="atm"),
            pcfc12_atm=pf.get("PCFC12_ATM", float, 465.0e-12, units="atm")))
    if not packages:
        return None, {}

    src = BGCForcingSources(
        u10=pf.get("BGC_EXCHANGE_WIND", float, 8.0, units="m s-1"),
        ice_frac=pf.get("BGC_ICE_FRACTION", float, 0.0))
    indir = pf.get("INPUTDIR", str, ".")

    def full_path(path):
        return path if os.path.isabs(path) else os.path.join(indir, path)

    def maybe_file(param, fields, scale_param=None):
        path = pf.get(param, str, "")
        if not path:
            return
        scale = pf.get(scale_param, float, 1.0) if scale_param else 1.0
        for fname, fvar in fields:
            try:
                src.add_file(fname, full_path(path), fvar, grid, scale=scale)
            except KeyError:
                pass                      # the variable is not in the file

    if pf.get("READ_RIV_FLUXES", bool, False):
        maybe_file("RIV_FLUX_FILE",
                   [(f"riv_{n}", f"{n}_riv_flux") for n in _RIVER_TRACERS])
    # dust -> bioavailable iron (MARBL_forcing_mod's fraction ladder)
    dust_file = pf.get("MARBL_DUST_FLUX_FILE", str, "")
    if dust_file:
        fe_frac = (pf.get("IRON_FRAC_IN_ATM_FINE_DUST", float, 0.035)
                   * pf.get("FE_BIOAVAIL_FRAC_OFFSET", float, 0.01)
                   / 0.035) if pf.has("FE_BIOAVAIL_FRAC_OFFSET") \
            else pf.get("IRON_FRAC_IN_ATM_FINE_DUST", float, 0.035) \
            * 0.01 / 0.035
        # dust [kg m-2 s-1] -> Fe [mmol m-3 m s-1]: mass fraction x
        # bioavailability / (56e-3 kg/mol) x 1e3 mmol/mol
        src.add_file("dust_fe", full_path(dust_file),
                     pf.get("MARBL_DUST_FLUX_VAR", str, "dust"), grid,
                     scale=fe_frac / 56.0e-3 * 1.0e3)
    maybe_file("MARBL_FESEDFLUX_FILE", [("fesedflux", "FESEDFLUX")],
               scale_param="MARBL_FESEDFLUX_SCALE_FACTOR")
    maybe_file("MARBL_NDEP_FILE", [("ndep", "ndep")])

    restoring = None
    rest_src = pf.get("MARBL_TRACER_RESTORING_SOURCE", str, "none")
    if rest_src.lower() == "file":
        rf = pf.get("MARBL_TRACER_RESTORING_FILE", str, "")
        itf = pf.get("MARBL_TRACER_RESTORING_I_TAU_FILE", str, rf)
        itv = pf.get("MARBL_TRACER_RESTORING_I_TAU_VAR_NAME", str, "I_TAU")
        rfp, itp = full_path(rf), full_path(itf)
        dev = dict(device=device, dtype=dtype)
        zed = np.asarray(read_field(rfp, "z_edges"), np.float64)
        dz = torch.as_tensor(np.diff(zed), **dev)
        names = field_names(rfp)
        clim = {}
        for pkg in packages:
            for s in pkg.specs():
                if s.restore and s.name in names:
                    clim[s.name] = _pad_to(torch.as_tensor(
                        np.asarray(read_field(rfp, s.name), np.float64),
                        **dev), shape)
        itau = _pad_to(torch.as_tensor(np.asarray(read_field(itp, itv),
                                                  np.float64), **dev), shape)
        restoring = RestoringData(clim=clim, dz=dz, i_tau=itau)

    coupler = BGCCoupler(
        packages=packages, forcing_sources=src, restoring=restoring,
        bot_flux_mix_thickness=pf.get("BOT_FLUX_MIX_THICKNESS", float,
                                      1.0e-3, units="m"))
    tracers = coupler.register(registry, shape, device=device, dtype=dtype)
    return coupler, tracers
