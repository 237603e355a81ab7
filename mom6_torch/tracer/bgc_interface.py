"""The biogeochemistry package interface (counterpart of
``mom6_tpu.tracer.bgc_interface``): a package declares its tracers into
the registry and steps them in the column physics, either on its own
(``column_physics``) or through the MARBL-shaped coupler
(``marbl_driver.BGCCoupler``: ``specs`` and ``interior_tendencies``).
``NPZDPackage`` is a 4-box nutrient-phytoplankton-zooplankton-detritus
model on that interface."""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.tracer.registry import TracerMeta, TracerRegistry

__all__ = ["NPZDPackage"]


@dataclasses.dataclass(frozen=True)
class NPZDPackage:
    """A minimal NPZD model."""
    name: str = "NPZD"
    growth_rate: float = 1.0 / 86400.0      # P growth [s-1]
    grazing: float = 0.5 / 86400.0
    mortality: float = 0.1 / 86400.0
    remin: float = 0.2 / 86400.0
    sinking: float = 5.0 / 86400.0          # detritus sinking [m s-1]
    k_light: float = 20.0                   # light e-folding depth [m]
    n0: float = 10.0

    def register(self, registry: TracerRegistry, shape, *, device,
                 dtype: torch.dtype) -> dict:
        for nm, ln in (("no3", "nitrate"), ("phyto", "phytoplankton"),
                       ("zoo", "zooplankton"), ("det", "detritus")):
            registry.register(TracerMeta(name=nm, longname=ln,
                                         units="mmol m-3"))
        z = torch.zeros(shape, device=device, dtype=dtype)
        return {"no3": z + self.n0, "phyto": z + 0.1, "zoo": z + 0.05,
                "det": z}

    def specs(self):
        """The coupler's tracer specs: nitrate takes river input and
        restoring, detritus sinks through the coupler's sinking pass."""
        from mom6_torch.tracer.marbl_driver import BGCTracerSpec
        return (
            BGCTracerSpec(name="no3", longname="nitrate", init=self.n0,
                          river_field="riv_no3", restore=True),
            BGCTracerSpec(name="phyto", longname="phytoplankton", init=0.1),
            BGCTracerSpec(name="zoo", longname="zooplankton", init=0.05),
            BGCTracerSpec(name="det", longname="detritus", init=0.0,
                          sinking=self.sinking),
        )

    def _rates(self, tracers, light):
        n, p = tracers["no3"], tracers["phyto"]
        zo, det = tracers["zoo"], tracers["det"]
        growth = self.growth_rate * light * n / (n + 1.0) * p
        graze = self.grazing * p * zo
        mort = self.mortality * (p + zo)
        rem = self.remin * det
        return {"no3": rem - growth,
                "phyto": growth - graze - self.mortality * p,
                "zoo": 0.7 * graze - self.mortality * zo,
                "det": 0.3 * graze + mort - rem}

    def interior_tendencies(self, tracers, h, T, S, irr, forcing):
        """dc/dt of the NPZD cycle, for the coupler."""
        z_mid = torch.cumsum(h, dim=0) - 0.5 * h
        light = irr if irr is not None else torch.exp(-z_mid / self.k_light)
        return self._rates(tracers, light)

    def column_physics(self, tracers: dict, h, T, S, dt,
                       irradiance=None, **_) -> dict:
        """One step of the cycle on its own: the rates, detritus sinking
        (upwind, nothing out the bottom), then a positivity clip."""
        z_mid = torch.cumsum(h, dim=0) - 0.5 * h
        rates = self._rates(tracers, torch.exp(-z_mid / self.k_light))
        new = {k: tracers[k] + dt * rates[k] for k in rates}
        flux = self.sinking * new["det"]      # downward at cell bottoms
        flux = torch.cat([flux[:-1], torch.zeros_like(flux[-1:])], dim=0)
        div = torch.cat([torch.zeros_like(flux[:1]), flux[:-1]],
                        dim=0) - flux
        new["det"] = new["det"] + dt * div / (h + 1e-20)
        return dict(tracers, **{k: torch.clamp(v, min=0.0)
                                for k, v in new.items()})
