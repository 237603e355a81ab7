"""CFC-11 and CFC-12 with the OCMIP2 air-sea exchange (counterpart of
``mom6_tpu.tracer.cfc``): the Warner and Weiss (1985) solubility, the
Zheng et al. (1998) Schmidt numbers and the piston-velocity surface flux

  F = k_w (C_sat(pCFC_atm, T, S) - C_surf).

The coefficient tables are the port's own copies of the JAX module's.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.tracer.registry import TracerMeta

__all__ = ["CFCCfg", "cfc_solubility", "cfc_schmidt", "cfc_surface_flux",
           "register_cfcs", "SOLUBILITY", "SCHMIDT"]

# Warner & Weiss (1985) solubility [mol l-1 atm-1], Table 5:
# ln F = a1 + a2 (100/T) + a3 ln(T/100) + a4 (T/100)^2
#        + S [b1 + b2 (T/100) + b3 (T/100)^2]
SOLUBILITY = {
    "CFC11": (-229.9261, 319.6552, 119.4471, -1.39165,
              -0.142382, 0.091459, -0.0157274),
    "CFC12": (-218.0971, 298.9702, 113.8049, -1.39165,
              -0.143566, 0.091015, -0.0153924),
}
# Zheng et al. (1998) Schmidt numbers Sc = a - bT + cT^2 - dT^3 (T degC)
SCHMIDT = {
    "CFC11": (3501.8, 210.31, 6.1851, 0.07513),
    "CFC12": (3845.4, 228.95, 6.1908, 0.067430),
}


@dataclasses.dataclass(frozen=True)
class CFCCfg:
    gas: str = "CFC11"
    piston_coeff: float = 0.31     # cm/hr per (m/s)^2 wind-speed-squared


def cfc_solubility(gas: str, T, S):
    """The solubility function F [mol l-1 atm-1]."""
    a1, a2, a3, a4, b1, b2, b3 = SOLUBILITY[gas]
    tk = (T + 273.15) / 100.0
    lnF = (a1 + a2 / tk + a3 * torch.log(tk) + a4 * tk * tk
           + S * (b1 + tk * (b2 + b3 * tk)))
    return torch.exp(lnF)


def cfc_schmidt(gas: str, T):
    a, b, c, d = SCHMIDT[gas]
    return a - T * (b - T * (c - T * d))


def cfc_surface_flux(cfg: CFCCfg, c_surf, T, S, u10, pcfc_atm):
    """The air-sea flux [mol m-2 s-1] into the ocean: c_surf [mol m-3],
    pcfc_atm [atm] partial pressure, u10 [m s-1]."""
    sol = cfc_solubility(cfg.gas, T, S) * 1e3       # mol m-3 atm-1
    c_sat = sol * pcfc_atm
    sc = cfc_schmidt(cfg.gas, T)
    # the OCMIP2 piston velocity a u10^2 (Sc/660)^-1/2, cm/hr -> m/s
    kw = cfg.piston_coeff * u10 * u10 * torch.sqrt(
        660.0 / torch.clamp(sc, min=1.0)) * (0.01 / 3600.0)
    return kw * (c_sat - c_surf)


def register_cfcs(reg, shape, u10: float = 8.0,
                  pcfc11_atm: float = 270.0e-12,
                  pcfc12_atm: float = 465.0e-12,
                  piston_coeff: float = 0.31, *, device,
                  dtype: torch.dtype) -> dict:
    """CFC-11 and CFC-12, each with a column function that adds
    kw (C_sat - C_surf) dt / h to the surface layer from the model's own
    SST and SSS; ``u10`` is a constant exchange wind [m s-1] and the
    atmospheric partial pressures are constants.  Returns their zero
    initial fields."""
    out = {}
    for name, patm in (("cfc11", pcfc11_atm), ("cfc12", pcfc12_atm)):
        cfg = CFCCfg(gas="CFC11" if name == "cfc11" else "CFC12",
                     piston_coeff=piston_coeff)

        def col(tr, h, dt, state=None, patm=patm, cfg=cfg, **ctx):
            if state is None or state.T is None:
                return tr
            F = cfc_surface_flux(cfg, tr[0], state.T[0], state.S[0], u10,
                                 patm)
            top = tr[0] + dt * F / torch.clamp(h[0], min=1e-3)
            return torch.cat([top[None], tr[1:]], dim=0)
        reg.register(TracerMeta(name=name, longname=f"{name} mole conc",
                                units="mol m-3", column_fn=col))
        out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out
