"""Kraus-Turner-type bulk mixed layer of layer mode (counterpart of
``mom6_tpu.param.vertical.bulk_mixed_layer``).

The surface layer deepens by entraining the layers below while the TKE
of the wind work m* u*^3 dt and the surface buoyancy loss (decaying with
depth as exp(-z TKE_DECAY absf / u*), absf blending |f| with 2 Omega by
ML_OMEGA_FRAC), plus BULK_RI_ML times the mean kinetic energy released
by homogenizing the velocity jump, pays the potential-energy cost
dRL = g/(2 rho0) (R0_k htot - sum R0 h) per unit entrained thickness.
A layer the budget cannot take whole is entrained in part (one Newton
step on the decayed budget, as the JAX package), and the mixed layer
never ends shallower than HMIX_MIN.  The column is walked down once, in
a loop over k carrying the mixed layer's budget and contents.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["BulkMixedLayerCfg", "bulk_mixed_layer"]

_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class BulkMixedLayerCfg:
    mstar: float = 1.2           # MSTAR
    nstar: float = 0.15          # NSTAR
    bulk_ri: float = 0.05        # BULK_RI_ML
    tke_decay: float = 2.5       # TKE_DECAY
    hmix_min: float = 0.0        # HMIX_MIN [m]
    omega_frac: float = 0.0      # ML_OMEGA_FRAC
    omega: float = 7.2921e-5     # OMEGA [s-1]
    g: float = 9.81
    rho0: float = 1035.0
    h_min: float = 1e-3


def _f1(kh):
    """(1 - exp(-kh)) / kh, by its series below kh = 2e-5."""
    return torch.where(kh > 2e-5,
                       (1.0 - torch.exp(-kh)) / torch.clamp(kh, min=_EPS),
                       1.0 - kh * (0.5 - kh / 6.0))


def bulk_mixed_layer(cfg: BulkMixedLayerCfg, h, T, S, eos, ustar,
                     buoy_flux, dt, tracers: dict | None = None,
                     u=None, v=None, absf=None):
    """Mixed-layer deepening and homogenization.  ``ustar`` (nj, ni)
    [m s-1], ``buoy_flux`` the destabilizing-positive surface buoyancy
    flux [m2 s-3], ``u``/``v`` cell-centred velocities for the MKE
    release (None: none), ``absf`` |f| at h points for the decay (None:
    no decay).  Returns (h, T, S, tracers, hml)."""
    nk = h.shape[0]
    rho = eos.density(T, S, torch.zeros_like(T))

    tke = dt * (cfg.mstar * ustar ** 3
                + cfg.nstar * torch.clamp(buoy_flux, min=0.0)
                * torch.clamp(h[0], min=cfg.h_min))
    if absf is not None and cfg.tke_decay > 0.0:
        af = absf
        if cfg.omega_frac > 0.0:
            af = torch.sqrt(cfg.omega_frac * 4.0 * cfg.omega ** 2
                            + (1.0 - cfg.omega_frac) * af ** 2)
        idecay = cfg.tke_decay * af / torch.clamp(ustar, min=1e-10)
    else:
        idecay = torch.zeros_like(ustar)

    g_2rho0 = cfg.g / (2.0 * cfg.rho0)
    have_uv = u is not None and v is not None and cfg.bulk_ri > 0.0
    u3 = u if have_uv else torch.zeros_like(h)
    v3 = v if have_uv else torch.zeros_like(h)
    htot = h[0]
    r0h, th, sh = rho[0] * h[0], T[0] * h[0], S[0] * h[0]
    uh, vh = u3[0] * h[0], v3[0] * h[0]
    zero = torch.zeros_like(htot)
    h_ents = [zero]
    for k in range(1, nk):
        h_k, r0_k, t_k, s_k = h[k], rho[k], T[k], S[k]
        u_k, v_k = u3[k], v3[k]
        kh = idecay * h_k
        exp_kh = torch.exp(-kh)
        f1_kh = _f1(kh)
        dRL = g_2rho0 * (r0_k * htot - r0h)
        if have_uv:
            u_ml = uh / torch.clamp(htot, min=_EPS)
            v_ml = vh / torch.clamp(htot, min=_EPS)
            du2 = (u_ml - u_k) ** 2 + (v_ml - v_k) ** 2
            red_m = h_k * htot / torch.clamp(h_k + htot, min=_EPS)
            dmke_full = cfg.bulk_ri * 0.5 * red_m * du2
        else:
            dmke_full = torch.zeros_like(h_k)
        tke_full = exp_kh * tke - h_k * dRL * f1_kh + dmke_full
        full = (tke_full >= 0.0) | (htot + h_k <= cfg.hmix_min)
        # partial entrainment: one Newton step from h0 = TKE/dRL on
        # exp(-i h) TKE - h dRL = 0, floored by the HMIX_MIN deficit
        h0 = tke / torch.clamp(dRL, min=_EPS)
        e0 = torch.exp(-torch.clamp(idecay * h0, max=40.0))
        g0 = e0 * tke - h0 * dRL
        gp = idecay * e0 * tke + dRL
        h_part = h0 + g0 / torch.clamp(gp, min=_EPS)
        h_part = torch.where(dRL > 0.0, h_part, h_k)
        h_part = torch.maximum(h_part, cfg.hmix_min - htot)
        h_ent = torch.minimum(torch.clamp(torch.where(full, h_k, h_part),
                                          min=0.0), h_k)
        khe = idecay * h_ent
        dmke_e = 0.0
        if have_uv:
            red_e = h_ent * htot / torch.clamp(h_ent + htot, min=_EPS)
            dmke_e = cfg.bulk_ri * 0.5 * red_e * du2
            uh = uh + u_k * h_ent
            vh = vh + v_k * h_ent
        tke = torch.clamp(torch.exp(-khe) * tke - h_ent * dRL * _f1(khe)
                          + dmke_e, min=0.0)
        htot = htot + h_ent
        r0h = r0h + r0_k * h_ent
        th = th + t_k * h_ent
        sh = sh + s_k * h_ent
        h_ents.append(h_ent)

    h_ml = htot
    dh = torch.stack(h_ents)
    t_ml = th / torch.clamp(h_ml, min=_EPS)
    s_ml = sh / torch.clamp(h_ml, min=_EPS)
    fully = dh >= h - 1e-12 * torch.clamp(h, min=_EPS)

    def homog(t, t_ml_val):
        t_new = torch.where(fully, t_ml_val[None], t)
        return torch.cat([t_ml_val[None], t_new[1:]], dim=0)

    T_new = homog(T, t_ml)
    S_new = homog(S, s_ml)
    h_new = torch.cat([h_ml[None], (h - dh)[1:]], dim=0)
    out = None
    if tracers is not None:
        out = {}
        for name, t in tracers.items():
            tr_ml = (t[0] * h[0] + torch.sum(dh * t, dim=0)) \
                / torch.clamp(h_ml, min=_EPS)
            out[name] = homog(t, tr_ml)
    return h_new, T_new, S_new, out, h_ml
