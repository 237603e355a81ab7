"""Layer-mode diapycnal entrainment in the diffusive limit.

Counterpart of ``mom6_tpu.param.vertical.entrain_diffusive`` (Hallberg,
MWR 2000; MOM_entrain_diffusive.F90 entrainment_diffusive): interior
diapycnal diffusion Kd migrates the interfaces of a layered column,
expressed as the entrainments ea/eb of each layer from its neighbours.
The implicit solver of the JAX package is ported: the layer density
fluxes F from the damped-Newton / tridiagonal sweep (``max_ent_it``
fixed iterations) between the no-depletion bounds maxF and the
no-interaction floor minF, F turned into ea/eb, the thickness update
and an implicit Thomas solve for the tracers.  The JAX package's
``lax.scan`` recursions over layers are loops over layers here, each
step vectorized over the columns.  The explicit solver
(``implicit=False``) is the JAX package's donor-limited forward
exchange f = dt Kd (1/h_below - 1/h_above), clipped to a fraction of the
donor layer, with upwind tracer contents.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["EntrainDiffusiveCfg", "entrainment_diffusive"]

_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class EntrainDiffusiveCfg:
    frac_max: float = 0.2        # max fraction of a donor layer / step
    h_min: float = 1e-3          # thickness floor in the 1/h rates
    implicit: bool = True        # Hallberg-2000 implicit F solve
    max_ent_it: int = 5          # MAX_ENT_IT (Newton sweeps)
    angstrom: float = 1e-10      # minimum layer thickness [m]
    h_neglect: float = 1e-30


def _no_deplete_bounds(cfg: EntrainDiffusiveCfg, h, dsp1_ds, ds_dsp1):
    """maxF: the largest flux that depletes no layer below Angstrom
    (MOM_entrain_diffusive.F90:407-470, zero surface buoyancy)."""
    nk = h.shape[0]
    havail = h - cfg.angstrom
    m = [torch.zeros_like(h[0])]
    mprev, htot = m[0], havail[0]
    for k in range(1, nk):
        mprev = ds_dsp1[k] * (mprev + htot)
        htot = htot + havail[k]
        m.append(mprev)
    m[nk - 1] = torch.zeros_like(h[0])
    out = [None] * nk
    out[nk - 1] = m[nk - 1]
    mnext, htot = m[nk - 1], havail[nk - 1]
    for k in range(nk - 2, -1, -1):
        mnext = torch.minimum(m[k], dsp1_ds[k + 1] * mnext + htot)
        htot = htot + havail[k]
        out[k] = mnext
    return torch.stack(out, dim=0)


def _implicit_F(cfg: EntrainDiffusiveCfg, h, dtkd, dsp1_ds, ds_dsp1):
    """The damped-Newton / tridiagonal sweep for the layer fluxes F
    (MOM_entrain_diffusive.F90:538-585), F pinned to 0 in the top and
    bottom layers."""
    nk = h.shape[0]
    hm = h + cfg.h_neglect
    I2p2 = 0.5 / (1.0 + dsp1_ds)
    fkq = (2.0 * (2.0 + dsp1_ds + ds_dsp1)) * dtkd
    maxF = _no_deplete_bounds(cfg, h, dsp1_ds, ds_dsp1)
    F = torch.minimum(torch.minimum(maxF, torch.sqrt(ds_dsp1 * dtkd)),
                      0.5 * (ds_dsp1 + 1.0) * (dtkd / hm))
    minF = torch.minimum(maxF, 0.9 * I2p2 * fkq
                         / (hm + torch.sqrt(hm * hm + fkq)))
    zero = torch.zeros_like(h[0])
    F = [zero] + list(F[1:nk - 1]) + [zero]
    minF = torch.cat([zero[None], minF[1:nk - 1], zero[None]], dim=0)

    for _ in range(cfg.max_ent_it):
        # forward pass over k = 1..nk-2 (the JAX package's fwd scan)
        b1, F_km1, dF_km1 = torch.ones_like(zero), F[0], zero
        F_mid, Fprev_mid, c1_mid = [], [], []
        for k in range(1, nk - 1):
            fm = (F_km1 - h[k]) + dsp1_ds[k + 1] * F[k + 1]
            fr = torch.sqrt(fm * fm + fkq[k])
            Fhat = torch.where(
                fm >= 0.0, I2p2[k] * (fm + fr),
                I2p2[k] * fkq[k] / torch.clamp(fr - fm, min=_EPS))
            Fhat = torch.minimum(Fhat, maxF[k])
            dF = torch.where((Fhat >= maxF[k]) | (fr <= 0.0), 0.0,
                             I2p2[k] * (fr + fm) / torch.clamp(fr, min=_EPS))
            if k >= 2:
                # tridiagonal coupling acceleration (:571-577)
                c1 = dF_km1 * (dsp1_ds[k] * b1)
                b1 = 1.0 / torch.clamp(1.0 - c1 * dF, min=1e-12)
                F_k = torch.minimum(b1 * (Fhat - F[k]) + F[k], maxF[k])
                dF = torch.where(F_k >= maxF[k], 0.0, dF)
            else:
                c1 = zero
                F_k = Fhat
            F_mid.append(F_k)
            Fprev_mid.append(F[k])
            c1_mid.append(c1)
            F_km1, dF_km1 = F_k, dF
        # backward pass (the bwd scan)
        new = [None] * (nk - 2)
        F_kp1, Fprev_kp1, c1_kp1 = zero, zero, zero
        for i in range(nk - 3, -1, -1):
            F_fin = torch.minimum(F_mid[i] + c1_kp1 * (F_kp1 - Fprev_kp1),
                                  maxF[i + 1])
            new[i] = F_fin
            F_kp1, Fprev_kp1, c1_kp1 = F_fin, Fprev_mid[i], c1_mid[i]
        F_new = torch.stack([zero] + new + [zero], dim=0)
        F = list(torch.maximum(F_new, minF))
    return torch.stack(F, dim=0)


def _thomas_entrain(ea, eb, h, tr):
    """Implicit tracer update on the entrainments (triDiagTS):
    (h+ea+eb) T_k - ea T_{k-1} - eb T_{k+1} = h T_k_old."""
    nk = h.shape[0]
    rhs = h * tr
    q_km1 = torch.zeros_like(h[0])
    r_km1 = torch.zeros_like(rhs[0])
    qs, rs = [], []
    for k in range(nk):
        b = (h[k] + ea[k] + eb[k]) - ea[k] * q_km1
        binv = 1.0 / torch.clamp(b, min=_EPS)
        q_km1 = eb[k] * binv
        r_km1 = (rhs[k] + ea[k] * r_km1) * binv
        qs.append(q_km1)
        rs.append(r_km1)
    out = [None] * nk
    t_kp1 = torch.zeros_like(rhs[0])
    for k in range(nk - 1, -1, -1):
        t_kp1 = rs[k] + qs[k] * t_kp1
        out[k] = t_kp1
    return torch.stack(out, dim=0)


def _ratios(h, gprime):
    """(dsp1_ds, ds_dsp1) per layer from the interface reduced
    gravities (rows 0 and nk-1 unused or forced to 0)."""
    nk = h.shape[0]
    dd = torch.ones(nk, dtype=h.dtype, device=h.device)
    dp = torch.ones(nk, dtype=h.dtype, device=h.device)
    if gprime is not None:
        gp = torch.as_tensor(gprime, dtype=h.dtype, device=h.device)
        gp = torch.where(gp > 0.0, torch.clamp(gp, min=_EPS), 1.0)
        dd[1:nk - 1] = gp[1:nk - 1] / gp[2:nk]
        dp[1:nk - 1] = gp[2:nk] / gp[1:nk - 1]
    dd[nk - 1] = 0.0
    dp[nk - 1] = 0.0
    shape = (-1,) + (1,) * (h.dim() - 1)
    return (dp.reshape(shape) * torch.ones_like(h),
            dd.reshape(shape) * torch.ones_like(h))


def _entrain_implicit(cfg, h, kd_int, dt, tracers, gprime):
    nk = h.shape[0]
    dtkd = dt * (0.5 * (kd_int[:-1] + kd_int[1:nk + 1]))
    dsp1_ds, ds_dsp1 = _ratios(h, gprime)
    F = _implicit_F(cfg, h, dtkd, dsp1_ds, ds_dsp1)

    zrow = torch.zeros_like(F[:1])
    eb = torch.clamp(F, min=0.0)
    F_km1 = torch.cat([zrow, F[:-1]], dim=0)
    eb_km1 = torch.cat([zrow, eb[:-1]], dim=0)
    ea_raw = dsp1_ds * F - (F_km1 - eb_km1)
    ea = torch.cat([zrow, torch.clamp(ea_raw[1:], min=0.0)], dim=0)
    neg = torch.cat([zrow, torch.clamp(ea_raw[1:], max=0.0)], dim=0)
    eb = eb - torch.cat([neg[1:], zrow], dim=0)
    eb = torch.cat([eb[:-1], zrow], dim=0)

    ea_kp1 = torch.cat([ea[1:], zrow], dim=0)
    eb_km1 = torch.cat([zrow, eb[:-1]], dim=0)
    h_new = h + (ea + eb) - (ea_kp1 + eb_km1)

    out = None
    if tracers is not None:
        names = list(tracers)
        stacked = torch.stack([tracers[n] for n in names], dim=1)
        t_new = _thomas_entrain(ea[:, None], eb[:, None], h[:, None],
                                stacked)
        out = {n: t_new[:, i] for i, n in enumerate(names)}
    f_full = torch.cat([zrow, ea[1:] - eb[:-1], zrow], dim=0)
    return h_new, out, f_full


def entrainment_diffusive(cfg: EntrainDiffusiveCfg, h, kd_int, dt,
                          tracers: dict | None = None, gprime=None):
    """Apply diffusive entrainment to thicknesses (and tracers).

    h: (nk, ...) layer thickness; kd_int: (nk+1, ...) interface
    diffusivity [m2 s-1]; gprime: optional (nk+1,) reduced gravities.
    Returns (h_new, tracers_new, f), f the (nk+1, ...) interface
    exchange (positive: the layer below gained mass from above)."""
    if cfg.implicit:
        kdi = kd_int.expand((h.shape[0] + 1,) + tuple(h.shape[1:]))
        return _entrain_implicit(cfg, h, kdi, dt, tracers, gprime)
    nk = h.shape[0]
    h_up, h_dn = h[:-1], h[1:]
    f = kd_int[1:nk] * dt * (1.0 / torch.clamp(h_dn, min=cfg.h_min)
                             - 1.0 / torch.clamp(h_up, min=cfg.h_min))
    # a downward transfer draws on the layer above, an upward one on the
    # layer below
    f = torch.minimum(torch.maximum(f, -cfg.frac_max * h_dn),
                      cfg.frac_max * h_up)
    zero = torch.zeros_like(h[:1])
    f_full = torch.cat([zero, f, zero], dim=0)
    h_new = h + f_full[:-1] - f_full[1:]
    out = None
    if tracers is not None:
        out = {}
        for name, t in tracers.items():
            t_up = torch.cat([t[:1], t[:-1]], dim=0)
            t_don = torch.where(f_full[:-1] > 0, t_up, t)
            t_don_b = torch.cat([t_don[1:], t[-1:]], dim=0)
            content = t * h + f_full[:-1] * t_don - f_full[1:] * t_don_b
            out[name] = content / torch.clamp(h_new, min=_EPS)
    return h_new, out, f_full
