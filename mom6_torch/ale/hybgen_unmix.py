"""Hybgen unmixing: prepare columns for a hybrid regrid.

Counterpart of ``mom6_tpu.ale.hybgen_unmix``: before a HYCOM-style
regrid, the deepest inflated layer is checked against its target
density and, when it is too light, water is entrained from it, swapped
with the layer above, or split off, so that the layer relaxes toward its
target without new water masses.

Every column at once: the deepest inflated layer ``kp`` of each column
is found by a reduction over the layers, its values are gathered with
``torch.gather``, written back where the layer index equals ``kp``, and
the three exclusive cases are blended with ``torch.where``.  As in the
JAX package, the deepest fixed layer is a configured integer and the
relaxation coefficient a scalar.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["HybgenUnmixCfg", "hybgen_unmix"]

_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class HybgenUnmixCfg:
    hybiso: float = 0.01      # HYBGEN_REMAP_DENSITY_MATCH [kg m-3]
    qhybrlx: float = 0.25     # HYBGEN_REGRID_RELAX [nondim]
    fixlay: int = 2           # deepest fixed-coordinate layer (1-based)
    ref_pressure: float = 2.0e7   # P_REF [Pa]
    h_thin: float = 1e-6      # vanished-layer threshold [m]


def _gather(x, idx):
    """x[idx] along the layer axis of each column; idx (nj, ni) ints."""
    return torch.gather(x, 0, idx[None])[0]


def _scatter(x, idx, val, K):
    """x with x[idx] := val in each column."""
    return torch.where(K == idx[None], val[None], x)


def hybgen_unmix(h, T, S, tracers, eos, rlay,
                 cfg: HybgenUnmixCfg = HybgenUnmixCfg()):
    """(h, T, S, tracers) with the deepest inflated layer unmixed toward
    its target density.  ``rlay``: the (nk,) target densities;
    ``tracers``: a dict of (nk, njh, nih) passive tracers, or None."""
    nk = h.shape[0]
    if nk < 3 or eos is None:
        return h, T, S, tracers
    tracers = tracers or {}
    K = torch.arange(nk, device=h.device).reshape(
        (-1,) + (1,) * (h.dim() - 1))
    p_ref = torch.full_like(T, cfg.ref_pressure)
    Rcv = eos.density(T, S, p_ref)
    tgt = rlay.reshape((-1,) + (1,) * (h.dim() - 1)) * torch.ones_like(h)
    # unmixing needs the 1-based layer index above fixlay + 1: the 0-based
    # kp above fixlay
    fix0 = cfg.fixlay

    # the deepest layer k >= 2 (0-based) of significant thickness
    kp = torch.amax(torch.where((h >= cfg.h_thin) & (K >= 2), K, 1), dim=0)

    def col(idx):
        return tuple(_gather(x, idx) for x in (h, T, S, Rcv, tgt))

    km1 = torch.clamp(kp - 1, min=0)
    h_k, T_k, S_k, R_k, G_k = col(kp)
    h_m, T_m, S_m, R_m, G_m = col(km1)
    R_a = _gather(Rcv, torch.clamp(kp - 2, min=0))

    base = (kp > fix0) & (h_m >= cfg.h_thin) & (G_k > R_k)
    cond_A = base & (R_m > R_k) & (R_a > R_k)
    cond_B = base & (R_m > R_k) & ~cond_A

    # case A: the whole too-light bottom layer entrained upward
    qA = h_k / ((h_k + h_m) + _EPS)
    hA_m = h_m + h_k
    # case B: the layer swapped with (a part of) the one above
    thin_b = h_k <= h_m
    qB = torch.where(thin_b, h_k / (h_m + _EPS), h_m / (h_k + _EPS))

    def apply_AB(x):
        x_k, x_m = _gather(x, kp), _gather(x, km1)
        xA_m = x_m - qA * (x_m - x_k)
        xB_m = torch.where(thin_b, x_m + qB * (x_k - x_m), x_k)
        xB_k = torch.where(thin_b, x_m, x_k + qB * (x_m - x_k))
        x_m_new = torch.where(cond_A, xA_m, torch.where(cond_B, xB_m, x_m))
        x = _scatter(x, km1, x_m_new, K)
        return _scatter(x, kp, torch.where(cond_B, xB_k, x_k), K)

    T = apply_AB(T)
    S = apply_AB(S)
    tracers = {name: apply_AB(tr) for name, tr in tracers.items()}
    h = _scatter(h, km1, torch.where(cond_A, hA_m, h_m), K)
    h = _scatter(h, kp, torch.where(cond_A, torch.zeros_like(h_k), h_k), K)
    # after a full entrainment the deepest inflated layer is one higher
    kp = torch.where(cond_A, km1, kp)

    # case C: the too-light layer split into a part at its target density
    # and a part matching the layer above
    Rcv = eos.density(T, S, p_ref)
    km1 = torch.clamp(kp - 1, min=0)
    h_k, T_k, S_k, R_k, G_k = col(kp)
    h_m, T_m, S_m, R_m, G_m = col(km1)
    G_m2 = _gather(tgt, torch.clamp(kp - 2, min=0))

    cond_C = ((kp > fix0) & (h_m >= cfg.h_thin)
              & (R_k < G_k) & (R_k > G_m)
              & ((G_m - R_m).abs() < cfg.hybiso)
              & (R_k - R_m > 0.001 * (G_k - G_m)))

    # the anchor layer: the deepest kt <= kp-2 at least one target
    # interval lighter than layer kp-1
    cand = ((K <= (kp - 2)[None]) & (K >= 1)
            & ((R_m[None] - Rcv) >= (G_m - G_m2)[None]))
    kaC = torch.amax(torch.where(cand, K, 0), dim=0)
    T_a = _gather(T, kaC)
    S_a = _gather(S, kaC)

    delsm = (S_a - S_m).abs()
    dels = (S_m - S_k).abs()
    deltm = (T_a - T_m).abs()
    delt = (T_m - T_k).abs()
    dRdT, dRdS = eos.density_derivs(T_m, S_m,
                                    torch.full_like(T_m, cfg.ref_pressure))
    dG = G_k - G_m
    deltm = torch.minimum(deltm, dG / (dRdT.abs() + _EPS))
    delsm = torch.minimum(delsm, dG / (dRdS.abs() + _EPS))

    qts = torch.zeros_like(dels)
    lim_s = torch.minimum(delsm - dels, dels)
    qts = torch.where(qts * dels < lim_s, lim_s / (dels + _EPS), qts)
    lim_t = torch.minimum(deltm - delt, delt)
    qts = torch.where(qts * delt < lim_t, lim_t / (delt + _EPS), qts)

    use_R = (1.0 + qts) * (G_k - R_k) < qts * (G_k - R_m)
    q = torch.where(use_R,
                    cfg.qhybrlx * (G_k - R_k) / ((G_k - R_m) + _EPS),
                    cfg.qhybrlx * qts / (1.0 + qts))
    q = torch.clamp(q, 0.0, 0.5)
    frac_dts = q / (1.0 - q)
    h_hat = torch.where(cond_C, q * h_k, 0.0)
    h_m_new = h_m + h_hat

    h = _scatter(h, km1, h_m_new, K)
    h = _scatter(h, kp, h_k - h_hat, K)
    T = _scatter(T, kp, torch.where(cond_C, T_k + frac_dts * (T_k - T_m),
                                    T_k), K)
    S = _scatter(S, kp, torch.where(cond_C, S_k + frac_dts * (S_k - S_m),
                                    S_k), K)
    qtr = h_hat / (h_m_new + _EPS)
    out = {}
    for name, tr in tracers.items():
        t_k, t_m = _gather(tr, kp), _gather(tr, km1)
        out[name] = _scatter(tr, km1, torch.where(
            cond_C, t_m + qtr * (t_k - t_m), t_m), K)
    return h, T, S, out
