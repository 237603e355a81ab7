"""Shear-driven mixing: the Jackson-Hallberg-Legg (2008) scheme
(counterpart of ``mom6_tpu.param.vertical.kappa_shear``).

The steady balance of turbulent kinetic energy Q and diffusivity kappa
at the interfaces,

  TKE:    d/dz[(kappa + kappa_0) dQ/dz] + kappa (S^2 - N^2) + kappa_0 S^2
              = (Q - q_0) sqrt(c_N^2 N^2 + c_S^2 S^2)
  kappa:  d^2 kappa/dz^2 + K_src - kappa / L_d^2 = 0,

with the source K_src = 2 Lambda |S| (Ri_c S^2 - N^2) / (Ri_c S^2 + C_f
N^2) where Ri < Ri_c and 1/L_d^2 = (N^2/lambda^2 + f^2)/Q + 1/L_bdry^2,
is solved per column by alternating the two linear tridiagonal problems
(block Gauss-Seidel, the kappa update damped by one half) MAX_RINO_IT
times.  Each Thomas solve is a forward and a backward loop over k in the
JAX package's order.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.parallel.stencil import im1, jm1

__all__ = ["KappaShearCfg", "kappa_shear_coeffs"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class KappaShearCfg:
    rino_crit: float = 0.25       # RINO_CRIT
    # thickness floor that keeps S^2, 1/dz and the pivots finite where
    # layers vanish
    dz_min: float = 0.01          # [m]
    shearmix_rate: float = 0.089  # SHEARMIX_RATE (Lambda)
    fri_curvature: float = -0.97  # FRI_CURVATURE
    c_n: float = 0.24             # TKE_N_DECAY_CONST
    c_s: float = 0.14             # TKE_SHEAR_DECAY_CONST
    lam: float = 0.82             # KAPPA_SHEAR_LAMBDA
    max_rino_it: int = 24         # MAX_RINO_IT: Gauss-Seidel sweeps
    kappa_0: float = 1e-7         # background kappa [m2 s-1]
    kd_max: float = 1.0           # KAPPA_SHEAR_MAX [m2 s-1]
    tke_bg: float = 0.0           # TKE_BACKGROUND [m2 s-2]
    tke_min: float = 1e-12


def _thomas(lo, dg, up, rhs):
    """Tridiagonal solve along the leading axis: lo[k] x[k-1] + dg[k]
    x[k] + up[k] x[k+1] = rhs[k]."""
    n = rhs.shape[0]
    cps, dps = [], []
    cp = dp_ = torch.zeros_like(rhs[0])
    for k in range(n):
        inv = 1.0 / (dg[k] - lo[k] * cp)
        cp, dp_ = up[k] * inv, (rhs[k] - lo[k] * dp_) * inv
        cps.append(cp)
        dps.append(dp_)
    x = [None] * n
    xk = torch.zeros_like(rhs[0])
    for k in range(n - 1, -1, -1):
        xk = dps[k] - cps[k] * xk
        x[k] = xk
    return torch.stack(x)


def kappa_shear_coeffs(cfg: KappaShearCfg, u, v, h, n2, f2=None):
    """kappa at the interior interfaces (nk-1, ...) from the JHL steady
    balance: u, v at the faces, h the layer thicknesses, n2 at the
    interior interfaces, f2 the optional squared Coriolis parameter at h
    points."""
    u_h = 0.5 * (u + im1(u))
    v_h = 0.5 * (v + jm1(v))
    hf = torch.clamp(h, min=cfg.dz_min)
    dzi = 0.5 * (hf[:-1] + hf[1:])
    du = (u_h[1:] - u_h[:-1]) / dzi
    dv = (v_h[1:] - v_h[:-1]) / dzi
    s2 = du * du + dv * dv
    n2p = torch.clamp(n2, min=0.0)
    if f2 is None:
        f2 = torch.zeros_like(s2[0])

    ric = cfg.rino_crit
    zero = torch.zeros_like(s2)
    k_src = torch.where(
        n2p < ric * s2,
        (2.0 * cfg.shearmix_rate * torch.sqrt(s2))
        * ((ric * s2 - n2p)
           / torch.clamp(ric * s2 + cfg.fri_curvature * n2p, min=_EPS)),
        zero)
    tke_decay = torch.sqrt(cfg.c_n ** 2 * n2p + cfg.c_s ** 2 * s2) + _EPS

    # boundary length scale 1/L^2 = (zt + zb)^2 / (zt zb)^2
    z_t = torch.cumsum(hf, dim=0)[:-1] + _EPS
    htot = torch.sum(hf, dim=0)[None]
    z_b = torch.clamp(htot - z_t, min=_EPS)
    i_l2_bdry = ((z_t + z_b) ** 2) / ((z_t * z_b) ** 2)

    h_mid = hf[1:-1]
    idz = 1.0 / h_mid
    ilam2 = 1.0 / cfg.lam ** 2
    q0 = cfg.tke_bg

    kappa = torch.full_like(s2, cfg.kappa_0)
    # cold start of the TKE from the mixing length, Q ~ (lambda L S)^2
    q = torch.clamp(cfg.lam ** 2 * s2 / i_l2_bdry, min=cfg.tke_min)
    zrow = torch.zeros_like(s2[:1])
    lo_k = torch.cat([zrow, -idz], dim=0)
    up_k = torch.cat([-idz, zrow], dim=0)
    src = dzi * k_src
    for _ in range(cfg.max_rino_it):
        # kappa given Q
        i_ld2 = (n2p * ilam2 + f2[None]) / q + i_l2_bdry
        dg_k = dzi * i_ld2 - lo_k - up_k
        kappa_new = torch.clamp(_thomas(lo_k, dg_k, up_k, src), 0.0,
                                cfg.kd_max)
        kappa = 0.5 * (kappa + kappa_new)
        # Q given kappa
        aq = (0.5 * (kappa[:-1] + kappa[1:]) + cfg.kappa_0) * idz
        lo = torch.cat([zrow, -aq], dim=0)
        up = torch.cat([-aq, zrow], dim=0)
        dg = dzi * tke_decay - lo - up
        rhs = dzi * (kappa * (s2 - n2p) + cfg.kappa_0 * s2
                     + q0 * tke_decay)
        q = torch.clamp(_thomas(lo, dg, up, rhs), min=cfg.tke_min)
        # with no shear and no stratification the TKE matrix is diagonally
        # dominant only by dzi * 1e-14, which float32 rounds away: its last
        # pivot is 0 and the column NaN.  Its right-hand side is then 0,
        # so Q is taken at its floor there; in float64 the pivot keeps its
        # dzi * 1e-14 and Q stays finite
        q = torch.where(torch.isfinite(q), q, torch.full_like(q, cfg.tke_min))
    # diffusivities below 0.01 kappa_0 round to zero (KAPPA_TRUNCATE)
    kappa = torch.where(kappa < 0.01 * cfg.kappa_0, zero, kappa)
    return torch.clamp(kappa, 0.0, cfg.kd_max)
