"""Lateral (along-layer) tracer diffusion.

Counterpart of ``mom6_tpu.tracer.hor_diff``: Laplacian diffusion along
layers with harmonic-mean face thicknesses, exactly conservative, in
``passes`` sub-steps whose face coefficient is bounded by the diffusive
CFL.  The coefficient is KHTR or a 2-D field (MEKE's share), plus the
Visbeck face term of KHTR_SLOPE_CFF, capped by KHTR_MAX, scaled by the
resolution function (RESOLN_SCALED_KHTR) and floored at KHTR_MIN.  Under
DIFFUSE_ML_TO_INTERIOR the mixed layer diffuses along layers only at
ML_KHTR_SCALE, the buffer layers not at all, and the mixed-layer and
buffer water of a column exchanges with the density-matched interior
layer of its neighbours (``ml_epipycnal_diff``).
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["TracerHorDiffCfg", "tracer_hordiff", "ml_epipycnal_diff"]

_H_NEGLECT = 1e-20


@dataclasses.dataclass(frozen=True)
class TracerHorDiffCfg:
    khtr: float = 0.0             # KHTR [m2 s-1]
    khtr_min: float = 0.0         # KHTR_MIN
    khtr_max: float = -1.0        # KHTR_MAX (<= 0: none)
    max_diff_cfl: float = 0.2     # per-pass diffusive CFL bound
    passes: int = 2
    khtr_slope_cff: float = 0.0   # KHTR_SLOPE_CFF
    diffuse_ml_to_interior: bool = False   # DIFFUSE_ML_TO_INTERIOR
    ml_khtr_scale: float = 1.0    # ML_KHTR_SCALE
    nkml: int = 0                 # mixed-layer layers (NKML)
    nkmb: int = 0                 # nkml + buffer layers
    p_ref: float = 2.0e7          # coordinate-density P_REF [Pa]


def _cfl_coef(grid, kh_u0, kh_v0, cfg, dt_pass):
    """The per-pass CFL-bounded face coefficients."""
    kh_u = torch.clamp(cfg.max_diff_cfl * grid.dxCu ** 2 / dt_pass,
                       max=kh_u0)
    kh_v = torch.clamp(cfg.max_diff_cfl * grid.dyCv ** 2 / dt_pass,
                       max=kh_v0)
    return kh_u * grid.mask2dCu, kh_v * grid.mask2dCv


def tracer_hordiff(domain, grid: Grid, tracers: dict, h, dt,
                   cfg: TracerHorDiffCfg, khtr_2d=None, res_u=None,
                   res_v=None, add_u=None, add_v=None, rho_ml=None,
                   rlay=None):
    """Diffuse each tracer along layers over dt; h needs 1 halo ring.
    ``khtr_2d``: an (njh, nih) coefficient replacing KHTR; ``add_u``/
    ``add_v``: face terms added before KHTR_MAX; ``res_u``/``res_v``:
    face factors after KHTR_MAX and before KHTR_MIN; ``rho_ml``: the
    coordinate density of the mixed-layer and buffer layers and
    ``rlay`` the layers' target densities, for the epipycnal exchange."""
    if cfg.khtr <= 0.0 and khtr_2d is None and add_u is None:
        return tracers
    kh0 = khtr_2d if khtr_2d is not None else cfg.khtr

    def face_coef(kh_add, res):
        k = torch.as_tensor(kh0 if kh_add is None else kh0 + kh_add,
                            dtype=h.dtype, device=h.device)
        if cfg.khtr_max > 0:
            k = torch.clamp(k, max=cfg.khtr_max)
        if res is not None:
            k = k * res
        return torch.clamp(k, min=cfg.khtr_min)

    kh_u0 = face_coef(add_u, res_u)
    kh_v0 = face_coef(add_v, res_v)

    layer_scale = None
    if cfg.diffuse_ml_to_interior and cfg.nkmb > 0:
        kidx = torch.arange(h.shape[0], device=h.device).reshape(
            (-1,) + (1,) * (h.dim() - 1))
        one = torch.ones((), dtype=h.dtype, device=h.device)
        layer_scale = torch.where(
            kidx < cfg.nkml, cfg.ml_khtr_scale * one,
            torch.where(kidx < cfg.nkmb, 0.0 * one, one))

    out = dict(tracers)
    dt_pass = dt / cfg.passes
    for _ in range(cfg.passes):
        kh_u, kh_v = _cfl_coef(grid, kh_u0, kh_v0, cfg, dt_pass)
        h_u = 2.0 * h * ip1(h) / (h + ip1(h) + _H_NEGLECT)
        h_v = 2.0 * h * jp1(h) / (h + jp1(h) + _H_NEGLECT)
        coef_u = kh_u * grid.dyCu * grid.IdxCu * h_u
        coef_v = kh_v * grid.dxCv * grid.IdyCv * h_v
        if layer_scale is not None:
            coef_u = coef_u * layer_scale
            coef_v = coef_v * layer_scale
        hvol = h * grid.areaT + _H_NEGLECT
        for name, t in out.items():
            fx = coef_u * (ip1(t) - t)
            fy = coef_v * (jp1(t) - t)
            dtr = ((fx - im1(fx)) + (fy - jm1(fy))) * dt_pass
            out[name] = t + dtr / hvol
        out = domain.fill_halos(out, width=1)
    if cfg.diffuse_ml_to_interior and cfg.nkmb > 0 and rho_ml is not None:
        out = ml_epipycnal_diff(domain, grid, out, h, rho_ml, rlay, dt,
                                cfg, kh_u0, kh_v0)
    return out


def _epi_pair_fluxes(c, h, kR, coef, ml_sl):
    """The exchange between the mixed-layer/buffer layers of a column
    (c[:nkmb]) and the layers kR of the neighbour that ``ml_sl`` shifts
    in: the tendency of the own layers, and the scatter of its negative
    onto the neighbour's layers, both [conc m3 s-1]."""
    nz, nkmb = h.shape[0], kR.shape[0]
    own_c, own_h = c[:nkmb], h[:nkmb]
    oth_ct = torch.gather(ml_sl(c), 0, kR)
    oth_ht = torch.gather(ml_sl(h), 0, kR)
    hpair = 2.0 * own_h * oth_ht / (own_h + oth_ht + _H_NEGLECT)
    f = coef * hpair * (oth_ct - own_c)
    scat = torch.zeros_like(c).scatter_add_(0, kR, f)
    d_own = torch.cat([f, torch.zeros_like(c[nkmb:])], dim=0)
    return d_own, scat


def ml_epipycnal_diff(domain, grid: Grid, tracers: dict, h, rho_ml, rlay,
                      dt, cfg: TracerHorDiffCfg, kh_u0, kh_v0):
    """Epipycnal diffusion of mixed-layer and buffer water into the
    neighbouring columns' interior layer of matching target density
    (the first interior layer whose Rlay is at least the water's
    coordinate density), with the along-layer scheme's harmonic
    thickness; exactly conservative."""
    nkmb = cfg.nkmb
    nz = h.shape[0]
    kR = torch.clamp(nkmb + torch.searchsorted(
        rlay[nkmb:].contiguous(), rho_ml.contiguous().reshape(-1),
        side="left").reshape(rho_ml.shape), nkmb, nz - 1)
    out = dict(tracers)
    dt_pass = dt / cfg.passes
    hvol = h * grid.areaT + _H_NEGLECT
    for _ in range(cfg.passes):
        kh_u, kh_v = _cfl_coef(grid, kh_u0, kh_v0, cfg, dt_pass)
        coef_u = kh_u * grid.dyCu * grid.IdxCu
        coef_v = kh_v * grid.dxCv * grid.IdyCv
        for name, t in out.items():
            d_e, scat_e = _epi_pair_fluxes(t, h, kR, coef_u, ip1)
            d_n, scat_n = _epi_pair_fluxes(t, h, kR, coef_v, jp1)
            dtr = (d_e + d_n) - (im1(scat_e) + jm1(scat_n))
            out[name] = t + dtr * dt_pass / hvol
        out = domain.fill_halos(out, width=1)
    return out
