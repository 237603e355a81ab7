"""Epineutral (along-neutral-surface) tracer diffusion.

Counterpart of ``mom6_tpu.tracer.neutral_diffusion``: the small-slope
rotated (Redi) tensor with z up and neutral slope S,

  F_h = -K (grad_z c + S dc/dz),   F_z = -K (S.grad_z c + |S|^2 dc/dz),

as conservative horizontal face fluxes (the plain-horizontal part and
the skew S dc/dz part), an explicit skew-vertical flux -K S.grad_z c at
the interior interfaces (telescoping in each column), and the |S|^2
diagonal through the implicit vertical diffusion solve.  The skew fluxes
pass a multidimensional flux-corrected limiter against the plain
diffusion's solution and the 7-point neighbourhood's range, so that no
cell leaves it.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.isopycnal_slopes import SlopeCfg, isoneutral_slopes
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1
from mom6_torch.tracer.vertdiff import tracer_vertdiff

__all__ = ["NeutralDiffCfg", "neutral_diffusion"]

_EPS = 1e-20


@dataclasses.dataclass(frozen=True)
class NeutralDiffCfg:
    khtr: float = 0.0
    slopes: SlopeCfg = SlopeCfg()
    max_diff_cfl: float = 0.2


def _pos(x):
    return torch.clamp(x, min=0.0)


def neutral_diffusion(domain, grid: Grid, vgrid, tracers: dict, h, T, S,
                      eos, dt, cfg: NeutralDiffCfg):
    """Rotated-tensor diffusion of ``tracers`` (T and S may be among
    them) on the slopes of (T, S); fields need 2 halo rings."""
    if cfg.khtr <= 0.0:
        return tracers
    sl = isoneutral_slopes(cfg.slopes, grid, vgrid, h, T, S, eos)
    kh_u = torch.clamp(cfg.max_diff_cfl * grid.dxCu ** 2 / dt,
                       max=cfg.khtr) * grid.mask2dCu
    kh_v = torch.clamp(cfg.max_diff_cfl * grid.dyCv ** 2 / dt,
                       max=cfg.khtr) * grid.mask2dCv
    kh_t = torch.clamp(cfg.max_diff_cfl
                       * torch.minimum(grid.dxT, grid.dyT) ** 2 / dt,
                       max=cfg.khtr) * grid.mask2dT
    h_u = 2.0 * h * ip1(h) / (h + ip1(h) + _EPS)
    h_v = 2.0 * h * jp1(h) / (h + jp1(h) + _EPS)
    hvol = h * grid.areaT + _EPS
    zc = torch.zeros_like(h[:1])

    def to_layers(s_int):
        return 0.5 * (torch.cat([zc, s_int], dim=0)
                      + torch.cat([s_int, zc], dim=0))

    def padz(x):
        return torch.cat([zc, x, zc], dim=0)

    sx = to_layers(sl.slope_x)
    sy = to_layers(sl.slope_y)
    sx_t = 0.5 * (sl.slope_x + im1(sl.slope_x))
    sy_t = 0.5 * (sl.slope_y + jm1(sl.slope_y))
    kv_pad = padz(kh_t * (sx_t ** 2 + sy_t ** 2))

    out = dict(tracers)
    for name, c in out.items():
        dcdz = padz((c[:-1] - c[1:]) / (0.5 * (h[:-1] + h[1:]) + _EPS))
        dcdz_l = 0.5 * (dcdz[:-1] + dcdz[1:])
        gx_raw = (ip1(c) - c) * grid.IdxCu * grid.mask2dCu
        gy_raw = (jp1(c) - c) * grid.IdyCv * grid.mask2dCv
        fx_d = kh_u * grid.dyCu * h_u * gx_raw
        fy_d = kh_v * grid.dxCv * h_v * gy_raw
        fx_s = kh_u * grid.dyCu * h_u * grid.mask2dCu \
            * sx * 0.5 * (dcdz_l + ip1(dcdz_l))
        fy_s = kh_v * grid.dxCv * h_v * grid.mask2dCv \
            * sy * 0.5 * (dcdz_l + jp1(dcdz_l))
        gxc = 0.5 * (gx_raw + im1(gx_raw))
        gyc = 0.5 * (gy_raw + jm1(gy_raw))
        gxc_i = 0.5 * (gxc[:-1] + gxc[1:])
        gyc_i = 0.5 * (gyc[:-1] + gyc[1:])
        g_int = -kh_t * (sx_t * gxc_i + sy_t * gyc_i)
        g_pad = padz(g_int)

        # flux-corrected limiter on the skew fluxes
        c_low = c + ((fx_d - im1(fx_d)) + (fy_d - jm1(fy_d))) * dt / hvol
        nbhd = torch.stack([c, c_low, ip1(c), im1(c), jp1(c), jm1(c)])
        c_up = torch.cat([c[:1], c[:-1]], dim=0)
        c_dn = torch.cat([c[1:], c[-1:]], dim=0)
        cmax = torch.maximum(torch.amax(nbhd, dim=0),
                             torch.maximum(c_up, c_dn))
        cmin = torch.minimum(torch.amin(nbhd, dim=0),
                             torch.minimum(c_up, c_dn))
        p_in = (_pos(fx_s) + _pos(-im1(fx_s)) + _pos(fy_s)
                + _pos(-jm1(fy_s))) * dt / hvol \
            + (_pos(g_pad[1:]) + _pos(-g_pad[:-1])) * dt / (h + _EPS)
        p_out = (_pos(-fx_s) + _pos(im1(fx_s)) + _pos(-fy_s)
                 + _pos(jm1(fy_s))) * dt / hvol \
            + (_pos(-g_pad[1:]) + _pos(g_pad[:-1])) * dt / (h + _EPS)
        r_in = torch.clamp(_pos(cmax - c_low) / (p_in + _EPS), max=1.0)
        r_out = torch.clamp(_pos(c_low - cmin) / (p_out + _EPS), max=1.0)
        fx_s = fx_s * torch.where(fx_s > 0,
                                  torch.minimum(r_in, ip1(r_out)),
                                  torch.minimum(r_out, ip1(r_in)))
        fy_s = fy_s * torch.where(fy_s > 0,
                                  torch.minimum(r_in, jp1(r_out)),
                                  torch.minimum(r_out, jp1(r_in)))
        r_up = torch.minimum(r_in[:-1], r_out[1:])
        r_dn = torch.minimum(r_out[:-1], r_in[1:])
        g_pad = padz(torch.where(g_int > 0, r_up * g_int, r_dn * g_int))

        fx = fx_d + fx_s
        fy = fy_d + fy_s
        dc = ((fx - im1(fx)) + (fy - jm1(fy))) * dt / hvol \
            + (g_pad[1:] - g_pad[:-1]) * dt / (h + _EPS)
        out[name] = tracer_vertdiff(c + dc, h, kv_pad, dt)
    return out
