"""Horizontal (along-layer) viscosity.

Counterpart of ``mom6_tpu.param.lateral.hor_visc``: stress-tensor
Laplacian and biharmonic friction with constant, velocity-scale
(KH_VEL_SCALE, AH_VEL_SCALE), Smagorinsky and Leith (with the modified
Leith divergence-gradient term) coefficients, which combine with the
background by their maximum or, with ADD_LES_VISCOSITY, their sum;
anisotropic viscosity along a fixed direction; the CFL stability
bounds; free slip or NOSLIP, with the land mask applied to cell
thicknesses or not (USE_LAND_MASK_FOR_HVISC); and the Zanna-Bolton
(ZB2020) stress added to the result.  Tension sh_xx lives at h points,
shearing strain sh_xy at q points; the divergence of the
thickness-weighted stress gives (diffu, diffv).  With USE_GME the
GME backscatter stress at the barotropic strain joins the stress
before the thickness weighting; the VarMix/MEKE coefficient inputs are
not ported (the steppers raise on them).  With
open boundaries the OBC_* flags zero the strain or vorticity components
on the q-point line of each open segment and the flow Laplacian at its
faces.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["HorViscCfg", "HorViscResult", "horizontal_viscosity"]

_H_NEGLECT = 1e-20
_INV_PI3 = 1.0 / math.pi ** 3
_INV_PI6 = _INV_PI3 * _INV_PI3


@dataclasses.dataclass(frozen=True)
class HorViscCfg:
    kh: float = 0.0               # KH background Laplacian [m2 s-1]
    ah: float = 0.0               # AH background biharmonic [m4 s-1]
    kh_vel_scale: float = 0.0     # KH_VEL_SCALE [m s-1]: Kh >= vel*dx
    ah_vel_scale: float = 0.0     # AH_VEL_SCALE [m s-1]: Ah >= vel*dx^3
    smag_lap_const: float = 0.0   # SMAG_LAP_CONST
    smag_bi_const: float = 0.0    # SMAG_BI_CONST
    leith_kh: bool = False        # LEITH_KH
    leith_lap_const: float = 0.0  # LEITH_LAP_CONST
    leith_ah: bool = False        # LEITH_AH
    leith_bi_const: float = 0.0   # LEITH_BI_CONST
    modified_leith: bool = False  # MODIFIED_LEITH (adds |grad div|)
    add_les_viscosity: bool = False   # ADD_LES_VISCOSITY
    anisotropic: bool = False     # ANISOTROPIC_VISCOSITY
    kh_aniso: float = 0.0         # KH_ANISO [m2 s-1]
    aniso_n: tuple = (1.0, 0.0)   # ANISO_GRID_DIR (n1, n2)
    use_zb2020: bool = False      # USE_ZB2020 (added to diffu/diffv)
    zb_scaling: float = 0.5       # ZB_SCALING
    zb_type: int = 0              # ZB_TYPE
    zb_cons: int = 0              # ZB_CONS
    laplacian: bool = False       # LAPLACIAN
    biharmonic: bool = False      # BIHARMONIC
    dt: float = 3600.0            # used only for the stability bounds
    # GME backscatter (USE_GME): an anti-viscous stress at the
    # barotropic strain with the coefficient
    # GME_EFFICIENCY min(htot/GME_H0, 1)^2 KHTH, capped at GME_LIMITER
    use_gme: bool = False         # USE_GME
    gme_h0: float = 1000.0        # GME_H0 [m]
    gme_efficiency: float = 1.0   # GME_EFFICIENCY
    gme_limiter: float = 1.0e7    # GME_LIMITER [m2 s-1]
    gme_kh: float = 0.0           # the GM coefficient fed back (KHTH)
    no_slip: bool = False         # NOSLIP
    use_land_mask: bool = True    # USE_LAND_MASK_FOR_HVISC
    # open segments: the shear and vorticity at their q points, the
    # biharmonic Laplacian at their faces
    obc_zero_vorticity: bool = False    # OBC_ZERO_VORTICITY
    obc_freeslip_vorticity: bool = False  # OBC_FREESLIP_VORTICITY
    obc_zero_strain: bool = False       # OBC_ZERO_STRAIN
    obc_freeslip_strain: bool = False   # OBC_FREESLIP_STRAIN
    obc_zero_biharmonic: bool = False   # OBC_ZERO_BIHARMONIC


class HorViscResult(NamedTuple):
    diffu: torch.Tensor
    diffv: torch.Tensor


def _zero_line(f, axis: int, index: int, line):
    """f with its row (axis -2) or column (axis -1) ``index`` zeroed where
    ``line`` (a bool vector, or True) holds."""
    out = f.clone()
    sel = (Ellipsis, index, slice(None)) if axis == -2 \
        else (Ellipsis, slice(None), index)
    out[sel] = 0.0 if line is True else torch.where(line, 0.0, f[sel])
    return out


def _strip_line(strip, axis: int, index: int):
    return True if strip is None else (strip[index, :] > 0 if axis == -2
                                       else strip[:, index] > 0)


def _obc_qline(f, obc, comps: str):
    """f zeroed on the q-point line of each open edge: N/S segments with
    ``comps`` "ns", E/W ones with "ew", all with "both"."""
    H, nj, ni = obc.halo, obc.njl, obc.nil
    if comps in ("ns", "both"):
        if obc.open_n:
            jq = H + nj - 1
            f = _zero_line(f, -2, jq, _strip_line(obc.strip_n, -2, jq))
        if obc.open_s:
            f = _zero_line(f, -2, H - 1, _strip_line(obc.strip_s, -2, H))
    if comps in ("ew", "both"):
        if obc.open_e:
            iq = H + ni - 1
            f = _zero_line(f, -1, iq, _strip_line(obc.strip_e, -1, iq))
        if obc.open_w:
            f = _zero_line(f, -1, H - 1, _strip_line(obc.strip_w, -1, H))
    return f


def _strains(grid: Grid, u, v, no_slip: bool, obc=None, cfg=None):
    """Tension at h points, shearing strain at q points (doubled at
    land corners with ``no_slip``), divergence at h points and relative
    vorticity at q points; with ``obc``, the OBC strain and vorticity
    flags of ``cfg`` act on the segments' q points."""
    DY_dxT = grid.dyT * grid.IdxT
    DX_dyT = grid.dxT * grid.IdyT
    DY_dxBu = grid.dyBu * grid.IdxBu
    DX_dyBu = grid.dxBu * grid.IdyBu
    dudx = DY_dxT * (grid.IdyCu * u - im1(grid.IdyCu * u))
    dvdy = DX_dyT * (grid.IdxCv * v - jm1(grid.IdxCv * v))
    dvdx = DY_dxBu * (ip1(grid.IdyCv * v) - grid.IdyCv * v)
    dudy = DX_dyBu * (jp1(grid.IdxCu * u) - grid.IdxCu * u)
    s_dvdx, s_dudy = dvdx, dudy          # strain components
    v_dvdx, v_dudy = dvdx, dudy          # vorticity components
    if obc is not None and cfg is not None:
        # zero strain kills both components; free slip only the
        # cross-boundary gradient of the tangential velocity (dudy on
        # N/S segments, dvdx on E/W ones); likewise for the vorticity
        if cfg.obc_zero_strain:
            s_dvdx = _obc_qline(s_dvdx, obc, "both")
            s_dudy = _obc_qline(s_dudy, obc, "both")
        elif cfg.obc_freeslip_strain:
            s_dudy = _obc_qline(s_dudy, obc, "ns")
            s_dvdx = _obc_qline(s_dvdx, obc, "ew")
        if cfg.obc_zero_vorticity:
            v_dvdx = _obc_qline(v_dvdx, obc, "both")
            v_dudy = _obc_qline(v_dudy, obc, "both")
        elif cfg.obc_freeslip_vorticity:
            v_dudy = _obc_qline(v_dudy, obc, "ns")
            v_dvdx = _obc_qline(v_dvdx, obc, "ew")
    fac = (2.0 - grid.mask2dBu) if no_slip else grid.mask2dBu
    return dudx - dvdy, fac * (s_dvdx + s_dudy), dudx + dvdy, \
        v_dvdx - v_dudy


def _combine(base, les, add):
    """Nonlinear coefficients take the maximum with the background, or
    add to it with ADD_LES_VISCOSITY."""
    return base + les if add else torch.maximum(base, les)


def _smooth9(f):
    """One 9-point smoothing pass (smooth_GME)."""
    c = 0.25 * f
    e = 0.125 * (ip1(f) + im1(f) + jp1(f) + jm1(f))
    x = 0.0625 * (ip1(jp1(f)) + im1(jp1(f)) + ip1(jm1(f)) + im1(jm1(f)))
    return c + e + x


def _gme_stress(grid: Grid, cfg: HorViscCfg, u_bt, v_bt, htot):
    """GME's (str_xx, str_xy): the coefficient at h and q points,
    capped, times the barotropic strain, smoothed once."""
    sh_xx_bt, sh_xy_bt, _, _ = _strains(grid, u_bt, v_bt, cfg.no_slip)
    effic_h = cfg.gme_efficiency * grid.mask2dT \
        * torch.clamp(htot / cfg.gme_h0, max=1.0) ** 2
    htot_q = 0.25 * ((htot + ip1(jp1(htot))) + (ip1(htot) + jp1(htot)))
    effic_q = cfg.gme_efficiency * grid.mask2dBu \
        * torch.clamp(htot_q / cfg.gme_h0, max=1.0) ** 2
    coeff_h = torch.clamp(effic_h * cfg.gme_kh, max=cfg.gme_limiter)
    coeff_q = torch.clamp(effic_q * cfg.gme_kh, max=cfg.gme_limiter)
    return (_smooth9(coeff_h * sh_xx_bt),
            _smooth9(coeff_q * sh_xy_bt) * grid.mask2dBu)


def horizontal_viscosity(grid: Grid, u, v, h,
                         cfg: HorViscCfg = HorViscCfg(), obc=None,
                         u_bt=None, v_bt=None, htot=None, kh_scale=None,
                         kh_extra=None) -> HorViscResult:
    """(diffu, diffv) [m s-2]; u, v need 2 valid halo rings, h one.
    ``obc``: the open boundaries the OBC_* flags of ``cfg`` act on.
    With USE_GME the caller gives the (2D) barotropic velocities
    ``u_bt``/``v_bt`` and the column thickness ``htot`` (sum of h when
    None); without u_bt the GME stress is left out, as in the JAX
    package.  ``kh_scale``: an (njh, nih) factor on the Laplacian
    viscosity (the resolution function, RESOLN_SCALED_KH; its 4-point
    mean at corners); ``kh_extra``: an (njh, nih) viscosity added after
    that scaling (MEKE's Ku); it may be negative, and the CFL bound then
    clips the coefficient from below as well."""
    zb = None
    if cfg.use_zb2020:
        # imported here: the closure takes this module's strains
        from mom6_torch.param.lateral.zanna_bolton import (ZB2020Cfg,
                                                           zb2020_accel)
        zb = zb2020_accel(grid, u, v, h, ZB2020Cfg(
            amplitude=cfg.zb_scaling, zb_type=cfg.zb_type,
            zb_cons=cfg.zb_cons))
    if not (cfg.laplacian or cfg.biharmonic):
        if zb is not None:
            return HorViscResult(zb.du, zb.dv)
        z = torch.zeros_like(u)
        return HorViscResult(z, z)

    dy2h = grid.dyT * grid.dyT
    dx2h = grid.dxT * grid.dxT
    dy2q = grid.dyBu * grid.dyBu
    dx2q = grid.dxBu * grid.dxBu
    sh_xx, sh_xy, div_xx, vort_xy = _strains(grid, u, v, cfg.no_slip,
                                             obc=obc, cfg=cfg)
    grid_sp_h2 = (2.0 * dx2h * dy2h) / (dx2h + dy2h + _H_NEGLECT)
    grid_sp_q2 = (2.0 * dx2q * dy2q) / (dx2q + dy2q + _H_NEGLECT)
    grid_sp_h3 = grid_sp_h2 * torch.sqrt(grid_sp_h2)
    grid_sp_q3 = grid_sp_q2 * torch.sqrt(grid_sp_q2)

    def shear_mag_h():
        s2 = sh_xy * sh_xy
        xy2 = 0.25 * ((s2 + im1(jm1(s2))) + (im1(s2) + jm1(s2)))
        return torch.sqrt(sh_xx * sh_xx + xy2)

    def shear_mag_q():
        s2 = sh_xx * sh_xx
        xx2 = 0.25 * ((s2 + ip1(jp1(s2))) + (ip1(s2) + jp1(s2)))
        return torch.sqrt(sh_xy * sh_xy + xx2)

    add = cfg.add_les_viscosity
    if cfg.leith_kh or cfg.leith_ah:
        # the vorticity gradient: d/dx at v points, d/dy at u points
        DY_dxBu = grid.dyBu * grid.IdxBu
        DX_dyBu = grid.dxBu * grid.IdyBu
        vdx = DY_dxBu * (vort_xy * grid.IdyCu - im1(vort_xy * grid.IdyCu))
        vdy = DX_dyBu * (vort_xy * grid.IdxCv - jm1(vort_xy * grid.IdxCv))
        gvort_h = torch.sqrt((0.5 * (vdx + jm1(vdx))) ** 2
                             + (0.5 * (vdy + im1(vdy))) ** 2)
        gvort_q = torch.sqrt((0.5 * (vdx + ip1(vdx))) ** 2
                             + (0.5 * (vdy + jp1(vdy))) ** 2)
        if cfg.modified_leith:
            ddx = (ip1(div_xx) - div_xx) * grid.IdxCu
            ddy = (jp1(div_xx) - div_xx) * grid.IdyCv
            gvort_h = gvort_h + torch.sqrt((0.5 * (ddx + im1(ddx))) ** 2
                                           + (0.5 * (ddy + jm1(ddy))) ** 2)
            gvort_q = gvort_q + torch.sqrt((0.5 * (ddx + jp1(ddx))) ** 2
                                           + (0.5 * (ddy + ip1(ddy))) ** 2)
        if cfg.leith_ah:
            # the Laplacian of vorticity at q points, averaged to h
            d2v_q = (DY_dxBu * (ip1(vdx * grid.IdyCv) - vdx * grid.IdyCv)
                     + DX_dyBu * (jp1(vdy * grid.IdxCu)
                                  - vdy * grid.IdxCu))
            d2v_h = 0.25 * ((d2v_q + im1(jm1(d2v_q)))
                            + (im1(d2v_q) + jm1(d2v_q)))

    str_xx = torch.zeros_like(sh_xx)
    str_xy = torch.zeros_like(sh_xy)
    if cfg.laplacian:
        Kh_h = torch.clamp(cfg.kh_vel_scale * torch.sqrt(grid_sp_h2),
                           min=cfg.kh)
        Kh_q = torch.clamp(cfg.kh_vel_scale * torch.sqrt(grid_sp_q2),
                           min=cfg.kh)
        if cfg.smag_lap_const > 0.0:
            Kh_h = _combine(Kh_h, cfg.smag_lap_const * grid_sp_h2
                            * shear_mag_h(), add)
            Kh_q = _combine(Kh_q, cfg.smag_lap_const * grid_sp_q2
                            * shear_mag_q(), add)
        if cfg.leith_kh:
            Kh_h = _combine(Kh_h, cfg.leith_lap_const * grid_sp_h3
                            * gvort_h * _INV_PI3, add)
            Kh_q = _combine(Kh_q, cfg.leith_lap_const * grid_sp_q3
                            * gvort_q * _INV_PI3, add)
        if cfg.anisotropic:
            n1, n2 = cfg.aniso_n
            nmag = math.hypot(n1, n2) or 1.0
            n1n2 = (n1 / nmag) * (n2 / nmag)
            n11_m_n22 = (n1 / nmag) ** 2 - (n2 / nmag) ** 2
            # the isotropic part of the anisotropic tensor
            Kh_h = Kh_h + cfg.kh_aniso * (1.0 - n1n2 ** 2)
            Kh_q = Kh_q + cfg.kh_aniso * n1n2 ** 2
        if kh_scale is not None:
            Kh_h = Kh_h * kh_scale
            Kh_q = Kh_q * (0.25 * ((kh_scale + ip1(jp1(kh_scale)))
                                   + (ip1(kh_scale) + jp1(kh_scale))))
        if kh_extra is not None:
            Kh_h = Kh_h + kh_extra
            Kh_q = Kh_q + 0.25 * ((kh_extra + ip1(jp1(kh_extra)))
                                  + (ip1(kh_extra) + jp1(kh_extra)))
        Kh_h = torch.minimum(Kh_h, 0.2 * grid_sp_h2 / cfg.dt)
        Kh_q = torch.minimum(Kh_q, 0.2 * grid_sp_q2 / cfg.dt)
        if kh_extra is not None:
            Kh_h = torch.maximum(Kh_h, -0.2 * grid_sp_h2 / cfg.dt)
            Kh_q = torch.maximum(Kh_q, -0.2 * grid_sp_q2 / cfg.dt)
        str_xx = str_xx - Kh_h * sh_xx
        str_xy = str_xy - Kh_q * sh_xy
        if cfg.anisotropic and cfg.kh_aniso != 0.0:
            # the cross-components of the direction tensor
            strain_h = 0.25 * ((sh_xy + im1(jm1(sh_xy)))
                               + (im1(sh_xy) + jm1(sh_xy)))
            strain_q = 0.25 * ((sh_xx + ip1(jp1(sh_xx)))
                               + (ip1(sh_xx) + jp1(sh_xx)))
            str_xx = str_xx - cfg.kh_aniso * n1n2 * n11_m_n22 * strain_h
            str_xy = str_xy - cfg.kh_aniso * n1n2 * n11_m_n22 * strain_q

    if cfg.biharmonic:
        Idxdy2u = grid.IdxCu * grid.IdyCu * grid.IdyCu
        Idx2dyCu = grid.IdxCu * grid.IdxCu * grid.IdyCu
        Idxdy2v = grid.IdxCv * grid.IdyCv * grid.IdyCv
        Idx2dyCv = grid.IdxCv * grid.IdxCv * grid.IdyCv
        Del2u = (Idxdy2u * (ip1(dy2h * sh_xx) - dy2h * sh_xx)
                 + Idx2dyCu * (dx2q * sh_xy - jm1(dx2q * sh_xy)))
        Del2v = (Idxdy2v * (dy2q * sh_xy - im1(dy2q * sh_xy))
                 - Idx2dyCv * (jp1(dx2h * sh_xx) - dx2h * sh_xx))
        if obc is not None and cfg.obc_zero_biharmonic:
            # no flow Laplacian at the segments' faces: Del2u on E/W
            # segments, Del2v on N/S ones (their q-point lines' indices)
            Del2u = _obc_qline(Del2u, obc, "ew")
            Del2v = _obc_qline(Del2v, obc, "ns")
        bh_xx, bh_xy, _, _ = _strains(grid, Del2u, Del2v, cfg.no_slip,
                                      obc=obc, cfg=cfg)
        Ah_h = torch.clamp(cfg.ah_vel_scale * grid_sp_h3, min=cfg.ah)
        Ah_q = torch.clamp(cfg.ah_vel_scale * grid_sp_q3, min=cfg.ah)
        if cfg.smag_bi_const > 0.0:
            Ah_h = _combine(Ah_h, cfg.smag_bi_const * grid_sp_h2
                            * grid_sp_h2 / 16.0 * shear_mag_h(), add)
            Ah_q = _combine(Ah_q, cfg.smag_bi_const * grid_sp_q2
                            * grid_sp_q2 / 16.0 * shear_mag_q(), add)
        if cfg.leith_ah:
            Ah_h = _combine(Ah_h, cfg.leith_bi_const * grid_sp_h3
                            * grid_sp_h3 * torch.abs(d2v_h) * _INV_PI6, add)
            Ah_q = _combine(Ah_q, cfg.leith_bi_const * grid_sp_q3
                            * grid_sp_q3 * torch.abs(d2v_q) * _INV_PI6, add)
        Ah_h = torch.minimum(Ah_h, 0.012 * grid_sp_h2 ** 2 / cfg.dt)
        Ah_q = torch.minimum(Ah_q, 0.012 * grid_sp_q2 ** 2 / cfg.dt)
        str_xx = str_xx + Ah_h * bh_xx
        str_xy = str_xy + Ah_q * bh_xy

    if cfg.use_gme and u_bt is not None:
        gxx, gxy = _gme_stress(grid, cfg, u_bt, v_bt,
                               torch.sum(h, dim=0) if htot is None else htot)
        str_xx = str_xx + gxx
        str_xy = str_xy + gxy

    # hq: harmonic-style mean of the four face thicknesses around a
    # corner, so vanished layers receive no stress divergence; the land
    # mask applies to cells, so a coast face keeps half its wet cell
    h_m = grid.mask2dT * h if cfg.use_land_mask else h
    h_u = 0.5 * (h_m + ip1(h_m))
    h_v = 0.5 * (h_m + jp1(h_m))
    h2uq = 4.0 * h_u * jp1(h_u)
    h2vq = 4.0 * h_v * ip1(h_v)
    hq = (2.0 * h2uq * h2vq) / (
        _H_NEGLECT + (h2uq + h2vq)
        * ((h_u + jp1(h_u)) + (h_v + ip1(h_v))))
    if cfg.no_slip:
        # at coastal corners the 4-face mean vanishes with a land face,
        # which would silence the doubled wall shear: rebuild hq there
        # from the wet faces only
        mcu, mcv = grid.mask2dCu, grid.mask2dCv
        hu_w = mcu * h_u + jp1(mcu * h_u)
        hv_w = mcv * h_v + ip1(mcv * h_v)
        nu_w = mcu + jp1(mcu)
        nv_w = mcv + ip1(mcv)
        one_sided = (nu_w * nv_w) == 0.0
        hq_coast = torch.where(one_sided, hu_w + hv_w,
                               2.0 * hu_w * hv_w
                               / (hu_w + hv_w + _H_NEGLECT))
        coastal = (grid.mask2dBu < 0.5) & ((nu_w + nv_w) > 0.0)
        hq = torch.where(coastal, hq_coast, hq)
    str_xx_h = str_xx * h
    str_xy_h = str_xy * hq
    diffu = ((grid.IdyCu * (dy2h * str_xx_h - ip1(dy2h * str_xx_h))
              + grid.IdxCu * (jm1(dx2q * str_xy_h) - dx2q * str_xy_h))
             * grid.IareaCu) / (h_u + _H_NEGLECT)
    diffv = ((grid.IdyCv * (im1(dy2q * str_xy_h) - dy2q * str_xy_h)
              - grid.IdxCv * (dx2h * str_xx_h - jp1(dx2h * str_xx_h)))
             * grid.IareaCv) / (h_v + _H_NEGLECT)
    diffu = diffu * grid.mask2dCu
    diffv = diffv * grid.mask2dCv
    if zb is not None:
        diffu = diffu + zb.du
        diffv = diffv + zb.dv
    return HorViscResult(diffu=diffu, diffv=diffv)
