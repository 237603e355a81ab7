"""Barotropic (2D shallow-water) solver for split time stepping.

Counterpart of ``mom6_tpu.core.barotropic``: ``btstep`` subcycles the
vertically integrated dynamics ``nstep`` (+ filter) times with the
dissipative forward-backward predictor-corrector and returns the
filtered mean transports, the free surface and the per-layer
barotropic anomaly accelerations.  The substep loop itself lives in
``barotropic_cuda.py``: kernel K3 on CUDA tensors, its plain PyTorch
loop on CPU tensors.

With ``wide_halo_period > 1`` (rounded up to an even period) btstep
runs the communication-avoiding march of the JAX package on one
device: the constants and the initial state are re-embedded in a
domain whose halo is ``3 * period`` wide, ``period`` substeps run with
no halo refresh while the valid region shrinks 3 rings per substep,
the wide halos are refreshed on each chunk's last substep, and the
weighted sums are narrowed back at the end (kernel K3m on CUDA
tensors, its plain loop on CPU tensors).

With open boundaries (``obc``) the exchange period is 1 and the
transports linear unless BT_cont curves are passed; the subcycle applies
the Flather radiation at the open faces after the velocity updates and
again after each halo refresh, which extends eta through the open edges
(kernel K3's open-face instance on CUDA tensors).  ``obc_edges`` gives
the along-edge data that both versions read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.domain import Domain, tree_map
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["BarotropicCfg", "BTResult", "ObcEdges", "SubcycleInputs",
           "btcalc", "btstep", "find_uhbt", "march_period", "obc_edges",
           "set_dtbt", "subcycle_inputs"]

_H_NEGLECT = 1e-20
BT_HALO = 3       # rings refreshed after every substep


@dataclasses.dataclass(frozen=True)
class BarotropicCfg:
    bebt: float = 0.2          # BEBT dissipative backward-Euler weight
    nstep: int = 32            # substeps per baroclinic dt (set_dtbt)
    wide_halo_period: int = 1  # BT_WIDE_HALO_PERIOD (>1: wide-halo march)
    dt_bt_filter: float = -0.25    # DT_BT_FILTER
    use_bt_cont: bool = True   # USE_BT_CONT_TYPE
    hvel_scheme: str = "FROM_BT_CONT"  # BT_THICK_SCHEME
    # SSH_EXTRA [m]: headroom added to the depth in set_dtbt's wave
    # speed; < 0 selects min(10 m, 5 % of the depth)
    ssh_extra: float = 0.0
    # BT_PROJECT_VELOCITY: read, and unused, as in the JAX package
    bt_project: bool = False
    # BOUND_BT_CORRECTION: cap the eta_cor mass source by what the
    # BT_cont curves carry at MAXCFL_BT_CONT (outward) and by the mass
    # in the column (inward)
    bound_bt_corr: bool = False
    maxcfl_bt_cont: float = 0.25     # MAXCFL_BT_CONT
    # BT_STRONG_DRAG: the per-substep viscous remnant in the harmonic
    # form n r / (1 + (n - 1) r) instead of r**(1/n)
    strong_drag: bool = False


class BTResult(NamedTuple):
    eta: torch.Tensor
    eta_av: torch.Tensor
    uhbtav: torch.Tensor
    vhbtav: torch.Tensor
    accel_layer_u: torch.Tensor
    accel_layer_v: torch.Tensor
    ubt_av: torch.Tensor
    vbt_av: torch.Tensor


def _rev_cumsum0(x):
    return torch.flip(torch.cumsum(torch.flip(x, [0]), dim=0), [0])


def _hvel_weights(h, h1, scheme, d0, d1):
    """Per-layer face thickness under BT_THICK_SCHEME (btcalc)."""
    h_arith = 0.5 * (h + h1)
    if scheme == "ARITHMETIC":
        return h_arith
    h_harm = (h * h1) / (h_arith + _H_NEGLECT)
    if scheme == "HARMONIC":
        return h_harm
    e_bot = -0.5 * (d0 + d1)
    d_shallow = -torch.minimum(d0, d1)
    e_top = e_bot[None] + _rev_cumsum0(h_arith)
    wt = torch.clamp((e_top - d_shallow[None]) / (h_arith + _H_NEGLECT),
                     0.0, 1.0)
    return wt * h_arith + (1.0 - wt) * h_harm


def btcalc(grid: Grid, h, scheme: str = "ARITHMETIC"):
    """frhatu/frhatv: fraction of the column thickness in each layer at
    u and v faces; FROM_BT_CONT uses the HYBRID weights."""
    sch = "HYBRID" if scheme == "FROM_BT_CONT" else scheme
    if sch not in ("ARITHMETIC", "HARMONIC", "HYBRID"):
        raise ValueError(f"Unknown BT_THICK_SCHEME '{scheme}'")
    h_u = _hvel_weights(h, ip1(h), sch, grid.bathyT, ip1(grid.bathyT))
    h_v = _hvel_weights(h, jp1(h), sch, grid.bathyT, jp1(grid.bathyT))
    frhatu = h_u * (grid.mask2dCu / (torch.sum(h_u, 0) + _H_NEGLECT))
    frhatv = h_v * (grid.mask2dCv / (torch.sum(h_v, 0) + _H_NEGLECT))
    return frhatu, frhatv


def set_dtbt(domain: Domain, grid: Grid, vgrid: VerticalGrid,
             cfg: BarotropicCfg, dt: float, max_depth: float | None = None,
             h=None) -> int:
    """Host-side substep count from the barotropic gravity-wave CFL, with
    the JAX package's empirical 0.9/(2c) bound.  The depth is the
    deepest point of the bathymetry, or ``max_depth`` when given; with
    ``h`` (the current layer thicknesses) it is the thickest column
    instead, the DTBT_RESET_PERIOD re-estimate (one host sync).
    ``cfg.ssh_extra`` adds headroom to that depth."""
    if h is not None:
        D = float(torch.max(torch.sum(h, dim=0) * grid.mask2dT))
    else:
        D = float(torch.max(grid.bathyT)) if max_depth is None \
            else max_depth
    ssh_extra = cfg.ssh_extra if cfg.ssh_extra >= 0.0 \
        else min(10.0, 0.05 * D)
    c = math.sqrt(vgrid.g_Earth * max(D + ssh_extra, 1.0))
    inf = torch.tensor(math.inf, dtype=grid.dxT.dtype,
                       device=grid.dxT.device)
    dx = float(torch.min(torch.where(grid.dxT > 0, grid.dxT, inf)))
    dy = float(torch.min(torch.where(grid.dyT > 0, grid.dyT, inf)))
    dtbt_max = 0.9 * min(dx, dy) / (2.0 * c)
    return max(1, int(math.ceil(dt / dtbt_max)))


def _bt_curve_consts(fa_far_neg, fa_0_neg, fa_0_pos, fa_far_pos,
                     u_neg, u_pos):
    """Cubic curvature and transition transports of the fitted curve
    (set_local_BT_cont_types)."""
    def one(fa0, fafar, ut):
        ut2 = ut * ut
        crv = torch.where(ut2 > 0.0, (fafar - fa0)
                          / torch.where(ut2 > 0.0, 3.0 * ut2, 1.0), 0.0)
        return crv, ut * ((2.0 * fa0 + fafar) / 3.0)
    crv_neg, uh_neg = one(fa_0_neg, fa_far_neg, u_neg)
    crv_pos, uh_pos = one(fa_0_pos, fa_far_pos, u_pos)
    return crv_neg, uh_neg, crv_pos, uh_pos


def find_uhbt(u, fa_far_neg, fa_0_neg, fa_0_pos, fa_far_pos,
              u_neg, u_pos, crv_neg, uh_neg, crv_pos, uh_pos):
    """Transport through a face on the fitted 3-segment curve
    (find_uhbt, MOM_barotropic.F90:3683)."""
    lin_neg = (u - u_neg) * fa_far_neg + uh_neg
    cub_neg = u * (fa_0_neg + crv_neg * u * u)
    cub_pos = u * (fa_0_pos + crv_pos * u * u)
    lin_pos = (u - u_pos) * fa_far_pos + uh_pos
    return torch.where(u < u_neg, lin_neg,
                       torch.where(u < 0.0, cub_neg,
                                   torch.where(u <= u_pos, cub_pos,
                                               lin_pos)))


def _filter_weights(nstep: int, nfilt: int, total: int, dt_filt: float,
                    dtbt: float, dtype: torch.dtype):
    """Host-side filter weights (MOM_barotropic.F90:1768-1810), a
    (4, total) numpy array of rows wt_vel, wt_eta, wt_trans, wt_accel,
    zero-padded past nstep + nfilt."""
    N = nstep + nfilt
    wt_vel = np.zeros(total)
    for n in range(1, N + 1):
        if (n == nstep) or (dt_filt - abs(n - nstep) * dtbt >= 0.0):
            wt_vel[n - 1] = 1.0
        elif dtbt + dt_filt - abs(n - nstep) * dtbt > 0.0:
            wt_vel[n - 1] = 1.0 + (dt_filt / dtbt) - abs(n - nstep)
    wt_eta = wt_vel.copy()
    wt_trans = np.zeros(total)
    wt_accel = np.zeros(total)
    acc_t = acc_a = 0.0
    for n in range(N, 0, -1):
        acc_t += wt_eta[n - 1]
        acc_a += wt_vel[n - 1]
        wt_trans[n - 1] = acc_t
        wt_accel[n - 1] = acc_a
    rows = [w / max(w.sum(), 1e-300)
            for w in (wt_vel, wt_eta, wt_trans, wt_accel)]
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return np.stack(rows).astype(npdt)


class SubcycleInputs(NamedTuple):
    """Everything the substep loop reads: the initial (eta, ubt, vbt)
    with valid halo rings, the 2D constant planes, the transport form,
    the (4, total) filter weights, the domain the loop runs on and the
    exchange period.  With ``period == 1`` the arrays have 3 valid
    rings on the model's domain (kernel K3, ``subcycle_cuda(*inp[:-1])``);
    with ``period > 1`` they are widened to ``domain.halo == 3 * period``
    (kernel K3m, ``subcycle_march_cuda(*inp)``)."""
    eta: torch.Tensor
    ubt: torch.Tensor
    vbt: torch.Tensor
    consts: dict
    use_curve: bool
    wts: np.ndarray
    dtbt: float
    bebt: float
    domain: Domain
    period: int


class ObcEdges(NamedTuple):
    """The open edges of a subcycle, each None when closed or a tuple
    (mask, coef, vel, ssh) of vectors along the edge (the padded rows of
    W/E, the padded columns of S/N): the segment strip at the boundary
    face, the Flather factor sqrt(g D)/D on the face depths, the
    external normal velocity and the external ssh."""
    w: tuple | None
    e: tuple | None
    s: tuple | None
    n: tuple | None


def obc_edges(obc, consts: dict, g: float) -> ObcEdges:
    """The edge vectors of ``obc`` for a subcycle whose constant planes
    are ``consts`` (``Du_q`` and ``Dv_q`` are the face depths), computed
    once a btstep on the planes' device."""
    H, ni, nj = obc.halo, obc.nil, obc.njl
    ref = consts["Du_q"]

    def along(v, n):
        if torch.is_tensor(v):
            v = v.to(device=ref.device, dtype=ref.dtype)
            return v.expand(n).contiguous() if v.dim() == 0 else v
        return torch.full((n,), float(v), device=ref.device,
                          dtype=ref.dtype)

    def cols(is_open, strip, vel, ssh, D, i):
        if not is_open:
            return None
        n = D.shape[0]
        mask = torch.ones(n, device=ref.device, dtype=ref.dtype) \
            if strip is None else strip[:, i].to(ref.dtype)
        return (mask.contiguous(),
                obc.wave_over_depth(D[:, i], g).contiguous(),
                along(obc._xval(vel, i), n).contiguous(),
                along(obc._xval(ssh, i), n).contiguous())

    def rows(is_open, strip, vel, ssh, D, j):
        if not is_open:
            return None
        n = D.shape[1]
        mask = torch.ones(n, device=ref.device, dtype=ref.dtype) \
            if strip is None else strip[j, :].to(ref.dtype)
        return (mask.contiguous(),
                obc.wave_over_depth(D[j, :], g).contiguous(),
                along(obc._yval(vel, j), n).contiguous(),
                along(obc._yval(ssh, j), n).contiguous())

    Du, Dv = consts["Du_q"], consts["Dv_q"]
    return ObcEdges(
        w=cols(obc.open_w, obc.strip_w, obc.u_w, obc.ssh_w, Du, H - 1),
        e=cols(obc.open_e, obc.strip_e, obc.u_e, obc.ssh_e, Du, H + ni - 1),
        s=rows(obc.open_s, obc.strip_s, obc.v_s, obc.ssh_s, Dv, H - 1),
        n=rows(obc.open_n, obc.strip_n, obc.v_n, obc.ssh_n, Dv, H + nj - 1))


def march_period(cfg: BarotropicCfg) -> int:
    """The exchange period: BT_WIDE_HALO_PERIOD rounded up to an even
    count when above 1 (barotropic.py:505-519 of the JAX package)."""
    period = max(1, int(cfg.wide_halo_period))
    if period % 2:
        period = period + 1 if period > 1 else 1
    return period


def _widen(domain: Domain, dw: Domain, f):
    """Re-embed halo-padded fields (a tensor or a nest of them) into the
    wider padding of ``dw`` and refresh the wide halos."""
    H = dw.halo
    return dw.fill_halos(tree_map(
        lambda a: torch.nn.functional.pad(domain.interior(a),
                                          (H, H, H, H)), f))


def _narrow(domain: Domain, dw: Domain, f):
    """Back from the wide padding of ``dw`` to ``domain``'s, refreshed."""
    H = domain.halo
    return domain.fill_halos(tree_map(
        lambda a: torch.nn.functional.pad(dw.interior(a), (H, H, H, H)),
        f))


def subcycle_inputs(domain: Domain, grid: Grid, vgrid: VerticalGrid,
                    u_in, v_in, eta_in, h,
                    bc_accel_u, bc_accel_v, pbce, u_cor, v_cor,
                    dt: float, cfg: BarotropicCfg,
                    visc_rem_u=None, visc_rem_v=None,
                    taux=None, tauy=None, eta_pf=None,
                    nstep: int | None = None, obc=None,
                    bt_cont=None, eta_cor=None,
                    uhbt_in=None, vhbt_in=None) -> SubcycleInputs:
    """The set-up half of btstep: projections onto the barotropic mode,
    effective gravities, Coriolis weights, viscous decay, curve
    constants and filter weights.  Arguments as for ``btstep``."""
    return _setup(domain, grid, vgrid, u_in, v_in, eta_in, h, bc_accel_u,
                  bc_accel_v, pbce, u_cor, v_cor, dt, cfg, visc_rem_u,
                  visc_rem_v, taux, tauy, eta_pf, nstep, obc, bt_cont,
                  eta_cor, uhbt_in, vhbt_in)[0]


def _setup(domain, grid, vgrid, u_in, v_in, eta_in, h, bc_accel_u,
           bc_accel_v, pbce, u_cor, v_cor, dt, cfg, visc_rem_u, visc_rem_v,
           taux, tauy, eta_pf, nstep, obc, bt_cont, eta_cor, uhbt_in,
           vhbt_in):
    """(SubcycleInputs, the constant planes on ``domain`` before any
    widening), the latter for the per-layer accelerations."""
    nstep = cfg.nstep if nstep is None else nstep
    dtbt = dt / nstep
    if visc_rem_u is None:
        visc_rem_u = torch.ones_like(u_in)
    if visc_rem_v is None:
        visc_rem_v = torch.ones_like(v_in)
    eta_in = domain.fill_halos(eta_in)
    if eta_pf is None:
        eta_pf = eta_in

    frhatu, frhatv = btcalc(grid, h, scheme=cfg.hvel_scheme)
    wt_u = frhatu * visc_rem_u
    wt_v = frhatv * visc_rem_v
    ubt0 = torch.sum(frhatu * u_in, dim=0)
    vbt0 = torch.sum(frhatv * v_in, dim=0)
    ubt_Cor = torch.sum(wt_u * u_cor, dim=0)
    vbt_Cor = torch.sum(wt_v * v_cor, dim=0)
    BT_force_u = torch.sum(wt_u * bc_accel_u, dim=0)
    BT_force_v = torch.sum(wt_v * bc_accel_v, dim=0)

    D_cell = torch.clamp(grid.bathyT + eta_in, min=0.0)
    DCor_u = 0.5 * (D_cell + ip1(D_cell))
    DCor_v = 0.5 * (D_cell + jp1(D_cell))
    Datu = grid.dyCu * DCor_u * grid.mask2dCu
    Datv = grid.dxCv * DCor_v * grid.mask2dCv
    if taux is not None:
        BT_force_u = BT_force_u + (taux / vgrid.Rho0) * visc_rem_u[0] \
            / (DCor_u + _H_NEGLECT)
    if tauy is not None:
        BT_force_v = BT_force_v + (tauy / vgrid.Rho0) * visc_rem_v[0] \
            / (DCor_v + _H_NEGLECT)

    gtot_E = torch.sum(pbce * wt_u, dim=0)
    gtot_W = torch.sum(pbce * im1(wt_u), dim=0)
    gtot_N = torch.sum(pbce * wt_v, dim=0)
    gtot_S = torch.sum(pbce * jm1(wt_v), dim=0)

    sumA = (grid.areaT + ip1(jp1(grid.areaT))) + (ip1(grid.areaT)
                                                  + jp1(grid.areaT))
    aD = grid.areaT * D_cell
    sumAD = (aD + ip1(jp1(aD))) + (ip1(aD) + jp1(aD))
    q = 0.25 * grid.CoriolisBu * sumA / torch.clamp(sumAD, min=_H_NEGLECT)

    def cor_u(vbt):
        dvv = DCor_v * vbt
        A = q * (ip1(dvv) + dvv)
        return A + jm1(A)

    def cor_v(ubt):
        duu = DCor_u * ubt
        B = q * (duu + jp1(duu))
        return -(B + im1(B))

    # per-substep viscous decay: av_rem**(1/nstep), or the harmonic
    # form under BT_STRONG_DRAG
    av_rem_u = torch.sum(frhatu * visc_rem_u, dim=0)
    av_rem_v = torch.sum(frhatv * visc_rem_v, dim=0)
    Instep = 1.0 / nstep
    if cfg.strong_drag:
        bt_rem_u = grid.mask2dCu * (nstep * av_rem_u) \
            / (1.0 + (nstep - 1.0) * av_rem_u)
        bt_rem_v = grid.mask2dCv * (nstep * av_rem_v) \
            / (1.0 + (nstep - 1.0) * av_rem_v)
    else:
        bt_rem_u = torch.where(av_rem_u > 0, av_rem_u ** Instep, 0.0) \
            * grid.mask2dCu
        bt_rem_v = torch.where(av_rem_v > 0, av_rem_v ** Instep, 0.0) \
            * grid.mask2dCv

    consts = dict(Datu=Datu, Datv=Datv, gtot_E=gtot_E, gtot_W=gtot_W,
                  gtot_N=gtot_N, gtot_S=gtot_S, q=q, Du_q=DCor_u,
                  Dv_q=DCor_v, Cor_ref_u=cor_u(vbt_Cor),
                  Cor_ref_v=cor_v(ubt_Cor),
                  bt_rem_u=bt_rem_u, bt_rem_v=bt_rem_v,
                  BT_force_u=BT_force_u, BT_force_v=BT_force_v,
                  eta_pf=eta_pf, IdxCu=grid.IdxCu, IdyCv=grid.IdyCv,
                  IareaT=grid.IareaT)

    use_curve = cfg.use_bt_cont and bt_cont is not None
    if use_curve:
        bc = bt_cont
        crv_E, uh_EE, crv_W, uh_WW = _bt_curve_consts(
            bc.FA_u_EE, bc.FA_u_E0, bc.FA_u_W0, bc.FA_u_WW,
            bc.uBT_EE, bc.uBT_WW)
        crv_N, vh_NN, crv_S, vh_SS = _bt_curve_consts(
            bc.FA_v_NN, bc.FA_v_N0, bc.FA_v_S0, bc.FA_v_SS,
            bc.vBT_NN, bc.vBT_SS)
        cu_args = (bc.FA_u_EE, bc.FA_u_E0, bc.FA_u_W0, bc.FA_u_WW,
                   bc.uBT_EE, bc.uBT_WW, crv_E, uh_EE, crv_W, uh_WW)
        cv_args = (bc.FA_v_NN, bc.FA_v_N0, bc.FA_v_S0, bc.FA_v_SS,
                   bc.vBT_NN, bc.vBT_SS, crv_N, vh_NN, crv_S, vh_SS)
        uhbt0 = -find_uhbt(ubt0, *cu_args)
        vhbt0 = -find_uhbt(vbt0, *cv_args)
        if uhbt_in is not None:
            uhbt0 = uhbt0 + uhbt_in
        if vhbt_in is not None:
            vhbt0 = vhbt0 + vhbt_in
        consts.update(cu=cu_args, cv=cv_args, uhbt0=uhbt0, vhbt0=vhbt0)

    if eta_cor is not None:
        ec = eta_cor
        if cfg.bound_bt_corr and use_curve:
            # outward corrections are limited to the mass the curves
            # export at MAXCFL_BT_CONT, inward ones to the column's mass
            u_cor = grid.dxT * (cfg.maxcfl_bt_cont / dt)
            v_cor = grid.dyT * (cfg.maxcfl_bt_cont / dt)
            out_u = find_uhbt(u_cor, *cu_args) + uhbt0
            in_u = find_uhbt(-u_cor, *cu_args) + uhbt0
            out_v = find_uhbt(v_cor, *cv_args) + vhbt0
            in_v = find_uhbt(-v_cor, *cv_args) + vhbt0
            ec_max = dt * grid.IareaT * (
                (out_u - im1(in_u)) + (out_v - jm1(in_v)))
            htot_col = grid.bathyT + eta_in
            ec = torch.where(ec > 0.0,
                             torch.minimum(ec, torch.clamp(ec_max, min=0.0)),
                             torch.maximum(ec, -torch.clamp(htot_col,
                                                            min=0.0)))
        consts["eta_src"] = grid.mask2dT * ec / nstep
    else:
        consts["eta_src"] = torch.zeros_like(eta_in)

    # DT_BT_FILTER window adds nfilt substeps past dt; the count is
    # padded to a whole number of chunks (u-first/v-first parity pairs,
    # or the march's exchange period) with zero weights on the padding.
    # Open faces take their Flather update every substep, so segments
    # keep the exchange period at 1
    period = 1 if obc is not None else march_period(cfg)
    chunk = max(2, period)
    if cfg.dt_bt_filter >= 0.0:
        dt_filt = 0.5 * max(0.0, min(cfg.dt_bt_filter, 2.0 * dt))
    else:
        dt_filt = 0.5 * max(0.0, dt * min(-cfg.dt_bt_filter, 2.0))
    nfilt = int(math.ceil(dt_filt / dtbt - 1e-9))
    total = -(-(nstep + nfilt) // chunk) * chunk
    wts = _filter_weights(nstep, nfilt, total, dt_filt, dtbt,
                          eta_in.dtype)

    if period > 1:
        dom_run = dataclasses.replace(domain, halo=3 * period)
        run_consts = _widen(domain, dom_run, consts)
        eta_r, ubt_r, vbt_r = _widen(domain, dom_run, (eta_in, ubt0, vbt0))
    else:
        dom_run, run_consts = domain, consts
        eta_r, ubt_r, vbt_r = domain.fill_halos((eta_in, ubt0, vbt0),
                                                width=BT_HALO)
    return SubcycleInputs(eta_r, ubt_r, vbt_r, run_consts, use_curve, wts,
                          dtbt, cfg.bebt, dom_run, period), consts


def btstep(domain: Domain, grid: Grid, vgrid: VerticalGrid,
           u_in, v_in, eta_in, h,
           bc_accel_u, bc_accel_v, pbce, u_cor, v_cor,
           dt: float, cfg: BarotropicCfg,
           visc_rem_u=None, visc_rem_v=None,
           taux=None, tauy=None, eta_pf=None,
           nstep: int | None = None, obc=None,
           bt_cont=None, eta_cor=None,
           uhbt_in=None, vhbt_in=None) -> BTResult:
    """One barotropic solve over the baroclinic step dt (btstep of the
    JAX package): set-up, the subcycle (kernel K3 on CUDA tensors, its
    open-face instance with ``obc``, or the wide-halo march K3m when
    ``wide_halo_period > 1``) and the per-layer accelerations."""
    from mom6_torch.core.barotropic_cuda import (subcycle_cuda,
                                                 subcycle_march_cuda)
    inp, c = _setup(domain, grid, vgrid, u_in, v_in, eta_in, h, bc_accel_u,
                    bc_accel_v, pbce, u_cor, v_cor, dt, cfg, visc_rem_u,
                    visc_rem_v, taux, tauy, eta_pf, nstep, obc, bt_cont,
                    eta_cor, uhbt_in, vhbt_in)
    if inp.period > 1:
        _, _, _, sums = subcycle_march_cuda(*inp)
        sums = _narrow(domain, inp.domain, sums)
    else:
        edges = None if obc is None else obc_edges(obc, c, vgrid.g_Earth)
        _, _, _, sums = subcycle_cuda(*inp[:-1], obc=edges)
        # consumers need valid rings at the wrap faces: refresh them
        sums = domain.fill_halos(sums, width=BT_HALO)

    eta_pf, gtot_E, gtot_W = c["eta_pf"], c["gtot_E"], c["gtot_W"]
    gtot_N, gtot_S = c["gtot_N"], c["gtot_S"]
    e_anom = sums["eta"] - eta_pf
    accel_layer_u = sums["accel_u"][None] - (
        ip1((pbce - gtot_W[None]) * e_anom[None])
        - (pbce - gtot_E[None]) * e_anom[None]) * grid.IdxCu[None]
    accel_layer_v = sums["accel_v"][None] - (
        jp1((pbce - gtot_S[None]) * e_anom[None])
        - (pbce - gtot_N[None]) * e_anom[None]) * grid.IdyCv[None]
    return BTResult(eta=sums["eta"], eta_av=sums["eta"],
                    uhbtav=sums["uhbt"], vhbtav=sums["vhbt"],
                    accel_layer_u=accel_layer_u * grid.mask2dCu,
                    accel_layer_v=accel_layer_v * grid.mask2dCv,
                    ubt_av=sums["ubt"], vbt_av=sums["vbt"])
