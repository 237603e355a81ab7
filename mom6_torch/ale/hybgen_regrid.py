"""Hybgen regridding: the HYCOM hybrid-coordinate generator.

Counterpart of ``mom6_tpu.ale.hybgen_regrid``.  For every column,

1.  ``_column_init`` turns the layerwise minimum thicknesses dp0k (deep)
    and ds0k (shallow) into the column's constraints: the terrain-
    following blend over the first ``nsigma`` layers, the dp00i deep
    isopycnal minimum, the relaxation weight of each interface, the
    cumulative minimum interface depths and the deepest fixed layer;
2.  ``hybgen_regrid`` moves interfaces toward the target densities under
    those constraints, with the Bleck & Benjamin (1992) cushion
    (``_cushn``), a blocking-layer cascade that may pull water down from
    two layers above, and relaxation at each interface.

Columns are vectorized: every scalar of a column becomes a field over
the columns.  Each pass walks the layers in the JAX package's k order;
the layer index of every step is a Python integer there too, so the
stack of thicknesses is kept as a list of 2-D rows and a step reads and
writes its two or three rows in place of the JAX package's one-hot
updates of the whole stack: the same values, in O(nk) and not O(nk^2)
work a pass.  The interface depths are the running sum of the rows,
taken afresh where the JAX package takes them.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["HybgenRegridCfg", "hybgen_regrid"]

_QQMN, _QQMX = -4.0, 2.0
_QQSCL = (_QQMX - 1.0) / (_QQMX - _QQMN) ** 2
_I_QQMX = 1.0 / _QQMX


@dataclasses.dataclass(frozen=True)
class HybgenRegridCfg:
    """The HYBGEN_* runtime parameters."""
    dp0k: tuple = ()              # deep z minimum separations [m]
    ds0k: tuple = ()              # shallow z minimum separations [m]
    nsigma: int = 0               # terrain-following layer count
    dp00i: float = 1.0            # deep isopycnal minimum [m]
    qhybrlx: float = 0.25         # relaxation (1 / HYBGEN_RELAX_PERIOD)
    topiso_const: float = 0.0     # HYBGEN_MIN_ISO_DEPTH [m]
    hybiso: float = 0.01          # HYBGEN_REMAP_DENSITY_MATCH [kg m-3]
    thkbot: float = 6.0           # bottom boundary layer thickness [m]
    min_thickness: float = 1e-3
    rho_eps: float = 1e-11        # density convergence tolerance
    h_thin: float = 1e-6          # negligible thickness change [m]
    dp_far_from_sfc: float = 0.25
    dp_far_from_bot: float = 0.25
    min_dilate: float = 0.5       # z* dilation clamps
    max_dilate: float = 2.0
    ref_pressure: float = 2.0e7   # coordinate reference pressure [Pa]


def _cushn(delp, dp0):
    """The Bleck & Benjamin (1992) cushion: a smoothly limited thickness,
    delp where delp >> dp0 and dp0 where delp << -dp0."""
    base = torch.maximum(dp0, delp * _I_QQMX)
    r = delp / torch.clamp(dp0, min=1e-30) - _QQMN
    mid = base * (1.0 + _QQSCL * (r * r))
    return torch.where(delp >= _QQMX * dp0, delp,
                       torch.where(delp < _QQMN * dp0, base, mid))


def _zcat(h):
    return torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                     dim=0)


def _column_init(cfg: HybgenRegridCfg, h, htot, dilate):
    """The column constraints: (fixlay, qhrlx (nk+1), dp0ij (nk),
    dp0cum (nk+1)), each a field over the columns."""
    nk = h.shape[0]
    dp0k = torch.as_tensor(cfg.dp0k, dtype=h.dtype,
                           device=h.device).reshape(-1, 1, 1)
    ds0k = torch.as_tensor(cfg.ds0k, dtype=h.dtype,
                           device=h.device).reshape(-1, 1, 1)
    dpns = float(sum(cfg.dp0k[:cfg.nsigma]))
    dsns = float(sum(cfg.ds0k[:cfg.nsigma]))
    if dpns <= dsns:
        qdep = torch.ones_like(htot)
    else:
        qdep = torch.clamp((htot - dilate * dsns)
                           / torch.clamp(dilate * (dpns - dsns), min=1e-30),
                           0.0, 1.0)
    p_int = _zcat(h)

    # the terrain-following (shallow) branch
    dp0ij_tf = dilate[None] * (qdep[None] * dp0k + (1.0 - qdep[None]) * ds0k)

    # the deep branch: dp0cum accumulated down the column, capped by dp00i
    dp00 = dilate * dp0k[0]
    dp0cum = dp00
    dp0ij_rows, qh_rows = [dp00], [torch.ones_like(dp00)] * 2
    for k in range(1, nk):
        d_k = dp0k[k]
        margin = p_int[k] - dp0cum
        q = d_k * (dilate * d_k / torch.clamp(margin, min=1e-30))
        fixed = (d_k <= cfg.dp00i) | (dilate * d_k >= margin)
        deep = cfg.dp00i >= q
        dp0ij_k = torch.where(fixed, d_k,
                              torch.where(deep, cfg.dp00i, dilate * q))
        relax = cfg.qhybrlx * (d_k - cfg.dp00i) / torch.clamp(
            (d_k - q) + (q - cfg.dp00i) * cfg.qhybrlx, min=1e-30)
        qh_k = torch.where(fixed, 1.0,
                           torch.where(deep, cfg.qhybrlx, relax))
        dp0cum = dp0cum + dp0ij_k
        dp0ij_rows.append(dp0ij_k)
        qh_rows.append(qh_k)
    tf = (qdep < 1.0)[None]
    dp0ij = torch.where(tf, dp0ij_tf, torch.stack(dp0ij_rows, dim=0))
    qhrlx = torch.where(tf, 1.0, torch.stack(qh_rows, dim=0))
    dp0cum = _zcat(dp0ij)

    # fixlay: layer 1 always fixed; extended while the layer top is above
    # topiso, then while the interfaces hug their minimum depths (a
    # "while" as a cumulative product)
    above_topiso = dp0cum[1:nk] < dilate[None] * cfg.topiso_const
    fixlay = 1.0 + torch.sum(torch.cumprod(above_topiso.to(h.dtype), dim=0),
                             dim=0)
    kk = torch.arange(2, nk + 1, dtype=h.dtype, device=h.device).reshape(
        -1, 1, 1)
    hug = p_int[2:nk + 1] <= dp0cum[2:nk + 1] + 0.1 * dp0ij[1:nk]
    cand = hug & (kk > fixlay[None])
    start_ok = torch.cumprod(torch.where(kk <= fixlay[None], 1.0,
                                         cand.to(h.dtype)), dim=0)
    fixlay2 = fixlay + torch.sum(torch.where(kk > fixlay[None], start_ok,
                                             0.0), dim=0)
    kq = torch.arange(nk + 1, dtype=h.dtype, device=h.device).reshape(
        -1, 1, 1)
    qhrlx = torch.where(kq <= fixlay2[None] + 1.0, 1.0, qhrlx)
    return fixlay2, qhrlx, dp0ij, dp0cum


def hybgen_regrid(cfg: HybgenRegridCfg, h, rcv, rcv_tgt, nominal_depth):
    """New layer thicknesses for every column.

    h: (nk, ...) source thicknesses; rcv: (nk, ...) the source layers'
    coordinate potential densities; rcv_tgt: (nk,) target densities;
    nominal_depth: (...) bottom depth [m].  Returns h_new (nk, ...)."""
    nk = h.shape[0]
    htot = torch.sum(h, dim=0)
    dilate = torch.clamp(htot / torch.clamp(nominal_depth, min=1e-30),
                         cfg.min_dilate, cfg.max_dilate)
    fixlay, qhrlx, dp0ij, dp0cum = _column_init(cfg, h, htot, dilate)
    tgt = rcv_tgt.reshape(-1, 1, 1)
    hc = list(torch.clamp(h, min=0.0).unbind(0))
    h_min = torch.clamp(htot / nk, max=cfg.min_thickness)

    def row(a, k, fill=0.0):
        """Row k of a stack, ``fill`` beyond its ends."""
        if 0 <= k < len(a):
            return a[k]
        return torch.full_like(htot, fill)

    def p_of():
        return _zcat(torch.stack(hc, dim=0))

    def move(k, dh):
        """dh from row k+1 to row k (rows beyond the stack are dropped)."""
        hc[k] = hc[k] + dh
        if k + 1 < nk:
            hc[k + 1] = hc[k + 1] - dh

    # ---- pass A: the prescribed thickness of the fixed layers ----
    for k in range(nk - 2, -1, -1):
        p = p_of()
        p_new = torch.minimum(dp0cum[k + 1], p[-1] - (nk - 1.0 - k) * h_min)
        dh = p_new - p[k + 1]
        dh = torch.where(k < fixlay - 1.0,
                         torch.minimum(dh, hc[k + 1] - h_min), dh)
        move(k, torch.where(k <= fixlay - 1.0, dh, 0.0))

    # ---- pass B: no thickness below h_min under the fixed layers ----
    for k in range(1, nk - 1):
        act = (k >= fixlay) & (hc[k] < h_min)
        move(k, torch.where(act, h_min - hc[k], 0.0))
    # then bottom up
    for k in range(nk - 1, 0, -1):
        act = hc[k] < h_min
        hc[k - 1] = hc[k - 1] + torch.where(act, hc[k] - h_min, 0.0)
        hc[k] = torch.where(act, h_min, hc[k])

    # ---- pass C: layers too dense, working upward ----
    for k in range(nk - 1, 1, -1):
        p = p_of()
        t_k, t_m = tgt[k], tgt[k - 1]
        r_k, r_m = rcv[k], rcv[k - 1]
        act = (k >= fixlay + 1.0) & (r_k > t_k + cfg.rho_eps)
        conflict = ((r_m >= t_m) | (p[k] <= dp0cum[k] + cfg.dp_far_from_bot)
                    | (hc[k] <= hc[k - 1]))
        act = act & conflict
        far_dense = (t_k - r_m) <= cfg.rho_eps
        qf = (t_k - r_k) / torch.where((t_k - r_m).abs() > cfg.rho_eps,
                                       t_k - r_m, 1.0)
        h_hat0 = torch.where(far_dense, 0.0, qf * hc[k])
        hm1, dpm1 = hc[k - 1], dp0ij[k - 1]
        h_hat_fix = torch.maximum(h_hat0, dpm1 - hm1)
        h_hat_cush = _cushn(h_hat0 + hm1, dpm1) - hm1
        h_hat = torch.where(far_dense, dpm1 - hm1,
                            torch.where(fixlay + 1.0 == k, h_hat_fix,
                                        h_hat_cush))
        h_hat = torch.minimum(h_hat, p[-1] - p[k])

        # the blocking-layer cascade one level deep (k-2), as in the JAX
        # package, which leaves out the reference's second level (k-3)
        hm2, dpm2 = hc[k - 2], dp0ij[k - 2]
        blockable = ((h_hat >= 0.0) & (k > fixlay + 1.0)
                     & (p[k - 1] > dp0cum[k - 1] + cfg.dp_far_from_sfc)
                     & ((p[-1] - p[k - 1] < cfg.thkbot)
                        | (hm2 > _QQMX * dpm2)))
        h_hat2 = torch.where(fixlay + 2.0 == k,
                             torch.maximum(h_hat0 - h_hat, dpm2 - hm2),
                             _cushn(hm2 + (h_hat0 - h_hat), dpm2) - hm2)
        do2 = blockable & (h_hat2 < -cfg.h_thin)
        dh2 = torch.where(do2, qhrlx[k - 1] * torch.maximum(
            h_hat2, -h_hat - hm1), 0.0)
        hc[k - 2] = hm2 + dh2
        hc[k - 1] = hm1 - dh2
        hm1 = hm1 - dh2
        h_hat = torch.where(do2, _cushn(h_hat0 + hm1, dpm1) - hm1, h_hat)
        move(k - 1, torch.where(act & (h_hat < 0.0), qhrlx[k] * h_hat, 0.0))

    # ---- pass D: layers too light, and thin layers above, downward ----
    for k in range(1, nk):
        p = p_of()
        t_k, r_k = tgt[k], rcv[k]
        r_p = row(rcv, k + 1, 1e9)
        t_p = row(tgt, k + 1, -1e9)
        hp1 = row(hc, k + 1)
        act = ((k >= fixlay) & (r_k < t_k - cfg.rho_eps)
               & (p[k + 1] < p[-1] - 1e-30))
        conflict = ((r_p <= t_p)
                    | (p[k + 1] <= dp0cum[k + 1] + cfg.dp_far_from_bot)
                    | (hc[k] < hp1))
        act = act & conflict
        far_light = (r_p - t_k) <= cfg.rho_eps
        qf = (t_k - r_k) / torch.where((r_p - t_k).abs() > cfg.rho_eps,
                                       r_p - t_k, 1.0)
        h_hat = torch.where(far_light, hp1, qf * hc[k])
        dpk, dpk1 = dp0ij[k], row(dp0ij, k + 1)
        interior = p[min(k + 3, nk)] < p[-1] - 1e-30
        roomy = (p[-1] - p[k]) > dpk + dpk1
        h_hat_i = torch.where(roomy, hp1 - _cushn(hp1 - h_hat, dpk1), h_hat)
        h_hat_i = torch.maximum(h_hat_i, dpk - hc[k])
        h_hat_i = torch.minimum(h_hat_i,
                                torch.maximum(0.5 * hp1, hp1 - dpk1))
        h_hat = torch.where(interior, h_hat_i, torch.minimum(hp1, h_hat))
        move(k, torch.where(act & (h_hat > 0.0), qhrlx[k + 1] * h_hat, 0.0))
        # a thin layer above: move the interface down
        p = p_of()
        dh = torch.minimum(qhrlx[k - 1] * torch.minimum(
            dp0ij[k - 1] - hc[k - 1], p[-1] - p[k]), hc[k])
        move(k - 1, torch.where((dh > 0.0) & (k >= fixlay), dh, 0.0))

    # conservation: any roundoff goes into the bottom layer
    h_col = torch.clamp(torch.stack(hc, dim=0), min=0.0)
    err = htot - torch.sum(h_col, dim=0)
    h_col = torch.cat([h_col[:-1], (h_col[-1] + err)[None]], dim=0)
    return torch.clamp(h_col, min=0.0)
