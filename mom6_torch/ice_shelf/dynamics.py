"""Ice-shelf dynamics: the shallow-shelf approximation (SSA), counterpart
of ``mom6_tpu.ice_shelf.dynamics``.

The depth-integrated momentum balance

  dx(2 nu h (2 ux + vy)) + dy(nu h (uy + vx)) - beta u = rho_i g h dx(s)

with the Glen-law viscosity nu = B/2 e^((1-n)/n) is solved for the
velocities at h points by Picard refreshes of the viscosity (and of the
basal traction), each followed by a fixed count of Jacobi-preconditioned
conjugate-gradient iterations on the linearized system.  The operator is
the gradient of the SSA energy

  J = sum_q W_q [2 ux^2 + 2 vy^2 + 2 ux vy + (uy + vx)^2 / 2]
      + sum_T beta (u^2 + v^2) / 2,     W = nu h area at the corners,

with the strains at the cell corners (a compact B-grid stencil).  The
JAX package takes it by ``jax.grad``; here ``ssa_apply`` writes the
gradient out: the corner strains' stencil (``_strains``) transposed,
each corner's four strains spread back onto its four cells
(``ip1``'s transpose is ``im1``).  u and v travel stacked as one
(2, njh, nih) tensor.  The loops are plain Python loops over device
tensors with no host synchronization inside them.  The stencils wrap,
so callers zero ``shelf_mask`` on the outermost ring (or land) to pin
the far field.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import im1, ip1, jm1, jp1

__all__ = ["SSACfg", "SSAResult", "ssa_velocity_solve", "basal_traction",
           "glen_a_arrhenius", "ssa_energy", "ssa_apply", "ssa_diagonal"]

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class SSACfg:
    glen_a: float = 2.4e-24        # Glen's law A [Pa-3 s-1]
    glen_n: float = 3.0
    rho_ice: float = 918.0
    rho_sw: float = 1028.0
    g: float = 9.81
    basal_beta: float = 0.0        # linear basal drag [Pa s m-1]
    n_outer: int = 24              # Picard viscosity refreshes
    n_inner: int = 200             # CG iterations per refresh
    eps_strain: float = 1e-10      # strain regularization [s-1]
    picard_damping: float = 0.0    # 0 = undamped, 0.5 = geometric mean
    # the basal friction over grounded ice: tau_b = C |u|^(n_b-1) u
    # (Weertman), with USE_COULOMB_FRICTION divided by
    # (1 + fB |u|^p)^n_b, fB = alpha (C / (CF_Max N))^(p/n_b) and N the
    # effective pressure above flotation, at least CF_MinN
    c_basal: float = 0.0           # C_BASAL_FRICTION [Pa (m s-1)^-n_b]
    n_basal: float = 1.0           # BASAL_FRICTION_EXP
    coulomb: bool = False          # USE_COULOMB_FRICTION
    cf_min_n: float = 1.0          # CF_MinN [Pa]
    cf_post_peak: float = 1.0      # CF_PostPeak exponent p
    cf_max: float = 0.5            # CF_Max coefficient


class SSAResult(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    visc: torch.Tensor


def _surface(cfg: SSACfg, h_shelf, floating):
    """The upper surface height: at flotation over water, h over the
    bed."""
    s_float = (1.0 - cfg.rho_ice / cfg.rho_sw) * h_shelf
    return torch.where(floating > 0, s_float, h_shelf)


def basal_traction(cfg: SSACfg, grid: Grid, u, v, h_shelf, ground_frac,
                   bed_elev=None):
    """The area-weighted basal traction coefficient beta [Pa s m-1 m2],
    tau_b A = beta u: the Weertman power law, Coulomb-limited with
    ``cfg.coulomb``, over the grounded fraction of each cell."""
    speed2 = u * u + v * v + (cfg.eps_strain ** 2
                              * (grid.dxT ** 2 + grid.dyT ** 2))
    unorm = torch.sqrt(speed2)
    coef = cfg.c_basal * unorm ** (cfg.n_basal - 1.0)
    if cfg.coulomb:
        p = cfg.cf_post_peak
        alpha = ((p - 1.0) ** (p - 1.0) / p ** p) if p != 1.0 else 1.0
        # the flotation thickness over the bed's depth below sea level
        bed = bed_elev if bed_elev is not None else torch.zeros_like(h_shelf)
        hf = torch.clamp((cfg.rho_sw / cfg.rho_ice) * bed, min=0.0)
        fN = torch.clamp(cfg.rho_ice * cfg.g * (h_shelf - hf),
                         min=cfg.cf_min_n)
        fB = alpha * (cfg.c_basal / (cfg.cf_max * fN)) ** (p / cfg.n_basal)
        coef = coef / (1.0 + fB * unorm ** p) ** cfg.n_basal
    return coef * grid.areaT * ground_frac


def glen_a_arrhenius(t_shelf, a_ref: float = 2.4e-24, t_ref: float = -10.0):
    """Glen's rate factor A(T) by the Arrhenius relation (Cuffey and
    Paterson 2010, 3.4.6), with the activation energy 60 kJ/mol below
    -10 degC and 115 kJ/mol above, both branches anchored at -10 degC,
    normalized so that A(t_ref) = a_ref."""
    R = 8.314
    tk = t_shelf + 273.15
    tk_ref = t_ref + 273.15
    q_ref = 60.0e3 if t_ref < -10.0 else 115.0e3
    tk10 = 263.15
    loga = torch.where(t_shelf < -10.0,
                       -(60.0e3 / R) * (1.0 / tk - 1.0 / tk10),
                       -(115.0e3 / R) * (1.0 / tk - 1.0 / tk10))
    loga_ref = -(q_ref / R) * (1.0 / tk_ref - 1.0 / tk10)
    return a_ref * torch.exp(loga - loga_ref)


def _corner_avg(a):
    return 0.25 * (a + ip1(a) + jp1(a) + ip1(jp1(a)))


def _csum(a):
    """The sum over the four corners of each cell."""
    return a + im1(a) + jm1(a) + im1(jm1(a))


def _strains(grid: Grid, x):
    """The compact strains at the corners (NE of cell (j, i)) of the
    stacked velocities x = (u, v): ((ux, vx), (uy, vy))."""
    dx = ip1(x) - x
    sx = 0.5 * (dx + jp1(dx)) * grid.IdxBu
    dy = jp1(x) - x
    sy = 0.5 * (dy + ip1(dy)) * grid.IdyBu
    return sx, sy


def ssa_energy(grid: Grid, x, w_q, beta_a):
    """J of the stacked velocities ``x`` with the corner weights
    ``w_q`` = nu h area and the cell drag ``beta_a``."""
    (ux, vx), (uy, vy) = _strains(grid, x)
    ev = torch.sum(w_q * (2.0 * ux * ux + 2.0 * vy * vy + 2.0 * ux * vy
                          + 0.5 * (uy + vx) ** 2))
    ed = 0.5 * torch.sum(beta_a * (x[0] * x[0] + x[1] * x[1]))
    return ev + ed


def ssa_apply(grid: Grid, x, w_q, beta_a, shelf_mask):
    """dJ/dx of the stacked velocities, masked to the shelf: the corner
    strains' stencil transposed onto the cells."""
    (ux, vx), (uy, vy) = _strains(grid, x)
    shear = w_q * (uy + vx)                 # dJ/duy = dJ/dvx
    w2 = 2.0 * w_q
    gx = torch.stack([w2 * torch.add(vy, ux, alpha=2.0), shear]) \
        * (0.5 * grid.IdxBu)
    gy = torch.stack([shear, w2 * torch.add(ux, vy, alpha=2.0)]) \
        * (0.5 * grid.IdyBu)
    tx = gx + jm1(gx)
    ty = gy + im1(gy)
    out = (im1(tx) - tx) + (jm1(ty) - ty)
    return torch.addcmul(out, beta_a, x) * shelf_mask


def ssa_diagonal(grid: Grid, w_q, beta_a):
    """The exact diagonal of the operator: a unit u at (j, i) strains
    its four corners by ux = +-IdxBu/2, uy = +-IdyBu/2."""
    wq_x = w_q * grid.IdxBu ** 2
    wq_y = w_q * grid.IdyBu ** 2
    diag_u = _csum(wq_x + 0.25 * wq_y) + beta_a
    diag_v = _csum(wq_y + 0.25 * wq_x) + beta_a
    return diag_u, diag_v


def ssa_velocity_solve(cfg: SSACfg, grid: Grid, h_shelf, shelf_mask,
                       floating=None, u0=None, v0=None, ground_frac=None,
                       bed_elev=None, a_glen_2d=None,
                       residuals: list | None = None) -> SSAResult:
    """The SSA velocities at h points of the ice thickness ``h_shelf``
    [m] where ``shelf_mask`` is 1.  ``floating`` (default: the mask
    less the grounded fraction) selects the flotation surface;
    ``ground_frac`` takes the basal friction, ``bed_elev`` the bed's
    depth below sea level [m] (the grounded surface and the Coulomb
    effective pressure), ``a_glen_2d`` a Glen rate factor field in place
    of ``cfg.glen_a``.  With a list ``residuals``, the residual's norm
    (a device tensor) after each refresh's CG iterations is appended to
    it."""
    if floating is None:
        floating = shelf_mask if ground_frac is None \
            else shelf_mask * (1.0 - ground_frac)
    if u0 is None:
        u0 = torch.zeros_like(h_shelf)
    if v0 is None:
        v0 = torch.zeros_like(h_shelf)
    if ground_frac is None:
        ground_frac = torch.zeros_like(h_shelf)

    # grounded ice rests on the bed: s = h - bed depth
    s = _surface(cfg, h_shelf, floating)
    if bed_elev is not None:
        s = torch.where(ground_frac > 0.5, h_shelf - bed_elev, s)
    # the driving stress rho_i g h ds/dx at h points (centred)
    tdx = cfg.rho_ice * cfg.g * h_shelf * 0.5 * (ip1(s) - im1(s)) * grid.IdxT
    tdy = cfg.rho_ice * cfg.g * h_shelf * 0.5 * (jp1(s) - jm1(s)) * grid.IdyT

    n = cfg.glen_n
    a_q = cfg.glen_a if a_glen_2d is None \
        else torch.clamp(_corner_avg(a_glen_2d), min=1e-32)
    B = a_q ** (-1.0 / n)

    x = torch.stack([u0 * shelf_mask, v0 * shelf_mask])
    beta_lin = cfg.basal_beta * grid.areaT * shelf_mask
    b = torch.stack([-tdx * grid.areaT * shelf_mask,
                     -tdy * grid.areaT * shelf_mask])

    # the first viscosity from Glen's free-spreading rate at the
    # extensional stress rho' g h / 4 (an ice tongue)
    h_q = torch.clamp(_corner_avg(h_shelf), min=1.0)
    tau0 = 0.25 * cfg.rho_ice * (1.0 - cfg.rho_ice / cfg.rho_sw) * cfg.g \
        * h_q
    ee0 = a_q * tau0 ** n + cfg.eps_strain
    visc_q = 0.5 * B * ee0 ** ((1.0 - n) / n)
    mask_q = _corner_avg(shelf_mask)

    def dot(a, c):
        return torch.vdot(a.reshape(-1), c.reshape(-1))

    for _ in range(cfg.n_outer):
        (ux, vx), (uy, vy) = _strains(grid, x)
        ee = torch.sqrt(ux * ux + vy * vy + ux * vy
                        + 0.25 * (uy + vx) ** 2 + cfg.eps_strain ** 2)
        visc_new = 0.5 * B * ee ** ((1.0 - n) / n)
        # damped Picard, relaxed in log space
        w = cfg.picard_damping
        visc_q = visc_q ** w * visc_new ** (1.0 - w)
        beta_a = beta_lin
        if cfg.c_basal > 0.0:
            beta_a = beta_a + basal_traction(cfg, grid, x[0], x[1], h_shelf,
                                             ground_frac, bed_elev) \
                * shelf_mask
        nu_h = visc_q * h_q * mask_q
        w_q = nu_h * grid.areaBu
        diag_u, diag_v = ssa_diagonal(grid, w_q, beta_a)
        idiag = torch.stack([shelf_mask / torch.clamp(diag_u, min=_EPS),
                             shelf_mask / torch.clamp(diag_v, min=_EPS)])

        # Jacobi-preconditioned CG on A x = b, a fixed count of steps
        r = b - ssa_apply(grid, x, w_q, beta_a, shelf_mask)
        z = r * idiag
        p = z
        rz = dot(r, z)
        for _ in range(cfg.n_inner):
            ap = ssa_apply(grid, p, w_q, beta_a, shelf_mask)
            alpha = rz / torch.clamp(dot(p, ap), min=_EPS)
            x = torch.addcmul(x, alpha, p)
            r = torch.addcmul(r, alpha, ap, value=-1.0)
            z = r * idiag
            rz_new = dot(r, z)
            bet = rz_new / torch.clamp(rz, min=_EPS)
            p = torch.addcmul(z, bet, p)
            rz = rz_new
        if residuals is not None:
            residuals.append(torch.linalg.vector_norm(r))
        x = x * shelf_mask
    # the viscosity at h points, for diagnostics
    visc = 0.25 * (visc_q + im1(visc_q) + jm1(visc_q) + im1(jm1(visc_q)))
    return SSAResult(u=x[0], v=x[1], visc=visc)
