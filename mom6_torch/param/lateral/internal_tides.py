"""Internal-tide energy propagation (ray tracing in angle space).

Counterpart of ``mom6_tpu.param.lateral.internal_tides``: the energy
density En(freq, mode, angle, y, x) [J m-2] is forced by the non-local
share of the barotropic-to-baroclinic conversion, refracted in angle by
the gradients of f and of the mode speed (half a step before and after
the propagation), advected in x and y at each wedge's group velocity
(first-order upwind, or the PPM face values of INTERNAL_TIDE_X_SCHEME),
reflected at tagged topography, and damped by background leakage,
quadratic bottom drag, the small-scale wave drag and Froude-limited
breaking.  The wave-drag loss is what the tidal mixing consumes.

Every update works on all the angular wedges of a (frequency, mode) at
once: the angle is one more leading axis of the tensors, its neighbours
a roll along it, and the reflection a scatter onto the reflected wedge.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mom6_torch.core.grid import Grid
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["InternalTidesCfg", "IntTideResult", "init_en", "reflect",
           "f2_at_h", "step_internal_tides"]

_CN_SUB = 1e-30
_EN_SUB = 1e-30


@dataclasses.dataclass(frozen=True)
class InternalTidesCfg:
    n_angle: int = 24                 # INTERNAL_TIDE_ANGLES
    freq: float = 1.4052e-4           # FIRST_MODE_PERIOD's [rad s-1]
    freqs: tuple = ()                 # frequency bins; () -> (freq,)
    freq_fraction: tuple = ()         # ENERGY_FRACTION_PER_FREQ
    q_itides: float = 0.3333          # GAMMA_ITIDES: local share
    decay_rate: float = 0.0           # INT_TIDE_DECAY_RATE [s-1]
    cdrag: float = 0.003              # CDRAG
    drag_min_depth: float = 1.0       # [m]
    kappa_itides: float = 2.0 * math.pi / 125e3   # 2 pi / ITIDE_WAVELENGTH
    kappa_h2_factor: float = 0.75     # KAPPA_H2_FACTOR
    apply_background_drag: bool = False   # INT_TIDE_BACKGROUND_DRAG
    apply_bottom_drag: bool = True        # INT_TIDE_QUAD_DRAG
    apply_wave_drag: bool = True          # INT_TIDE_WAVE_DRAG
    apply_froude_drag: bool = False       # INT_TIDE_FROUDE_DRAG
    rho0: float = 1035.0
    h2_default: float = 2500.0        # roughness variance [m2]
    n_mode: int = 1                   # INTERNAL_TIDE_MODES
    mode_fraction: tuple = ()         # ENERGY_FRACTION_PER_MODE
    scheme: str = "upwind_1st"        # INTERNAL_TIDE_X_SCHEME | ppm

    @property
    def freq_list(self):
        return tuple(self.freqs) if self.freqs else (self.freq,)

    @property
    def n_freq(self):
        return len(self.freq_list)


class IntTideResult(NamedTuple):
    En: torch.Tensor               # (n_freq, n_mode, n_angle, njh, nih)
    tot_En: torch.Tensor           # summed over freq, mode and angle
    itidal_loss: torch.Tensor      # wave-drag dissipation [W m-2]
    leak_loss: torch.Tensor        # background loss [W m-2]
    quad_loss: torch.Tensor        # bottom-drag loss [W m-2]
    froude_loss: torch.Tensor      # wave-breaking loss [W m-2]
    itidal_loss_freq: Optional[torch.Tensor] = None   # (n_freq, ...)
    leak_loss_freq: Optional[torch.Tensor] = None
    quad_loss_freq: Optional[torch.Tensor] = None
    froude_loss_freq: Optional[torch.Tensor] = None


def init_en(cfg: InternalTidesCfg, shape, *, device=None,
            dtype=torch.float64) -> torch.Tensor:
    return torch.zeros((cfg.n_freq, cfg.n_mode, cfg.n_angle) + tuple(shape),
                       device=device, dtype=dtype)


def _fractions(given, n):
    if given:
        return (list(given) + [0.0] * n)[:n]
    return [1.0] + [0.0] * (n - 1)


def _column(values, like):
    """A (n, 1, 1) tensor of ``values`` on ``like``'s device and dtype."""
    return torch.as_tensor(np.asarray(values), dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1)


def reflect(cfg: InternalTidesCfg, En, refl_angle, refl_pref,
            refl_dbl=None):
    """Specular redistribution of one mode's energy En (n_angle, njh,
    nih) at the cells with a wall angle ``refl_angle`` [rad] (NaN: no
    wall), a fraction ``refl_pref`` of each incident wedge moving to
    the reflected one; ``refl_dbl`` marks ridges, which reflect rays
    from either side."""
    na = cfg.n_angle
    na2 = na // 2
    dtheta = 2.0 * math.pi / na
    has = ~torch.isnan(refl_angle)
    ang = torch.where(has, refl_angle, 0.0)
    wall = torch.round(torch.remainder(ang, 2.0 * math.pi) / dtheta
                       ).to(torch.int64) % na
    pref = torch.where(has, refl_pref, 0.0)
    ridge = torch.zeros_like(has) if refl_dbl is None else refl_dbl
    a0 = torch.arange(na, device=En.device).reshape(-1, 1, 1)
    attw = (a0 - wall) % na
    flip = ridge & (attw > na2) & (attw < na)
    wall_e = torch.where(flip, (wall + na2) % na, wall)
    attw_e = (a0 - wall_e) % na
    incident = has & (attw_e > 0) & (attw_e < na2)
    angle_r = (2 * wall_e - a0) % na
    frac = torch.where(incident & (angle_r != a0), pref, 0.0)
    moved = frac * En
    return (En - moved) + torch.zeros_like(En).scatter_add_(0, angle_r,
                                                            moved)


def f2_at_h(grid: Grid):
    """f^2 averaged from the corners to h points."""
    fB2 = grid.CoriolisBu ** 2
    return 0.25 * ((fB2 + im1(jm1(fB2))) + (im1(fB2) + jm1(fB2)))


def _cn_face(cn, shift):
    """Face mean of the mode speed skipping zero (land) values."""
    m = (cn != 0.0).to(cn.dtype)
    mn = shift(m)
    w1 = m - 0.5 * m * mn
    w2 = mn - 0.5 * m * mn
    return w1 * cn + w2 * shift(cn)


def _refract(cfg: InternalTidesCfg, grid: Grid, En, cn, dt, freq=None):
    """Angular upwind advection of every wedge at the refraction rate
    d theta/dt = cos(theta) Dl - sin(theta) Dk."""
    freq = cfg.freq if freq is None else freq
    na = cfg.n_angle
    fB = grid.CoriolisBu
    f2 = f2_at_h(grid)
    favg = 0.25 * ((fB + im1(jm1(fB))) + (im1(fB) + jm1(fB)))
    df_dx = 0.5 * ((fB + jm1(fB)) - (im1(fB) + im1(jm1(fB)))) * grid.IdxT
    df_dy = 0.5 * ((fB + im1(fB)) - (jm1(fB) + im1(jm1(fB)))) * grid.IdyT
    cn_u = _cn_face(cn, ip1)
    cn_v = _cn_face(cn, jp1)
    dlnCn_dx = grid.IdxT * (cn_u - im1(cn_u)) \
        / (0.5 * (cn_u + im1(cn_u)) + _CN_SUB)
    dlnCn_dy = grid.IdyT * (cn_v - jm1(cn_v)) \
        / (0.5 * (cn_v + jm1(cn_v)) + _CN_SUB)
    kmag2 = (freq ** 2 - f2) / (cn ** 2 + _CN_SUB ** 2)
    i_kmag = torch.where(kmag2 > 0.0,
                         1.0 / torch.sqrt(torch.clamp(kmag2, min=1e-300)),
                         0.0)
    ifreq = 1.0 / freq
    dk = -ifreq * (favg * df_dx + (freq ** 2 - f2) * dlnCn_dx) * i_kmag
    dl = -ifreq * (favg * df_dy + (freq ** 2 - f2) * dlnCn_dy) * i_kmag
    dk = torch.where(kmag2 > 0.0, dk, 0.0)
    dl = torch.where(kmag2 > 0.0, dl, 0.0)

    dtheta = 2.0 * math.pi / na
    # the angular edge A lies between wedges A and A+1
    edge_ang = (np.arange(na) + 0.5) * dtheta
    cosA = _column(np.cos(edge_ang), En)
    sinA = _column(np.sin(edge_ang), En)
    cfl = torch.clamp((cosA * dl[None] - sinA * dk[None]) * (dt / dtheta),
                      -1.0, 1.0)
    flux = torch.where(cfl > 0.0, cfl * En, cfl * torch.roll(En, -1, 0))
    return En + (torch.roll(flux, 1, 0) - flux)


def _ppm_face(c, up2, up1, dn1, cfl):
    """PPM face value over the CFL sweep of the upwind cell up1 (up2
    farther upwind, dn1 downwind), monotonized central edges; ``c`` (the
    face speed) is unused, as in the JAX package."""
    dl = 0.5 * (up1 - up2) + 0.5 * (dn1 - up1)
    slp = torch.sign(dl) * torch.minimum(
        torch.abs(dl), 2.0 * torch.minimum(torch.abs(up1 - up2),
                                           torch.abs(dn1 - up1)))
    slp = torch.where((up1 - up2) * (dn1 - up1) > 0.0, slp, 0.0)
    eL = up1 - 0.5 * slp
    eR = up1 + 0.5 * slp
    curv3 = eL + eR - 2.0 * up1
    return eR + cfl * (0.5 * (eL - eR) + curv3 * (cfl - 1.5))


def _propagate(cfg: InternalTidesCfg, domain, grid: Grid, En, cn, dt,
               freq=None):
    """Flux-form x then y advection of every wedge at its group
    velocity, upwind or PPM."""
    freq = cfg.freq if freq is None else freq
    na = cfg.n_angle
    f2 = f2_at_h(grid)
    speed = cn * torch.sqrt(torch.clamp(freq ** 2 - f2, min=0.0)) / freq
    speed_u = 0.5 * (speed + ip1(speed)) * grid.mask2dCu
    speed_v = 0.5 * (speed + jp1(speed)) * grid.mask2dCv
    dtheta = 2.0 * math.pi / na
    a0 = np.arange(na) * dtheta
    a1 = a0 + dtheta
    cgx_av = _column((np.sin(a1) - np.sin(a0)) / dtheta, En)
    cgy_av = _column((np.cos(a0) - np.cos(a1)) / dtheta, En)
    use_ppm = cfg.scheme.lower() == "ppm"

    cg_x = speed_u[None] * cgx_av
    if use_ppm:
        cfl_x = torch.abs(cg_x) * dt * grid.IdxCu
        face = torch.where(cg_x > 0.0,
                           _ppm_face(cg_x, im1(En), En, ip1(En), cfl_x),
                           _ppm_face(cg_x, ip1(ip1(En)), ip1(En), En, cfl_x))
        face = torch.clamp(face, min=0.0)
    else:
        face = torch.where(cg_x > 0.0, En, ip1(En))
    flux_x = face * cg_x * grid.dyCu
    En = domain.fill_halos(En + dt * grid.IareaT * (im1(flux_x) - flux_x))
    cg_y = speed_v[None] * cgy_av
    if use_ppm:
        cfl_y = torch.abs(cg_y) * dt * grid.IdyCv
        face = torch.where(cg_y > 0.0,
                           _ppm_face(cg_y, jm1(En), En, jp1(En), cfl_y),
                           _ppm_face(cg_y, jp1(jp1(En)), jp1(En), En, cfl_y))
        face = torch.clamp(face, min=0.0)
    else:
        face = torch.where(cg_y > 0.0, En, jp1(En))
    flux_y = face * cg_y * grid.dxCv
    En = En + dt * grid.IareaT * (jm1(flux_y) - flux_y)
    return torch.clamp(En, min=0.0) * grid.mask2dT


def step_internal_tides(cfg: InternalTidesCfg, domain, grid: Grid, En, cn,
                        dt, tke_input, Nb, htot, u_bt2=0.0, h2_rough=None,
                        refl_angle=None, refl_pref=None,
                        refl_dbl=None) -> IntTideResult:
    """One internal-tide energy step.

    En: (n_freq, n_mode, n_angle, njh, nih) [J m-2] ((n_mode, n_angle,
    ...) and (n_angle, ...) are promoted); cn: the mode-1 speed (mode m
    then moves at cn/m) or (n_mode, njh, nih) speeds; tke_input: the
    conversion [W m-2]; Nb: the near-bottom buoyancy frequency [s-1];
    htot: the column depth [m]; u_bt2: the squared barotropic tidal
    speed; h2_rough: the roughness variance [m2]; refl_*: the
    reflection maps of :func:`reflect`."""
    na, nm, nf = cfg.n_angle, cfg.n_mode, cfg.n_freq
    freqs = cfg.freq_list
    f2 = f2_at_h(grid)
    if En.dim() == 3:
        En = En[None]
    if En.dim() == 4:
        En = En[None]

    frac_m = torch.as_tensor(_fractions(cfg.mode_fraction, nm),
                             dtype=En.dtype, device=En.device
                             ).reshape(-1, 1, 1, 1)
    frac_f = _fractions(cfg.freq_fraction, nf)
    src0 = dt * ((1.0 - cfg.q_itides) / na) * tke_input
    En = En + torch.stack([
        frac_f[f] * frac_m
        * (src0 * ((freqs[f] ** 2 > f2).to(En.dtype)
                   * grid.mask2dT))[None, None]
        for f in range(nf)])

    cn_modes = [cn[m] if cn.dim() == 3 else cn / (m + 1.0)
                for m in range(nm)] if nm > 1 or cn.dim() == 3 else [cn]

    def transport(En_m, cn_m, freq):
        En_m = domain.fill_halos(En_m)
        En_m = _refract(cfg, grid, En_m, cn_m, 0.5 * dt, freq=freq)
        En_m = domain.fill_halos(En_m)
        En_m = _propagate(cfg, domain, grid, En_m, cn_m, dt, freq=freq)
        if refl_angle is not None:
            En_m = reflect(cfg, En_m, refl_angle,
                           refl_pref if refl_pref is not None
                           else torch.ones_like(refl_angle), refl_dbl)
        return En_m

    En = torch.stack([torch.stack([transport(En[f, m], cn_modes[m],
                                             freqs[f])
                                   for m in range(nm)])
                      for f in range(nf)])

    i_d = 1.0 / torch.clamp(htot, min=cfg.drag_min_depth)
    zero_f = torch.zeros((nf,) + tuple(htot.shape), dtype=En.dtype,
                         device=En.device)
    leak_f = zero_f
    if cfg.apply_background_drag and cfg.decay_rate > 0.0:
        leak_f = torch.sum(En, dim=(1, 2)) * cfg.decay_rate
        En = En / (1.0 + dt * cfg.decay_rate)
    quad_f = zero_f
    if cfg.apply_bottom_drag:
        tot_all = torch.sum(En, dim=(0, 1, 2))
        drag_scale = cfg.cdrag * torch.sqrt(torch.clamp(
            u_bt2 + tot_all * i_d / cfg.rho0, min=0.0)) * i_d
        quad_f = torch.sum(En, dim=(1, 2)) * drag_scale[None]
        En = En / (1.0 + dt * drag_scale[None, None, None])
    itidal_f = zero_f
    if cfg.apply_wave_drag:
        # Jayne and St Laurent wave drag, the near-bottom velocity of
        # each mode from energy equipartition
        if h2_rough is None:
            h2_rough = cfg.h2_default
        loss_fixed = 0.5 * cfg.kappa_h2_factor * cfg.kappa_itides \
            * h2_rough * cfg.rho0
        tot_fm = torch.sum(En, dim=2)
        ub2 = 2.0 * tot_fm * (i_d / cfg.rho0)[None, None]
        loss_m = cfg.q_itides * loss_fixed * Nb[None, None] * ub2
        loss_rate = loss_m / (tot_fm + _EN_SUB)
        itidal_f = torch.sum(loss_m * (tot_fm > 0.0), dim=1)
        En = En / (1.0 + dt * loss_rate[:, :, None])
    froude_f = zero_f
    if cfg.apply_froude_drag:
        tot_fm = torch.sum(En, dim=2)
        ub2 = 2.0 * tot_fm * (i_d / cfg.rho0)[None, None]
        c2 = torch.stack([cn_modes[m] ** 2 for m in range(nm)])
        fr2 = ub2 / torch.clamp(c2[None], min=_CN_SUB)
        scale = torch.where(fr2 > 1.0, 1.0 / fr2, 1.0)
        froude_f = torch.sum(tot_fm * (1.0 - scale), dim=1) / dt
        En = En * scale[:, :, None]

    En = torch.stack([torch.stack([
        _refract(cfg, grid, domain.fill_halos(En[f, m]), cn_modes[m],
                 0.5 * dt, freq=freqs[f]) for m in range(nm)])
        for f in range(nf)])
    En = torch.clamp(En, min=0.0) * grid.mask2dT
    return IntTideResult(
        En=En, tot_En=torch.sum(En, dim=(0, 1, 2)),
        itidal_loss=torch.sum(itidal_f, dim=0),
        leak_loss=torch.sum(leak_f, dim=0),
        quad_loss=torch.sum(quad_f, dim=0),
        froude_loss=torch.sum(froude_f, dim=0),
        itidal_loss_freq=itidal_f, leak_loss_freq=leak_f,
        quad_loss_freq=quad_f, froude_loss_freq=froude_f)
