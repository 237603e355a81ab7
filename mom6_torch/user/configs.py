"""Analytic user configurations (counterpart of the JAX package's
``user/configs.py``): the named topographies of TOPO_CONFIG
(``topo_registry``), the thickness initializers of THICKNESS_CONFIG
(``thickness_registry``, some with their own T/S and velocities) and
the T/S profiles of TS_CONFIG benchmark, ISOMIP, baroclinic_zone and
SCM_CVMix_tests.

The topographies take float64 numpy lon/lat arrays at h points and a
``ctx`` of the domain's extent and depths (and the shape parameters the
builder reads) and return depths, positive down.  The initializers take
a ``ctx`` that also holds the grid, vertical grid and equation of state
and return a dict of float64 numpy arrays ``h`` (and ``T``, ``S``,
``u``, ``v`` where they set them), halo-padded like the grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["topo_registry", "thickness_registry", "topo_benchmark",
           "topo_halfpipe", "init_benchmark", "init_benchmark_ts",
           "init_circle_obcs", "isomip_ts", "baroclinic_zone_ts",
           "scm_cvmix_ts"]


def _np(t) -> np.ndarray:
    """A tensor (or array) as a float64 numpy array."""
    if torch.is_tensor(t):
        return t.detach().cpu().double().numpy()
    return np.asarray(t, np.float64)


# ---------------------------------------------------------------------
# topographies: fn(lon, lat, ctx) -> depth (positive down)
# ---------------------------------------------------------------------

def topo_seamount(lon, lat, ctx):
    """A Gaussian seamount in the domain's centre."""
    d0 = ctx["max_depth"]
    h0 = ctx.get("seamount_height", 0.5 * d0)
    lsm = ctx.get("seamount_length", 0.2 * ctx["lenlon"])
    x0 = ctx["west"] + 0.5 * ctx["lenlon"]
    y0 = ctx["south"] + 0.5 * ctx["lenlat"]
    r2 = ((lon - x0) / lsm) ** 2 + ((lat - y0) / lsm) ** 2
    return d0 - h0 * np.exp(-r2)


def topo_dome2d(lon, lat, ctx):
    """The 2-D DOME overflow: a shallow bay in the west, a linear slope,
    a deep basin in the east."""
    d0 = ctx["max_depth"]
    l1 = ctx.get("dome2d_shelf_width", 0.1)
    l2 = 1.0 - ctx.get("dome2d_basin_width", 0.3)
    bay = ctx.get("dome2d_shelf_depth", 0.2)
    x = (lon - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    ramp = bay * d0 + (1.0 - bay) * d0 * (x - l1) / max(l2 - l1, 1e-30)
    return np.where(x <= l1, bay * d0, np.where(x < l2, ramp, d0))


def topo_dumbbell(lon, lat, ctx):
    """Two reservoirs joined by a strait: land where |x/DUMBBELL_LEN| <=
    1/4 and |y/LENLAT| >= DUMBBELL_FRACTION/2, in coordinates centred on
    the domain (x and y swapped by DUMBBELL_ROTATION)."""
    d0 = ctx["max_depth"]
    dblen = ctx.get("dumbbell_len", 600.0)
    dbfrac = ctx.get("dumbbell_fraction", 0.5)
    xc = ctx["west"] + 0.5 * ctx["lenlon"]
    yc = ctx["south"] + 0.5 * ctx["lenlat"]
    if ctx.get("dumbbell_rotation", False):
        x = (lat - yc) / max(dblen, 1e-30)
        y = (lon - xc) / max(ctx["lenlon"], 1e-30)
    else:
        x = (lon - xc) / max(dblen, 1e-30)
        y = (lat - yc) / max(ctx["lenlat"], 1e-30)
    land = (np.abs(x) <= 0.25) & (np.abs(y) >= 0.5 * dbfrac)
    return np.where(land, 0.0, d0)


def topo_benchmark(lon, lat, ctx):
    """D = -D0 (y (1 + 0.6 cos 4 pi x) + 0.75 exp(-6 y)
    + 0.05 cos 10 pi x - 0.7), D0 = 2 max_depth, capped at max_depth,
    land where shallower than min_depth."""
    d0 = ctx["max_depth"] / 0.5
    x = (lon - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    y = (lat - ctx["south"]) / max(ctx["lenlat"], 1e-30)
    D = -d0 * (y * (1.0 + 0.6 * np.cos(4.0 * np.pi * x))
               + 0.75 * np.exp(-6.0 * y)
               + 0.05 * np.cos(10.0 * np.pi * x) - 0.7)
    D = np.minimum(D, ctx["max_depth"])
    return np.where(D < ctx["min_depth"], 0.0, D)


def topo_halfpipe(lon, lat, ctx):
    """A zonally uniform channel with a half-sine meridional profile
    from EDGE_DEPTH to max_depth."""
    dedge = ctx.get("edge_depth", 100.0)
    y = (lat - ctx["south"]) / max(ctx["lenlat"], 1e-30)
    return dedge + (ctx["max_depth"] - dedge) * np.abs(np.sin(np.pi * y))


def topo_dome(lon, lat, ctx):
    """DOME: a deep basin whose slope rises to a shelf (SHELF_DEPTH) in
    the north, cut by an embayment channel in the north-west."""
    H = ctx["max_depth"]
    yn = (lat - ctx["south"]) / max(ctx["lenlat"], 1e-30)
    shelf = ctx.get("shelf_depth", 600.0)
    d = H - (H - shelf) * np.clip((yn - 0.5) / 0.3, 0.0, 1.0)
    x0 = ctx["west"] + 0.15 * ctx["lenlon"]
    chan = np.abs(lon - x0) < 0.05 * ctx["lenlon"]
    d = np.where(chan & (yn > 0.8), shelf, d)
    return np.maximum(d, ctx.get("min_depth", 1.0))


def topo_isomip(lon, lat, ctx):
    """The ISOMIP bed: from 0.6 max_depth at the west wall deepening
    linearly to max_depth at the east."""
    H = ctx["max_depth"]
    xn = np.clip((lon - ctx["west"]) / max(ctx["lenlon"], 1e-30), 0.0, 1.0)
    return H * (0.6 + 0.4 * xn)


def topo_dense_water(lon, lat, ctx):
    """A shallow shelf (SHELF_DEPTH) on the southern third, a linear
    slope down to the deep basin."""
    H = ctx["max_depth"]
    yn = np.clip((lat - ctx["south"]) / max(ctx["lenlat"], 1e-30), 0.0, 1.0)
    shelf = ctx.get("shelf_depth", 500.0)
    return shelf + (H - shelf) * np.clip((yn - 0.3) / 0.4, 0.0, 1.0)


def _spike(x, L):
    """1 at x = 0 falling as 1 - sin to 0 at |x| = L."""
    xn = np.minimum(np.abs(x) / L, 1.0)
    return 1.0 - np.sin(0.5 * np.pi * xn)


def _cosbell(x, L):
    """A cosine bell of unit height and half-width L."""
    xn = np.minimum(np.abs(x) / L, 1.0)
    return 0.5 * (1.0 + np.cos(np.pi * xn))


def topo_neverworld(lon, lat, ctx):
    """Neverworld2: the northern wall and Antarctica's spikes, idealized
    South America, Africa and the Antarctic Peninsula, the Drake
    Passage ridge, the Scotia Arc's bells and a wavy roughness, clipped
    to [0, max_depth]."""
    H = ctx["max_depth"]
    amp = ctx.get("nl_continent_amp", 1.0)
    rough = ctx.get("nl_roughness_amp", 0.05)
    x = (lon - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    y = (lat - ctx["south"]) / max(ctx["lenlat"], 1e-30)
    d = (1.0 - 1.1 * _spike(y - 1.0, 0.12) - 1.1 * _spike(y, 0.12)
         - amp * (
             (1.2 * _spike(x, 0.2) + 1.2 * _spike(x - 1.0, 0.2))
             * _spike(np.minimum(0.0, y - 0.3), 0.2)
             + 1.2 * _spike(x - 0.5, 0.2)
             * _spike(np.minimum(0.0, y - 0.55), 0.2)
             + 1.2 * (_spike(x, 0.12) + _spike(x - 1.0, 0.12))
             * _spike(np.maximum(0.0, y - 0.06), 0.12)
             + 0.1 * (_cosbell(x, 0.1) + _cosbell(x - 1.0, 0.1))
             + 0.5 * _cosbell(x - 0.16, 0.05)
             * _cosbell(y - 0.18, 0.13) ** 0.4
             + 0.4 * _cosbell(x - 0.09, 0.08) ** 0.4
             * _cosbell(y - 0.26, 0.05)
             + 0.4 * _cosbell(x - 0.08, 0.08) ** 0.4
             * _cosbell(y - 0.1, 0.05))
         - rough * np.cos(14 * np.pi * x) * np.sin(14 * np.pi * y)
         - rough * np.cos(20 * np.pi * x) * np.cos(20 * np.pi * y))
    return np.minimum(np.maximum(d, 0.0), 1.0) * H


def topo_shelfwave(lon, lat, ctx):
    """An exponential cross-shore shelf, D = H0 exp(2 y / Ly), capped at
    max_depth, H0 = max(min_depth, 10 m)."""
    h0 = max(ctx["min_depth"], 10.0)
    ly = ctx.get("shelfwave_y_length_scale", 50.0)
    y = lat - ctx["south"]
    return np.minimum(h0 * np.exp(2.0 * y / max(ly, 1e-30)),
                      ctx["max_depth"])


topo_registry = {
    "seamount": topo_seamount,
    "dome2d": topo_dome2d,
    "dumbbell": topo_dumbbell,
    "benchmark": topo_benchmark,
    "halfpipe": topo_halfpipe,
    "dome": topo_dome,
    "isomip": topo_isomip,
    "dense_water": topo_dense_water,
    "neverworld": topo_neverworld,
    "shelfwave": topo_shelfwave,
}


# ---------------------------------------------------------------------
# thickness (and T/S, velocity) initializers: fn(ctx) -> dict
# ---------------------------------------------------------------------

def init_phillips(ctx):
    """The Phillips two-layer channel: the interface at -H/2 + slope
    (y - y0) with a wave perturbation, and the thermal-wind jet
    u1 - u2 = -(g'/f) d(eta)/dy in the top layer."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    if vgrid.nk != 2:
        raise ValueError("phillips config requires NK=2")
    f0 = ctx.get("f0", 1e-4)
    gp = float(vgrid.g_prime[1])
    H0 = ctx["max_depth"]
    lenlat, south = ctx["lenlat"], ctx["south"]
    slope = ctx.get("phillips_slope", 0.0005)
    amp = ctx.get("phillips_amp", 10.0)
    latT, lonT = _np(grid.geoLatT), _np(grid.geoLonT)
    y = (latT - south - 0.5 * lenlat) * 1e3          # m from the centre
    lam = ctx["lenlon"] * 1e3 / 2.0
    pert = amp * np.sin(2 * np.pi * (lonT * 1e3) / lam) \
        * np.exp(-(y / (0.25 * lenlat * 1e3)) ** 2)
    eta1 = np.clip(-0.5 * H0 + slope * y + pert, -H0 + 1.0, -1.0)
    h = np.stack([-eta1, H0 + eta1])
    yC = (_np(grid.geoLatCu) - south - 0.5 * lenlat) * 1e3
    u1 = -(gp / f0) * slope * np.ones_like(yC)
    u = np.stack([u1, np.zeros_like(u1)])
    return dict(h=h, u=u * _np(grid.mask2dCu), v=np.zeros_like(u))


def init_sloshing(ctx):
    """A tilted interface oscillating freely: the interior interfaces
    displaced by SLOSHING_AMP cos(pi x) sin(pi z / H)."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    H0 = ctx["max_depth"]
    amp = ctx.get("sloshing_amp", 75.0)
    lonT = _np(grid.geoLonT)
    xn = (lonT - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    disp = amp * np.cos(np.pi * xn)
    z_nom = np.linspace(0.0, H0, nk + 1)
    e = -(z_nom[:, None, None] * np.ones_like(lonT)[None])
    for K in range(1, nk):
        e[K] -= disp * np.sin(np.pi * z_nom[K] / H0)
    return dict(h=np.maximum(e[:-1] - e[1:], 1e-3))


def _eos_np(eos, fn, T, S, p):
    """An EOS function on float64 numpy arrays."""
    out = getattr(eos, fn)(*(torch.as_tensor(np.asarray(a, np.float64))
                             for a in (T, S, p)))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _benchmark_t0(ctx):
    """The layer temperatures that hit the target densities Rlay at
    P_REF (6 Newton steps from the lightest layer's linearization), the
    salinities and the index of the lightest interior layer."""
    vgrid, eos = ctx["vgrid"], ctx["eos"]
    nk = vgrid.nk
    k1 = ctx.get("nk_rho_varies", 0)
    rlay = _np(vgrid.Rlay)
    s_ref = ctx.get("s_ref", 35.0)
    t_light = ctx.get("benchmark_t_light", 29.0)
    p_ref = ctx.get("p_ref", 2e7)
    S0 = np.full(nk, s_ref)
    pres = np.full(nk, p_ref)
    rho1 = float(_eos_np(eos, "density", [t_light], [s_ref], [p_ref])[0])
    drdt1 = float(_eos_np(eos, "density_derivs", [t_light], [s_ref],
                          [p_ref])[0][0])
    T0 = t_light + (rlay - rho1) / drdt1
    for _ in range(6):
        rho = _eos_np(eos, "density", T0, S0, pres)
        drdt = _eos_np(eos, "density_derivs", T0, S0, pres)[0]
        T0 = T0 + (rlay - rho) / drdt
    return T0, S0, k1


def _benchmark_sst(ctx, T0, k1, nk):
    latT = _np(ctx["grid"].geoLatT)
    return 0.5 * (T0[k1] + T0[nk - 1]) - 0.45 * (T0[k1] - T0[nk - 1]) \
        * np.cos(np.pi * (latT - ctx["south"]) / max(ctx["lenlat"], 1e-30))


def init_benchmark(ctx):
    """Benchmark thicknesses (and, with ``thermo``, T/S): interfaces of
    an exponential-plus-linear thermocline found by Newton from the
    layer temperatures, under a 50 m mixed layer, and the meridional
    cosine SST in the mixed and buffer layers."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    T0, S0, k1 = _benchmark_t0(ctx)
    ml_depth = ctx.get("benchmark_ml_depth_ic", 50.0)
    ts_scale = ctx.get("benchmark_thermocline_scale", 500.0)
    a_exp = 0.9
    depth = _np(grid.bathyT)
    sst = _benchmark_sst(ctx, T0, k1, nk)
    i_ts, i_md = 1.0 / ts_scale, 1.0 / ctx["max_depth"]
    angstrom = vgrid.angstrom
    eta = np.zeros((nk + 1,) + depth.shape)
    eta[nk] = -depth
    h = np.zeros((nk,) + depth.shape)
    for k in range(nk - 1, 0, -1):
        t_int = 0.5 * (T0[k] + T0[k - 1])
        t_frac = (t_int - T0[nk - 1]) / np.maximum(sst - T0[nk - 1], 1e-12)
        z = np.zeros_like(depth)
        for _ in range(6):
            err = a_exp * np.exp(z * i_ts) \
                + (1.0 - a_exp) * (z * i_md + 1.0) - t_frac
            derr = a_exp * i_ts * np.exp(z * i_ts) + (1.0 - a_exp) * i_md
            z = z - err / derr
        eta[k] = np.maximum(np.minimum(z, -ml_depth), eta[k + 1] + angstrom)
        h[k] = np.maximum(eta[k] - eta[k + 1], angstrom)
    h[0] = np.maximum(0.0 - eta[1], angstrom)
    out = dict(h=h)
    if ctx.get("thermo", False):
        T = np.broadcast_to(T0[:, None, None], h.shape).copy()
        T[:k1] = sst
        out["T"] = T
        out["S"] = np.full(h.shape, S0[0])
    return out


def init_benchmark_ts(ctx, shape):
    """Benchmark T/S on thicknesses from elsewhere: the layer
    temperatures that hit Rlay, the cosine SST in the mixed and buffer
    layers; float64 numpy arrays (T, S)."""
    nk = ctx["vgrid"].nk
    T0, S0, k1 = _benchmark_t0(ctx)
    sst = _benchmark_sst(ctx, T0, k1, nk)
    T = np.broadcast_to(T0[:, None, None], shape).copy()
    T[:k1] = sst
    return T, np.full(shape, S0[0])


def _stack_interfaces(e0, depth, floor):
    """Nominal interface heights ``e0`` (nk, up positive) cut by the
    bottom, with at least ``floor`` to a layer, stacked up from the
    bottom; returns the thicknesses."""
    nk = e0.shape[0]
    eta = np.empty((nk + 1,) + depth.shape)
    eta[nk] = -depth
    h = np.empty((nk,) + depth.shape)
    for k in range(nk - 1, -1, -1):
        ek = np.maximum(e0[k] * np.ones_like(depth), eta[k + 1] + floor)
        h[k] = ek - eta[k + 1]
        eta[k] = ek
    return h


def init_circle_obcs(ctx):
    """Uniform z-interfaces cut by the bottom, with a cosine-bell
    displacement of DISK_IC_AMPLITUDE [m] over a disk of DISK_RADIUS
    (axis units) in the domain's centre."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    depth = _np(grid.bathyT)
    diskrad = ctx.get("disk_radius", 0.25 * ctx["lenlon"])
    ic_amp = ctx.get("disk_ic_amplitude", 5.0)
    angstrom = vgrid.angstrom
    lonT, latT = _np(grid.geoLonT), _np(grid.geoLatT)

    e0 = -(ctx["max_depth"] * np.arange(nk) / nk)
    eta = np.zeros((nk + 1,) + depth.shape)
    eta[nk] = -depth
    h = np.zeros((nk,) + depth.shape)
    for k in range(nk - 1, -1, -1):
        eta[k] = np.maximum(e0[k] * np.ones_like(depth),
                            eta[k + 1] + angstrom)
        h[k] = np.maximum(eta[k] - eta[k + 1], angstrom)

    lonc = ctx["west"] + 0.5 * ctx["lenlon"]
    latc = ctx["south"] + 0.5 * ctx["lenlat"]
    rad = np.sqrt((lonT - lonc) ** 2 + (latT - latc) ** 2) / diskrad
    bell = 0.5 * (1.0 + np.cos(np.minimum(rad, 1.0) * np.pi))
    if nk == 1:
        h[0] = h[0] + ic_amp * bell
    else:
        for k in range(nk):
            h[k] = h[k] - bell * ic_amp * (2 * (k + 1) - nk)
        h = np.maximum(h, angstrom)
    return dict(h=h)


def init_adjustment(ctx):
    """Uniform layers with a tanh temperature front (FRONT_WIDTH of
    LENLAT, DELTA_T) across the channel."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    latT = _np(grid.geoLatT)
    yn = (latT - ctx["south"]) / max(ctx["lenlat"], 1e-30) - 0.5
    width = ctx.get("front_width", 0.05)
    dT = ctx.get("delta_t", 2.0)
    shape = (nk,) + latT.shape
    h = np.full(shape, ctx["max_depth"] / nk)
    T = (ctx.get("t_ref", 10.0) + 0.5 * dT * np.tanh(yn / width))[None] \
        * np.ones(shape)
    return dict(h=h, T=T, S=np.full(shape, ctx.get("s_ref", 35.0)))


def init_rossby_front(ctx):
    """A surface temperature front over a mixed layer (ML_DEPTH), with
    the balanced along-front jet (alpha = 2e-4)."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    H0 = ctx["max_depth"]
    f0 = ctx.get("f0", 1e-4)
    latT = _np(grid.geoLatT)
    south, lenlat = ctx["south"], ctx["lenlat"]
    yn = (latT - south) / max(lenlat, 1e-30) - 0.5
    dT = ctx.get("delta_t", 2.0)
    hml = ctx.get("ml_depth", 0.25 * H0)
    shape = (nk,) + latT.shape
    h = np.full(shape, H0 / nk)
    z_mid = (np.arange(nk) + 0.5) * (H0 / nk)
    in_ml = (z_mid < hml).astype(np.float64)
    T = ctx.get("t_ref", 10.0) + dT * np.sin(np.pi * np.clip(yn + 0.5, 0, 1)) \
        * in_ml[:, None, None]
    S = np.full(shape, ctx.get("s_ref", 35.0))
    ynC = (_np(grid.geoLatCu) - south) / max(lenlat, 1e-30) - 0.5
    dTdy = dT * np.pi * np.cos(np.pi * np.clip(ynC + 0.5, 0, 1)) \
        / max(lenlat * 1e3, 1.0)
    alpha = 2e-4
    u_sfc = (9.8 * alpha / f0) * dTdy * hml
    u = u_sfc[None] * in_ml[:, None, None] * _np(grid.mask2dCu)[None]
    return dict(h=h, T=T, S=S, u=u)


def init_lock_exchange(ctx):
    """Dense water (DELTA_T colder) in the western half of the tank."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    lonT = _np(grid.geoLonT)
    xn = (lonT - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    shape = (nk,) + lonT.shape
    h = np.full(shape, ctx["max_depth"] / nk)
    dT = ctx.get("delta_t", 2.0)
    T = (ctx.get("t_ref", 10.0) - dT * (xn < 0.5))[None] * np.ones(shape)
    return dict(h=h, T=T, S=np.full(shape, ctx.get("s_ref", 35.0)))


def init_external_gwave(ctx):
    """A free-surface cosine bump: columns scaled so that
    eta = SSH_ANOMALY_HEIGHT cos(pi x)."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    H0 = ctx["max_depth"]
    lonT = _np(grid.geoLonT)
    xn = (lonT - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    eta = ctx.get("ssh_anomaly_height", 1.0) * np.cos(np.pi * xn)
    scale = (H0 + eta) / H0
    return dict(h=np.full((nk,) + lonT.shape, H0 / nk) * scale[None])


def init_dome(ctx):
    """DOME layers thinning exponentially toward the bottom, cut by the
    topography (the dense classes nearly massless off the slope)."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    bathy = _np(grid.bathyT)
    zi = np.minimum(np.exp(np.linspace(
        0.0, np.log(np.maximum(bathy.max(), 1.0) + 1.0),
        nk + 1))[:, None, None] - 1.0, bathy[None])
    return dict(h=np.maximum(zi[1:] - zi[:-1], 1e-3))


def init_dense_water(ctx):
    """Dense shelf water: a salinity anomaly DELTA_S in the upper water
    column (ML_DEPTH) over the southern 30 %."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    H0 = ctx["max_depth"]
    latT = _np(grid.geoLatT)
    yn = (latT - ctx["south"]) / max(ctx["lenlat"], 1e-30)
    shape = (nk,) + latT.shape
    h = np.full(shape, H0 / nk)
    z_mid = (np.arange(nk) + 0.5) * (H0 / nk)
    in_ml = z_mid < ctx.get("ml_depth", 0.2 * H0)
    S = ctx.get("s_ref", 35.0) \
        + ctx.get("delta_s", 1.5) * (yn < 0.3)[None] * in_ml[:, None, None]
    return dict(h=h, T=np.full(shape, ctx.get("t_ref", 5.0)), S=S)


def init_soliton(ctx):
    """The equatorial Rossby soliton of Boyd (1980): the sech^2-envelope
    height and velocities on an equatorial beta plane, scaled by the
    deformation radius L_eq = sqrt(c_g / beta) (axes in km)."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    H0 = ctx["max_depth"]
    beta = ctx.get("beta", 0.0) or 2.0e-11
    cg_max = math.sqrt(vgrid.g_Earth * H0)
    scale_pos = 1.0e3 / math.sqrt(cg_max / abs(beta))
    x0 = 2.0 * ctx["lenlon"] / 3.0
    y0 = ctx["south"] + 0.5 * ctx["lenlat"]

    def fields(lon, lat, amp):
        x = (_np(lon) - x0) * scale_pos
        y = (_np(lat) - y0) * scale_pos
        v3 = np.exp(-0.395 * x)
        return x, y, amp * (2.0 * v3 / (1.0 + v3 * v3)) ** 2

    _, yT, v4h = fields(grid.geoLonT, grid.geoLatT, H0 * 0.771 * 0.395 ** 2)
    eta = 0.25 * v4h * (6.0 * yT * yT + 3.0) * np.exp(-0.5 * yT * yT)
    h = np.broadcast_to(((eta + H0) / nk)[None], (nk,) + eta.shape).copy()
    val2_u = cg_max * 0.771 * 0.395 ** 2
    _, yU, v4u = fields(grid.geoLonCu, grid.geoLatCu, val2_u)
    u1 = 0.25 * v4u * (6.0 * yU * yU - 9.0) * np.exp(-0.5 * yU * yU)
    xV, yV, v4v = fields(grid.geoLonCv, grid.geoLatCv, val2_u)
    v1 = 2.0 * v4v * yV * (-2.0 * 0.395 * np.tanh(0.395 * xV)) \
        * np.exp(-0.5 * yV * yV)
    u = np.broadcast_to(u1[None], (nk,) + u1.shape) * _np(grid.mask2dCu)
    v = np.broadcast_to(v1[None], (nk,) + v1.shape) * _np(grid.mask2dCv)
    return dict(h=h, u=u, v=v)


def init_dome2d(ctx):
    """DOME2d thicknesses and T/S: uniform-z interfaces (vanished over
    the bay in layer and rho mode, terrain-following in sigma), a
    linear salinity stratification, and the western bay filled with
    salty cold water whose extent depends on the coordinate mode."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    H0 = ctx["max_depth"]
    mode = ctx.get("coord_mode", "LAYER").upper()
    min_th = ctx.get("min_thickness", 1.0e-3)
    wbay = ctx.get("dome2d_shelf_width", 0.1)
    dbay = ctx.get("dome2d_depth_bay", ctx.get("dome2d_shelf_depth", 0.2))
    depth = _np(grid.bathyT)
    x = (_np(grid.geoLonT) - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    e0 = -H0 * np.arange(nk) / nk
    ang = vgrid.angstrom

    if mode in ("LAYER", "RHO"):
        h = _stack_interfaces(e0, depth, ang)
        in_bay = x <= wbay
        h[:-1] = np.where(in_bay[None], ang, h[:-1])
        h[-1] = np.where(in_bay, dbay * H0 - (nk - 1) * ang, h[-1])
    elif mode == "SIGMA":
        h = np.broadcast_to(depth / nk, (nk,) + depth.shape).copy()
    else:                                   # ZSTAR
        h = _stack_interfaces(e0, depth, min_th)

    out = dict(h=h)
    if ctx.get("thermo", False):
        s_surf = ctx.get("initial_sss", 34.0)
        s_range = ctx.get("s_range", 2.0)
        s_ref = ctx.get("s_ref", 35.0)
        t_bay = ctx.get("dome2d_t_bay", 1.0)
        # fractional depths of the layers' tops and bottoms
        xi1 = np.cumsum(h, axis=0) / H0
        xi0 = xi1 - h / H0
        T = np.zeros_like(h)
        if mode in ("ZSTAR", "SIGMA"):
            S = s_surf + 0.5 * s_range * (xi0 + xi1)
            if mode == "ZSTAR":
                kbay = int(round(dbay * nk))
                in_bay3 = (x <= wbay)[None] \
                    & (np.arange(nk) < kbay)[:, None, None]
            else:
                in_bay3 = np.broadcast_to((x <= wbay)[None], h.shape)
            S = np.where(in_bay3, s_ref + s_range, S)
            T = np.where(in_bay3, t_bay, T)
        else:                               # RHO / LAYER
            if mode == "RHO":
                S = s_surf + 0.5 * s_range * (xi0 + xi1)
            else:
                S = (s_ref + s_range * np.arange(nk) / max(nk - 1, 1)
                     )[:, None, None] * np.ones_like(h)
            S[-1] = np.where(x <= wbay, s_surf + s_range, S[-1])
            T[-1] = np.where(x <= wbay, t_bay, T[-1])
        out["T"] = T
        out["S"] = S
    return out


def init_dumbbell(ctx):
    """Dumbbell thicknesses and T/S: salinity DUMBBELL_SREF +-
    DUMBBELL_S_RANGE/2 on the two sides of the strait, the interfaces by
    the coordinate mode."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    H0 = ctx["max_depth"]
    mode = ctx.get("coord_mode", "LAYER").upper()
    min_th = ctx.get("min_thickness", 1.0e-3)
    dblen = ctx.get("dumbbell_len", 600.0)
    rotate = ctx.get("dumbbell_rotation", False)
    depth = _np(grid.bathyT)
    coord = _np(grid.geoLatT if rotate else grid.geoLonT)
    center = (ctx["south"] + 0.5 * ctx["lenlat"]) if rotate \
        else (ctx["west"] + 0.5 * ctx["lenlon"])
    x = (coord - center) / max(dblen, 1e-30)
    ang = vgrid.angstrom

    if mode == "LAYER":
        # the left side's water in the bottom layer, the right's in the
        # top layer
        h = np.empty((nk,) + depth.shape)
        rest = np.maximum(depth - (nk - 1) * min_th, min_th)
        for k in range(nk):
            left = rest if k == 0 else min_th
            right = rest if k == nk - 1 else min_th
            h[k] = np.where(x < 0.0, left, right)
    elif mode in ("RHO", "HYCOM1"):
        s_surf = ctx.get("initial_sss", 34.0)
        s_range = ctx.get("s_range", 2.0)
        s_light = ctx.get("ts_range_s_light", ctx.get("s_ref", 35.0))
        s_dense = ctx.get("ts_range_s_dense", ctx.get("s_ref", 35.0))
        quanta = ctx.get("interface_ic_quanta", 2048.0)
        Kk = np.arange(nk + 1, dtype=np.float64)
        e0 = -H0 * ((s_light - s_surf) + (s_dense - s_light)
                    * ((Kk + 1.0 - 1.5) / max(nk - 1, 1))) \
            / max(s_range, 1e-30)
        if quanta > 0.0:
            e0 = np.rint(quanta * e0) / quanta
        e0 = np.maximum(-H0, np.minimum(-Kk * ang, e0))
        h = _stack_interfaces(e0[:nk], depth, ang)
    elif mode == "SIGMA":
        h = np.broadcast_to(depth / nk, (nk,) + depth.shape).copy()
    else:                                   # ZSTAR
        h = _stack_interfaces(-H0 * np.arange(nk) / nk, depth, min_th)

    out = dict(h=h)
    if ctx.get("thermo", False):
        s_surf = ctx.get("dumbbell_sref", 34.0)
        s_range = ctx.get("dumbbell_s_range", 2.0)
        out["T"] = np.full_like(h, ctx.get("dumbbell_t_surf", 20.0))
        out["S"] = np.where((x >= 0.0)[None], s_surf + 0.5 * s_range,
                            s_surf - 0.5 * s_range) * np.ones_like(h)
    return out


def init_neverworld(ctx):
    """Neverworld thicknesses: the resting INIT_THICKNESS_PROFILE
    (default uniform) stacked up from the bottom, with optional
    sin-spike interface perturbations (NL_THICKNESS_PERT_AMP)."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    profile = ctx.get("init_thickness_profile")
    if profile is None:
        profile = [ctx["max_depth"] / nk] * nk
    profile = np.asarray(profile, np.float64)
    if profile.size != nk:
        raise ValueError("INIT_THICKNESS_PROFILE must have NK entries")
    pert = ctx.get("nl_thickness_pert_amp", 0.0)
    depth = _np(grid.bathyT)
    x = (_np(grid.geoLonT) - ctx["west"]) / max(ctx["lenlon"], 1e-30)
    y = (_np(grid.geoLatT) - ctx["south"]) / max(ctx["lenlat"], 1e-30)
    r1 = np.sqrt((x - 0.7) ** 2 + (y - 0.2) ** 2)
    r2 = np.sqrt((x - 0.3) ** 2 + (y - 0.25) ** 2)
    dspike = _spike(r1, 0.15) - _spike(r2, 0.15)
    e0 = np.concatenate([[0.0], -np.cumsum(profile)])
    ang = vgrid.angstrom
    h = np.empty((nk,) + depth.shape)
    e_int = -depth
    for k in range(nk - 1, 0, -1):
        hk = e0[k] - e_int
        hk = np.maximum(ang, hk + pert * (e0[k] - e0[nk]) * dspike)
        h[k] = hk
        e_int = e_int + hk
    h[0] = np.maximum(ang, e0[0] - e_int)
    return dict(h=h)


thickness_registry = {
    "phillips": init_phillips,
    "sloshing": init_sloshing,
    "benchmark": init_benchmark,
    "circle_obcs": init_circle_obcs,
    "adjustment": init_adjustment,
    "rossby_front": init_rossby_front,
    "lock_exchange": init_lock_exchange,
    "external_gwave": init_external_gwave,
    "dome": init_dome,
    "dense_water": init_dense_water,
    "soliton": init_soliton,
    "DOME2D": init_dome2d,
    "dumbbell": init_dumbbell,
    "Neverworld": init_neverworld,
}


# ---------------------------------------------------------------------
# T/S profiles on given thicknesses
# ---------------------------------------------------------------------

def isomip_ts(ctx, h):
    """ISOMIP's linear T/S between the surface (ISOMIP_T_SUR, _S_SUR)
    and bottom (ISOMIP_T_BOT, _S_BOT) values over max_depth, at the
    layer centres measured from the local bottom; float64 numpy (T, S)."""
    H0 = ctx["max_depth"]
    t_sur = ctx.get("isomip_t_sur", -1.9)
    s_sur = ctx.get("isomip_s_sur", 33.8)
    t_bot = ctx.get("isomip_t_bot", -1.9)
    s_bot = ctx.get("isomip_s_bot", 34.55)
    hn = _np(h)
    depth_tot = hn.sum(axis=0)
    zc_from_bot = np.cumsum(hn[::-1], axis=0)[::-1] - 0.5 * hn
    xi0 = -depth_tot + zc_from_bot
    return (t_sur + (t_sur - t_bot) / H0 * xi0,
            s_sur + (s_sur - s_bot) / H0 * xi0)


def baroclinic_zone_ts(ctx, h):
    """The idealized baroclinic zone: linear vertical and zonal
    gradients (BCZIC%DTDZ, %DTDX, ...) plus a sin front of width
    BCZIC%L_ZONE across the channel in x; float64 numpy (T, S)."""
    grid = ctx["grid"]
    t_ref, dtdz = ctx.get("t_ref", 10.0), ctx.get("bcz_dtdz", 0.0)
    delta_t, dtdx = ctx.get("bcz_delta_t", 0.0), ctx.get("bcz_dtdx", 0.0)
    s_ref, dsdz = ctx.get("s_ref", 35.0), ctx.get("bcz_dsdz", 0.0)
    delta_s, dsdx = ctx.get("bcz_delta_s", 0.0), ctx.get("bcz_dsdx", 0.0)
    L_zone = ctx.get("bcz_l_zone", 0.5 * ctx["lenlat"])
    hn = _np(h)
    depth_tot = hn.sum(axis=0)
    zc = -depth_tot + np.cumsum(hn[::-1], axis=0)[::-1] - 0.5 * hn
    xx = _np(grid.geoLonT) - (ctx["west"] + 0.5 * ctx["lenlon"])
    if L_zone != 0.0:
        fn = np.sin(0.5 * np.pi * np.clip(xx / L_zone, -1.0, 1.0))
    else:
        fn = np.sign(xx)
    T = t_ref + dtdz * zc + (dtdx * xx + delta_t * fn)[None]
    S = s_ref + dsdz * zc + (dsdx * xx + delta_s * fn)[None]
    return T, S


def scm_cvmix_ts(h, t_mld=0.0, s_mld=0.0, l2_temp=20.0, l2_salt=35.0,
                 dtdz=0.0, dsdz=0.0, min_temp=4.0):
    """The single-column CVMix tests' T/S on the thickness tensor ``h``:
    a mixed layer over a linear interior,
    T = max(min_temp, L2_TEMP + dT/dz min(0, z_centre + MLD_T)), S alike
    without the floor; tensors like ``h``."""
    zbot = -torch.cumsum(h, dim=0)
    ztop = torch.cat([torch.zeros_like(h[:1]), zbot[:-1]], dim=0)
    zc = 0.5 * (ztop + zbot)
    T = torch.clamp(l2_temp + dtdz * torch.clamp(zc + t_mld, max=0.0),
                    min=min_temp)
    S = l2_salt + dsdz * torch.clamp(zc + s_mld, max=0.0)
    return T, S
