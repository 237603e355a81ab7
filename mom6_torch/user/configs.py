"""Analytic user configurations (counterpart of the JAX package's
``user/configs.py`` for the cases the port runs): the ``benchmark`` and
``halfpipe`` topographies (TOPO_CONFIG), the benchmark thicknesses
and temperatures (THICKNESS_CONFIG and TS_CONFIG ``benchmark``) and the
circle_obcs thicknesses; ``thickness_registry`` names the ported
THICKNESS_CONFIG initializers.  They
work on float64 numpy arrays at h points, as the builder's grid
functions do; ``ctx`` holds the domain's extent and depths and, for the
initializers, the grid, vertical grid and equation of state."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["topo_benchmark", "topo_halfpipe", "init_benchmark",
           "init_benchmark_ts", "init_circle_obcs", "thickness_registry"]


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
    rlay = vgrid.Rlay.detach().cpu().double().numpy()
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
    latT = ctx["grid"].geoLatT.detach().cpu().double().numpy()
    return 0.5 * (T0[k1] + T0[nk - 1]) - 0.45 * (T0[k1] - T0[nk - 1]) \
        * np.cos(np.pi * (latT - ctx["south"]) / max(ctx["lenlat"], 1e-30))


def init_benchmark(ctx):
    """Benchmark thicknesses (and, with ``thermo``, T/S): interfaces of
    an exponential-plus-linear thermocline found by Newton from the
    layer temperatures, under a 50 m mixed layer, and the meridional
    cosine SST in the mixed and buffer layers.  Returns a dict of
    float64 numpy arrays ``h`` (and ``T``, ``S``)."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    T0, S0, k1 = _benchmark_t0(ctx)
    ml_depth = ctx.get("benchmark_ml_depth_ic", 50.0)
    ts_scale = ctx.get("benchmark_thermocline_scale", 500.0)
    a_exp = 0.9
    depth = grid.bathyT.detach().cpu().double().numpy()
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


def init_circle_obcs(ctx):
    """Uniform z-interfaces cut by the bottom, with a cosine-bell
    displacement of DISK_IC_AMPLITUDE [m] over a disk of DISK_RADIUS
    (axis units) in the domain's centre.  Returns {"h": float64 numpy
    array}."""
    grid, vgrid = ctx["grid"], ctx["vgrid"]
    nk = vgrid.nk
    depth = grid.bathyT.detach().cpu().double().numpy()
    diskrad = ctx.get("disk_radius", 0.25 * ctx["lenlon"])
    ic_amp = ctx.get("disk_ic_amplitude", 5.0)
    angstrom = vgrid.angstrom
    lonT = grid.geoLonT.detach().cpu().double().numpy()
    latT = grid.geoLatT.detach().cpu().double().numpy()

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


# the ported THICKNESS_CONFIG initializers (the JAX package's
# thickness_registry has the others too)
thickness_registry = {
    "benchmark": init_benchmark,
    "circle_obcs": init_circle_obcs,
}
