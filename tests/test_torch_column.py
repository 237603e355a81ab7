"""mom6_torch against mom6_tpu: the column physics of the full step.

One seeded set of columns (5 layers over 8x9 points, a stratified T/S
profile, surface fluxes and wind) goes through the JAX functions,
called eagerly in float64, and their ports on device="cpu" in float64:
set_diffusivity (constant and Bryan-Lewis backgrounds), KPP, the
surface-flux application, tracer_vertdiff, diffusive entrainment and
the diabatic driver (KPP, fluxes, vertical diffusion, entrainment),
and the surface forcing that feeds them (gyre wind, linear SST
restoring).  The costlier JAX references run under jax.jit, which at
this size compiles faster than they run eagerly.  Tolerance 1e-12
relative to each field's maximum, except
KPP's boundary-layer depth and the fields downstream of it (1e-10: the
bulk-Richardson crossing divides by a near-cancelling difference).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core.forcing import Fluxes as JFluxes
from mom6_tpu.core.forcing import MechForcing as JMechForcing
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.drivers import surface_forcing as jsf
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.param.vertical import bkgnd_mixing as jbk
from mom6_tpu.param.vertical import diabatic as jdia
from mom6_tpu.param.vertical import diabatic_aux as jaux
from mom6_tpu.param.vertical import entrain_diffusive as jent
from mom6_tpu.param.vertical import kpp as jkpp
from mom6_tpu.param.vertical import set_diffusivity as jsd
from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.tracer.vertdiff import tracer_vertdiff as j_vertdiff

from mom6_torch.convert import grid_from_numpy
from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.drivers import surface_forcing as tsf
from mom6_torch.eos import make_eos
from mom6_torch.param.vertical import bkgnd_mixing as tbk
from mom6_torch.param.vertical import diabatic as tdia
from mom6_torch.param.vertical import diabatic_aux as taux
from mom6_torch.param.vertical import entrain_diffusive as tent
from mom6_torch.param.vertical import kpp as tkpp
from mom6_torch.param.vertical import set_diffusivity as tsd
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer.vertdiff import tracer_vertdiff as t_vertdiff

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NK, NJ, NI = 5, 8, 9
RNG = np.random.default_rng(21)
H = np.concatenate([RNG.uniform(5.0, 40.0, (2, NJ, NI)),
                    RNG.uniform(200.0, 900.0, (NK - 2, NJ, NI))])
T = np.linspace(18.0, 3.0, NK)[:, None, None] \
    + 0.3 * RNG.standard_normal((NK, NJ, NI))
S = 35.0 + 0.1 * RNG.standard_normal((NK, NJ, NI))
U = 0.2 * RNG.standard_normal((NK, NJ, NI))
V = 0.2 * RNG.standard_normal((NK, NJ, NI))
AGE = RNG.uniform(0.0, 2.0, (NK, NJ, NI))
KD = 1e-5 + 1e-3 * RNG.uniform(0.0, 1.0, (NK + 1, NJ, NI))
HEAT = 200.0 * RNG.standard_normal((NJ, NI))
TAUX = 0.1 * RNG.standard_normal((NJ, NI))
GP = np.array([9.8, 0.01, 0.02, 0.0, 0.015, 0.0])


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _check(ref, out, tol, name):
    a = np.asarray(ref)
    b = out.numpy()
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("scheme", ["constant", "bryan_lewis"])
def test_set_diffusivity_matches_jax(scheme):
    jcfg = jsd.DiffusivityCfg(kd=2e-5, kd_min=1.5e-5, kd_max=1e-4,
                              bkgnd=jbk.BkgndMixingCfg(scheme=scheme,
                                                       kd=2e-5))
    tcfg = tsd.DiffusivityCfg(kd=2e-5, kd_min=1.5e-5, kd_max=1e-4,
                              bkgnd=tbk.BkgndMixingCfg(scheme=scheme,
                                                       kd=2e-5))
    ref = jsd.set_diffusivity(jnp.asarray(H), jcfg)
    out = tsd.set_diffusivity(_t(H), tcfg)
    _check(ref.kd_int, out.kd_int, 1e-12, "kd_int")
    _check(ref.kv_int, out.kv_int, 1e-12, "kv_int")


def _ustar_buoy():
    rng = np.random.default_rng(2)
    return (np.abs(0.01 * rng.standard_normal((NJ, NI))),
            1e-7 * rng.standard_normal((NJ, NI)))


def test_kpp_matches_jax():
    ustar, buoy = _ustar_buoy()
    ref = jax.jit(lambda u, v, h, t, s, us, bf: jkpp.kpp_coefficients(
        jkpp.KPPCfg(), u, v, h, t, s, j_make_eos("WRIGHT"), 1035.0, 9.8,
        ustar=us, buoy_flux=bf))(*(jnp.asarray(a) for a in
                                   (U, V, H, T, S, ustar, buoy)))
    out = tkpp.kpp_coefficients(tkpp.KPPCfg(), *(_t(a) for a in
                                                 (U, V, H, T, S)),
                                make_eos("WRIGHT"), 1035.0, 9.8,
                                ustar=_t(ustar), buoy_flux=_t(buoy))
    for name in ("kd_int", "kv_int", "bld", "nonlocal_shape"):
        _check(getattr(ref, name), getattr(out, name), 1e-10, name)


@pytest.mark.parametrize("with_fw", [False, True])
def test_apply_boundary_fluxes_matches_jax(with_fw):
    rng = np.random.default_rng(4)
    extra = {}
    if with_fw:
        extra = dict(lprec=1e-4 * rng.uniform(0.0, 1.0, (NJ, NI)),
                     evap=1e-4 * rng.uniform(0.0, 1.0, (NJ, NI)),
                     salt_flux=1e-6 * rng.standard_normal((NJ, NI)),
                     sw=100.0 * rng.uniform(0.0, 1.0, (NJ, NI)))
    jf = JFluxes(sensible=jnp.asarray(HEAT),
                 **{k: jnp.asarray(v) for k, v in extra.items()})
    tf = Fluxes(sensible=_t(HEAT), **{k: _t(v) for k, v in extra.items()})
    ref = jaux.apply_boundary_fluxes(jnp.asarray(H), jnp.asarray(T),
                                     jnp.asarray(S), jf, 1200.0, 1035.0)
    out = taux.apply_boundary_fluxes(_t(H), _t(T), _t(S), tf, 1200.0,
                                     1035.0)
    for name in ref._fields:
        _check(getattr(ref, name), getattr(out, name), 1e-12, name)


def test_tracer_vertdiff_matches_jax():
    ref = j_vertdiff(jnp.asarray(T), jnp.asarray(H), jnp.asarray(KD),
                     1200.0)
    out = t_vertdiff(_t(T), _t(H), _t(KD), 1200.0)
    _check(ref, out, 1e-12, "T")


@pytest.mark.parametrize("gprime", [None, GP])
def test_entrainment_diffusive_matches_jax(gprime):
    trs = {"T": T, "age": AGE}
    ref = jax.jit(lambda h, kd, tr: jent.entrainment_diffusive(
        jent.EntrainDiffusiveCfg(), h, kd, 1200.0, tr,
        gprime=None if gprime is None else jnp.asarray(gprime)))(
        jnp.asarray(H), jnp.asarray(KD),
        {k: jnp.asarray(v) for k, v in trs.items()})
    out = tent.entrainment_diffusive(
        tent.EntrainDiffusiveCfg(), _t(H), _t(KD), 1200.0,
        {k: _t(v) for k, v in trs.items()},
        gprime=None if gprime is None else _t(gprime))
    _check(ref[0], out[0], 1e-12, "h")
    _check(ref[2], out[2], 1e-12, "f")
    for k in trs:
        _check(ref[1][k], out[1][k], 1e-12, k)


def test_diabatic_matches_jax():
    nk = NK
    jvg = JVerticalGrid.uniform(nk=nk)
    tvg = VerticalGrid.uniform(nk=nk, device="cpu", dtype=F64)
    jcfg = jdia.DiabaticCfg(
        diffusivity=jsd.DiffusivityCfg(kd=1e-5,
                                       bkgnd=jbk.BkgndMixingCfg(kd=1e-5)),
        use_kpp=True, use_entrain_diffusive=True)
    tcfg = tdia.DiabaticCfg(
        diffusivity=tsd.DiffusivityCfg(kd=1e-5,
                                       bkgnd=tbk.BkgndMixingCfg(kd=1e-5)),
        use_kpp=True, use_entrain_diffusive=True)
    js = JState(u=jnp.asarray(U), v=jnp.asarray(V), h=jnp.asarray(H),
                T=jnp.asarray(T), S=jnp.asarray(S))
    ts = State(u=_t(U), v=_t(V), h=_t(H), T=_t(T), S=_t(S))
    ref = jax.jit(lambda st, heat, age, taux: jdia.diabatic(
        st, JFluxes(sensible=heat), 1200.0, jcfg, {"age": age}, vgrid=jvg,
        eos=j_make_eos("WRIGHT"), forces=JMechForcing(taux=taux)))(
        js, jnp.asarray(HEAT), jnp.asarray(AGE), jnp.asarray(TAUX))
    out = tdia.diabatic(ts, Fluxes(sensible=_t(HEAT)), 1200.0, tcfg,
                        {"age": _t(AGE)}, vgrid=tvg, eos=make_eos("WRIGHT"),
                        forces=MechForcing(taux=_t(TAUX)))
    for name in ("h", "T", "S"):
        _check(getattr(ref[0], name), getattr(out[0], name), 1e-10, name)
    _check(ref[1]["age"], out[1]["age"], 1e-10, "age")
    _check(ref[2]["kd_int"], out[2]["kd_int"], 1e-10, "kd_int")
    _check(ref[2]["mld"], out[2]["mld"], 1e-10, "mld")


def test_surface_forcing_matches_jax():
    ni, nj = 12, 10
    jd = JDomain(ni=ni, nj=nj, halo=4, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=120.0, lenlat_km=100.0,
                          max_depth=4000.0)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    tg = grid_from_numpy(gnp, Domain(ni=ni, nj=nj, reentrant_x=True),
                         device="cpu", dtype=F64)
    kw = dict(wind_config="gyres", taux_magnitude=0.1,
              buoy_config="linear_restoring", restore_sst=True,
              fluxconst=0.5, restore_sss=True, sss_north=34.0)
    jcfg, tcfg = jsf.SurfaceForcingCfg(**kw), tsf.SurfaceForcingCfg(**kw)
    _check(jsf.build_wind(jcfg, jg, 0.0, 100.0).taux,
           tsf.build_wind(tcfg, tg, 0.0, 100.0).taux, 1e-13, "taux")
    sst = 15.0 + np.random.default_rng(5).standard_normal(gnp["bathyT"].shape)
    rf = jsf.buoyancy_restoring(jcfg, jg, jnp.asarray(sst), 0.0, 100.0,
                                sss=jnp.asarray(sst + 20.0))
    of = tsf.buoyancy_restoring(tcfg, tg, _t(sst), 0.0, 100.0,
                                sss=_t(sst + 20.0))
    _check(rf.sensible, of.sensible, 1e-13, "sensible")
    _check(rf.salt_flux, of.salt_flux, 1e-13, "salt_flux")
