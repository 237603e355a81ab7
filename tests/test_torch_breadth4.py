"""mom6_torch against mom6_tpu: the lateral parameterizations of the fourth
breadth item, on the CPU in float64.

* Each module at a seeded 12x10x4 state (reentrant x, walls in y, a beta
  plane, one nearly vanished layer in some columns), eagerly through
  both packages: the WKB and modal wave speeds (1e-11; 1e-10 in the
  columns with the vanished layer, whose eigenproblem moves by 1.5e-11
  under a one-ulp change of h), the isoneutral
  slopes, the VarMix resolution function (KH_RES_FN_POWER 2, 3, 4 and
  the cutoff; direct and interpolated faces; Gill's and Pedlosky's
  deformation radius), the Eady rate (interface or EOS slopes,
  VARMIX_KTOP) and the Visbeck diffusivity, MEKE (length scales in both
  blends, the step with every source and the advection of E, the
  GEOMETRIC diffusivity, Ku and the equilibrium), thickness_diffuse with
  a 2-D coefficient, face resolution factors and given reduced
  gravities, hor_visc with the resolution scaling and a Ku of either
  sign, the interface filter (both orders), tracer_hordiff's 2-D,
  Visbeck, resolution and mixed-layer epipycnal branches, neutral and
  boundary diffusion, internal_tide_input and step_internal_tides
  (12 angles; reflection at walls and ridges, refraction on the beta
  plane, both advection schemes, two modes and two frequencies, every
  drag):
  1e-12 relative to each field's maximum unless stated.
* ``configs.BENCH_CONFIG_B4`` at 16x16x4 with DT_THERM = DT: 2
  thermodynamic steps (1 and 3) of the port's ``Model.step_fn`` against
  the JAX one, from a perturbed state with a perturbed MEKE energy and
  given carries (a 50 m boundary layer for MLE and the boundary
  diffusion, zero internal-tide energy), so that both steps take the
  same arguments and the JAX package compiles one step function (with
  most XLA optimizations off); the MLD and internal-tide carries
  included (1e-9); both texts' configurations equal the JAX builder's.
* ``cases/ref_tc1`` and ``ref_tc2`` through ``python -m
  mom6_torch.drivers.solo --cpu`` against tests/goldens_ref_cases.json at
  tests/test_ref_cases.py's tolerances (the JAX package's own test holds
  those goldens).
* A port restart with MEKE's energy and the internal-tide carry: its
  trees, leaf order and treedefs equal the JAX package's layout, and a
  restarted run continues bit for bit.
* A float32 column at rest through wave_speeds, the resolution function
  and a MEKE step gives finite values.
"""

import dataclasses
import json
import math
import pathlib
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import isopycnal_slopes as jsl
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.diagnostics import wave_speed as jws
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.framework import restart as jrestart
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.param.lateral import hor_visc as jhv
from mom6_tpu.param.lateral import interface_filter as jif
from mom6_tpu.param.lateral import internal_tides as jit
from mom6_tpu.param.lateral import meke as jmk
from mom6_tpu.param.lateral import thickness_diffuse as jtd
from mom6_tpu.param.lateral import varmix as jvm
from mom6_tpu.param.vertical import tidal_mixing as jtm
from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.tracer import hor_bnd_diffusion as jhbd
from mom6_tpu.tracer import hor_diff as jhd
from mom6_tpu.tracer import neutral_diffusion as jnd

from mom6_torch import configs, convert
from mom6_torch.convert import grid_from_numpy
from mom6_torch.core import isopycnal_slopes as tsl
from mom6_torch.core.grid import cartesian_grid
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.diagnostics import sum_output
from mom6_torch.diagnostics import wave_speed as tws
from mom6_torch.drivers import solo
from mom6_torch.eos import make_eos
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.param.lateral import hor_visc as thv
from mom6_torch.param.lateral import interface_filter as tif
from mom6_torch.param.lateral import internal_tides as tit
from mom6_torch.param.lateral import meke as tmk
from mom6_torch.param.lateral import thickness_diffuse as ttd
from mom6_torch.param.lateral import varmix as tvm
from mom6_torch.param.vertical import tidal_mixing as ttm
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer import hor_bnd_diffusion as thbd
from mom6_torch.tracer import hor_diff as thd
from mom6_torch.tracer import neutral_diffusion as tnd

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
NI, NJ, NK = 12, 10, 4
H = 4
TOL = 1e-12
DT = 600.0


def _setup():
    jd = JDomain(ni=NI, nj=NJ, halo=H, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=240.0, lenlat_km=200.0, f0=5e-5,
                          beta=2e-11, max_depth=3000.0)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    td = Domain(ni=NI, nj=NJ, halo=H, reentrant_x=True)
    tg = grid_from_numpy(gnp, td, device="cpu", dtype=F64)
    rng = np.random.default_rng(41)
    shape = (NK, jd.njh, jd.nih)

    def field(a):
        return np.asarray(jd.fill_halos(jnp.asarray(a)))

    h = rng.uniform(300.0, 900.0, shape)
    h[1, 5:8, 6:9] = 1e-3              # a nearly vanished layer
    T = np.linspace(22.0, 3.0, NK)[:, None, None] \
        + 0.8 * rng.standard_normal(shape)
    T[:, 3:5, 2:4] = 10.0              # unstratified columns
    a = dict(
        h=field(h), T=field(T),
        S=field(35.0 + 0.3 * rng.standard_normal(shape)),
        age=field(rng.uniform(0.0, 3.0, shape)),
        u=field(0.2 * rng.standard_normal(shape) * gnp["mask2dCu"]),
        v=field(0.2 * rng.standard_normal(shape) * gnp["mask2dCv"]),
        meke=field(rng.uniform(0.0, 0.05, shape[1:]) * gnp["mask2dT"]),
        f2d=field(rng.uniform(0.2, 1.0, shape[1:])),
        g2d=field(rng.uniform(-1.0, 1.0, shape[1:])),
        w2d=field(rng.uniform(1e-9, 1e-6, shape[1:])),
        bld=field(rng.uniform(20.0, 900.0, shape[1:])))
    return jd, jg, td, tg, a


JD, JG, TD, TG, A = _setup()
JVG = JVerticalGrid.uniform(nk=NK, gint=0.01)
TVG = VerticalGrid.uniform(nk=NK, gint=0.01, device="cpu", dtype=F64)
JEOS, TEOS = j_make_eos("WRIGHT"), make_eos("WRIGHT")


def _j(name):
    return jnp.asarray(A[name])


def _t(a):
    a = A[a] if isinstance(a, str) else a
    return torch.tensor(np.asarray(a), dtype=F64)


def _check(ref, out, name, tol=TOL, halo=H):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    if halo and a.ndim >= 2:
        a, b = a[..., halo:-halo, halo:-halo], b[..., halo:-halo, halo:-halo]
    assert a.shape == b.shape, name
    assert np.isfinite(b).all(), name
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


# ---- wave speeds, slopes and VarMix -----------------------------------------

@pytest.mark.parametrize("with_eos", [True, False])
def test_wave_speeds_match_jax(with_eos):
    jts = (_j("T"), _j("S"), JEOS) if with_eos else (None, None, None)
    tts = (_t("T"), _t("S"), TEOS) if with_eos else (None, None, None)
    _check(jws.wave_speed_wkb(JVG, _j("h"), *jts),
           tws.wave_speed_wkb(TVG, _t("h"), *tts), "c_wkb", 1e-11)
    # compiled once: eagerly each of its 60 Thomas scans would compile
    nm = 2 if with_eos else 1
    ref = jax.jit(lambda h, T, S: jws.wave_speeds(JVG, h, T, S, jts[2],
                                                   n_mode=nm))(
        _j("h"), *jts[:2])
    out = tws.wave_speeds(TVG, _t("h"), *tts, n_mode=nm)
    # the columns with the nearly vanished layer are ill-conditioned: a
    # one-ulp change of h moves their speeds by ~1.5e-11 of the largest,
    # in either package, so they are held at 1e-10 and the rest at 1e-11
    _check(ref, out, "wave_speeds", 1e-10)
    keep = np.ones((NJ, NI), bool)
    keep[5 - H:8 - H, 6 - H:9 - H] = False
    _check(np.asarray(ref)[:, H:-H, H:-H][:, keep],
           out[:, H:-H, H:-H].numpy()[:, keep], "wave_speeds", 1e-11, 0)
    assert float(out[0].max()) > 0.0
    rng = np.random.default_rng(3)
    rows = [rng.uniform(-1.0, 1.0, (5, 7)) for _ in range(4)]
    rows[1] = rows[1] + 4.0
    _check(jws._thomas_rows(*(jnp.asarray(r) for r in rows)),
           tws._thomas_rows(*(_t(r) for r in rows)), "thomas", 1e-13, 0)


def test_isoneutral_slopes_match_jax():
    ref = jsl.isoneutral_slopes(jsl.SlopeCfg(), JG, JVG, _j("h"), _j("T"),
                                _j("S"), JEOS)
    out = tsl.isoneutral_slopes(tsl.SlopeCfg(), TG, TVG, _t("h"), _t("T"),
                                _t("S"), TEOS)
    for k in ("slope_x", "slope_y", "n2"):
        _check(getattr(ref, k), getattr(out, k), k)


@pytest.mark.parametrize("power,interp,gill", [
    (2, False, True), (3, True, False), (4, False, False), (100, False, True)])
def test_resolution_function_matches_jax(power, interp, gill):
    kw = dict(res_fn_power=power, interpolate_res_fn=interp,
              gill_equatorial_ld=gill, res_coef=0.7)
    ref = jvm.calc_resolution_function(jvm.VarMixCfg(**kw), JG, JVG,
                                       _j("h"), _j("T"), _j("S"), JEOS)
    out = tvm.calc_resolution_function(tvm.VarMixCfg(**kw), TG, TVG,
                                       _t("h"), _t("T"), _t("S"), TEOS)
    for k in ("res_fn", "rd_dx", "res_fn_u", "res_fn_v"):
        _check(getattr(ref, k), getattr(out, k), k)


@pytest.mark.parametrize("stored,ktop", [(False, 2), (True, 3), (False, 3)])
def test_eady_rate_and_visbeck_match_jax(stored, ktop):
    kw = dict(use_stored_slopes=stored, varmix_ktop=ktop, khth_slope_cff=0.1,
              visbeck_l_scale=0.0 if stored else 3e4)
    jsn = jvm.calc_eady_rate(jvm.VarMixCfg(**kw), JG, JVG, _j("h"), _j("T"),
                             _j("S"), JEOS)
    tsn = tvm.calc_eady_rate(tvm.VarMixCfg(**kw), TG, TVG, _t("h"), _t("T"),
                             _t("S"), TEOS)
    _check(jsn, tsn, "sn")
    assert float(tsn.max()) > 0.0
    _check(jvm.visbeck_kh(jvm.VarMixCfg(**kw), JG, jsn),
           tvm.visbeck_kh(tvm.VarMixCfg(**kw), TG, tsn), "visbeck")
    assert tvm.visbeck_kh(tvm.VarMixCfg(), TG, tsn) is None


# ---- MEKE -------------------------------------------------------------------

MEKE_KW = dict(gmcoeff=1.0, bgsrc=1e-13, khmeke_fac=1.0, a_rhines=0.15,
               a_eady=0.15, a_deform=0.3, advection_factor=0.5,
               viscosity_coeff_ku=-0.4, cd_scale=0.1)


@pytest.mark.parametrize("use_min", [False, True])
def test_meke_matches_jax(use_min):
    kw = dict(MEKE_KW, use_min_lscale=use_min)
    jc, tc = jmk.MEKECfg(**kw), tmk.MEKECfg(**kw)
    depth = 2000.0 + 1000.0 * A["f2d"]
    sn = 1e-6 * A["f2d"]
    beta = 1e-11 * A["f2d"]
    ref = jmk.meke_length_scales(jc, JG, _j("meke"), jnp.asarray(depth),
                                 rd_dx=_j("f2d"), sn=jnp.asarray(sn),
                                 beta=jnp.asarray(beta))
    out = tmk.meke_length_scales(tc, TG, _t("meke"), _t(depth),
                                 rd_dx=_t("f2d"), sn=_t(sn), beta=_t(beta))
    for k, a, b in zip(("lmix", "bottom2", "barotr2"), ref, out):
        _check(a, b, k)
    u_bt = 0.1 * A["g2d"] * np.asarray(JG.mask2dCu)
    v_bt = -0.1 * A["g2d"] * np.asarray(JG.mask2dCv)
    jkw = dict(gm_work=_j("w2d"), fric_work=0.5 * _j("w2d"),
               depth_tot=jnp.asarray(depth), rd_dx=_j("f2d"),
               sn=jnp.asarray(sn), u_bt=jnp.asarray(u_bt),
               v_bt=jnp.asarray(v_bt))
    tkw = {k: _t(np.asarray(v)) for k, v in jkw.items()}
    _check(jmk.step_meke(jc, JG, _j("meke"), DT, **jkw),
           tmk.step_meke(tc, TG, _t("meke"), DT, **tkw), "step_meke")
    _check(jmk.step_meke(jc, JG, _j("meke"), DT),
           tmk.step_meke(tc, TG, _t("meke"), DT), "step_meke bare")
    _check(jmk.meke_khth(jc, _j("meke"), lmix=ref[0], barotr2=ref[2]),
           tmk.meke_khth(tc, _t("meke"), lmix=out[0], barotr2=out[2]),
           "meke_khth")
    _check(jmk.meke_ku(jc, _j("meke"), lmix=ref[0]),
           tmk.meke_ku(tc, _t("meke"), lmix=out[0]), "meke_ku")
    assert float(tmk.meke_ku(tc, _t("meke"), lmix=out[0]).min()) < 0.0
    _check(jmk.meke_equilibrium(jc, JG, jnp.asarray(depth),
                                jnp.asarray(sn), gm_work=_j("w2d")),
           tmk.meke_equilibrium(tc, TG, _t(depth), _t(sn),
                                gm_work=_t("w2d")), "equilibrium")


def test_meke_geometric_matches_jax():
    kw = dict(MEKE_KW, geometric=True)
    jc, tc = jmk.MEKECfg(**kw), tmk.MEKECfg(**kw)
    sn = 1e-6 * A["f2d"]
    _check(jmk.meke_khth(jc, _j("meke"), sn=jnp.asarray(sn)),
           tmk.meke_khth(tc, _t("meke"), sn=_t(sn)), "geometric khth")
    depth = 2000.0 + 1000.0 * A["f2d"]
    _check(jmk.meke_equilibrium(jc, JG, jnp.asarray(depth), jnp.asarray(sn)),
           tmk.meke_equilibrium(tc, TG, _t(depth), _t(sn)),
           "geometric equilibrium")


# ---- GM, viscosity, interface filter ----------------------------------------

def test_thickness_diffuse_2d_matches_jax():
    gp = np.concatenate([np.zeros((1,) + A["f2d"].shape),
                         1e-3 * (1.0 + A["T"][1:] ** 0 * A["f2d"]),
                         np.zeros((1,) + A["f2d"].shape)])
    res_u, res_v = A["f2d"], 0.5 * A["f2d"] + 0.3
    cfg = dict(khth=600.0, khth_max=900.0)
    ref = jtd.thickness_diffuse(JG, JVG, _j("h"), DT,
                                jtd.ThicknessDiffuseCfg(**cfg),
                                khth_2d=1500.0 * _j("f2d"),
                                gprime_int=jnp.asarray(gp),
                                res_u=jnp.asarray(res_u),
                                res_v=jnp.asarray(res_v))
    out = ttd.thickness_diffuse(TG, TVG, _t("h"), DT,
                                ttd.ThicknessDiffuseCfg(**cfg),
                                khth_2d=1500.0 * _t("f2d"),
                                gprime_int=_t(gp), res_u=_t(res_u),
                                res_v=_t(res_v))
    for k in ("h", "uhD", "vhD", "gm_work"):
        _check(getattr(ref, k), getattr(out, k), k)
    # a constant KHTH with face factors only
    ref = jtd.thickness_diffuse(JG, JVG, _j("h"), DT,
                                jtd.ThicknessDiffuseCfg(khth=600.0),
                                res_u=jnp.asarray(res_u),
                                res_v=jnp.asarray(res_v))
    out = ttd.thickness_diffuse(TG, TVG, _t("h"), DT,
                                ttd.ThicknessDiffuseCfg(khth=600.0),
                                res_u=_t(res_u), res_v=_t(res_v))
    _check(ref.uhD, out.uhD, "uhD res")


@pytest.mark.parametrize("ku", [30.0, -300.0])
def test_hor_visc_kh_scale_and_extra_match_jax(ku):
    kw = dict(laplacian=True, biharmonic=True, kh=200.0, smag_bi_const=0.06,
              smag_lap_const=0.1, dt=DT)
    args_j = (JG, _j("u"), _j("v"), _j("h"))
    args_t = (TG, _t("u"), _t("v"), _t("h"))
    ref = jhv.horizontal_viscosity(*args_j, jhv.HorViscCfg(**kw),
                                   kh_scale=_j("f2d"),
                                   kh_extra=ku * _j("f2d"))
    out = thv.horizontal_viscosity(*args_t, thv.HorViscCfg(**kw),
                                   kh_scale=_t("f2d"),
                                   kh_extra=ku * _t("f2d"))
    _check(ref[0], out[0], "diffu")
    _check(ref[1], out[1], "diffv")


@pytest.mark.parametrize("order", [2, 4])
def test_interface_filter_matches_jax(order):
    kw = dict(time_scale=3000.0, order=order)
    ref = jif.interface_filter(JD, JG, JVG, _j("h"), DT,
                               jif.InterfaceFilterCfg(**kw))
    out = tif.interface_filter(TD, TG, TVG, _t("h"), DT,
                               tif.InterfaceFilterCfg(**kw))
    for k, a, b in zip(("h", "uhD", "vhD"), ref, out):
        _check(a, b, k)
    h, _, _ = tif.interface_filter(TD, TG, TVG, _t("h"), DT,
                                   tif.InterfaceFilterCfg())
    assert torch.equal(h, _t("h"))


# ---- tracers ----------------------------------------------------------------

def test_tracer_hordiff_branches_match_jax():
    names = ("T", "S", "age")
    cfg = dict(khtr=600.0, khtr_min=50.0, khtr_max=900.0,
               khtr_slope_cff=0.1, diffuse_ml_to_interior=True,
               ml_khtr_scale=0.3, nkml=1, nkmb=2)
    res_u, res_v = A["f2d"], 0.5 * A["f2d"] + 0.3
    add = 400.0 * A["g2d"] ** 2
    rlay = np.array([1024.0, 1024.5, 1025.6, 1026.3])
    rho_ml = 1025.0 + 1.5 * A["f2d"][None] * np.ones((2, 1, 1))
    rho_ml[0, 2:4] = 1027.0                # denser than every target
    jkw = dict(khtr_2d=jnp.asarray(800.0 * A["f2d"]),
               res_u=jnp.asarray(res_u), res_v=jnp.asarray(res_v),
               add_u=jnp.asarray(add), add_v=jnp.asarray(0.5 * add),
               rho_ml=jnp.asarray(rho_ml), rlay=jnp.asarray(rlay))
    tkw = {k: _t(np.asarray(v)) for k, v in jkw.items()}
    ref = jhd.tracer_hordiff(JD, JG, {k: _j(k) for k in names}, _j("h"),
                             1200.0, jhd.TracerHorDiffCfg(**cfg), **jkw)
    out = thd.tracer_hordiff(TD, TG, {k: _t(k) for k in names}, _t("h"),
                             1200.0, thd.TracerHorDiffCfg(**cfg), **tkw)
    for k in names:
        _check(ref[k], out[k], k)
    # the Visbeck face term alone, with no KHTR
    cfg = dict(khtr=0.0, khtr_slope_cff=0.1)
    ref = jhd.tracer_hordiff(JD, JG, {"age": _j("age")}, _j("h"), 1200.0,
                             jhd.TracerHorDiffCfg(**cfg),
                             add_u=jnp.asarray(add), add_v=jnp.asarray(add))
    out = thd.tracer_hordiff(TD, TG, {"age": _t("age")}, _t("h"), 1200.0,
                             thd.TracerHorDiffCfg(**cfg), add_u=_t(add),
                             add_v=_t(add))
    _check(ref["age"], out["age"], "age visbeck")


def test_neutral_and_boundary_diffusion_match_jax():
    names = ("T", "S", "age")
    jtr = dict(JD.fill_halos({k: _j(k) for k in names}))
    ttr = {k: _t(np.asarray(v)) for k, v in jtr.items()}
    cfg = dict(khtr=600.0)
    ref = jnd.neutral_diffusion(JD, JG, JVG, jtr, _j("h"), _j("T"), _j("S"),
                                JEOS, DT, jnd.NeutralDiffCfg(**cfg))
    out = tnd.neutral_diffusion(TD, TG, TVG, ttr, _t("h"), _t("T"),
                                _t("S"), TEOS, DT, tnd.NeutralDiffCfg(**cfg))
    for k in names:
        _check(ref[k], out[k], "neutral " + k)
        assert not torch.equal(out[k], ttr[k])
    ref = jhbd.hor_bnd_diffusion(JD, JG, jtr, _j("h"), _j("bld"), DT,
                                 jhbd.HorBndDiffCfg(khtr_bnd=600.0))
    out = thbd.hor_bnd_diffusion(TD, TG, ttr, _t("h"), _t("bld"), DT,
                                 thbd.HorBndDiffCfg(khtr_bnd=600.0))
    for k in names:
        _check(ref[k], out[k], "hbd " + k)


# ---- internal tides ---------------------------------------------------------

def test_internal_tide_input_matches_jax():
    nb = 1e-3 * A["f2d"]
    _check(jtm.internal_tide_input(0.02, 50.0, jnp.asarray(nb),
                                   kappa_itides=2 * math.pi / 125e3),
           ttm.internal_tide_input(0.02, 50.0, _t(nb),
                                   kappa_itides=2 * math.pi / 125e3),
           "tke_input")


NA = 12          # angular wedges of the module tests (the B4 text: 24)


def _refl_maps():
    ang = np.full(A["f2d"].shape, np.nan)
    ang[H + 2, H:H + NI] = 0.5 * math.pi     # a wall along a row
    ang[H + 6, H + 3:H + 7] = 0.25 * math.pi
    pref = 0.6 + 0.4 * A["f2d"]
    dbl = np.zeros(A["f2d"].shape, bool)
    dbl[H + 6, H + 3:H + 5] = True           # a ridge: either side reflects
    return ang, pref, dbl


@pytest.mark.parametrize("scheme,nm,freqs,drags", [
    ("upwind_1st", 1, (), (False, False)),
    ("ppm", 2, (1.4052e-4, 7.2921e-5), (True, True)),
])
def test_step_internal_tides_matches_jax(scheme, nm, freqs, drags):
    kw = dict(n_angle=NA, scheme=scheme, n_mode=nm, freqs=freqs,
              freq_fraction=(0.7, 0.3) if freqs else (),
              mode_fraction=(0.8, 0.2) if nm > 1 else (),
              apply_background_drag=drags[0], decay_rate=1e-6,
              apply_froude_drag=drags[1])
    jc, tc = jit.InternalTidesCfg(**kw), tit.InternalTidesCfg(**kw)
    rng = np.random.default_rng(7)
    shape = (tc.n_freq, nm, NA) + A["f2d"].shape
    en = np.asarray(JD.fill_halos(jnp.asarray(
        rng.uniform(0.0, 50.0, shape)))) * np.asarray(JG.mask2dT)
    cn = np.stack([2.5 * A["f2d"] / (m + 1) for m in range(nm)]) \
        * np.asarray(JG.mask2dT)
    nb = 1e-3 * A["f2d"]
    tke = 1e-3 * A["f2d"]
    htot = 3000.0 * A["f2d"]
    ang, pref, dbl = _refl_maps()
    ref = jit.step_internal_tides(
        jc, JD, JG, jnp.asarray(en), jnp.asarray(cn), DT, jnp.asarray(tke),
        jnp.asarray(nb), jnp.asarray(htot), u_bt2=4e-4, h2_rough=2500.0,
        refl_angle=jnp.asarray(ang), refl_pref=jnp.asarray(pref),
        refl_dbl=jnp.asarray(dbl))
    out = tit.step_internal_tides(
        tc, TD, TG, _t(en), _t(cn), DT, _t(tke), _t(nb), _t(htot),
        u_bt2=4e-4, h2_rough=2500.0, refl_angle=_t(ang), refl_pref=_t(pref),
        refl_dbl=torch.as_tensor(dbl))
    for k in ("En", "tot_En", "itidal_loss", "leak_loss", "quad_loss",
              "froude_loss", "itidal_loss_freq"):
        _check(getattr(ref, k), getattr(out, k), k)
    assert float(out.itidal_loss.max()) > 0.0
    if nm > 1:
        return
    # the single-mode layout without a frequency axis, mode-1 speed only
    jc1, tc1 = (m.InternalTidesCfg(n_angle=NA) for m in (jit, tit))
    ref = jit.step_internal_tides(jc1, JD, JG, jnp.asarray(en[0, 0]),
                                  jnp.asarray(cn[0]), DT, jnp.asarray(tke),
                                  jnp.asarray(nb), jnp.asarray(htot))
    out = tit.step_internal_tides(tc1, TD, TG, _t(en[0, 0]), _t(cn[0]), DT,
                                  _t(tke), _t(nb), _t(htot))
    _check(ref.En, out.En, "En legacy")


def test_reflect_matches_jax():
    ang, pref, dbl = _refl_maps()
    cfg = dict(n_angle=NA)
    en = np.random.default_rng(9).uniform(0.0, 1.0, (NA,) + ang.shape)
    ref = jit.reflect(jit.InternalTidesCfg(**cfg), jnp.asarray(en),
                      jnp.asarray(ang), jnp.asarray(pref), jnp.asarray(dbl))
    out = tit.reflect(tit.InternalTidesCfg(**cfg), _t(en), _t(ang),
                      _t(pref), torch.as_tensor(dbl))
    _check(ref, out, "reflect", 1e-14)
    assert not torch.equal(out, _t(en))
    assert abs(float(out.sum()) - float(en.sum())) <= 1e-12 * float(en.sum())


# ---- the full step and the reference cases ----------------------------------

SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n#override LENLON = 160.0\n"
         "#override LENLAT = 160.0\nBT_WIDE_HALO_PERIOD = 2\n")


def _defaults(obj):
    base = type(obj)()
    return {f.name: _defaults(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(base, f.name) for f in dataclasses.fields(obj)}


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


# every step thermodynamic (DT_THERM = DT), steps 1 and 3 (x_first False
# in both), and the carries given from the start (a 50 m boundary layer,
# no internal-tide energy yet): both steps take the same arguments, so
# the JAX package compiles one step function
STEPS = (1, 3)
MLD0 = 50.0


def _carry(shape2d, zeros, full):
    return {"u": None, "v": None, "truncs": 0, "res": None, "kv": None,
            "sppt": None, "mld": full(shape2d, MLD0),
            "iten": zeros((1, 1, 24) + shape2d)}


@pytest.fixture(scope="module")
def b4_jax():
    """BENCH_CONFIG_B4 at 16x16x4 with DT_THERM = DT, 2 steps of the JAX
    Model.step_fn (compiled once, with most XLA optimizations off) from a
    perturbed state and given carries."""
    body = configs.BENCH_CONFIG_B4 + SMALL + "#override DT_THERM = 600.0\n"
    jm = j_build_model(JParamFile(text=body))
    rng = np.random.default_rng(5)
    d, g, st = jm.domain, jm.grid, jm.state

    def noisy(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    st0 = dataclasses.replace(
        st, h=noisy(st.h, 2.0), T=noisy(st.T, 0.5),
        u=noisy(st.u, 0.3, g.mask2dCu), v=noisy(st.v, 0.3, g.mask2dCv),
        meke=d.fill_halos(jnp.asarray(np.asarray(st.meke) + 1e-3 * rng.random(
            st.meke.shape)) * g.mask2dT))
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        # (a strongly typed MLD: a weakly typed one would compile again)
        step = jm.step_fn(carry=_carry(tuple(st.h.shape[1:]), jnp.zeros,
                                       lambda sh, v: jnp.zeros(sh) + v))
        js, jsp, jtr = st0, jm.split_state, jm.tracers
        for n in STEPS:
            js, jsp, jtr = step(js, jsp, jtr, n)
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    return dict(body=body, model=jm, st0=st0, state=js, split=jsp,
                tracers=jtr, carry=step.carry())


def _step_close(ref, out, name):
    a = np.asarray(ref, np.float64)[..., H:-H, H:-H]
    b = out.detach().double().numpy()[..., H:-H, H:-H]
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= 1e-9, f"{name}: relative error {err:.3e} > 1e-9"


def test_b4_text_matches_step_fn(b4_jax):
    jm = b4_jax["model"]
    pm = build_model(ParamFile(text=b4_jax["body"]), device="cpu", dtype=F64)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    assert cfg.use_meke and cfg.use_neutral and cfg.use_hbd
    assert cfg.int_tides.n_angle == 24 and cfg.interface_filter.time_scale > 0
    pm = convert.model_with_state(
        pm, _arrays(b4_jax["st0"]), _arrays(jm.split_state),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step = pm.step_fn(carry=_carry(
        tuple(pm.state.h.shape[1:]),
        lambda sh: torch.zeros(sh, dtype=F64),
        lambda sh, v: torch.full(sh, v, dtype=F64)))
    ts, tsp, ttr = pm.state, pm.split, pm.tracers
    for n in STEPS:
        ts, tsp, ttr = step(ts, tsp, ttr, n)
    js, jsp = b4_jax["state"], b4_jax["split"]
    for name in ("h", "u", "v", "T", "S", "meke"):
        _step_close(getattr(js, name), getattr(ts, name), name)
    for name in ("eta", "u_av", "v_av", "uh", "vh"):
        _step_close(getattr(jsp, name), getattr(tsp, name), name)
    _step_close(b4_jax["tracers"]["age"], ttr["age"], "age")
    jc, tc = b4_jax["carry"], step.carry()
    for name in ("mld", "iten"):
        _step_close(jc[name], tc[name], name)
    assert tuple(tc["iten"].shape) == (1, 1, 24, 24, 24)
    assert float(tc["iten"].max()) > 0.0


def test_b4v_builder_matches_jax():
    body = configs.BENCH_CONFIG_B4V + SMALL
    jm = j_build_model(JParamFile(text=body))
    pm = build_model(ParamFile(text=body), device="cpu", dtype=F64)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    assert cfg.use_varmix and cfg.hordiff.diffuse_ml_to_interior
    assert cfg.hordiff.nkmb == 4 and cfg.thickness_diffuse_first


GOLDENS = json.loads((ROOT / "tests" / "goldens_ref_cases.json").read_text())


def _run_case(tmp_path, case, steps=None, restart=None):
    for name in ("MOM_input", "MOM_override"):
        shutil.copy(ROOT / "cases" / case / name, tmp_path / name)
    pf = ParamFile(str(tmp_path / "MOM_input"), str(tmp_path / "MOM_override"))
    m = build_model(pf, device="cpu", dtype=F64)
    n = GOLDENS[case]["nsteps"] if steps is None else steps
    argv = [str(tmp_path), "--cpu", "--days", repr(n * m.dt / 86400.0)]
    if restart is not None:
        argv += ["--restart-from", restart]
    return m, solo.main(argv)


@pytest.mark.parametrize("case", ["ref_tc1", "ref_tc2"])
def test_ref_case_driver_matches_golden(tmp_path, case):
    g = GOLDENS[case]
    m, run = _run_case(tmp_path, case)
    assert run["steps"] == g["nsteps"]
    s = run["state"]
    assert bool(torch.isfinite(s.h).all())
    st = sum_output.collect_stats(
        sum_output.stat_sums(m.domain, m.grid, m.vgrid, s, m.dt), m.vgrid,
        g["nsteps"], 0.0)
    np.testing.assert_allclose(st.energy_per_mass, g["energy_per_mass"],
                               rtol=1e-9)
    np.testing.assert_allclose(st.total_mass, g["mass"], rtol=1e-11)
    np.testing.assert_allclose(st.mean_salin, g["salt"], atol=1e-9)
    np.testing.assert_allclose(st.mean_temp, g["temp"], rtol=1e-9)
    np.testing.assert_allclose(st.max_cfl, g["max_cfl"], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(st.mean_sea_level, g["sea_level"],
                               rtol=1e-6, atol=1e-12)
    if case == "ref_tc2":
        assert s.meke is not None and float(s.meke.min()) >= 0.0


def test_restart_with_meke_and_internal_tides(tmp_path):
    """The B4 text at 8x8x3 through the port's driver: 2 steps, then a
    restart for 2 more, against 4 steps in one run; the manifest equals
    the JAX package's layout for the same trees."""
    text = configs.BENCH_CONFIG_B4 + (
        "#override NIGLOBAL = 8\n#override NJGLOBAL = 8\n#override NK = 3\n"
        "#override LENLON = 80.0\n#override LENLAT = 80.0\n"
        "BT_WIDE_HALO_PERIOD = 2\n#override DAYMAX = 0.0277777777777777\n")
    runs = {}
    for name in ("whole", "first", "second"):
        d = tmp_path / name
        d.mkdir()
        (d / "MOM_input").write_text(text)
    days = 1200.0 / 86400.0
    runs["whole"] = solo.main([str(tmp_path / "whole"), "--cpu", "--days",
                               repr(2 * days)])
    solo.main([str(tmp_path / "first"), "--cpu", "--days", repr(days)])
    res = str(tmp_path / "first" / "RESTART" / "MOM.res")
    runs["second"] = solo.main([str(tmp_path / "second"), "--cpu", "--days",
                                repr(2 * days), "--restart-from", res])
    a, b = runs["whole"]["state"], runs["second"]["state"]
    for k in ("u", "v", "h", "T", "S", "meke"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    man = json.loads(pathlib.Path(res + ".json").read_text())
    assert "carry_iten" in man["trees"]
    data = np.load(res + ".npz")
    assert data[man["trees"]["carry_iten"]["keys"][0]].shape \
        == (1, 1, 24, 16, 16)
    # the same trees written by the JAX package
    st = {k: jnp.asarray(data[key]) for k, key in zip(
        ("u", "v", "h", "T", "S", "meke", "frazil"),
        man["trees"]["state"]["keys"])}
    assert len(man["trees"]["state"]["keys"]) == 6        # no frazil
    jtrees = {"state": JState(**{k: v for k, v in st.items()
                                 if k != "frazil"})}
    for name in man["trees"]:
        if name.startswith("carry_"):
            jtrees[name] = jnp.asarray(data[man["trees"][name]["keys"][0]])
    jrestart.save_restart(str(tmp_path / "jax"), jtrees, {})
    jman = json.loads((tmp_path / "jax.json").read_text())
    for name, tree in jman["trees"].items():
        assert man["trees"][name] == tree, name


# ---- float32 at rest --------------------------------------------------------

def test_float32_column_at_rest_is_finite():
    F32 = torch.float32
    d = Domain(ni=6, nj=5, halo=H, reentrant_x=True)
    g = cartesian_grid(d, lenlon_km=60.0, lenlat_km=50.0, f0=0.0, beta=0.0,
                       max_depth=4000.0, device="cpu", dtype=F32)
    vg = VerticalGrid.uniform(nk=5, device="cpu", dtype=F32)
    h = d.fill_halos(torch.full((5, d.njh, d.nih), 800.0, dtype=F32))
    T = torch.full_like(h, 10.0)
    S = torch.full_like(h, 35.0)
    eos = make_eos("WRIGHT")
    c = tws.wave_speeds(vg, h, T, S, eos, n_mode=2)
    vm = tvm.calc_resolution_function(tvm.VarMixCfg(res_fn_power=4), g, vg,
                                      h, T, S, eos)
    sn = tvm.calc_eady_rate(tvm.VarMixCfg(), g, vg, h)
    e = tmk.step_meke(tmk.MEKECfg(**MEKE_KW), g, torch.zeros_like(h[0]),
                      DT, gm_work=torch.zeros_like(h[0]), rd_dx=vm.rd_dx,
                      sn=sn, u_bt=torch.zeros_like(h[0]),
                      v_bt=torch.zeros_like(h[0]))
    for name, x in (("c", c), ("res_fn", vm.res_fn), ("res_u", vm.res_fn_u),
                    ("rd_dx", vm.rd_dx), ("sn", sn), ("meke", e)):
        assert bool(torch.isfinite(x).all()), name
    assert float(c.abs().max()) == 0.0 and float(e.min()) >= 0.0
