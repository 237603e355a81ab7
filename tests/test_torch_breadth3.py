"""mom6_torch against mom6_tpu: the vertical column physics of the third
breadth item, on the CPU in float64.

* Each module at a few seeded columns (6 layers over 5x7 points, one
  layer nearly vanished in some columns): brunt_vaisala2, LMD94 and PP81
  shear mixing, CVMix convection and double diffusion, kappa-shear
  (1e-11: 8 and 24 Gauss-Seidel sweeps of two Thomas solves), tidal
  mixing (both profiles), the user bands, the Henyey background,
  set_diffusivity with every term on, ePBL (1e-11: its MLD fixed point;
  both m* modes, with and without the iteration), the Langmuir factor,
  the opacity bands (every scheme, with and without
  CORRECT_ABSORPTION_DEPTH), apply_boundary_fluxes with the opacity and
  DEPTH_LIMIT_FLUXES, geothermal heating, full convection, make_frazil
  (RECLAIM_FRAZIL, the surface pressure, thin layers), the bulk mixed
  layer (MKE release, the TKE decay with ML_OMEGA_FRAC, HMIX_MIN,
  tracers), explicit diffusive entrainment and regularization: 1e-12
  relative to each field's maximum unless stated.
* The diabatic driver with the column physics of each full-width text
  (1e-11), and vertvisc_coef with an interface viscosity (1e-12).
* The spherical, isotropic spherical and Mercator grids of the builder
  (GRID_CONFIG, ISOTROPIC, ROTATION = betaplane): every metric, mask and
  Coriolis at 1e-12 relative.
* ``Model.step_fn`` of ``configs.BENCH_CONFIG_B3`` (Z* ALE), and of B3
  with PP81 in place of kappa-shear, at 16x16x4 for 3 steps from a
  perturbed state (the dynamics of step 2 take the shear viscosity of
  the thermodynamic step 1), with the shear-viscosity, MLD and frazil
  carries (1e-9); the builder's configurations equal the JAX builder's.
  ``BENCH_CONFIG_BML`` is held in tests/test_torch_layered.py.

The JAX side runs eagerly (``jax.disable_jit``) but for its barotropic
solve, which runs under ``jax.jit`` as in its own runs.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import dynamics_split_rk2 as jrk2
from mom6_tpu.core import vert_friction as jvf
from mom6_tpu.core.forcing import Fluxes as JFluxes
from mom6_tpu.core.forcing import MechForcing as JMechForcing
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.diagnostics import wave_speed as jws
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.framework import obsolete_params as jobs
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.param.vertical import bkgnd_mixing as jbk
from mom6_tpu.param.vertical import bulk_mixed_layer as jbml
from mom6_tpu.param.vertical import conv_ddiff as jcd
from mom6_tpu.param.vertical import diabatic as jdia
from mom6_tpu.param.vertical import diabatic_aux as jaux
from mom6_tpu.param.vertical import energetic_pbl as jep
from mom6_tpu.param.vertical import entrain_diffusive as jent
from mom6_tpu.param.vertical import full_convection as jfc
from mom6_tpu.param.vertical import geothermal as jgeo
from mom6_tpu.param.vertical import kappa_shear as jks
from mom6_tpu.param.vertical import opacity as jop
from mom6_tpu.param.vertical import regularize_layers as jreg
from mom6_tpu.param.vertical import set_diffusivity as jsd
from mom6_tpu.param.vertical import shear_mixing as jsm
from mom6_tpu.param.vertical import tidal_mixing as jtm
from mom6_tpu.param.vertical import user_change_diff as juc
from mom6_tpu.param.waves import wave_interface as jwv

from mom6_torch import configs, convert
from mom6_torch.core import vert_friction as tvf
from mom6_torch.core.forcing import Fluxes, MechForcing
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.diagnostics import wave_speed as tws
from mom6_torch.eos import make_eos
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.param.vertical import bkgnd_mixing as tbk
from mom6_torch.param.vertical import bulk_mixed_layer as tbml
from mom6_torch.param.vertical import conv_ddiff as tcd
from mom6_torch.param.vertical import diabatic as tdia
from mom6_torch.param.vertical import diabatic_aux as taux
from mom6_torch.param.vertical import energetic_pbl as tep
from mom6_torch.param.vertical import entrain_diffusive as tent
from mom6_torch.param.vertical import full_convection as tfc
from mom6_torch.param.vertical import geothermal as tgeo
from mom6_torch.param.vertical import kappa_shear as tks
from mom6_torch.param.vertical import opacity as top
from mom6_torch.param.vertical import regularize_layers as treg
from mom6_torch.param.vertical import set_diffusivity as tsd
from mom6_torch.param.vertical import shear_mixing as tsm
from mom6_torch.param.vertical import tidal_mixing as ttm
from mom6_torch.param.vertical import user_change_diff as tuc
from mom6_torch.param.waves import wave_interface as twv

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

F64 = torch.float64
NK, NJ, NI = 6, 5, 7
SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n#override LENLON = 160.0\n"
         "#override LENLAT = 160.0\n")
PP81 = "#override USE_JACKSON_PARAM = False\nUSE_PP81 = True\n"
# the column texts at 16x16x4 take a weakly stratified 400 m column:
# kappa-shear needs Ri < 0.25 somewhere, and under 1000 m layers ePBL's
# first-interface decision compares a roundoff-sized cost (zero in exact
# arithmetic) with a TKE decayed by exp(-25), so that its MLD (1 m or
# ~1000 m) is decided by the last bits of T (ROADMAP.md Queue 3)
COLUMN = "#override MAXIMUM_DEPTH = 400.0\n#override T_RANGE = 0.2\n"


def _jitted_btstep(fn):
    """The JAX package's btstep under jax.jit (its normal mode), also
    inside disable_jit."""
    jf = jax.jit(fn, static_argnums=(0, 12, 13),
                 static_argnames=("nstep", "obc"))

    def call(*args, **kw):
        with jax.disable_jit(False):
            return jf(*args, **kw)
    return call


def _jitted(fn, *static):
    """``fn`` under jax.jit, also inside disable_jit: kappa-shear's
    sweeps of scans run op by op are most of an eager B3 step."""
    jf = jax.jit(fn, static_argnums=static)

    def call(*args, **kw):
        with jax.disable_jit(False):
            return jf(*args, **kw)
    return call


@pytest.fixture(scope="module", autouse=True)
def _eager_jax():
    """Eager JAX but for btstep and kappa-shear; and the JAX builder's obsolete-parameter
    guard without its "Use_PP81" entry, which its case-insensitive keys
    match to USE_PP81 itself (the port's builder skips the entry by
    ``allow_obsolete``)."""
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jrk2, "btstep", _jitted_btstep(jrk2.btstep))
        mp.setattr(jsd, "kappa_shear_coeffs",
                   _jitted(jks.kappa_shear_coeffs, 0))
        mp.setattr(jobs, "_OBSOLETE",
                   [e for e in jobs._OBSOLETE if e[0] != "Use_PP81"])
        yield


def _close(ref, out, tol, name):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _j(a):
    return jnp.asarray(np.array(a))


class Columns:
    """Seeded stratified columns: thicknesses of 2-60 m with a nearly
    vanished layer in a third of the columns, T falling from ~20 degC
    with depth (one inversion), S ~ 35 ppt, sheared velocities, the wind
    and the surface fluxes."""

    def __init__(self, seed=3):
        rng = np.random.default_rng(seed)
        self.rng = rng
        shape = (NK, NJ, NI)
        h = rng.uniform(2.0, 60.0, shape)
        h[2][rng.random((NJ, NI)) < 0.33] = 1e-9
        self.h = h
        z = np.cumsum(h, 0) - 0.5 * h
        self.T = 20.0 - 0.05 * z + 0.5 * rng.standard_normal(shape)
        self.T[3] += 1.5
        self.S = 35.0 + 0.3 * rng.standard_normal(shape) + 0.002 * z
        self.u = 0.2 * rng.standard_normal(shape)
        self.v = 0.2 * rng.standard_normal(shape)
        self.lat = np.linspace(-70.0, 70.0, NJ)[:, None] \
            + np.zeros((NJ, NI))
        self.ustar = np.abs(0.01 * rng.standard_normal((NJ, NI))) + 1e-3
        self.buoy = 1e-7 * rng.standard_normal((NJ, NI))
        self.absf = 1e-4 * rng.uniform(0.2, 1.5, (NJ, NI))
        self.taux = 0.1 * rng.standard_normal((NJ, NI))
        self.tauy = 0.1 * rng.standard_normal((NJ, NI))
        self.sw = rng.uniform(50.0, 300.0, (NJ, NI))
        self.lw = -rng.uniform(20.0, 80.0, (NJ, NI))
        self.evap = rng.uniform(0.0, 3e-5, (NJ, NI))
        self.lprec = rng.uniform(0.0, 3e-5, (NJ, NI))
        self.age = rng.uniform(0.0, 10.0, shape)
        self.jvg = JVerticalGrid.uniform(nk=NK, gint=0.01)
        self.tvg = VerticalGrid.uniform(nk=NK, gint=0.01, device="cpu",
                                        dtype=F64)
        self.jeos = j_make_eos("WRIGHT")
        self.teos = make_eos("WRIGHT")

    def j(self, name):
        return _j(getattr(self, name))

    def t(self, name):
        return _t(getattr(self, name))

    def grids(self):
        """Stand-ins for the grid fields the diabatic driver reads."""
        rng = np.random.default_rng(9)
        f = 1e-4 * rng.uniform(-1.5, 1.5, (NJ, NI))
        mask = np.ones((NJ, NI))
        jg = types.SimpleNamespace(geoLatT=_j(self.lat), CoriolisBu=_j(f),
                                   mask2dT=_j(mask))
        tg = types.SimpleNamespace(geoLatT=_t(self.lat), CoriolisBu=_t(f),
                                   mask2dT=_t(mask))
        return jg, tg


@pytest.fixture(scope="module")
def col():
    return Columns()


# ---- the diffusivities -----------------------------------------------------

@pytest.mark.parametrize("with_eos", [True, False])
def test_brunt_vaisala2_matches(col, with_eos):
    kw = dict(T=col.j("T"), S=col.j("S"), eos=col.jeos) if with_eos else {}
    tkw = dict(T=col.t("T"), S=col.t("S"), eos=col.teos) if with_eos \
        else {}
    _close(jws.brunt_vaisala2(col.jvg, col.j("h"), **kw),
           tws.brunt_vaisala2(col.tvg, col.t("h"), **tkw), 1e-12, "n2")


@pytest.mark.parametrize("scheme", ["LMD94", "PP81", "NONE"])
def test_shear_mixing_matches(col, scheme):
    n2 = jws.brunt_vaisala2(col.jvg, col.j("h"), col.j("T"), col.j("S"),
                            col.jeos)
    ref = jsm.shear_mixing_coeffs(jsm.ShearMixingCfg(scheme=scheme),
                                  col.j("u"), col.j("v"), col.j("h"), n2)
    out = tsm.shear_mixing_coeffs(tsm.ShearMixingCfg(scheme=scheme),
                                  col.t("u"), col.t("v"), col.t("h"),
                                  _t(n2))
    _close(ref, out, 1e-12, scheme)


def test_convection_and_double_diffusion_match(col):
    n2 = np.asarray(jws.brunt_vaisala2(col.jvg, col.j("h"), col.j("T"),
                                       col.j("S"), col.jeos))
    n2 = n2 - np.median(n2)          # some interfaces convect
    _close(jcd.convection_coeffs(jcd.ConvectionCfg(kd_conv=0.3), _j(n2)),
           tcd.convection_coeffs(tcd.ConvectionCfg(kd_conv=0.3), _t(n2)),
           1e-12, "kd_conv")
    # T and S gradients of both signs: fingering and diffusive regimes
    T = col.T.copy()
    T[1::2] -= 3.0
    S = col.S + np.where(np.arange(NK)[:, None, None] % 2, -0.4, 0.4)
    p = 1035.0 * 9.8 * np.cumsum(col.h, 0)[:-1]
    ref = jcd.ddiff_coeffs(jcd.DoubleDiffusionCfg(), _j(T), _j(S), _j(p),
                           col.jeos)
    out = tcd.ddiff_coeffs(tcd.DoubleDiffusionCfg(), _t(T), _t(S), _t(p),
                           col.teos)
    assert np.count_nonzero(np.asarray(ref[0])) > 5
    for name, a, b in zip(("kd_T", "kd_S"), ref, out):
        _close(a, b, 1e-12, name)


@pytest.mark.parametrize("its", [8, 24])
def test_kappa_shear_matches(col, its):
    """1e-11: each sweep's damped update carries the last one's
    roundoff."""
    n2 = jws.brunt_vaisala2(col.jvg, col.j("h"), col.j("T"), col.j("S"),
                            col.jeos)
    u, v = 10.0 * col.u, 10.0 * col.v          # Ri < Ri_c somewhere
    f2 = col.absf ** 2
    ref = jks.kappa_shear_coeffs(jks.KappaShearCfg(max_rino_it=its),
                                 _j(u), _j(v), col.j("h"), n2, f2=_j(f2))
    out = tks.kappa_shear_coeffs(tks.KappaShearCfg(max_rino_it=its),
                                 _t(u), _t(v), col.t("h"), _t(n2),
                                 f2=_t(f2))
    assert float(np.asarray(ref).max()) > 1e-5
    _close(ref, out, 1e-11, "kappa")


def test_kappa_shear_float32_column_at_rest_is_finite(col):
    """A column with no shear and no stratification (a wall's halo, or a
    mixed column at rest) makes the TKE matrix singular in float32; the
    port takes Q at its floor there (0 kappa), as float64 gives."""
    z = torch.zeros((NK, NJ, NI), dtype=torch.float32)
    h = torch.tensor(col.h, dtype=torch.float32)
    h[:, 0] = 0.0
    cfg = tks.KappaShearCfg(max_rino_it=8)
    out = tks.kappa_shear_coeffs(cfg, z, z, h, z[1:])
    assert torch.equal(out, torch.zeros_like(out))
    ref = jks.kappa_shear_coeffs(jks.KappaShearCfg(max_rino_it=8),
                                 _j(z.double()), _j(z.double()),
                                 _j(h.double()), _j(z[1:].double()))
    assert np.array_equal(np.asarray(ref), np.zeros_like(np.asarray(ref)))


@pytest.mark.parametrize("profile", ["STLAURENT_02", "POLZIN_09"])
def test_tidal_mixing_matches(col, profile):
    n2 = jws.brunt_vaisala2(col.jvg, col.j("h"), col.j("T"), col.j("S"),
                            col.jeos)
    e = col.rng.uniform(1e-4, 1e-2, (NJ, NI))
    ref = jtm.tidal_mixing_coeffs(jtm.TidalMixingCfg(profile=profile),
                                  col.j("h"), n2, _j(e))
    out = ttm.tidal_mixing_coeffs(ttm.TidalMixingCfg(profile=profile),
                                  col.t("h"), _t(n2), _t(e))
    _close(ref, out, 1e-12, profile)


def test_user_change_diff_matches(col):
    kw = dict(kd_add=1e-4, lat_range=(-50.0, -20.0, 10.0, 60.0),
              rho_range=(1032.0, 1033.5, 1034.5, 1036.0), use_abs_lat=True)
    ref = juc.user_change_diff(juc.UserKdCfg(**kw).validate(), col.j("h"),
                               col.j("T"), col.j("S"), col.jeos,
                               col.j("lat"))
    out = tuc.user_change_diff(tuc.UserKdCfg(**kw).validate(), col.t("h"),
                               col.t("T"), col.t("S"), col.teos,
                               col.t("lat"))
    assert float(np.asarray(ref).max()) > 0.0
    _close(ref, out, 1e-12, "user kd")
    with pytest.raises(ValueError, match="ascending"):
        tuc.UserKdCfg(lat_range=(1.0, 0.0, 2.0, 3.0)).validate()


def test_henyey_background_matches(col):
    cfg = dict(scheme="henyey", kd=2e-5)
    _close(jbk.bkgnd_mixing_coeffs(jbk.BkgndMixingCfg(**cfg), col.j("h"),
                                   col.j("lat")),
           tbk.bkgnd_mixing_coeffs(tbk.BkgndMixingCfg(**cfg), col.t("h"),
                                   col.t("lat")), 1e-12, "henyey")


def _every_term(mod, user):
    return mod.DiffusivityCfg(
        kd=1e-5, kd_min=2e-6, kd_max=0.5, use_shear=True,
        shear=mod.ShearMixingCfg(scheme="PP81"), use_conv=True,
        use_ddiff=True, use_kappa_shear=True,
        kappa_shear=mod.KappaShearCfg(max_rino_it=8), prandtl_turb=0.8,
        use_tidal=True, tidal_energy_flux=3e-3, use_user_kd=True,
        user_kd=user, use_lotw_bbl=True, ml_radiation=True)


def test_set_diffusivity_every_term_matches(col):
    """Every term on, with a shear strong enough for kappa-shear;
    kd_int, kv_int, the salt's excess and kv_shear."""
    ukw = dict(kd_add=5e-5, lat_range=(-60.0, -30.0, 30.0, 60.0))
    u, v = 10.0 * col.u, 10.0 * col.v
    mld = col.rng.uniform(5.0, 80.0, (NJ, NI))
    ref = jsd.set_diffusivity(
        col.j("h"), _every_term(jsd, juc.UserKdCfg(**ukw)), vgrid=col.jvg,
        u=_j(u), v=_j(v), T=col.j("T"), S=col.j("S"), eos=col.jeos,
        lat=col.j("lat"), ustar=col.j("ustar"), mld=_j(mld))
    out = tsd.set_diffusivity(
        col.t("h"), _every_term(tsd, tuc.UserKdCfg(**ukw)), vgrid=col.tvg,
        u=_t(u), v=_t(v), T=col.t("T"), S=col.t("S"), eos=col.teos,
        lat=col.t("lat"), ustar=col.t("ustar"), mld=_t(mld))
    for name in ("kd_int", "kv_int", "kd_extra_S", "kv_shear"):
        _close(getattr(ref, name), getattr(out, name), 1e-11, name)
    # the law of the wall and ML radiation alone, at 1e-12
    n2 = jws.brunt_vaisala2(col.jvg, col.j("h"), col.j("T"), col.j("S"),
                            col.jeos)
    jc, tc = jsd.DiffusivityCfg(), tsd.DiffusivityCfg()
    absf = jsd.absf_2d(col.j("h"), col.j("lat"))
    _close(absf, tsd.absf_2d(col.t("h"), col.t("lat")), 1e-12, "absf")
    _close(jsd.lotw_bbl_diffusivity(jc, col.j("h"), n2, _j(u), _j(v), absf),
           tsd.lotw_bbl_diffusivity(tc, col.t("h"), _t(n2), _t(u), _t(v),
                                    _t(absf)), 1e-12, "lotw")
    _close(jsd.mlrad_diffusivity(jc, col.j("h"), n2, col.j("ustar"),
                                 _j(mld), absf),
           tsd.mlrad_diffusivity(tc, col.t("h"), _t(n2), col.t("ustar"),
                                 _t(mld), _t(absf)), 1e-12, "mlrad")


# ---- the boundary layers and the surface -----------------------------------

@pytest.mark.parametrize("mode,iterate", [(0, True), (2, True), (2, False)])
def test_energetic_pbl_matches(col, mode, iterate):
    """1e-11: the MLD is the deepest affordable interface, a comparison
    that roundoff could flip only at a tie."""
    kw = dict(mstar_mode=mode, use_mld_iteration=iterate, max_mld=120.0)
    ref = jep.energetic_pbl(jep.EPBLCfg(**kw), col.j("h"), col.j("T"),
                            col.j("S"), col.jeos, 1035.0, 9.8, 1200.0,
                            ustar=col.j("ustar"), buoy_flux=col.j("buoy"),
                            absf=col.j("absf"))
    out = tep.energetic_pbl(tep.EPBLCfg(**kw), col.t("h"), col.t("T"),
                            col.t("S"), col.teos, 1035.0, 9.8, 1200.0,
                            ustar=col.t("ustar"), buoy_flux=col.t("buoy"),
                            absf=col.t("absf"))
    _close(ref.kd_int, out.kd_int, 1e-11, "kd")
    _close(ref.mld, out.mld, 1e-11, "mld")


@pytest.mark.parametrize("method", ["EMPIRICAL", "CONST"])
def test_langmuir_enhancement_matches(col, method):
    kw = dict(wave_method=method, const_us=0.05)
    u10 = 800.0 * col.ustar
    ref = jwv.stokes_profile(jwv.WavesCfg(**kw), col.j("h"), u10=_j(u10))
    out = twv.stokes_profile(twv.WavesCfg(**kw), col.t("h"), u10=_t(u10))
    for name in ("us", "vs", "us0"):
        _close(getattr(ref, name), getattr(out, name), 1e-12, name)
    _close(jwv.langmuir_enhancement(jwv.langmuir_number(col.j("ustar"),
                                                        ref.us0)),
           twv.langmuir_enhancement(twv.langmuir_number(col.t("ustar"),
                                                        out.us0)),
           1e-12, "enhancement")


@pytest.mark.parametrize("scheme,correct", [
    ("JERLOV", False), ("JERLOV", True), ("MANIZZA_05", False),
    ("MOREL_88", True), ("EXPONENTIAL", False)])
def test_opacity_matches(col, scheme, correct):
    kw = dict(scheme=scheme, correct_absorption_depth=correct, chl=0.3)
    ref = jop.sw_absorption_profile(jop.OpacityCfg(**kw), col.j("h"),
                                    col.j("sw"))
    out = top.sw_absorption_profile(top.OpacityCfg(**kw), col.t("h"),
                                    col.t("sw"))
    _close(ref[0], out[0], 1e-12, "heating")
    _close(ref[1], out[1], 1e-12, "sw_bottom")


@pytest.mark.parametrize("limit", [0.0, 150.0])
def test_boundary_fluxes_with_opacity_match(col, limit):
    jf = JFluxes(sw=col.j("sw"), lw=col.j("lw"), evap=col.j("evap"),
                 lprec=col.j("lprec"))
    tf = Fluxes(sw=col.t("sw"), lw=col.t("lw"), evap=col.t("evap"),
                lprec=col.t("lprec"))
    ref = jaux.apply_boundary_fluxes(
        col.j("h"), col.j("T"), col.j("S"), jf, 1200.0, 1035.0,
        opacity_cfg=jop.OpacityCfg(), depth_limit_fluxes=limit)
    out = taux.apply_boundary_fluxes(
        col.t("h"), col.t("T"), col.t("S"), tf, 1200.0, 1035.0,
        opacity_cfg=top.OpacityCfg(), depth_limit_fluxes=limit)
    for name in ref._fields:
        if name != "T":
            _close(getattr(ref, name), getattr(out, name), 1e-12, name)
    # a layer of 1e-9 m turns the last bits of the shortwave it absorbs
    # (a difference of two exponentials) into 1/h-amplified warming: T
    # holds to 1e-12 where h > 1e-6 m, the heat content h T everywhere
    thick = col.h > 1e-6
    _close(np.where(thick, ref.T, 0.0),
           torch.where(torch.from_numpy(thick), out.T, 0.0),
           1e-12, "T")
    _close(ref.h * ref.T, out.h * out.T, 1e-12, "h T")


def test_geothermal_and_full_convection_match(col):
    h = col.h.copy()
    h[-2:, 1, 2] = 1e-4                       # the bottom layers dry
    ref = jgeo.geothermal_heating(jgeo.GeothermalCfg(geothermal_flux=0.05),
                                  col.j("T"), _j(h), 1200.0)
    out = tgeo.geothermal_heating(tgeo.GeothermalCfg(geothermal_flux=0.05),
                                  col.t("T"), _t(h), 1200.0)
    _close(ref, out, 1e-12, "geothermal T")
    p = 1035.0 * 9.8 * np.cumsum(col.h, 0)[:-1]
    for cfg_kw, pk in (({}, None), ({"n_sweeps": 7}, p)):
        ref = jfc.full_convection(jfc.FullConvectionCfg(**cfg_kw),
                                  col.j("T"), col.j("S"), col.j("h"),
                                  col.jeos,
                                  p_int=None if pk is None else _j(pk))
        out = tfc.full_convection(tfc.FullConvectionCfg(**cfg_kw),
                                  col.t("T"), col.t("S"), col.t("h"),
                                  col.teos,
                                  p_int=None if pk is None else _t(pk))
        _close(ref[0], out[0], 1e-12, "convected T")
        _close(ref[1], out[1], 1e-12, "convected S")


@pytest.mark.parametrize("reclaim", [True, False])
def test_make_frazil_matches(col, reclaim):
    """Near-freezing columns with sub-freezing layers at depth and thin
    layers, a pending frazil and a surface pressure."""
    T = -1.7 + 0.3 * col.rng.standard_normal((NK, NJ, NI))
    T[0, :2] = 0.5                                 # warm surface water
    prev = col.rng.uniform(0.0, 5e6, (NJ, NI))
    ps = col.rng.uniform(0.0, 2e5, (NJ, NI))
    h = col.h.copy()
    h[1, 3] = 1e-10
    kw = dict(reclaim=reclaim)
    ref = jaux.make_frazil(jaux.FrazilCfg(**kw), _j(h), _j(T), col.j("S"),
                           p_surf=_j(ps), frazil_prev=_j(prev))
    out = taux.make_frazil(taux.FrazilCfg(**kw), _t(h), _t(T), col.t("S"),
                           p_surf=_t(ps), frazil_prev=_t(prev))
    assert float(np.asarray(ref[1]).max()) > float(prev.max())
    _close(ref[0], out[0], 1e-12, "T")
    _close(ref[1], out[1], 1e-12, "frazil")


@pytest.mark.parametrize("uv,omega_frac,hmix", [(True, 0.0, 0.0),
                                                (True, 0.5, 30.0),
                                                (False, 0.0, 10.0)])
def test_bulk_mixed_layer_matches(col, uv, omega_frac, hmix):
    kw = dict(omega_frac=omega_frac, hmix_min=hmix)
    ustar = 3.0 * col.ustar
    outs = []
    for mod, a, eos in ((jbml, _j, col.jeos), (tbml, _t, col.teos)):
        uh = a(col.u) if uv else None
        vh = a(col.v) if uv else None
        outs.append(mod.bulk_mixed_layer(
            mod.BulkMixedLayerCfg(**kw), a(col.h), a(col.T), a(col.S), eos,
            a(ustar), a(np.abs(col.buoy)), 3600.0,
            tracers={"age": a(col.age)}, u=uh, v=vh, absf=a(col.absf)))
    ref, out = outs
    assert float(np.asarray(ref[4]).max()) > float(col.h[0].max())
    for name, a, b in zip(("h", "T", "S"), ref[:3], out[:3]):
        _close(a, b, 1e-12, name)
    _close(ref[3]["age"], out[3]["age"], 1e-12, "age")
    _close(ref[4], out[4], 1e-12, "hml")


def test_explicit_entrainment_and_regularization_match(col):
    kd = col.rng.uniform(1e-5, 1e-2, (NK + 1, NJ, NI))
    h = col.h.copy()
    h[0, :, :3] = 0.1                          # thin surface layers
    tr = {"T": col.T, "age": col.age}
    ref = jent.entrainment_diffusive(
        jent.EntrainDiffusiveCfg(implicit=False), _j(h), _j(kd), 3600.0,
        {k: _j(v) for k, v in tr.items()})
    out = tent.entrainment_diffusive(
        tent.EntrainDiffusiveCfg(implicit=False), _t(h), _t(kd), 3600.0,
        {k: _t(v) for k, v in tr.items()})
    _close(ref[0], out[0], 1e-12, "h")
    _close(ref[2], out[2], 1e-12, "f")
    for k in tr:
        _close(ref[1][k], out[1][k], 1e-12, k)
    cfg = dict(hmix_min=3.0, n_sweeps=3)
    ref = jreg.regularize_layers(jreg.RegularizeLayersCfg(**cfg), _j(h),
                                 {k: _j(v) for k, v in tr.items()})
    out = treg.regularize_layers(treg.RegularizeLayersCfg(**cfg), _t(h),
                                 {k: _t(v) for k, v in tr.items()})
    _close(ref[0], out[0], 1e-12, "regularized h")
    for k in tr:
        _close(ref[1][k], out[1][k], 1e-12, f"regularized {k}")


# ---- the driver and the dynamics -------------------------------------------

def _driver_cfgs(mod, bml):
    """The column physics of BENCH_CONFIG_B3 (ALE) or BENCH_CONFIG_BML
    (layered), with shortwave and the Langmuir factor."""
    if bml:
        return mod.DiabaticCfg(
            diffusivity=_shear_cfg(mod, "LMD94"), use_bml=True,
            use_entrain_diffusive=True, use_regularize=True,
            regularize=_reg_cfg(mod), do_frazil=True)
    return mod.DiabaticCfg(
        diffusivity=_b3_diff(mod), use_epbl=True, use_opacity=True, use_geothermal=True,
        geothermal=_geo_cfg(mod), use_full_conv=True,
        full_conv=_fc_cfg(mod), do_frazil=True, use_waves=True,
        waves=_waves_cfg(mod))


def _modules(mod):
    return {jdia: (jsd, jsm, jks, jreg, jgeo, jfc, jwv),
            tdia: (tsd, tsm, tks, treg, tgeo, tfc, twv)}[mod]


def _shear_cfg(mod, scheme):
    sd, sm = _modules(mod)[:2]
    return sd.DiffusivityCfg(kd=1e-5, use_shear=True,
                             shear=sm.ShearMixingCfg(scheme=scheme))


def _b3_diff(mod):
    sd, _, ks = _modules(mod)[:3]
    return sd.DiffusivityCfg(
        kd=1e-5, use_conv=True, use_ddiff=True, use_kappa_shear=True,
        kappa_shear=ks.KappaShearCfg(max_rino_it=8), use_tidal=True,
        tidal_energy_flux=1e-3, use_lotw_bbl=True, ml_radiation=True)


def _reg_cfg(mod):
    return _modules(mod)[3].RegularizeLayersCfg(hmix_min=3.0)


def _geo_cfg(mod):
    return _modules(mod)[4].GeothermalCfg(geothermal_flux=0.05)


def _fc_cfg(mod):
    return _modules(mod)[5].FullConvectionCfg(n_sweeps=8)


def _waves_cfg(mod):
    return _modules(mod)[6].WavesCfg()


@pytest.mark.parametrize("bml", [False, True], ids=["b3", "bml"])
def test_diabatic_driver_matches(col, bml):
    """1e-11: kappa-shear and ePBL inside."""
    jg, tg = col.grids()
    prev = col.rng.uniform(0.0, 1e5, (NJ, NI))
    u, v = 10.0 * col.u, 10.0 * col.v
    js = JState(u=_j(u), v=_j(v), h=col.j("h"), T=col.j("T"), S=col.j("S"),
                frazil=_j(prev))
    ts = State(u=_t(u), v=_t(v), h=col.t("h"), T=col.t("T"), S=col.t("S"),
               frazil=_t(prev))
    mld = col.rng.uniform(5.0, 50.0, (NJ, NI))
    ref = jdia.diabatic(
        js, JFluxes(sw=col.j("sw"), lw=col.j("lw"), evap=col.j("evap")),
        1200.0, _driver_cfgs(jdia, bml), {"age": col.j("age")},
        vgrid=col.jvg, eos=col.jeos,
        forces=JMechForcing(taux=col.j("taux"), tauy=col.j("tauy")),
        grid=jg, mld_prev=_j(mld))
    out = tdia.diabatic(
        ts, Fluxes(sw=col.t("sw"), lw=col.t("lw"), evap=col.t("evap")),
        1200.0, _driver_cfgs(tdia, bml), {"age": col.t("age")},
        vgrid=col.tvg, eos=col.teos,
        forces=MechForcing(taux=col.t("taux"), tauy=col.t("tauy")),
        grid=tg, mld_prev=_t(mld))
    for name in ("h", "T", "S", "frazil"):
        _close(getattr(ref[0], name), getattr(out[0], name), 1e-11, name)
    _close(ref[1]["age"], out[1]["age"], 1e-11, "age")
    assert sorted(ref[2]) == sorted(out[2])
    assert "kv_shear" in out[2] and "frazil" in out[2]
    for k in ref[2]:
        _close(ref[2][k], out[2][k], 1e-11, k)


def test_vertvisc_coef_with_interface_viscosity(col):
    """Kv = KV + kv_shear at the interfaces, averaged to the faces."""
    from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
    from mom6_tpu.parallel.domain import Domain as JDomain
    from mom6_torch.core.grid import cartesian_grid
    from mom6_torch.parallel.domain import Domain
    jg = j_cartesian_grid(JDomain(ni=NI - 4, nj=NJ - 4, halo=2,
                                  reentrant_x=True),
                          lenlon_km=30.0, lenlat_km=10.0, f0=1e-4)
    tg = cartesian_grid(Domain(ni=NI - 4, nj=NJ - 4, halo=2,
                               reentrant_x=True), lenlon_km=30.0,
                        lenlat_km=10.0, f0=1e-4, device="cpu", dtype=F64)
    kv = col.rng.uniform(0.0, 1e-2, (NK + 1, NJ, NI))
    ref = jvf.vertvisc_coef(jg, col.j("u"), col.j("v"), col.j("h"),
                            kv_int=_j(1e-4 + kv), cfg=jvf.VertViscCfg())
    out = tvf.vertvisc_coef(tg, col.t("u"), col.t("v"), col.t("h"),
                            _t(1e-4 + kv), cfg=tvf.VertViscCfg())
    for name in ("a_u", "a_v"):
        _close(getattr(ref, name), getattr(out, name), 1e-12, name)


# ---- the grids -------------------------------------------------------------

GRID_TEXT = """NIGLOBAL = 12
NJGLOBAL = 10
NK = 2
DT = 600.0
GRID_CONFIG = {config}
SOUTHLAT = 30.0
LENLAT = 20.0
WESTLON = -10.0
LENLON = 25.0
TOPO_CONFIG = bowl
MAXIMUM_DEPTH = 4500.0
MINIMUM_DEPTH = 100.0
ENABLE_THERMODYNAMICS = False
"""


@pytest.mark.parametrize("config,extra", [
    ("spherical", ""), ("spherical", "ISOTROPIC = True\n"),
    ("mercator", ""),
    ("spherical", "ROTATION = betaplane\nF_0 = 1.0e-4\nBETA = 2.0e-11\n"
                  "BETA_LAT_REF = 40.0\n")],
    ids=["spherical", "isotropic", "mercator", "betaplane"])
def test_grids_match(config, extra):
    text = GRID_TEXT.format(config=config) + extra
    jm = j_build_model(JParamFile(text=text))
    pm = build_model(ParamFile(text=text), device="cpu", dtype=F64)
    for f in dataclasses.fields(pm.grid):
        v = getattr(pm.grid, f.name)
        if torch.is_tensor(v):
            _close(getattr(jm.grid, f.name), v, 1e-12, f"grid.{f.name}")
    if config == "mercator":
        from mom6_tpu.core.grid import mercator_grid as j_mercator_grid
        from mom6_tpu.parallel.domain import Domain as JDomain
        from mom6_torch.core.grid import mercator_grid
        from mom6_torch.parallel.domain import Domain
        # without a north edge: the isotropic spacing of the longitudes
        jg = j_mercator_grid(JDomain(ni=12, nj=10, halo=4), west_lon=0.0,
                             lenlon=25.0, south_lat=-30.0)
        tg = mercator_grid(Domain(ni=12, nj=10, halo=4), west_lon=0.0,
                           lenlon=25.0, south_lat=-30.0, device="cpu",
                           dtype=F64)
        for name in ("dxT", "dyCu", "areaBu", "CoriolisBu", "geoLatCv"):
            _close(getattr(jg, name), getattr(tg, name), 1e-12, name)


def test_config_texts_are_bench_config_plus_their_lines():
    assert configs.BENCH_CONFIG_B3 == configs.BENCH_CONFIG + configs.B3_LINES
    assert configs.BENCH_CONFIG_BML == (configs.BENCH_CONFIG
                                        + configs.BML_LINES)
    for lines in (configs.B3_LINES, configs.BML_LINES):
        names = [ln.split("=")[0].replace("#override", "").strip()
                 for ln in lines.splitlines()]
        assert len(names) == len(set(names))


# ---- the models ------------------------------------------------------------

def _defaults(obj):
    base = type(obj)()
    return {f.name: _defaults(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(base, f.name) for f in dataclasses.fields(obj)}


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _perturbed(jm, seed=5):
    """The JAX model's initial state plus seeded noise (h, T, u, v; a
    stronger shear in u and v, so that kappa-shear acts)."""
    rng = np.random.default_rng(seed)
    d, g = jm.domain, jm.grid

    def noisy(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    st = jm.state
    return dataclasses.replace(
        st, h=noisy(st.h, 2.0), T=noisy(st.T, 0.5),
        u=noisy(st.u, 0.3, g.mask2dCu), v=noisy(st.v, 0.3, g.mask2dCv))


@pytest.mark.parametrize("text", ["b3", "b3pp81"])
def test_text_matches_step_fn(text):
    """Steps 0-2 (a thermodynamic step at n = 1, whose shear viscosity
    the dynamics of step 2 take): state, split state, age, and the
    carries kv, mld and frazil, 1e-9."""
    body = {"b3": configs.BENCH_CONFIG_B3,
            "b3pp81": configs.BENCH_CONFIG_B3 + PP81}[text] + SMALL + COLUMN
    jm = j_build_model(JParamFile(text=body))
    pm = build_model(ParamFile(text=body), device="cpu", dtype=F64,
                     allow_obsolete=("Use_PP81",))
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    st0, sp0 = _perturbed(jm), jm.split_state
    assert st0.frazil is not None and pm.state.frazil is not None
    step_j = jm.step_fn()
    js, jsp, jtr = st0, sp0, jm.tracers
    for n in range(3):
        js, jsp, jtr = step_j(js, jsp, jtr, n)
    pm = convert.model_with_state(
        pm, _arrays(st0), _arrays(sp0),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step_p = pm.step_fn()
    ts, tsp, ttr = pm.state, pm.split, pm.tracers
    for n in range(3):
        ts, tsp, ttr = step_p(ts, tsp, ttr, n)
    H = 4
    for name in ("h", "u", "v", "T", "S", "frazil"):
        a, b = getattr(js, name), getattr(ts, name)
        _close(np.asarray(a)[..., H:-H, H:-H], b[..., H:-H, H:-H], 1e-9,
               name)
    for name in ("eta", "u_av", "v_av", "uh", "vh"):
        _close(np.asarray(getattr(jsp, name))[..., H:-H, H:-H],
               getattr(tsp, name)[..., H:-H, H:-H], 1e-9, name)
    _close(np.asarray(jtr["age"])[..., H:-H, H:-H],
           ttr["age"][..., H:-H, H:-H], 1e-9, "age")
    jc, tc = step_j.carry(), step_p.carry()
    for k in ("kv", "mld"):
        _close(np.asarray(jc[k])[..., H:-H, H:-H], tc[k][..., H:-H, H:-H],
               1e-9, k)
    assert float(tc["kv"].abs().max()) > 0.0
