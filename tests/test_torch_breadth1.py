"""mom6_torch against mom6_tpu: the rest of the first breadth item's
dynamics options, on the CPU in float64.

* Porous barriers: the open fractions of each layer at U and V faces
  and the PPM continuity on a porous grid, x- and y-first, matched and
  untargeted (so the y sweep's fractions come from the intermediate h
  on the x-first calls); ``set_up_bt_cont`` on a porous grid (plain
  face masks, as in the JAX package).  1e-12 (the BT_cont turn
  velocities 1e-8, tests/test_torch_continuity.py's tolerance).
* Tides and SAL: ``equilibrium_tide``, ``scalar_sal`` and
  ``SALHarmonics`` at degree 4 (1e-12), and its real basis against one
  built from an independent associated-Legendre form (1e-12).
* The EOS second derivative and the Stanley variance for LINEAR and
  WRIGHT, the Stanley, tidal and non-Boussinesq pressure force and
  ``set_pbce_nonbouss`` (1e-12).
* ``btstep`` under BT_STRONG_DRAG and BOUND_BT_CORRECTION (1e-11).
* Each vertical-friction and horizontal-viscosity option, and ZB2020
  in each of its types (1e-12).
* ``build_model`` + ``Model.step_fn`` of ``configs.BENCH_CONFIG_B1``
  and ``BENCH_CONFIG_NONBOUSS`` at 16x16x4 with Z* ALE, a dynamics
  step and a thermodynamic one (1e-9); the porous file comes from
  ``configs.write_topog_edge`` in ``tmp_path``.  The JAX side runs
  eagerly (``jax.disable_jit``): at this size compiling its steps costs
  more than running them.
* The builder reads the Laplacian-only options (velocity scale, Leith,
  ADD_LES_VISCOSITY, anisotropic) and the fixed viscous mixed layer as
  the JAX builder does; the configuration texts are ``BENCH_CONFIG``
  plus exactly their lines.

Tolerances are relative to each field's maximum on the compute domain.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import barotropic as jbt
from mom6_tpu.core import continuity_ppm as jcont
from mom6_tpu.core import porous_barriers as jpor
from mom6_tpu.core import pressure_force as jpf
from mom6_tpu.core import stoch_eos as jstoch
from mom6_tpu.core import vert_friction as jvf
from mom6_tpu.core.forcing import MechForcing as JMechForcing
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.param.lateral import hor_visc as jhv
from mom6_tpu.param.lateral import self_attr_load as jsal
from mom6_tpu.param.lateral import tidal_forcing as jtide
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch import configs, convert
from mom6_torch.core import barotropic as tbt
from mom6_torch.core import continuity_ppm as tcont
from mom6_torch.core import porous_barriers as tpor
from mom6_torch.core import pressure_force as tpf
from mom6_torch.core import stoch_eos as tstoch
from mom6_torch.core import vert_friction as tvf
from mom6_torch.core.forcing import MechForcing
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.eos import make_eos
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.param.lateral import hor_visc as thv
from mom6_torch.param.lateral import self_attr_load as tsal
from mom6_torch.param.lateral import tidal_forcing as ttide
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, NK, H = 14, 12, 4, 4
DT = 600.0


@pytest.fixture(scope="module", autouse=True)
def _eager_jax():
    """Run the JAX references op by op: every call here is small."""
    with jax.disable_jit():
        yield


def _close(ref, out, tol, name, halo=H):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    if halo:
        a, b = a[..., halo:-halo, halo:-halo], b[..., halo:-halo, halo:-halo]
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _j(a):
    return jnp.asarray(np.asarray(a))


class Setup:
    """Both packages' domain, grids and vertical grids on a bowl-shaped
    channel (so CHANNEL_DRAG and the BBL see sloping faces), optionally
    with random porous faces, and seeded layered fields as numpy."""

    def __init__(self, seed=3, porous=False, reentrant_x=True):
        kw = dict(ni=NI, nj=NJ, halo=H, reentrant_x=reentrant_x,
                  reentrant_y=False)
        self.jd, self.td = JDomain(**kw), Domain(**kw)

        def bowl(lon, lat):
            return 1000.0 + 600.0 * np.cos(np.pi * (lat - 60.0) / 140.0) \
                + 40.0 * np.sin(lon / 9.0)
        jg = j_cartesian_grid(self.jd, lenlon_km=NI * 10.0,
                              lenlat_km=NJ * 10.0, f0=1e-4, beta=2e-11,
                              max_depth=1600.0, depth_fn=bowl)
        rng = np.random.default_rng(seed)
        self.rng = rng
        if porous:
            por = {}
            for s in "UV":
                ridge = rng.random(jg.mask2dT.shape) < 0.4
                dmax = -rng.uniform(200.0, 900.0, ridge.shape)
                dmin = np.full(ridge.shape, -1700.0)
                davg = dmin + rng.uniform(0.2, 0.8, ridge.shape) \
                    * (dmax - dmin)
                por[f"porous_Dmin{s}"] = jnp.asarray(dmin)
                por[f"porous_Dmax{s}"] = jnp.asarray(
                    np.where(ridge, dmax, 0.0))
                por[f"porous_Davg{s}"] = jnp.asarray(
                    np.where(ridge, davg, dmin))
            jg = dataclasses.replace(jg, **por)
        self.jg = jg
        self.tg = convert.grid_from_numpy(
            {f.name: np.asarray(getattr(jg, f.name))
             for f in dataclasses.fields(jg)
             if f.name != "domain" and getattr(jg, f.name) is not None},
            self.td, device="cpu", dtype=F64)
        self.jvg = JVerticalGrid.uniform(nk=NK, gint=0.01)
        self.tvg = VerticalGrid.uniform(nk=NK, gint=0.01, device="cpu",
                                        dtype=F64)
        shape = (NK, self.jd.njh, self.jd.nih)
        depth = np.asarray(jg.bathyT)
        frac = rng.uniform(0.8, 1.2, shape)
        h = depth[None] * frac / frac.sum(0)[None] + 1e-3
        self.a = dict(
            h=self.fill(h),
            u=self.fill(0.1 * rng.standard_normal(shape)
                        * np.asarray(jg.mask2dCu)),
            v=self.fill(0.1 * rng.standard_normal(shape)
                        * np.asarray(jg.mask2dCv)),
            T=self.fill(10.0 + 4.0 * rng.standard_normal(shape)),
            S=self.fill(35.0 + 0.5 * rng.standard_normal(shape)))

    def fill(self, a):
        return np.asarray(self.jd.fill_halos(jnp.asarray(a)))

    def j(self, k):
        return jnp.asarray(self.a[k])

    def t(self, k):
        return _t(self.a[k])


# ---- porous barriers ---------------------------------------------------

def test_porous_fractions_match():
    s = Setup(porous=True)
    jU, jV = jpor.porous_widths_from_h(s.jg, s.j("h"))
    tU, tV = tpor.porous_widths_from_h(s.tg, s.t("h"))
    _close(jU, tU, 1e-12, "porU", halo=0)
    _close(jV, tV, 1e-12, "porV", halo=0)
    assert float(tU.min()) < 0.5 and float(tU.max()) > 0.99


@pytest.mark.parametrize("x_first", [True, False], ids=["x_first",
                                                        "y_first"])
@pytest.mark.parametrize("matched", [True, False],
                         ids=["matched", "untargeted"])
def test_porous_continuity_matches(x_first, matched):
    s = Setup(porous=True)
    kw_j, kw_t = {}, {}
    if matched:
        ub = np.sum(s.a["h"] * 0.05, 0) * np.asarray(s.jg.dyCu)
        vb = np.sum(s.a["h"] * -0.03, 0) * np.asarray(s.jg.dxCv)
        vr = s.fill(s.rng.uniform(0.6, 1.0, s.a["h"].shape))
        kw_j = dict(uhbt=_j(ub), vhbt=_j(vb), visc_rem_u=_j(vr),
                    visc_rem_v=_j(vr))
        kw_t = dict(uhbt=_t(ub), vhbt=_t(vb), visc_rem_u=_t(vr),
                    visc_rem_v=_t(vr))
    cfg = jcont.ContinuityCfg()
    ref = jcont.continuity_ppm(s.jg, s.jvg, s.j("u"), s.j("v"), s.j("h"),
                               DT, cfg, x_first=x_first, **kw_j)
    out = tcont.continuity_ppm(s.tg, s.tvg, s.t("u"), s.t("v"), s.t("h"),
                               DT, tcont.ContinuityCfg(), x_first=x_first,
                               **kw_t)
    names = ("h", "uh", "vh") + (("u_cor", "v_cor", "du_cor", "dv_cor")
                                 if matched else ())
    for name in names:
        _close(getattr(ref, name), getattr(out, name), 1e-12, name)
    # the porous faces change the fluxes
    plain = tcont.continuity_ppm(
        dataclasses.replace(s.tg, porous_DavgU=None, porous_DavgV=None),
        s.tvg, s.t("u"), s.t("v"), s.t("h"), DT, tcont.ContinuityCfg(),
        x_first=x_first, **kw_t)
    assert not torch.allclose(plain.uh, out.uh)


def test_set_up_bt_cont_on_a_porous_grid():
    s = Setup(porous=True)
    ref = jcont.set_up_bt_cont(s.jg, s.jvg, s.j("u"), s.j("v"), s.j("h"),
                               DT, jcont.ContinuityCfg())
    out = tcont.set_up_bt_cont(s.tg, s.tvg, s.t("u"), s.t("v"), s.t("h"),
                               DT, tcont.ContinuityCfg())
    for name, r in ref._asdict().items():
        tol = 1e-8 if "BT" in name else 1e-12
        _close(r, getattr(out, name), tol, name)


# ---- tides and SAL -------------------------------------------------------

def test_equilibrium_tide_and_scalar_sal():
    rng = np.random.default_rng(1)
    lat, lon = rng.uniform(-70, 70, (9, 11)), rng.uniform(0, 360, (9, 11))
    eta = 0.3 * rng.standard_normal((9, 11))
    for consts in (("M2",), ("M2", "K1", "S2", "O1")):
        jc = jtide.TidalForcingCfg(constituents=consts)
        tc = ttide.TidalForcingCfg(constituents=consts)
        _close(jtide.equilibrium_tide(jc, 4321.0, _j(lat), _j(lon)),
               ttide.equilibrium_tide(tc, 4321.0, _t(lat), _t(lon)), 1e-12,
               "eta_eq", halo=0)
        _close(jtide.scalar_sal(jc, _j(eta)), ttide.scalar_sal(tc, _t(eta)),
               1e-12, "eta_sal", halo=0)


def _legendre_sph_harm(n, m, colat, lon):
    """Y_n^m from the associated Legendre function (Condon-Shortley
    phase included in lpmv), independent of ``sph_harm_y``."""
    from math import factorial
    from scipy.special import lpmv
    norm = np.sqrt((2 * n + 1) / (4 * np.pi)
                   * factorial(n - m) / factorial(n + m))
    return norm * lpmv(m, n, np.cos(colat)) * np.exp(1j * m * lon)


def test_real_sph_basis_matches_legendre():
    rng = np.random.default_rng(2)
    lat, lon = rng.uniform(-89, 89, 50), rng.uniform(0, 360, 50)
    colat, lam = np.deg2rad(90.0 - lat), np.deg2rad(lon)
    rows, degs = [], []
    for n in range(5):
        for m in range(n + 1):
            y = _legendre_sph_harm(n, m, colat, lam)
            rows += [y.real] if m == 0 else [np.sqrt(2.0) * y.real,
                                             np.sqrt(2.0) * y.imag]
            degs += [n] if m == 0 else [n, n]
    basis, deg = tsal._real_sph_basis(lat, lon, 4)
    np.testing.assert_array_equal(deg, degs)
    assert np.abs(basis - np.stack(rows)).max() <= 1e-12


def test_sal_harmonics_match():
    s = Setup()
    jd = JDomain(ni=NI, nj=NJ, halo=H)
    from mom6_tpu.core.grid import spherical_grid as j_spherical_grid
    from mom6_torch.core.grid import spherical_grid
    jg = j_spherical_grid(jd, west_lon=10.0, lenlon=70.0, south_lat=-40.0,
                          lenlat=60.0)
    tg = spherical_grid(Domain(ni=NI, nj=NJ, halo=H), west_lon=10.0,
                        lenlon=70.0, south_lat=-40.0, lenlat=60.0,
                        device="cpu", dtype=F64)
    ref = jsal.SALHarmonics.build(jg, 4, rho_w=1035.0)
    out = tsal.SALHarmonics.build(tg, 4, rho_w=1035.0)
    for name in ("basis", "weights", "love"):
        _close(getattr(ref, name), getattr(out, name), 1e-12, name, halo=0)
    np.testing.assert_allclose(jsal.love_scaling(6), tsal.love_scaling(6),
                               rtol=0, atol=0)
    eta = 0.2 * s.rng.standard_normal(tuple(ref.shape))
    _close(ref(_j(eta)), out(_t(eta)), 1e-12, "eta_sal")
    carried = convert.sal_from_numpy(
        {k: np.asarray(getattr(ref, k)) for k in ("basis", "weights",
                                                   "love")}
        | {"shape": ref.shape}, device="cpu", dtype=F64)
    _close(ref(_j(eta)), carried(_t(eta)), 1e-12, "eta_sal carried")


# ---- the Stanley correction and the pressure force ---------------------

@pytest.mark.parametrize("form", ["LINEAR", "WRIGHT"])
def test_stanley_density_terms(form):
    s = Setup()
    je, te = j_make_eos(form), make_eos(form)
    p = 2e7 * s.rng.uniform(0.0, 1.0, s.a["T"].shape)
    _close(jstoch.density_second_dT2(je, s.j("T"), s.j("S"), _j(p)),
           tstoch.density_second_dT2(te, s.t("T"), s.t("S"), _t(p)),
           1e-12, "d2rho_dT2")
    _close(jstoch.calc_varT(s.jg, s.j("h"), s.j("T"), 0.5),
           tstoch.calc_varT(s.tg, s.t("h"), s.t("T"), 0.5), 1e-12, "varT")


PF_CASES = {
    "stanley": (True, dict(stanley_coeff=0.5, quad_points=5), False),
    "tidal": (True, dict(quad_points=5, reconstruct=True), True),
    "tidal_rlay": (True, {}, True),
    "nonbouss_boole": (False, dict(quad_points=5), True),
    "nonbouss_mid": (False, dict(quad_points=1), False),
    "nonbouss_rlay": (False, {}, False),
}


@pytest.mark.parametrize("case", list(PF_CASES))
def test_pressure_force_options(case):
    bouss, kw, tidal = PF_CASES[case]
    s = Setup()
    jvg = dataclasses.replace(s.jvg, boussinesq=bouss)
    tvg = dataclasses.replace(s.tvg, boussinesq=bouss)
    with_eos = case not in ("tidal_rlay", "nonbouss_rlay")
    eos_j = j_make_eos("WRIGHT") if with_eos else None
    eos_t = make_eos("WRIGHT") if with_eos else None
    ts_j = (s.j("T"), s.j("S")) if with_eos else (None, None)
    ts_t = (s.t("T"), s.t("S")) if with_eos else (None, None)
    et = 0.1 * s.rng.standard_normal(s.a["h"].shape[1:]) if tidal else None
    ref = jpf.pressure_force(s.jg, jvg, s.j("h"), *ts_j, eos_j,
                             cfg=jpf.PressureForceCfg(**kw),
                             e_tidal=None if et is None else _j(et))
    out = tpf.pressure_force(s.tg, tvg, s.t("h"), *ts_t, eos_t,
                             cfg=tpf.PressureForceCfg(**kw),
                             e_tidal=None if et is None else _t(et))
    for name in ("PFu", "PFv", "pbce", "eta_pf"):
        _close(getattr(ref, name), getattr(out, name), 1e-12, name)
    if not bouss:
        p_int = jnp.concatenate([jnp.zeros_like(s.j("h")[:1]),
                                 jnp.cumsum(9.8 * 1035.0 * s.j("h"), 0)])
        _close(jpf.set_pbce_nonbouss(jvg, p_int, *ts_j, eos_j),
               tpf.set_pbce_nonbouss(tvg, _t(p_int), *ts_t, eos_t), 1e-12,
               "set_pbce_nonbouss")


# ---- barotropic options ------------------------------------------------

@pytest.mark.parametrize("period", [1, 2])
def test_btstep_strong_drag_and_bounded_correction(period):
    s = Setup(reentrant_x=True)
    rng = s.rng
    shape = s.a["h"].shape
    a = dict(eta=s.fill(0.05 * rng.standard_normal(shape[1:])),
             acc=s.fill(1e-6 * rng.standard_normal(shape)),
             vr=s.fill(rng.uniform(0.3, 1.0, shape)),
             ecor=s.fill(0.5 * rng.standard_normal(shape[1:])))
    a["pbce"] = np.full(shape, 9.8 / NK)
    bc = jcont.set_up_bt_cont(s.jg, s.jvg, s.j("u"), s.j("v"), s.j("h"),
                              DT, jcont.ContinuityCfg())
    uh0 = np.sum(s.a["h"] * 0.01, 0)
    nstep = jbt.set_dtbt(s.jd, s.jg, s.jvg, jbt.BarotropicCfg(), DT)
    opts = dict(nstep=nstep, strong_drag=True, bound_bt_corr=True,
                maxcfl_bt_cont=1e-4, wide_halo_period=period)
    ref = jbt.btstep(s.jd, s.jg, s.jvg, s.j("u"), s.j("v"), _j(a["eta"]),
                     s.j("h"), _j(a["acc"]), _j(a["acc"]), _j(a["pbce"]),
                     s.j("u"), s.j("v"), DT, jbt.BarotropicCfg(**opts),
                     _j(a["vr"]), _j(a["vr"]), taux=0.1 * s.jg.mask2dCu,
                     bt_cont=bc, eta_cor=_j(a["ecor"]), uhbt_in=_j(uh0),
                     vhbt_in=_j(-uh0))
    tbc = convert.bt_cont_from_numpy(
        {k: np.asarray(v) for k, v in bc._asdict().items()}, device="cpu",
        dtype=F64)
    out = tbt.btstep(s.td, s.tg, s.tvg, s.t("u"), s.t("v"), _t(a["eta"]),
                     s.t("h"), _t(a["acc"]), _t(a["acc"]), _t(a["pbce"]),
                     s.t("u"), s.t("v"), DT, tbt.BarotropicCfg(**opts),
                     _t(a["vr"]), _t(a["vr"]), taux=0.1 * s.tg.mask2dCu,
                     bt_cont=tbc, eta_cor=_t(a["ecor"]), uhbt_in=_t(uh0),
                     vhbt_in=_t(-uh0))
    for name in ("eta", "uhbtav", "vhbtav", "ubt_av", "vbt_av",
                 "accel_layer_u", "accel_layer_v"):
        _close(getattr(ref, name), getattr(out, name), 1e-11, name)
    # the bound acts: the unbounded correction gives another eta
    free = tbt.btstep(s.td, s.tg, s.tvg, s.t("u"), s.t("v"), _t(a["eta"]),
                      s.t("h"), _t(a["acc"]), _t(a["acc"]), _t(a["pbce"]),
                      s.t("u"), s.t("v"), DT,
                      tbt.BarotropicCfg(**(opts | dict(bound_bt_corr=False))),
                      _t(a["vr"]), _t(a["vr"]), taux=0.1 * s.tg.mask2dCu,
                      bt_cont=tbc, eta_cor=_t(a["ecor"]), uhbt_in=_t(uh0),
                      vhbt_in=_t(-uh0))
    assert not torch.allclose(free.eta, out.eta)


# ---- vertical friction ---------------------------------------------------

VF_CASES = {
    "linear_drag": dict(linear_drag=True, drag_bg_vel=0.05),
    "channel_drag": dict(channel_drag=True, drag_bg_vel=0.01),
    "fixed_hbbl": dict(dynamic_bbl=False),
    "bbl_use_eos": dict(bbl_use_eos=True),
    "visc_ml_fixed": dict(visc_ml_mode="fixed", hmix_fixed=300.0),
    "visc_ml_dynamic": dict(visc_ml_mode="dynamic"),
    "harmonic_visc": dict(harmonic_visc=True),
    "kv_ml_invz2": dict(kv_ml_invz2=0.01, hmix_fixed=200.0),
    "direct_stress": dict(direct_stress=True, hmix_stress=300.0),
}


@pytest.mark.parametrize("case", list(VF_CASES))
def test_vert_friction_options(case):
    kw = VF_CASES[case]
    s = Setup()
    jcfg, tcfg = jvf.VertViscCfg(**kw), tvf.VertViscCfg(**kw)
    eos_j, eos_t = j_make_eos("WRIGHT"), make_eos("WRIGHT")
    taux = 0.2 * s.rng.standard_normal(s.a["h"].shape[1:])
    jforces = JMechForcing(taux=_j(s.fill(taux)), tauy=_j(s.fill(-taux)))
    tforces = MechForcing(taux=_t(jforces.taux), tauy=_t(jforces.tauy))
    jbbl = jvf.set_viscous_bbl(s.jg, s.j("u"), s.j("v"), s.j("h"), jcfg,
                               s.jvg, T=s.j("T"), S=s.j("S"), eos=eos_j)
    tbbl = tvf.set_viscous_bbl(s.tg, s.t("u"), s.t("v"), s.t("h"), tcfg,
                               s.tvg, s.t("T"), s.t("S"), eos_t)
    for name in jbbl._fields:
        _close(getattr(jbbl, name), getattr(tbbl, name), 1e-12, name)
    jus = jvf.surface_ustar(s.jg, 1035.0, jforces)
    tus = tvf.surface_ustar(s.tg, 1035.0, tforces)
    jc = jvf.vertvisc_coef(s.jg, s.j("u"), s.j("v"), s.j("h"), cfg=jcfg,
                           bbl=jbbl, ustar=jus)
    tc = tvf.vertvisc_coef(s.tg, s.t("u"), s.t("v"), s.t("h"), cfg=tcfg,
                           bbl=tbbl, ustar=tus)
    for name in ("a_u", "a_v") + (("ray_u", "ray_v")
                                  if kw.get("channel_drag") else ()):
        _close(getattr(jc, name), getattr(tc, name), 1e-12, name)
    ju, jv = jvf.vertvisc(s.jg, s.j("u"), s.j("v"), s.j("h"), jc, DT,
                          jforces.taux, jforces.tauy,
                          direct_stress=jcfg.direct_stress,
                          hmix_stress=jcfg.hmix_stress)
    tu, tv = tvf.vertvisc(s.tg, s.t("u"), s.t("v"), s.t("h"), tc, DT,
                          tforces.taux, tforces.tauy,
                          direct_stress=tcfg.direct_stress,
                          hmix_stress=tcfg.hmix_stress)
    _close(ju, tu, 1e-12, "u")
    _close(jv, tv, 1e-12, "v")
    jr, tr = (jvf.vertvisc_remnant(s.jg, jc, DT),
              tvf.vertvisc_remnant(s.tg, tc, DT))
    _close(jr[0], tr[0], 1e-12, "visc_rem_u")
    _close(jr[1], tr[1], 1e-12, "visc_rem_v")


# ---- horizontal viscosity --------------------------------------------------

HV_CASES = {
    "kh_vel_scale": dict(laplacian=True, kh=1.0, kh_vel_scale=0.02),
    "ah_vel_scale": dict(biharmonic=True, ah=1e6, ah_vel_scale=0.005),
    "leith_kh": dict(laplacian=True, leith_kh=True, leith_lap_const=2.0),
    "modified_leith_ah": dict(biharmonic=True, smag_bi_const=0.06,
                              leith_ah=True, leith_bi_const=1.0,
                              modified_leith=True),
    "add_les": dict(laplacian=True, kh=5.0, smag_lap_const=0.15,
                    leith_kh=True, leith_lap_const=1.0,
                    add_les_viscosity=True),
    "anisotropic": dict(laplacian=True, kh=5.0, anisotropic=True,
                        kh_aniso=20.0, aniso_n=(1.0, 0.5)),
    "zb2020": dict(biharmonic=True, smag_bi_const=0.06, use_zb2020=True),
    "zb2020_trace_free": dict(use_zb2020=True, zb_type=1, zb_cons=1,
                              zb_scaling=1.0),
    "zb2020_trace": dict(laplacian=True, kh=2.0, use_zb2020=True,
                         zb_type=2),
}


@pytest.mark.parametrize("case", list(HV_CASES))
def test_hor_visc_options(case):
    s = Setup(reentrant_x=False)
    kw = dict(HV_CASES[case], dt=DT)
    ref = jhv.horizontal_viscosity(s.jg, s.j("u"), s.j("v"), s.j("h"),
                                   jhv.HorViscCfg(**kw))
    out = thv.horizontal_viscosity(s.tg, s.t("u"), s.t("v"), s.t("h"),
                                   thv.HorViscCfg(**kw))
    _close(ref.diffu, out.diffu, 1e-12, "diffu")
    _close(ref.diffv, out.diffv, 1e-12, "diffv")
    assert float(torch.abs(out.diffu).max()) > 0.0


# ---- the models of the two configuration texts ---------------------------

SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n")
SMALL_KM = SMALL + "#override LENLON = 160.0\n#override LENLAT = 160.0\n"
SMALL_DEG = SMALL + ("#override LENLON = 1.6\n#override LENLAT = 1.6\n"
                     "#override SOUTHLAT = -0.8\n")


def _defaults(obj):
    base = type(obj)()
    return {f.name: _defaults(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(base, f.name) for f in dataclasses.fields(obj)}


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _without_tides(cfg):
    """The configuration with its tidal closure dropped (the two
    packages' closures are different objects)."""
    if cfg.split_cfg is not None:
        return dataclasses.replace(cfg, split_cfg=dataclasses.replace(
            cfg.split_cfg, tides_fn=None))
    return dataclasses.replace(cfg, unsplit_cfg=dataclasses.replace(
        cfg.unsplit_cfg, tides_fn=None))


@pytest.mark.parametrize("text", ["BENCH_CONFIG_B1", "BENCH_CONFIG_NONBOUSS"])
def test_model_two_steps_match_step_fn(text, tmp_path):
    base = getattr(configs, text)
    small = SMALL_KM
    if text == "BENCH_CONFIG_B1":
        configs.write_topog_edge(str(tmp_path / "topog_edge.nc"), 16, 16,
                                 seed=7)
        small = SMALL_DEG + f"INPUTDIR = {tmp_path}\n"
    jm = j_build_model(JParamFile(text=base + small))
    pm = build_model(ParamFile(text=base + small), device="cpu", dtype=F64)
    jcfg = _without_tides(jm.ocean_cfg)
    cfg = convert.config_from_values(OceanCfg, dataclasses.asdict(jcfg),
                                     _defaults(jcfg))
    assert cfg == _without_tides(pm.cfg)
    assert (pm.cfg.split_cfg.tides_fn is None) == (text != "BENCH_CONFIG_B1")
    assert pm.vgrid.boussinesq == (text == "BENCH_CONFIG_B1")
    if text == "BENCH_CONFIG_B1":
        for f in ("DminU", "DmaxU", "DavgU", "DminV", "DmaxV", "DavgV"):
            _close(getattr(jm.grid, "porous_" + f),
                   getattr(pm.grid, "porous_" + f), 0.0, f, halo=0)
    rng = np.random.default_rng(5)
    d, g = jm.domain, jm.grid

    def perturbed(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    st0 = dataclasses.replace(
        jm.state, h=perturbed(jm.state.h, 2.0), T=perturbed(jm.state.T, 0.5),
        u=perturbed(jm.state.u, 0.05, g.mask2dCu),
        v=perturbed(jm.state.v, 0.05, g.mask2dCv))
    sp0 = jm.split_state
    st, sp, tr = st0, sp0, jm.tracers
    step_j = jm.step_fn()
    for n in (0, 1):        # a dynamics step, then a thermodynamic one
        st, sp, tr = step_j(st, sp, tr, n)
    pm = convert.model_with_state(
        pm, _arrays(st0), _arrays(sp0),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step_p = pm.step_fn()
    pst, psp, ptr = pm.state, pm.split, pm.tracers
    for n in (0, 1):
        pst, psp, ptr = step_p(pst, psp, ptr, n)
    for name in ("h", "u", "v", "T", "S"):
        _close(getattr(st, name), getattr(pst, name), 1e-9, name)
    for name in ("eta", "u_av", "v_av", "uh", "vh"):
        _close(getattr(sp, name), getattr(psp, name), 1e-9, name)
    _close(tr["age"], ptr["age"], 1e-9, "age")
    assert float(np.abs(np.asarray(st.u)).max()) > 0.0


def test_builder_reads_the_laplacian_options():
    """The Laplacian-only viscosity options, DYNAMIC_BBL = False and the
    fixed viscous mixed layer, which no full-width run turns on: the
    port's builder reads them into the JAX builder's configuration."""
    text = configs.BENCH_CONFIG + SMALL_KM + """#override BIHARMONIC = False
LAPLACIAN = True
KH = 10.0
KH_VEL_SCALE = 0.01
AH_VEL_SCALE = 0.002
LEITH_KH = True
LEITH_LAP_CONST = 1.5
ADD_LES_VISCOSITY = True
ANISOTROPIC_VISCOSITY = True
KH_ANISO = 30.0
ANISO_GRID_DIR = 1.0, 2.0
DYNAMIC_BBL = False
FIXED_DEPTH_LOTW_ML = True
HMIX_FIXED = 40.0
VON_KARMAN_CONST = 0.4
ZB_SCALING = 1.5
ZB_TYPE = 1
ZB_CONS = 1
"""
    jm = j_build_model(JParamFile(text=text))
    pm = build_model(ParamFile(text=text), device="cpu", dtype=F64)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    hv, vv = pm.cfg.split_cfg.horvisc, pm.cfg.split_cfg.vertvisc
    assert hv.anisotropic and hv.aniso_n == (1.0, 2.0) and hv.leith_kh
    assert vv.visc_ml_mode == "fixed" and not vv.dynamic_bbl


def test_config_texts_are_bench_config_plus_their_lines():
    assert configs.BENCH_CONFIG_B1 == configs.BENCH_CONFIG + configs.B1_LINES
    assert configs.BENCH_CONFIG_NONBOUSS == (configs.BENCH_CONFIG
                                             + configs.NONBOUSS_LINES)
    for lines in (configs.B1_LINES, configs.NONBOUSS_LINES):
        names = [ln.split("=")[0].replace("#override", "").strip()
                 for ln in lines.splitlines()]
        assert len(names) == len(set(names))
    assert "BOUSSINESQ" not in configs.B1_LINES
    assert "STANLEY" not in configs.NONBOUSS_LINES

