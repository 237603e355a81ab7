"""mom6_torch against mom6_tpu: the rest of the tenth breadth item in
float64 on the CPU.

* The obsolete-parameter guard: FATAL and WARNING cases through both
  packages' ``check_obsolete_params`` with the same messages, and the
  port's ``build_model`` refusing and warning as the JAX builder does.
* The forcing library on the same 16x16 grid: ``scm_wind`` and the
  fluxes of ``scm_buoyancy_fn`` but its diurnal shortwave, ``bfb`` and
  the dumbbell's masks bitwise; the diurnal shortwave, the hurricane
  (the Holland profile with its 10-15 rmw ramps, the single-column mode,
  the BR benchmark's fixed f) and the dumbbell's seesaw 1e-12.
* The HURR text: bench.py's CONFIG plus its lines, the storm's origin
  moved with the basin by ``entry.build_full``.
* ``build_model`` of both packages on every new WIND_CONFIG, BUOY_CONFIG
  and COORD_CONFIG (and WIND_STAGGER A on an on-grid file): the forces
  at two times, the fluxes, Rlay and the parameter docs; then 2 steps of
  four of them, 1e-9 (the JAX steps run eagerly).
* The particles: RK2 steps in a uniform flow and in a sheared flow across
  the reentrant seam and against a wall, 1e-14.
* The shape-wide draw of ``framework/random.py``: uniform bits bitwise,
  normals 4e-15 absolute.
* The controlled forcing, the derived diagnostics, the energy of
  diapycnal mixing, the spatial means and the quarter-turn rotation,
  1e-13 (the means' efp sums bitwise).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.state import State as JState
from mom6_tpu.diagnostics import derived as jder
from mom6_tpu.diagnostics import diapyc_energy_req as jdia
from mom6_tpu.diagnostics import spatial_means as jsm
from mom6_tpu.drivers import controlled_forcing as jcf
from mom6_tpu.drivers import surface_forcing as jsf
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.framework import array_transform as jat
from mom6_tpu.framework import obsolete_params as jobs
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.framework.config import param_doc_text as j_doc_text
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.tracer import particles as jpart

from mom6_torch.convert import grid_from_numpy
from mom6_torch.core.state import State
from mom6_torch.diagnostics import derived as pder
from mom6_torch.diagnostics import diapyc_energy_req as pdia
from mom6_torch.diagnostics import spatial_means as psm
from mom6_torch.drivers import controlled_forcing as pcf
from mom6_torch.drivers import surface_forcing as psf
from mom6_torch.eos import make_eos
from mom6_torch.framework import array_transform as pat
from mom6_torch.framework import obsolete_params as pobs
from mom6_torch.framework import random as prandom
from mom6_torch.framework.config import ParamFile
from mom6_torch.framework.config import param_doc_text
from mom6_torch.framework.error_handler import FatalError
from mom6_torch.framework.io import write_fields
from mom6_torch.model import build_model
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer import particles as ppart

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
N, H = 16, 4


def _check(ref, out, name, tol):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    if tol == 0.0:
        np.testing.assert_array_equal(b, a, err_msg=name)
        return
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.fixture(scope="module")
def grids():
    """One 16x16 grid of 10 km cells, walls in y, f on a beta plane, in
    both packages (the port's a copy of the JAX arrays)."""
    jd = JDomain(ni=N, nj=N, halo=H, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=N * 10.0, lenlat_km=N * 10.0,
                          f0=1e-4, beta=2e-11, max_depth=1000.0)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    td = Domain(ni=N, nj=N, halo=H, reentrant_x=True)
    return jd, jg, td, grid_from_numpy(gnp, td, device="cpu", dtype=F64)


# ---- the obsolete-parameter guard -----------------------------------------

OBSOLETE = [("OBC_CONFIG = x", "FATAL"), ("MSTAR_FIXED = True", "FATAL"),
            ("USE_PP81 = True", "FATAL"),
            ("WINDSTRESS_STAGGER = A", "FATAL"),
            ("CORRECT_DENSITY = False", "FATAL"),
            ("WINDSTRESS_STAGGER = C", "WARNING"),
            ("CONTINUITY_SCHEME = PPM", "WARNING"),
            ("BT_MASS_SOURCE_LIMIT = 0.0", "WARNING")]


class _Stop(Exception):
    pass


def _guard_messages(mod, pf, monkeypatch):
    got = []

    def record(level, msg):
        got.append((level, msg))
        if level == mod.FATAL:
            raise _Stop
    monkeypatch.setattr(mod, "MOM_error", record)
    try:
        mod.check_obsolete_params(pf)
    except _Stop:
        pass
    return got


@pytest.mark.parametrize("line,level", OBSOLETE,
                         ids=[c[0].split(" ")[0] + "_" + c[1] for c in OBSOLETE])
def test_obsolete_guard_matches_jax(line, level, monkeypatch):
    jpf, ppf = JParamFile(text=line + "\n"), ParamFile(text=line + "\n")
    want = _guard_messages(jobs, jpf, monkeypatch)
    got = _guard_messages(pobs, ppf, monkeypatch)
    assert got == want and len(got) == 1
    assert got[0][0] == (pobs.FATAL if level == "FATAL" else pobs.WARNING)
    if level == "WARNING":
        # at its safe value the parameter counts as read
        assert ppf.unused() == [] and jpf.unused() == []


SMALL = """NIGLOBAL = 12
NJGLOBAL = 10
NK = 4
DT = 600.0
DAYMAX = 0.01
GRID_CONFIG = cartesian
AXIS_UNITS = k
LENLON = 240.0
LENLAT = 200.0
MAXIMUM_DEPTH = 1000.0
F_0 = 1.0e-4
BETA = 2.0e-11
EQN_OF_STATE = LINEAR
BULKMIXEDLAYER = False
"""


@pytest.mark.parametrize("line", ["OBC_CONFIG = x",
                                  "WINDSTRESS_STAGGER = A"])
def test_builder_refuses_obsolete(line):
    with pytest.raises(FatalError) as err:
        build_model(ParamFile(text=SMALL + line + "\n"), device="cpu",
                    dtype=F64)
    with pytest.raises(Exception) as jerr:
        j_build_model(JParamFile(text=SMALL + line + "\n"))
    assert str(err.value) == str(jerr.value)


# ---- the forcing library ----------------------------------------------------

def _mech(jf, pf, name, tol):
    for k in ("taux", "tauy", "p_surf"):
        a, b = getattr(jf, k), getattr(pf, k)
        assert (a is None) == (b is None), f"{name}.{k}"
        if a is not None:
            _check(a, b, f"{name}.{k}", tol)


def _fluxes(jf, pf, name, tol):
    for f in dataclasses.fields(pf):
        a, b = getattr(jf, f.name), getattr(pf, f.name)
        assert (a is None) == (b is None), f"{name}.{f.name}"
        if a is not None:
            _check(a, b, f"{name}.{f.name}", tol.get(f.name, 0.0)
                   if isinstance(tol, dict) else tol)


def _states(jg, seed=0, nk=3):
    rng = np.random.default_rng(seed)
    shape = (nk,) + np.asarray(jg.mask2dT).shape
    T = 10.0 + 5.0 * rng.random(shape)
    S = 34.0 + 2.0 * rng.random(shape)
    h = 50.0 + 10.0 * rng.random(shape)
    u = 0.1 * rng.standard_normal(shape)
    v = 0.1 * rng.standard_normal(shape)
    js = JState(u=jnp.asarray(u), v=jnp.asarray(v), h=jnp.asarray(h),
                T=jnp.asarray(T), S=jnp.asarray(S))
    ps = State(u=torch.tensor(u), v=torch.tensor(v), h=torch.tensor(h),
               T=torch.tensor(T), S=torch.tensor(S))
    return js, ps


def test_scm_and_bfb_forcing_match_jax(grids):
    _, jg, _, pg = grids
    _mech(jsf.scm_wind(jg, 0.1, -0.05), psf.scm_wind(pg, 0.1, -0.05),
          "scm_wind", 0.0)
    js, ps = _states(jg)
    jfn = jsf.scm_buoyancy_fn(jg, heat_flux=2e-5, evaporation=1e-7,
                              max_sw=3e-5, rho_restore=1030.0)
    pfn = psf.scm_buoyancy_fn(pg, heat_flux=2e-5, evaporation=1e-7,
                              max_sw=3e-5, rho_restore=1030.0)
    assert pfn.time_varying == jfn.time_varying
    for t in (0.0, 43200.0 + 300.0, 50000.0):
        _fluxes(jfn(js, jnp.asarray(t)), pfn(ps, t), f"scm t={t}",
                {"sw": 1e-12})
    jfn = jsf.bfb_buoyancy_fn(jg, sst_s=20.0, sst_n=10.0, lfr_slat=40.0,
                              lfr_nlat=120.0, flux_const=0.5)
    pfn = psf.bfb_buoyancy_fn(pg, sst_s=20.0, sst_n=10.0, lfr_slat=40.0,
                              lfr_nlat=120.0, flux_const=0.5)
    _fluxes(jfn(js, jnp.asarray(0.0)), pfn(ps, 0.0), "bfb", 0.0)


HURRICANES = {
    # rmw 8 km: the 10-15 rmw ramps inside the 160 km square, the centre
    # on a u point at t = 0 (radius 0)
    "holland": dict(rad_max_wind=8.0e3, x0=50.0e3, y0=55.0e3),
    "heading_ne": dict(rad_max_wind=6.0e3, x0=70.0e3, y0=80.0e3,
                       translation_dir=45.0, translation_spd=7.0,
                       max_windspeed=50.0),
    "scm": dict(scm_mode=True, x0=-30.0e3, y0=10.0e3,
                dy_from_center=25.0e3),
    "br_bench": dict(br_bench=True, rad_max_wind=10.0e3, x0=90.0e3,
                     y0=40.0e3),
}


@pytest.mark.parametrize("name", sorted(HURRICANES))
def test_hurricane_matches_jax(grids, name):
    _, jg, _, pg = grids
    jcfg = jsf.HurricaneCfg(**HURRICANES[name])
    pcfg = psf.HurricaneCfg(**HURRICANES[name])
    assert pcfg.holland_b == jcfg.holland_b
    assert pcfg.holland_a == jcfg.holland_a
    jfn = jsf.idealized_hurricane_fn(jcfg, jg)
    pfn = psf.idealized_hurricane_fn(pcfg, pg)
    for t in (0.0, 1800.0, 7300.0):
        jf, pf = jfn(jnp.asarray(t)), pfn(t)
        _mech(jf, pf, f"{name} t={t}", 1e-12)
    assert float(pf.taux.abs().max()) > 0.01


@pytest.mark.parametrize("rotate", [False, True])
def test_dumbbell_forcing_matches_jax(grids, rotate):
    _, jg, _, pg = grids
    kw = dict(slp_amplitude=5000.0, slp_period=0.5, flux_const=1.0,
              rho_restore=1030.0, rotate=rotate)
    jff, jfl = jsf.dumbbell_forcing(jsf.DumbbellForcingCfg(**kw), jg,
                                    0.0, 160.0, 0.0, 160.0)
    pff, pfl = psf.dumbbell_forcing(psf.DumbbellForcingCfg(**kw), pg,
                                    0.0, 160.0, 0.0, 160.0)
    for t in (0.0, 3600.0, 40000.0):
        _mech(jff(jnp.asarray(t)), pff(t), f"dumbbell t={t}", 1e-12)
    js, ps = _states(jg, seed=1)
    _fluxes(jfl(js, jnp.asarray(0.0)), pfl(ps, 0.0), "dumbbell", 0.0)
    assert float(pfl(ps, 0.0).lprec.abs().max()) > 0.0
    assert psf.dumbbell_forcing(
        psf.DumbbellForcingCfg(), pg, 0.0, 160.0, 0.0, 160.0)[1] is None


# ---- the builder's new branches --------------------------------------------

BUILDS = {
    # the storm inside the 240 x 200 km basin; BFB restoring over the
    # BFB coordinate (latitudes in km here: the ramp over 40-160)
    "hurr_bfb": """WIND_CONFIG = ideal_hurr
IDL_HURR_X0 = 180.0e3
IDL_HURR_Y0 = 100.0e3
IDL_HURR_RAD_MAX_WIND = 30.0e3
BUOY_CONFIG = BFB
RESTOREBUOY = True
FLUXCONST = 0.5
LFR_SLAT = 40.0
LFR_NLAT = 160.0
COORD_CONFIG = BFB
T_BOT = 4.0
""",
    "dumbbell": """WIND_CONFIG = dumbbell
BUOY_CONFIG = dumbbell
DUMBBELL_SLP_AMP = 2000.0
DUMBBELL_SLP_PERIOD = 0.25
RESTOREBUOY = True
FLUXCONST = 1.0
INITIAL_SSS = 35.0
""",
    "scm": """WIND_CONFIG = SCM_CVMix_tests
SCM_TAU_X = 0.1
SCM_TAU_Y = 0.05
BUOY_CONFIG = SCM_CVMix_tests
SCM_USE_HEAT_FLUX = True
SCM_HEAT_FLUX = -2.0e-5
SCM_USE_EVAPORATION = True
SCM_EVAPORATION = 1.0e-7
SCM_USE_DIURNAL_SW = True
SCM_DIURNAL_SW_MAX = 4.0e-5
""",
    "scm_hurr_const_heat": """WIND_CONFIG = SCM_ideal_hurr
IDL_HURR_X0 = -60.0e3
BUOY_CONFIG = const_heat
SENSIBLE_HEAT_FLUX = -80.0
""",
    "stagger_a": """WIND_CONFIG = file
WIND_FILE = wind.nc
WIND_STAGGER = A
BUOY_CONFIG = const_heat
SENSIBLE_HEAT_FLUX = 20.0
""",
}
# the keys of the docs compared line by line: the new branches' reads
NEW_KEYS = ("WIND_CONFIG", "BUOY_CONFIG", "COORD_CONFIG", "WIND_STAGGER",
            "SENSIBLE_HEAT_FLUX", "RESTORE_FLUX_RHO", "SST_S", "SST_N",
            "LFR_SLAT", "LFR_NLAT", "DRHO_DT", "DRHO_DS", "RHO_T0_S0",
            "T_BOT", "S_REF", "DUMBBELL_SLP_AMP", "DUMBBELL_SLP_PERIOD",
            "INITIAL_SSS", "INITIAL_S_RANGE", "DUMBBELL_ROTATION")


def _doc_lines(text):
    return {line.split(" = ", 1)[0].strip(): line
            for line in text.splitlines()
            if " = " in line and not line.lstrip().startswith("!")}


def _build_both(case, tmp_path):
    text = SMALL + BUILDS[case]
    if case == "stagger_a":
        # an A-grid file of the compute domain's shape, taken as C
        rng = np.random.default_rng(3)
        write_fields(str(tmp_path / "wind.nc"),
                     {"STRESS_X": 0.1 * rng.standard_normal((10, 12)),
                      "STRESS_Y": 0.1 * rng.standard_normal((10, 12))},
                     dims={"STRESS_X": ("ny", "nx"),
                           "STRESS_Y": ("ny", "nx")})
        text += f"INPUTDIR = {tmp_path}\n"
    jpf, ppf = JParamFile(text=text), ParamFile(text=text)
    jm = j_build_model(jpf)
    pm = build_model(ppf, device="cpu", dtype=F64)
    assert ppf.unused() == [], ppf.unused()
    return jm, pm, jpf, ppf


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_builder_matches_jax(case, tmp_path):
    jm, pm, jpf, ppf = _build_both(case, tmp_path)
    _mech(jm.forces, pm.forces, "forces", 1e-12)
    assert (jm.forces_fn is None) == (pm.forces_fn is None)
    if pm.forces_fn is not None:
        _mech(jm.forces_fn(jnp.asarray(5400.0)), pm.forces_fn(5400.0),
              "forces t=5400", 1e-12)
    for t in (300.0, 44000.0):
        jfl = jm.fluxes_fn(jm.state, jnp.asarray(t))
        _fluxes(jfl, pm.fluxes(pm.state, t), f"fluxes t={t}", 1e-12)
    _check(jm.vgrid.Rlay, pm.vgrid.Rlay, "Rlay", 1e-14)
    want, got = _doc_lines(j_doc_text(jpf)), _doc_lines(param_doc_text(ppf))
    for key in NEW_KEYS + tuple(k for k in got
                                if k.startswith(("IDL_HURR", "SCM_"))):
        assert got.get(key) == want.get(key), key


@pytest.mark.parametrize("case", ["dumbbell", "hurr_bfb", "scm",
                                  "scm_hurr_const_heat"])
def test_two_steps_match_jax(case, tmp_path):
    jm, pm, _, _ = _build_both(case, tmp_path)
    # eagerly: at this size faster than compiling the steps
    with jax.disable_jit():
        step = jm.step_fn()
        jcur = (jm.state, jm.split_state, jm.tracers)
        for k in range(2):
            jcur = step(*jcur, k)
    pstep = pm.step_fn()
    pcur = (pm.state, pm.split, pm.tracers)
    for k in range(2):
        pcur = pstep(*pcur, k)
    for name in ("h", "u", "v", "T", "S"):
        _check(np.asarray(getattr(jcur[0], name))[..., H:-H, H:-H],
               getattr(pcur[0], name)[..., H:-H, H:-H], name, 1e-9)
    for name in ("eta", "uh", "vh"):
        _check(np.asarray(getattr(jcur[1], name))[..., H:-H, H:-H],
               getattr(pcur[1], name)[..., H:-H, H:-H], name, 1e-9)
    assert float(pcur[0].u.abs().max()) > 0.0


def test_hurr_text():
    """configs.BENCH_CONFIG_HURR is bench.py's CONFIG plus its lines, and
    build_full moves the storm's origin with the basin: at 16x16 the
    storm starts at (120 km, 80 km), its strongest stress near it."""
    from mom6_torch import configs, entry
    assert configs.BENCH_CONFIG_HURR == configs.BENCH_CONFIG \
        + configs.HURR_LINES
    m = entry.build_full(16, 16, 4, dynamics="hurr", device="cpu",
                         dtype=F64)
    tau = torch.hypot(m.forces.taux, m.forces.tauy)[H:-H, H:-H]
    j, i = divmod(int(torch.argmax(tau)), 16)
    assert abs((i + 1) * 10.0 - 120.0) <= 60.0 and abs(j * 10.0 - 80.0) <= 60.0
    assert float(tau.max()) > 1.0
    fl = m.fluxes(m.state, 300.0)
    assert float(fl.sensible[H, H]) == -100.0


# ---- particles ----------------------------------------------------------------

def _particles_both(jd, td, xs, ys, ks):
    return (jpart.init_particles(xs, ys, ks),
            ppart.init_particles(xs, ys, ks, device="cpu"))


@pytest.mark.parametrize("flow", ["uniform", "sheared"])
def test_particles_match_jax(grids, flow):
    """Four RK2 steps of 1 h: a uniform flow, or a flow sheared in y
    and varying in x (u up to 0.6 m/s, some particles carried across
    the reentrant seam, the others pushed against the south wall)."""
    jd, jg, td, pg = grids
    nk, shp = 3, np.asarray(jg.mask2dT).shape
    jj, ii = np.meshgrid(np.arange(shp[0]), np.arange(shp[1]),
                         indexing="ij")
    if flow == "uniform":
        u = np.full((nk,) + shp, 0.3)
        v = np.full((nk,) + shp, -0.1)
    else:
        u = np.stack([(0.2 + 0.4 * jj / shp[0]) * (1 + 0.1 * np.sin(ii))
                      * (k + 1) for k in range(nk)])
        v = np.stack([-0.15 * (k + 1) * (1.0 + 0.5 * np.cos(0.5 * ii))
                      for k in range(nk)])
    rng = np.random.default_rng(4)
    xs = rng.uniform(0.0, N, 25)
    xs[:5] = N - rng.uniform(0.0, 0.3, 5)          # at the seam
    ys = rng.uniform(0.2, N - 0.2, 25)
    ys[5:10] = 0.3                                   # by the south wall
    ks = rng.integers(0, nk, 25)
    jp, pp = _particles_both(jd, td, xs, ys, ks)
    for _ in range(4):
        jp = jpart.advect_particles(jd, jg, jp, jnp.asarray(u),
                                    jnp.asarray(v), 3600.0)
        pp = ppart.advect_particles(td, pg, pp, torch.tensor(u),
                                    torch.tensor(v), 3600.0)
    assert pp.x.dtype == F64
    _check(jp.x, pp.x, "x", 1e-14)
    _check(jp.y, pp.y, "y", 1e-14)
    assert np.array_equal(np.asarray(jp.k), pp.k.numpy())
    if flow == "sheared":
        moved = np.abs(pp.x.numpy() - xs)
        assert (moved > N / 2).any()               # wrapped
        assert float(pp.y.min()) == 0.0            # clamped at the wall


# ---- the shape-wide draw -----------------------------------------------------

@pytest.mark.parametrize("dtype,draws", [
    (torch.float64, ((0, 3, ()), (11, 2, (4, 6, 10)))),
    (torch.float32, ((2 ** 40 + 5, 1, (4, 6, 10)),))], ids=["f64", "f32"])
def test_shape_draw_matches_jax(dtype, draws):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    for seed, m, shape in draws:
        jk = jax.random.fold_in(jax.random.key(seed), m)
        pk = prandom.fold_in(prandom.key(seed), m)
        np.testing.assert_array_equal(
            prandom.uniform(pk, shape, dtype=dtype).numpy(),
            np.asarray(jax.random.uniform(jk, shape, jdt)))
        err = np.abs(prandom.normal(pk, shape, dtype=dtype).numpy()
                     - np.asarray(jax.random.normal(jk, shape, jdt))).max()
        assert err <= (4e-15 if dtype == torch.float64 else 2.4e-7), err


# ---- the controlled forcing, the diagnostics, the rotation ---------------------

def test_controlled_forcing_matches_jax(grids):
    _, jg, _, pg = grids
    kw = dict(heat_int_rate=1e-6, prec_int_rate=2e-6, smooth_len=2e4,
              lam_heat=10.0, lam_prec=1e-5)
    jc, pc = jcf.CtrlForcingCfg(**kw), pcf.CtrlForcingCfg(**kw)
    shp = np.asarray(jg.mask2dT).shape
    jst = jcf.init_ctrl_state(shp)
    pst = pcf.init_ctrl_state(shp, device="cpu")
    rng = np.random.default_rng(5)
    for k in range(3):
        sst, sss = rng.standard_normal(shp), 0.1 * rng.standard_normal(shp)
        jst, jh, jp = jcf.apply_ctrl_forcing(jc, jg, jst, jnp.asarray(sst),
                                             jnp.asarray(sss), 35.0, 3600.0)
        pst, ph, pp = pcf.apply_ctrl_forcing(pc, pg, pst, torch.tensor(sst),
                                             torch.tensor(sss), 35.0, 3600.0)
    _check(jh, ph, "heat_0", 1e-13)
    _check(jp, pp, "precip_0", 1e-13)


def test_diagnostics_match_jax(grids):
    jd, jg, td, pg = grids
    js, ps = _states(jg, seed=6, nk=4)
    _check(jder.relative_vorticity_z(jg, js.u[0], js.v[0]),
           pder.relative_vorticity_z(pg, ps.u[0], ps.v[0]), "rv", 1e-13)
    _check(jder.speed(js.u, js.v), pder.speed(ps.u, ps.v), "speed", 1e-13)
    _check(jder.kinetic_energy(jg, js.u, js.v),
           pder.kinetic_energy(pg, ps.u, ps.v), "ke", 1e-13)
    _check(jder.column_average(js.T, js.h),
           pder.column_average(ps.T, ps.h), "colavg", 1e-13)
    _check(jder.sea_surface_height(jg, js.h),
           pder.sea_surface_height(pg, ps.h), "ssh", 1e-13)
    # the energy of mixing a stable column: positive where it mixes
    nk = 4
    kd = np.full((nk + 1,) + np.asarray(jg.mask2dT).shape, 1e-3)
    kd[0] = kd[-1] = 0.0
    T = np.asarray(js.T)[np.argsort(-np.asarray(js.T).mean(axis=(1, 2)))]
    je, pe = j_make_eos("LINEAR"), make_eos("LINEAR")
    want = jdia.diapyc_energy_req(js.h, jnp.asarray(T), js.S,
                                  jnp.asarray(kd), 3600.0, je)
    got = pdia.diapyc_energy_req(ps.h, torch.tensor(T), ps.S,
                                 torch.tensor(kd), 3600.0, pe)
    _check(want, got, "diapyc_energy_req", 1e-12)
    for fn, args in ((jsm.global_area_mean, (js.T[0],)),
                     (jsm.global_volume_mean, (js.T, js.h)),
                     (jsm.global_layer_mean, (js.S, js.h))):
        pfn = getattr(psm, fn.__name__)
        pargs = tuple(torch.tensor(np.asarray(a)) for a in args)
        np.testing.assert_array_equal(pfn(td, pg, *pargs),
                                      fn(jd, jg, *args))


def test_rotation_matches_jax():
    rng = np.random.default_rng(7)
    a, u, v = (rng.standard_normal((3, 10, 14)) for _ in range(3))
    _check(jat.rotate_scalar(jnp.asarray(a)),
           pat.rotate_scalar(torch.tensor(a)), "scalar", 0.0)
    _check(jat.rotate_corner(jnp.asarray(a)),
           pat.rotate_corner(torch.tensor(a)), "corner", 0.0)
    for x, y in zip(jat.rotate_vector(jnp.asarray(u), jnp.asarray(v)),
                    pat.rotate_vector(torch.tensor(u), torch.tensor(v))):
        _check(x, y, "vector", 0.0)
