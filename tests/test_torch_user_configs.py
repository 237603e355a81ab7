"""mom6_torch against mom6_tpu: the user set-up (the tenth breadth item's
``user/configs.py`` and ``user/basin_builder.py``) in float64 on the CPU.

* Every topography of ``topo_registry`` on the same lon/lat and context
  (DUMBBELL_ROTATION both ways), 1e-13.
* Every thickness initializer of ``thickness_registry`` on the same
  grid (a seamount, so that the bottom cuts layers), vertical grid and
  context, with its own T/S and velocities; DOME2D in each coordinate
  mode and dumbbell in each, 1e-13.
* ``isomip_ts``, ``baroclinic_zone_ts`` and ``scm_cvmix_ts`` on seeded
  thicknesses, and ``basin_builder_topography`` with every primitive,
  1e-13.
* ``build_model`` of both packages on MOM_inputs that take the
  builder's branches: TS_CONFIG ISOMIP, baroclinic_zone and
  SCM_CVMix_tests, VELOCITY_CONFIG uniform and circular (axes in km and
  in degrees), TOPO_CONFIG basin_builder, THICKNESS_CONFIG sigma and
  Neverworld's INIT_THICKNESS_PROFILE, the benchmark family's T/S:
  bathymetry, h, u, v, T, S at 1e-13.
* 2 steps of ``Model.step_fn`` of three of them, seamount + sloshing,
  DOME2D and ISOMIP (its cavity under a shelf), 1e-9 (the JAX steps
  run eagerly).
* ``cases/phillips`` through both solo drivers for 0.25 days, its
  ocean.stats every 3 steps, the lines compared as
  tests/test_torch_cases.py compares tc1's.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.user import basin_builder as jbb
from mom6_tpu.user import configs as juc

from mom6_tpu.drivers import solo as jsolo
from test_torch_cases import ROOT, _compare, _stats

from mom6_torch.convert import grid_from_numpy
from mom6_torch.drivers import solo
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.parallel.domain import Domain
from mom6_torch.user import basin_builder as pbb
from mom6_torch.user import configs as puc

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, H = 12, 10, 4
TOL = 1e-13
CTX = dict(max_depth=1000.0, min_depth=0.0, lenlon=240.0, lenlat=200.0,
           west=0.0, south=0.0, f0=1e-4, beta=2e-11)


def _check(ref, out, name, tol=TOL):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.fixture(scope="module")
def grids():
    """The same 12x10 km grid over a seamount in both packages."""
    jd = JDomain(ni=NI, nj=NJ, halo=H)
    jg = j_cartesian_grid(
        jd, lenlon_km=CTX["lenlon"], lenlat_km=CTX["lenlat"], f0=1e-4,
        beta=2e-11, depth_fn=lambda lo, la: juc.topo_seamount(
            np.asarray(lo), np.asarray(la), dict(CTX, seamount_height=700.0)),
        max_depth=CTX["max_depth"])
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    td = Domain(ni=NI, nj=NJ, halo=H)
    return jd, jg, td, grid_from_numpy(gnp, td, device="cpu", dtype=F64), gnp


TOPOS = sorted(juc.topo_registry) + ["dumbbell_rotated"]


@pytest.mark.parametrize("name", TOPOS)
def test_topography_matches_jax(grids, name):
    gnp = grids[4]
    lon, lat = gnp["geoLonT"], gnp["geoLatT"]
    ctx = dict(CTX, min_depth=20.0, edge_depth=150.0, shelf_depth=350.0,
               dome2d_shelf_width=0.15, dumbbell_len=120.0,
               dumbbell_fraction=0.4, nl_continent_amp=0.8,
               shelfwave_y_length_scale=80.0)
    if name == "dumbbell_rotated":
        name, ctx["dumbbell_rotation"] = "dumbbell", True
    want = juc.topo_registry[name](lon, lat, ctx)
    got = puc.topo_registry[name](lon, lat, ctx)
    _check(want, got, name)
    assert np.ptp(want) > 0.0 or name == "flat"


# (initializer, its coordinate mode and extra context)
INITS = [("phillips", "LAYER", dict(phillips_slope=4e-4, phillips_amp=5.0)),
         ("sloshing", "LAYER", dict(sloshing_amp=40.0)),
         ("circle_obcs", "LAYER", dict(disk_radius=60.0)),
         ("adjustment", "LAYER", dict(delta_t=3.0, front_width=0.1)),
         ("rossby_front", "LAYER", dict(ml_depth=300.0)),
         ("lock_exchange", "LAYER", dict(delta_t=4.0)),
         ("external_gwave", "LAYER", dict(ssh_anomaly_height=2.0)),
         ("dome", "LAYER", {}),
         ("dense_water", "LAYER", dict(delta_s=2.0)),
         ("soliton", "LAYER", {}),
         ("Neverworld", "LAYER", dict(nl_thickness_pert_amp=0.2,
                                      init_thickness_profile=[100.0, 200.0,
                                                              300.0, 400.0])),
         ] + [("DOME2D", m, dict(dome2d_shelf_width=0.2))
              for m in ("LAYER", "RHO", "SIGMA", "ZSTAR")] + [
    ("dumbbell", m, dict(dumbbell_len=120.0, dumbbell_rotation=m == "RHO",
                         interface_ic_quanta=64.0 if m == "HYCOM1" else 0.0))
    for m in ("LAYER", "RHO", "HYCOM1", "SIGMA", "ZSTAR")]


@pytest.mark.parametrize("name,mode,extra", INITS,
                         ids=[f"{n}-{m}" for n, m, _ in INITS])
def test_initializer_matches_jax(grids, name, mode, extra):
    jd, jg, td, tg, _ = grids
    nk = 2 if name == "phillips" else 4
    jvg = JVerticalGrid.uniform(nk=nk, gint=0.01)
    pvg = VerticalGrid.uniform(nk=nk, gint=0.01, device="cpu", dtype=F64)
    base = dict(CTX, thermo=True, coord_mode=mode, min_thickness=1e-3,
                t_ref=8.0, s_ref=34.0, s_range=3.0, initial_sss=33.5,
                **extra)
    want = juc.thickness_registry[name](dict(base, grid=jg, vgrid=jvg,
                                             domain=jd))
    got = puc.thickness_registry[name](dict(base, grid=tg, vgrid=pvg,
                                            domain=td))
    assert sorted(got) == sorted(want)
    for k in want:
        _check(want[k], got[k], f"{name} {mode} {k}")


def test_ts_profiles_and_basin_builder_match_jax(grids):
    jd, jg, td, tg, gnp = grids
    rng = np.random.default_rng(17)
    h = rng.uniform(10.0, 400.0, (5,) + gnp["geoLonT"].shape)
    ctx = dict(CTX, isomip_t_bot=1.0, isomip_s_bot=34.7, bcz_dtdz=0.01,
               bcz_delta_t=2.0, bcz_dtdx=1e-3, bcz_dsdz=-1e-3,
               bcz_delta_s=0.5, bcz_dsdx=1e-4, bcz_l_zone=50.0)
    for fn in ("isomip_ts", "baroclinic_zone_ts"):
        want = getattr(juc, fn)(dict(ctx, grid=jg), jnp.asarray(h))
        got = getattr(puc, fn)(dict(ctx, grid=tg), torch.as_tensor(h))
        for k, a, b in zip("TS", want, got):
            _check(a, b, f"{fn} {k}")
    kw = dict(t_mld=30.0, s_mld=20.0, l2_temp=18.0, l2_salt=35.5,
              dtdz=0.01, dsdz=-0.002, min_temp=6.0)
    want = juc.scm_cvmix_ts(jnp.asarray(h), **kw)
    got = puc.scm_cvmix_ts(torch.as_tensor(h), **kw)
    for k, a, b in zip("TS", want, got):
        _check(a, b, f"scm_cvmix_ts {k}")
    text = BBUILDER + "MAXIMUM_DEPTH = 1000.0\n"
    want = jbb.basin_builder_topography(gnp["geoLonT"], gnp["geoLatT"],
                                        JParamFile(text=text), 1000.0)
    pf = ParamFile(text=text)
    got = pbb.basin_builder_topography(gnp["geoLonT"], gnp["geoLatT"], pf,
                                       1000.0)
    _check(want, got, "basin_builder")
    assert pf.unused() == ["MAXIMUM_DEPTH"]


# every basin_builder primitive
BBUILDER = """BBUILDER_N = 7
BBUILDER_001_FUNC = NS_COAST
BBUILDER_001_PARS = 20.0, 0.0, 150.0, 40.0, 100.0
BBUILDER_002_FUNC = EW_COAST
BBUILDER_002_PARS = 190.0, 30.0, 200.0, 30.0, 150.0
BBUILDER_003_FUNC = ANGLED_COAST
BBUILDER_003_PARS = 300.0, 260.0, 50.0, 120.0
BBUILDER_004_FUNC = NS_CONIC_RIDGE
BBUILDER_004_PARS = 120.0, 20.0, 120.0, 30.0, 600.0
BBUILDER_005_FUNC = NS_SCURVE_RIDGE
BBUILDER_005_PARS = 180.0, 60.0, 180.0, 25.0, 400.0
BBUILDER_006_FUNC = CIRC_CONIC_RIDGE
BBUILDER_006_PARS = 120.0, 100.0, 60.0, 20.0, 500.0
BBUILDER_007_FUNC = CIRC_SCURVE_RIDGE
BBUILDER_007_PARS = 80.0, 150.0, 30.0, 15.0, 700.0
"""

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
EQN_OF_STATE = LINEAR
BULKMIXEDLAYER = False
"""

# the builder's branches, each on SMALL
BUILDS = {
    "isomip_ts": """TOPO_CONFIG = isomip
TS_CONFIG = ISOMIP
ISOMIP_T_SUR = -1.9
ISOMIP_S_SUR = 33.8
ISOMIP_T_BOT = 1.0
ISOMIP_S_BOT = 34.7
""",
    "baroclinic_zone": """REENTRANT_X = True
TS_CONFIG = baroclinic_zone
BCZIC%DTDZ = 0.005
BCZIC%DELTA_T = 2.0
BCZIC%DTDX = 0.002
BCZIC%DSDZ = -0.001
BCZIC%DELTA_S = 0.3
BCZIC%L_ZONE = 60.0
""",
    "scm_cvmix": """TS_CONFIG = SCM_CVMix_tests
SCM_L1_TEMP = 21.0
SCM_L2_TEMP = 18.0
SCM_L2_SALT = 35.5
SCM_TEMP_MLD = 40.0
SCM_SALT_MLD = 25.0
SCM_L2_DTDZ = 0.02
SCM_L2_DSDZ = -0.001
SCM_L2_MINTEMP = 5.0
""",
    "velocity_uniform_basin_builder": "TOPO_CONFIG = basin_builder\n"
    + BBUILDER + """VELOCITY_CONFIG = uniform
INITIAL_U_CONST = 0.3
INITIAL_V_CONST = -0.1
""",
    "velocity_circular_km": """TOPO_CONFIG = seamount
VELOCITY_CONFIG = circular
CIRCULAR_MAX_U = 0.5
""",
    "velocity_circular_degrees": """#override AXIS_UNITS = degrees
#override LENLON = 2.4
#override LENLAT = 2.0
SOUTHLAT = 30.0
VELOCITY_CONFIG = circular
CIRCULAR_MAX_U = 0.5
""",
    "sigma_shelfwave": """TOPO_CONFIG = shelfwave
MINIMUM_DEPTH = 20.0
SHELFWAVE_Y_LENGTH_SCALE = 90.0
THICKNESS_CONFIG = sigma
""",
    "neverworld_profile": """TOPO_CONFIG = neverworld
NL_CONTINENT_AMP = 0.7
THICKNESS_CONFIG = Neverworld
INIT_THICKNESS_PROFILE = 100.0, 200.0, 300.0, 400.0
NL_THICKNESS_PERT_AMP = 0.1
""",
    "dumbbell_family": """TOPO_CONFIG = dumbbell
DUMBBELL_LEN = 120.0
DUMBBELL_ROTATION = True
THICKNESS_CONFIG = dumbbell
TS_CONFIG = dumbbell
DUMBBELL_SREF = 34.0
DUMBBELL_S_RANGE = 2.0
""",
    "dense_water_family": """TOPO_CONFIG = dense_water
SHELF_DEPTH = 300.0
THICKNESS_CONFIG = dense_water
TS_CONFIG = dense_water
DELTA_S = 2.0
""",
    "rossby_front_family": """REENTRANT_X = True
THICKNESS_CONFIG = rossby_front
TS_CONFIG = rossby_front
""",
}


def _build_both(text):
    jm = j_build_model(JParamFile(text=text))
    pf = ParamFile(text=text)
    pm = build_model(pf, device="cpu", dtype=F64)
    assert pf.unused() == [], pf.unused()
    return jm, pm


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_builder_matches_jax(case):
    jm, pm = _build_both(SMALL + BUILDS[case])
    _check(jm.grid.bathyT, pm.grid.bathyT, "bathyT")
    for name in ("h", "u", "v", "T", "S"):
        _check(getattr(jm.state, name), getattr(pm.state, name), name)
    if case.startswith("velocity"):
        assert float(pm.state.u.abs().max()) > 0.0
        assert float(pm.state.v.abs().max()) > 0.0


# the three runs: seamount + sloshing (adiabatic, layered), DOME2D (Z*
# layers with its bay water) and ISOMIP (its bed, profile and a shelf)
RUNS = {
    "seamount_sloshing": """ENABLE_THERMODYNAMICS = False
ADIABATIC = True
TOPO_CONFIG = seamount
SEAMOUNT_HEIGHT = 500.0
THICKNESS_CONFIG = sloshing
SLOSHING_AMP = 30.0
""",
    "dome2d": """TOPO_CONFIG = DOME2D
THICKNESS_CONFIG = DOME2D
TS_CONFIG = DOME2D
DOME2D_SHELF_WIDTH = 0.2
INITIAL_SSS = 34.0
S_RANGE = 2.0
""",
    "isomip": """TOPO_CONFIG = isomip
TS_CONFIG = ISOMIP
ISOMIP_T_BOT = 1.0
ISOMIP_S_BOT = 34.7
ICE_SHELF = True
SHELF_MAX_THICKNESS = 300.0
""",
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_two_steps_match_jax(case):
    jm, pm = _build_both(SMALL + RUNS[case])
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
        want = getattr(jcur[0], name)
        if want is None:
            assert getattr(pcur[0], name) is None
            continue
        _check(np.asarray(want)[..., H:-H, H:-H],
               getattr(pcur[0], name)[..., H:-H, H:-H], name, 1e-9)
    for name in ("eta", "uh", "vh"):
        _check(np.asarray(getattr(jcur[1], name))[..., H:-H, H:-H],
               getattr(pcur[1], name)[..., H:-H, H:-H], name, 1e-9)
    assert float(pcur[0].u.abs().max()) > 0.0


def test_phillips_drivers_match_jax(tmp_path):
    """cases/phillips (its thermal-wind jet over a sloped interface in a
    reentrant channel) for 12 steps of 1800 s, ocean.stats every 3 (a
    MOM_override in each copy)."""
    dirs, runs = {}, {}
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for name, main in (("jax", jsolo.main), ("port", solo.main)):
            d = dirs[name] = tmp_path / name
            d.mkdir()
            (d / "MOM_input").write_text(
                (ROOT / "cases" / "phillips" / "MOM_input").read_text())
            (d / "MOM_override").write_text(
                "#override ENERGYSAVEDAYS = 0.0625\n")
            runs[name] = main([str(d), "--days", "0.25", "--cpu"])
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    _compare(_stats(dirs["port"] / "ocean.stats"),
             _stats(dirs["jax"] / "ocean.stats"), [0, 3, 6, 9, 12])
    assert float(runs["port"]["state"].u.abs().max()) > 0.1
