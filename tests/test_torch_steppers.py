"""mom6_torch against mom6_tpu: the split RK2b and unsplit steppers, and
the models, cases and restarts that run them.

* ``step_dyn_split_rk2b`` (BT_WIDE_HALO_PERIOD 1, kernel K3's path, on
  a closed basin) and ``step_dyn_unsplit`` (RK3 on a reentrant channel,
  RK2 on the basin): three steps from the same seeded numpy state, the
  RK2b state with nonzero increments so that the u_inst reconstruction
  acts from the first step; the JAX step under one jax.jit each, the
  port on device="cpu" in float64; h, u, v (and eta and the
  increments) agree to 1e-9 relative to each field's maximum on the
  compute domain.
* ``build_model`` of ``configs.BENCH_CONFIG_RK2B`` (a reentrant channel
  on the wide-halo march, BT_WIDE_HALO_PERIOD 2) and
  ``BENCH_CONFIG_UNSPLIT`` at 16x16x4 in their layered variant
  (USE_REGRIDDING = False; Z* ALE is held to the JAX package by
  tests/test_torch_full.py): the configurations carried across equal
  the port's own, and two steps of the port's ``Model.step_fn`` from a
  seeded perturbation, a dynamics-only one and a thermodynamic one,
  agree with the JAX model's to 1e-9.
* ``cases/ref_tc0`` through the port's ``build_model`` and ``step_fn``
  against ``tests/goldens_ref_cases.json`` at the tolerances of
  tests/test_ref_cases.py (through the port's solo driver, with its
  DEBUG and DIAG_AS_CHKSUM output: tests/test_torch_debug.py).
* ``cases/tc0`` through both packages' solo drivers for the first of
  its four days: ocean.stats agree (a live run of the JAX driver).
* An RK2b restart written by each package and read by the other.
* The configuration texts: each is ``BENCH_CONFIG`` plus exactly its
  lines.
"""

import dataclasses
import json
import pathlib
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import dynamics_split_rk2 as jrk2
from mom6_tpu.core import dynamics_split_rk2b as jrk2b
from mom6_tpu.core import dynamics_unsplit as junsplit
from mom6_tpu.core.barotropic import BarotropicCfg as JBarotropicCfg
from mom6_tpu.core.barotropic import set_dtbt as j_set_dtbt
from mom6_tpu.core.forcing import MechForcing as JMechForcing
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.vert_friction import VertViscCfg as JVertViscCfg
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.drivers import solo as jsolo
from mom6_tpu.framework import restart as jrestart
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.param.lateral.hor_visc import HorViscCfg as JHorViscCfg
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch import configs, convert
from mom6_torch.core.barotropic import BarotropicCfg
from mom6_torch.core.dynamics_split_rk2 import SplitCfg
from mom6_torch.core.dynamics_split_rk2b import (SplitBDynState,
                                                 step_dyn_split_rk2b)
from mom6_torch.core.dynamics_unsplit import UnsplitCfg, step_dyn_unsplit
from mom6_torch.core.forcing import MechForcing
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import VertViscCfg
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.diagnostics.sum_output import collect_stats, stat_sums
from mom6_torch.drivers import solo
from mom6_torch.framework import restart
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.param.lateral.hor_visc import HorViscCfg
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
NI, NJ, NK = 12, 10, 3
DT_SPLIT, DT_UNSPLIT = 600.0, 20.0
SMALL = (f"#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         f"#override NK = 4\n#override LENLON = 160.0\n"
         f"#override LENLAT = 160.0\n#override USE_REGRIDDING = False\n")


@pytest.fixture(scope="module", autouse=True)
def _quick_xla_compile():
    """Compile the JAX references with most XLA optimizations off: at
    this size their compile time is most of the test's time."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _close(ref, out, tol, name, H=4):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    if H:
        a, b = a[..., H:-H, H:-H], b[..., H:-H, H:-H]
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _setup(reentrant_x: bool, seed: int):
    """Both packages' domain, grid and vertical grid, and a seeded
    layered state (h = 1333 m +- 2 m, u, v ~ 0.05 m/s) as numpy."""
    kw = dict(ni=NI, nj=NJ, halo=4, reentrant_x=reentrant_x,
              reentrant_y=False)
    jd = JDomain(**kw)
    jg = j_cartesian_grid(jd, lenlon_km=NI * 10.0, lenlat_km=NJ * 10.0,
                          f0=1e-4, beta=2e-11, max_depth=4000.0)
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.005)
    td = Domain(**kw)
    tg = convert.grid_from_numpy(
        {f.name: np.asarray(getattr(jg, f.name))
         for f in dataclasses.fields(jg)
         if f.name != "domain" and getattr(jg, f.name) is not None},
        td, device="cpu", dtype=F64)
    tvg = VerticalGrid.uniform(nk=NK, gint=0.005, device="cpu", dtype=F64)
    rng = np.random.default_rng(seed)
    shape = (NK, jd.njh, jd.nih)

    def field(scale, offset=0.0, mask=1.0, s=shape):
        a = offset + scale * rng.standard_normal(s)
        return np.asarray(jd.fill_halos(jnp.asarray(a) * mask))

    st = dict(h=field(2.0, 4000.0 / NK), u=field(0.05, mask=jg.mask2dCu),
              v=field(0.05, mask=jg.mask2dCv))
    return (jd, jg, jvg), (td, tg, tvg), st, field


def _viscosities(dt):
    return (dict(kv=1e-4), dict(biharmonic=True, smag_bi_const=0.06, dt=dt))


# (name, reentrant x, stepper, barotropic period or unsplit scheme)
STEPPERS = [("rk2b_basin_period1", False, "rk2b", 1),
            ("unsplit_rk3_channel", True, "unsplit", "RK3"),
            ("unsplit_rk2_basin", False, "unsplit", "RK2")]


@pytest.mark.parametrize("name,reentrant_x,kind,opt", STEPPERS,
                         ids=[s[0] for s in STEPPERS])
def test_three_steps_match_jax(name, reentrant_x, kind, opt):
    (jd, jg, jvg), (td, tg, tvg), st, field = _setup(reentrant_x, seed=11)
    dt = DT_SPLIT if kind == "rk2b" else DT_UNSPLIT
    vv, hv = _viscosities(dt)
    jforces = JMechForcing(taux=0.1 * jg.mask2dCu)
    tforces = MechForcing(taux=_t(jforces.taux))
    jst = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    tst = State(**{k: _t(v) for k, v in st.items()})
    if kind == "rk2b":
        nstep = j_set_dtbt(jd, jg, jvg, JBarotropicCfg(), dt)
        jcfg = jrk2.SplitCfg(vertvisc=JVertViscCfg(**vv),
                             horvisc=JHorViscCfg(**hv),
                             barotropic=JBarotropicCfg(
                                 nstep=nstep, wide_halo_period=opt))
        tcfg = SplitCfg(vertvisc=VertViscCfg(**vv), horvisc=HorViscCfg(**hv),
                        barotropic=BarotropicCfg(nstep=nstep,
                                                 wide_halo_period=opt))
        sp = jrk2b.init_split_b_state(jd, jg, jvg, jst)
        # nonzero increments: u_inst differs from u_av from the start
        inc = dict(du_av_inst=field(0.01, mask=jg.mask2dCu, s=st["h"].shape[1:]),
                   dv_av_inst=field(0.01, mask=jg.mask2dCv, s=st["h"].shape[1:]),
                   eta=np.asarray(sp.eta))
        jsp = jrk2b.SplitBDynState(**{k: jnp.asarray(v)
                                      for k, v in inc.items()})
        tsp = convert.split_b_state_from_numpy(inc, device="cpu", dtype=F64)

        @jax.jit
        def jstep(s, p):
            s2, p2, _ = jrk2b.step_dyn_split_rk2b(jd, jg, jvg, s, p, jforces,
                                                  dt, jcfg)
            return s2, p2

        for _ in range(3):
            jst, jsp = jstep(jst, jsp)
            tst, tsp, _ = step_dyn_split_rk2b(td, tg, tvg, tst, tsp, tforces,
                                              dt, tcfg)
        for f in ("eta", "du_av_inst", "dv_av_inst"):
            _close(getattr(jsp, f), getattr(tsp, f), 1e-9, f)
    else:
        jcfg = junsplit.UnsplitCfg(vertvisc=JVertViscCfg(**vv),
                                   horvisc=JHorViscCfg(**hv), scheme=opt)
        tcfg = UnsplitCfg(vertvisc=VertViscCfg(**vv),
                          horvisc=HorViscCfg(**hv), scheme=opt)
        jstep = jax.jit(lambda s: junsplit.step_dyn_unsplit(
            jd, jg, jvg, s, jforces, dt, jcfg)[0])
        for _ in range(3):
            jst = jstep(jst)
            tst, _ = step_dyn_unsplit(td, tg, tvg, tst, tforces, dt, tcfg)
    for f in ("h", "u", "v"):
        _close(getattr(jst, f), getattr(tst, f), 1e-9, f)
    assert float(torch.abs(tst.u).max()) > 1e-3


# ---- the models of the two configuration texts ----------------------------

def _defaults(obj):
    base = type(obj)()
    return {f.name: _defaults(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(base, f.name) for f in dataclasses.fields(obj)}


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


@pytest.mark.parametrize("text", ["BENCH_CONFIG_RK2B", "BENCH_CONFIG_UNSPLIT"])
def test_model_two_steps_match_step_fn(text):
    base = getattr(configs, text)
    if text == "BENCH_CONFIG_RK2B":
        base += "BT_WIDE_HALO_PERIOD = 2\n"
    jm = j_build_model(JParamFile(text=base + SMALL))
    pm = build_model(ParamFile(text=base + SMALL), device="cpu", dtype=F64)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    assert (jm.dt, jm.dt_therm) == (pm.dt, pm.dt_therm)
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
    if text == "BENCH_CONFIG_RK2B":
        assert isinstance(pm.split, SplitBDynState)
        sp0 = jrk2b.init_split_b_state(d, g, jm.vgrid, st0)
    else:
        assert sp0 is None and pm.split is None and not pm.cfg.split
        with pytest.raises(ValueError, match="unsplit"):
            pm.reset_dtbt(pm.state)
    # a dynamics-only step, then a thermodynamic one (DT_THERM is 2 DT
    # in the RK2b text, 6 DT in the unsplit one)
    steps = [0, 1] if text == "BENCH_CONFIG_RK2B" else [4, 5]
    step_j = jm.step_fn()
    st, sp, tr = st0, sp0, jm.tracers
    for n in steps:
        st, sp, tr = step_j(st, sp, tr, n)
    pm = convert.model_with_state(
        pm, _arrays(st0), None if sp0 is None else _arrays(sp0),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step_p = pm.step_fn()
    pst, psp, ptr = pm.state, pm.split, pm.tracers
    for n in steps:
        pst, psp, ptr = step_p(pst, psp, ptr, n)
    for name in ("h", "u", "v", "T", "S"):
        _close(getattr(st, name), getattr(pst, name), 1e-9, name)
    _close(tr["age"], ptr["age"], 1e-9, "age")
    if sp is not None:
        for f in ("eta", "du_av_inst", "dv_av_inst"):
            _close(getattr(sp, f), getattr(psp, f), 1e-9, f)
    assert float(np.abs(np.asarray(st.u)).max()) > 0.0


def test_config_texts_are_bench_config_plus_their_lines():
    assert configs.BENCH_CONFIG_RK2B == (configs.BENCH_CONFIG
                                         + "SPLIT_RK2B = True\n")
    assert configs.BENCH_CONFIG_UNSPLIT == (
        configs.BENCH_CONFIG + "SPLIT = False\n#override DT = 20.0\n"
        "#override DT_THERM = 120.0\n")
    assert "BT_" not in configs.BENCH_CONFIG_UNSPLIT


# ---- cases -----------------------------------------------------------------

def test_ref_tc0_matches_golden():
    """ref_tc0 (unsplit RK3, SIMPLE_2ND_PPM_CONTINUITY, BOTTOMDRAGLAW =
    False, USE_LAND_MASK_FOR_HVISC = False, a cartesian grid in degrees)
    through the port's build_model and step_fn, ocean.stats against its
    golden (tests/test_torch_debug.py runs it through the driver, with
    its DEBUG and DIAG_AS_CHKSUM output)."""
    golden = json.loads((ROOT / "tests" / "goldens_ref_cases.json")
                        .read_text())["ref_tc0"]
    case = ROOT / "cases" / "ref_tc0"
    m = build_model(ParamFile(str(case / "MOM_input"),
                              str(case / "MOM_override")),
                    device="cpu", dtype=F64)
    assert not m.cfg.split and m.cfg.unsplit_cfg.continuity.simple_2nd
    step = m.step_fn()
    s, a, tr = m.state, m.split, m.tracers
    for n in range(golden["nsteps"]):
        s, a, tr = step(s, a, tr, n)
    st = collect_stats(stat_sums(m.domain, m.grid, m.vgrid, s, m.dt),
                       m.vgrid, golden["nsteps"], 0.0)
    assert bool(torch.isfinite(m.domain.interior(s.h)).all())
    np.testing.assert_allclose(st.energy_per_mass,
                               golden["energy_per_mass"], rtol=1e-9)
    np.testing.assert_allclose(st.total_mass, golden["mass"], rtol=1e-11)
    np.testing.assert_allclose(st.mean_salin, golden["salt"], atol=1e-9)
    np.testing.assert_allclose(st.mean_temp, golden["temp"], rtol=1e-9)
    np.testing.assert_allclose(st.max_cfl, golden["max_cfl"], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(st.mean_sea_level, golden["sea_level"],
                               rtol=1e-6, atol=1e-12)


def _stats(path):
    rows = []
    for line in path.read_text().splitlines()[2:]:
        step, day, truncs, *rest = [c.strip() for c in line.split(",")]
        rows.append((int(step), int(truncs),
                     {k: float(v) for k, v in (c.split(None, 1)
                                               for c in rest)}))
    return rows


def test_tc0_drivers_agree(tmp_path):
    """cases/tc0 (4x4x1, unsplit, adiabatic) through the port's solo
    driver and the JAX package's for 1 day (1 step), each on a copy of
    the case: every
    ocean.stats line agrees (En and CFL to 1e-9 relative, the
    roundoff-sized SL and Me to 1e-12 absolute)."""
    dirs = {}
    for pkg in ("jax", "torch"):
        dirs[pkg] = tmp_path / pkg
        dirs[pkg].mkdir()
        shutil.copy(ROOT / "cases" / "tc0" / "MOM_input", dirs[pkg])
    jsolo.main([str(dirs["jax"]), "--cpu", "--days", "1"])
    run = solo.main([str(dirs["torch"]), "--cpu", "--days", "1"])
    assert run["split"] is None and run["nstep_bt"] == [None]
    want, got = (_stats(dirs[p] / "ocean.stats") for p in ("jax", "torch"))
    assert [r[:2] for r in got] == [r[:2] for r in want] and len(got) == 2
    for (step, _, w), (_, _, g) in zip(want, got):
        for k, a in w.items():
            if k in ("SL", "Me"):
                assert abs(g[k] - a) <= 1e-12, (step, k, g[k], a)
            else:
                assert abs(g[k] - a) <= 1e-9 * abs(a), (step, k, g[k], a)
    # the port's restart of an unsplit model holds no split state
    saved = json.loads((dirs["torch"] / "RESTART" / "MOM.res.json")
                       .read_text())["trees"]
    assert saved["split"] == {"keys": [], "treedef": "PyTreeDef(None)"}


def test_rk2b_restart_across_packages(tmp_path):
    """An RK2b split state written by either package restores in the
    other, field for field."""
    rng = np.random.default_rng(2)
    arrays = {k: rng.standard_normal((6, 7))
              for k in ("du_av_inst", "dv_av_inst", "eta")}
    jsp = jrk2b.SplitBDynState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()})
    tsp = convert.split_b_state_from_numpy(arrays, device="cpu", dtype=F64)
    tpl_t = convert.split_b_state_from_numpy(
        {k: 0 * v for k, v in arrays.items()}, device="cpu", dtype=F64)
    tpl_j = jrk2b.SplitBDynState(**{k: jnp.zeros((6, 7)) for k in arrays})
    jrestart.save_restart(str(tmp_path / "j" / "MOM.res"), {"split": jsp},
                          meta={"step": 3})
    restart.save_restart(str(tmp_path / "t" / "MOM.res"), {"split": tsp},
                         meta={"step": 3})
    trees, meta = restart.restore_restart(str(tmp_path / "j" / "MOM.res"),
                                          {"split": tpl_t})
    assert isinstance(trees["split"], SplitBDynState) and meta["step"] == 3
    jtrees, _ = jrestart.restore_restart(str(tmp_path / "t" / "MOM.res"),
                                         {"split": tpl_j})
    for k, v in arrays.items():
        np.testing.assert_array_equal(trees["split"].__dict__[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(getattr(jtrees["split"], k)),
                                      v)
    for sub in ("j", "t"):
        manifest = json.loads((tmp_path / sub / "MOM.res.json").read_text())
        assert manifest["trees"]["split"]["treedef"] == \
            "PyTreeDef(CustomNode(SplitBDynState[()], [*, *, *]))"
