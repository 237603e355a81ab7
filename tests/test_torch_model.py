"""mom6_torch against mom6_tpu: the MOM_input parser, the model builder,
the reproducing sums and the ocean.stats sums.

* ``ParamFile`` reads every ``cases/*/MOM_input`` (with its
  ``MOM_override``) and bench.py's CONFIG to the same raw values and
  #override results as the JAX package's.
* ``configs.BENCH_CONFIG`` is bench.py's CONFIG, character for
  character.
* ``model.build_model`` against ``mom6_tpu.model.build_model`` on
  bench.py's CONFIG at 16x16x4 (with ALE and layered, BT_WIDE_HALO_PERIOD
  1 and 2) and on ``cases/double_gyre/MOM_input``: every configuration
  value carried over by ``convert.config_from_values`` equals the
  port's own, every initial field agrees to 1e-13 relative to its
  maximum.
* Options outside the slice raise ``NotImplementedError`` naming them.
* ``efp_sum``/``efp_sum_layers`` limbs are bitwise the JAX package's on
  seeded float64 arrays with both signs, tiny and huge values.
* ``stat_sums`` + ``collect_stats`` on the same state (depth list on, a
  bowl topography) agree field by field to 1e-12 relative, and the
  table's header and lines format to the same bytes.
"""

import dataclasses
import gc
import importlib.util
import pathlib
import weakref

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.diagnostics import sum_output as jsum
from mom6_tpu.diagnostics.depth_list import depth_list_setup as jdepth_list
from mom6_tpu.framework import efp as jefp
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as jbuild_model

from mom6_torch import convert
from mom6_torch.configs import BENCH_CONFIG
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.diagnostics import sum_output as psum
from mom6_torch.diagnostics.depth_list import depth_list_setup
from mom6_torch.framework import efp as pefp
from mom6_torch.framework.clock import ClockRegistry
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = sorted(p.parent for p in (ROOT / "cases").glob("*/MOM_input"))
DOUBLE_GYRE = (ROOT / "cases" / "double_gyre" / "MOM_input").read_text()
SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n#override LENLON = 160.0\n"
         "#override LENLAT = 160.0\n")


def _bench_config():
    spec = importlib.util.spec_from_file_location("_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CONFIG


def _sources(case):
    src = [str(case / "MOM_input")]
    if (case / "MOM_override").exists():
        src.append(str(case / "MOM_override"))
    return src


def _parsed(cls, *sources, text=None):
    try:
        pf = cls(*sources, text=text)
    except ValueError as e:
        return ("ValueError", str(e))
    keys = sorted(set(pf._plain) | set(pf._over))
    return {k: pf.raw(k) for k in keys}, dict(pf._over)


@pytest.mark.parametrize("case", CASES + ["bench"],
                         ids=lambda c: c if isinstance(c, str) else c.name)
def test_paramfile_matches_jax(case):
    if case == "bench":
        args, text = (), _bench_config()
    else:
        args, text = _sources(case), None
    want = _parsed(JParamFile, *args, text=text)
    got = _parsed(ParamFile, *args, text=text)
    assert got == want


def test_bench_config_is_bench_py_config():
    assert BENCH_CONFIG == _bench_config()


# ---- build_model --------------------------------------------------------

BUILDS = {
    "bench_ale_p1": BENCH_CONFIG + SMALL,
    "bench_ale_p2": BENCH_CONFIG + "BT_WIDE_HALO_PERIOD = 2\n" + SMALL,
    "bench_layered_p1": BENCH_CONFIG + SMALL
    + "#override USE_REGRIDDING = False\n",
    "bench_layered_p2": BENCH_CONFIG + "BT_WIDE_HALO_PERIOD = 2\n" + SMALL
    + "#override USE_REGRIDDING = False\n",
    "double_gyre": DOUBLE_GYRE,
}


def _defaults(obj):
    """Nested dict of the JAX config class defaults, following the
    configuration's own nested config objects."""
    base = type(obj)()
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _defaults(v) if dataclasses.is_dataclass(v) \
            else getattr(base, f.name)
    return out


def _close(ref, out, tol, name):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_model_matches_jax(name):
    text = BUILDS[name]
    jm = jbuild_model(JParamFile(text=text))
    pm = build_model(ParamFile(text=text), device="cpu", dtype=F64)
    # configuration
    assert convert.config_from_values(
        OceanCfg, dataclasses.asdict(jm.ocean_cfg),
        _defaults(jm.ocean_cfg)) == pm.cfg
    assert jm.split_cfg.barotropic.nstep == pm.cfg.split_cfg.barotropic.nstep
    assert (jm.dt, jm.dt_therm, jm.dt_forcing, jm.daymax, jm.thermo) == (
        pm.dt, pm.dt_therm, pm.dt_forcing, pm.daymax, pm.thermo)
    assert (jm.eos is None) == (pm.eos is None)
    if jm.eos is not None:
        assert (jm.eos.name, jm.eos.variant) == (pm.eos.name,
                                                 pm.eos.variant)
    for k in ("ni", "nj", "halo", "reentrant_x", "reentrant_y"):
        assert getattr(jm.domain, k) == getattr(pm.domain, k), k
    for k in ("nk", "g_Earth", "Rho0", "boussinesq", "angstrom"):
        assert getattr(jm.vgrid, k) == getattr(pm.vgrid, k), k
    if jm.fluxes_fn is None:
        assert pm.fluxes(pm.state) is None
    else:
        fcfg, _, south, lenlat = jm.fluxes_fn.__defaults__
        assert dataclasses.asdict(fcfg) == dataclasses.asdict(pm.forcing_cfg)
        assert (south, lenlat) == (pm.south, pm.lenlat)
        _close(jm.fluxes_fn(jm.state, 0.0).sensible,
               pm.fluxes(pm.state).sensible, 1e-13, "fluxes.sensible")
    assert (jm.tracer_registry.names() if jm.tracers else []) \
        == pm.registry.names()
    # fields
    for f in dataclasses.fields(pm.grid):
        v = getattr(pm.grid, f.name)
        if torch.is_tensor(v):
            _close(getattr(jm.grid, f.name), v, 1e-13, f"grid.{f.name}")
    _close(jm.vgrid.Rlay, pm.vgrid.Rlay, 1e-13, "Rlay")
    _close(jm.vgrid.g_prime, pm.vgrid.g_prime, 1e-13, "g_prime")
    for k in ("taux", "tauy"):
        a, b = getattr(jm.forces, k), getattr(pm.forces, k)
        assert (a is None) == (b is None), k
        if a is not None:
            _close(a, b, 1e-13, k)
    for k in ("u", "v", "h", "T", "S"):
        a, b = getattr(jm.state, k), getattr(pm.state, k)
        assert (a is None) == (b is None), k
        if a is not None:
            _close(a, b, 1e-13, f"state.{k}")
    for f in dataclasses.fields(pm.split):
        _close(getattr(jm.split_state, f.name), getattr(pm.split, f.name),
               1e-13, f"split.{f.name}")
    assert sorted(jm.tracers or {}) == sorted(pm.tracers or {})
    for k in pm.tracers or {}:
        _close(jm.tracers[k], pm.tracers[k], 1e-13, k)


# spherical grids and the bulk mixed layer, once cases here, are ported
# (tests/test_torch_breadth3.py, test_torch_layered.py), and so are
# USE_MEKE, USE_VISBECK, the benchmark topography and INTERNAL_TIDES
# (tests/test_torch_breadth4.py), and the TEOS10 and UNESCO equations of
# state and the ADAPTIVE coordinate (tests/test_torch_eos_forms.py,
# test_torch_hybgen.py), and the mosaic grid and the sponges
# (tests/test_torch_breadth9.py), and the tracer packages, COORD_CONFIG
# layer_ref and THICKNESS_CONFIG circle_obcs (tests/test_torch_bgc.py,
# test_torch_ref_tc3.py), and ICE_SHELF, THICKNESS_CONFIG phillips and
# sloshing and TOPO_CONFIG seamount (tests/test_torch_ice_shelf.py,
# test_torch_user_configs.py), and the wind and buoyancy configurations,
# WIND_STAGGER A and COORD_CONFIG BFB (tests/test_torch_breadth10.py, and
# test_ported_options_build below): their cases now name options still
# refused, the multi-device ones and PHASED_JIT
@pytest.mark.parametrize("line,name", [
    ("TRIPOLAR_N = True", "TRIPOLAR_N"),
    ('MASKTABLE = "mask_table.2.4x4"', "MASKTABLE"),
    ("AUTO_MASKTABLE = True", "AUTO_MASKTABLE"),
    ("PHASED_JIT = True", "PHASED_JIT"),
])
def test_options_outside_the_slice_raise(line, name):
    pf = ParamFile(text=BENCH_CONFIG + SMALL + line + "\n")
    with pytest.raises(NotImplementedError, match=name):
        build_model(pf, device="cpu", dtype=F64)


# options that this test's list above refused until they were ported:
# each builds and reads its parameters
@pytest.mark.parametrize("lines,names", [
    ("#override WIND_CONFIG = dumbbell\n#override BUOY_CONFIG = dumbbell\n"
     "DUMBBELL_SLP_AMP = 500.0", ("DUMBBELL_SLP_AMP", "INITIAL_S_RANGE")),
    ("#override WIND_CONFIG = ideal_hurr\nIDL_HURR_X0 = 8.0e4",
     ("IDL_HURR_X0", "IDL_HURR_RAD_MAX_WIND")),
    ("#override BUOY_CONFIG = SCM_CVMix_tests\nSCM_USE_HEAT_FLUX = True\n"
     "SCM_HEAT_FLUX = 1.0e-5", ("SCM_HEAT_FLUX", "SCM_USE_DIURNAL_SW")),
    ("#override WIND_CONFIG = SCM_CVMix_tests\nSCM_TAU_X = 0.05",
     ("SCM_TAU_X", "SCM_USE_WIND_STRESS")),
    ("#override BUOY_CONFIG = const_heat\nSENSIBLE_HEAT_FLUX = -20.0",
     ("SENSIBLE_HEAT_FLUX",)),
    ("#override BUOY_CONFIG = BFB\nLFR_NLAT = 100.0",
     ("LFR_NLAT", "SST_S")),
    ("COORD_CONFIG = BFB\nT_BOT = 3.0", ("T_BOT", "S_REF")),
    ("#override WIND_CONFIG = file\nWIND_FILE = wind.nc\nWIND_STAGGER = A",
     ("WIND_STAGGER", "WIND_FILE")),
], ids=["buoy_dumbbell", "wind_ideal_hurr", "buoy_scm", "wind_scm",
        "buoy_const_heat", "buoy_bfb", "coord_bfb", "wind_stagger_a"])
def test_ported_options_build(lines, names, tmp_path):
    from mom6_torch.framework.io import write_fields
    write_fields(str(tmp_path / "wind.nc"),
                 {"STRESS_X": np.full((16, 16), 0.05),
                  "STRESS_Y": np.zeros((16, 16))},
                 dims={"STRESS_X": ("ny", "nx"), "STRESS_Y": ("ny", "nx")})
    pf = ParamFile(text=BENCH_CONFIG + SMALL + lines
                   + f"\nINPUTDIR = {tmp_path}\n")
    m = build_model(pf, device="cpu", dtype=F64)
    assert pf.unused() == []
    assert all(n in pf._doc for n in names)
    fc, fl = m.forcing(m.state, 300.0, True)
    assert fl is not None
    assert all(torch.isfinite(x).all() for x in (fc.taux, fc.tauy, fc.p_surf)
               if x is not None)


# ---- reproducing sums ------------------------------------------------------

def _efp_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 9, 11)) * 10.0 ** rng.uniform(-30, 20,
                                                              (3, 9, 11))
    x[0, 0, :4] = [1e-300, -1e-300, 5e-324, -0.0]
    x[1, 2, :3] = [2.0 ** 74, -(2.0 ** 74), 3.0e22]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_efp_limbs_bitwise(seed):
    x = _efp_inputs(seed)
    mask = (np.random.default_rng(seed + 10).random(x.shape) > 0.3) * 1.0
    want = np.asarray(jefp.efp_sum(jnp.asarray(x)))
    got = pefp.efp_sum(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jefp.efp_sum(jnp.asarray(x), jnp.asarray(mask)))
    got = pefp.efp_sum(torch.as_tensor(x), torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jefp.efp_sum_layers(jnp.asarray(x)))
    got = pefp.efp_sum_layers(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert pefp.efp_to_float(got[:, 0]) == jefp.efp_to_float(want[:, 0])
    np.testing.assert_array_equal(
        pefp.efp_limbs_to_float_ingraph(torch.as_tensor(got)).numpy(),
        np.asarray(jefp.efp_limbs_to_float_ingraph(jnp.asarray(want))))


# ---- ocean.stats sums ------------------------------------------------------

STATS_CASES = {
    "double_gyre_bowl": DOUBLE_GYRE + "#override TOPO_CONFIG = bowl\n"
    "MINIMUM_DEPTH = 100.0\n",
    "bench_layered": BENCH_CONFIG + SMALL
    + "#override USE_REGRIDDING = False\n",
}


@pytest.mark.parametrize("name", list(STATS_CASES))
def test_stats_match_jax(name):
    jm = jbuild_model(JParamFile(text=STATS_CASES[name]))
    d, g = jm.domain, jm.grid
    rng = np.random.default_rng(5)

    def pert(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(np.shape(a))
        return np.asarray(d.fill_halos(jnp.asarray(a) * mask))

    arrays = {"h": np.maximum(pert(jm.state.h, 1.0), 1e-3),
              "u": pert(jm.state.u, 0.1, g.mask2dCu),
              "v": pert(jm.state.v, 0.1, g.mask2dCv)}
    if jm.state.T is not None:
        arrays.update(T=pert(jm.state.T, 0.5), S=pert(jm.state.S, 0.1))
    jstate = dataclasses.replace(jm.state, **{k: jnp.asarray(v)
                                              for k, v in arrays.items()})
    want = jsum.collect_stats(
        jsum.stat_sums(d, g, jm.vgrid, jstate, jm.dt, jdepth_list(d, g)),
        jm.vgrid, 7, 0.5, truncs=3)

    pm = build_model(ParamFile(text=STATS_CASES[name]), device="cpu",
                     dtype=F64)
    pg = convert.grid_from_numpy(
        {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)
         if f.name != "domain" and getattr(g, f.name) is not None},
        pm.domain, device="cpu", dtype=F64)
    pm = convert.model_with_state(
        pm, arrays, split={f.name: np.asarray(getattr(jm.split_state, f.name))
                           for f in dataclasses.fields(jm.split_state)},
        tracers={k: np.asarray(v) for k, v in (jm.tracers or {}).items()})
    assert torch.equal(pm.split.eta, torch.as_tensor(
        np.asarray(jm.split_state.eta)))
    got = psum.collect_stats(
        psum.stat_sums(pm.domain, pg, pm.vgrid, pm.state, pm.dt,
                       depth_list_setup(pm.domain, pg)),
        pm.vgrid, 7, 0.5, truncs=3)
    assert want.h0 is not None and got.h0 is not None
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert abs(a - b) <= 1e-12 * max(abs(a), 1e-300), \
            f"{f.name}: {b!r} != {a!r}"
    assert psum.format_stats_header() == jsum.format_stats_header()
    mass0 = want.total_mass * (1 + 1e-9)
    assert psum.format_stats_line(want, mass0) \
        == jsum.format_stats_line(want, mass0)


# ---- step_fn carries -------------------------------------------------------

@pytest.fixture(scope="module")
def layered_model():
    return build_model(ParamFile(text=BUILDS["bench_layered_p1"]),
                       device="cpu", dtype=F64)


@pytest.mark.parametrize("reuse", [True, False], ids=["memo", "fresh"])
def test_carry_survives_a_revisit(layered_model, reuse):
    """DTBT_RESET_PERIOD's nstep -> nstep + 1 -> nstep: the driver hands
    one closure's carry to a new closure and later back to the first
    (``reuse``, the driver's memo) or to a fresh one; both go on from
    the second closure's accumulators, and no closure shares them."""
    m = layered_model
    first = m.step_fn()
    nstep = first.nstep_bt
    cur = first(m.state, m.split, m.tracers, 0)   # transports accumulate
    second = m.step_fn(nstep_bt=nstep + 1, carry=first.carry())
    assert second.nstep_bt == nstep + 1
    cur = second(*cur, 1)                         # thermodynamic step
    cur = second(*cur, 2)
    acc = second.carry()
    assert acc["u"] is not None and acc["mld"] is not None
    if reuse:
        first.set_carry(acc)
        back = first
    else:
        back = m.step_fn(carry=acc)
    got = back.carry()
    assert got.keys() == acc.keys()
    assert all(got[k] is acc[k] for k in acc)
    assert back.truncations() == second.truncations()
    st, sp, tr = back(*cur, 3)
    assert torch.isfinite(st.h).all()
    # the thermodynamic step closed the interval in ``back`` only
    assert back.carry()["u"] is None and second.carry()["u"] is acc["u"]
    if reuse:
        fresh = m.step_fn(carry=acc)
        want = fresh(*cur, 3)
        for a, b in zip((st, sp), want[:2]):
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                assert (x is None) == (y is None), f.name
                if x is not None:
                    assert torch.equal(x, y), f.name


def test_step_closure_frees_without_the_cycle_collector(layered_model):
    """A step closure and what it holds (the model's accumulators) go
    when its last reference goes, without waiting for the cycle
    collector: a closure that referred to itself would keep a finished
    run's fields allocated into the next run."""
    m = layered_model
    step = m.step_fn()
    step(m.state, m.split, m.tracers, 0)
    ref = weakref.ref(step)
    gc.disable()
    try:
        del step
        assert ref() is None
    finally:
        gc.enable()


def test_clock_counts_and_rejects_what_it_cannot_sync(layered_model):
    """The clock's ``sync=`` takes tensors (or nests of them); anything
    else, such as a State, raises instead of silently timing launches
    only."""
    reg = ClockRegistry()
    st = layered_model.state
    for _ in range(2):
        with reg("step", sync=lambda: st.h):
            pass
    with reg("tracers", sync=lambda: {"h": st.h, "none": None}):
        pass
    with pytest.raises(TypeError, match="State"):
        with reg("bad", sync=lambda: st):
            pass
    rows = {line.split()[0]: line.split()[1]
            for line in reg.report().splitlines()[1:]}
    assert rows == {"step": "2", "tracers": "1", "bad": "1"}
    assert reg._stack == []
