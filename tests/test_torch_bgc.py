"""mom6_torch against mom6_tpu: the tracer packages and the BGC coupling
of the seventh breadth item, in float64 on the CPU, each fed the same
numpy inputs from a seed (the JAX functions called eagerly).

* The ideal packages (age, pseudo-salt, a regional dye, the DOME dyes, a
  boundary impulse, oil, the advection-test shapes) and the standalone
  CFCs, built by both builders from one MOM_input at 12x10x4: their
  initial fields, then their column functions on a seeded state inside
  and after the impulse's window.
* The gas fluxes: ``cfc_surface_flux`` and ``GasSpec.flux`` of the O2,
  CO2 and CFC specs.
* ``BGCForcingSources.at`` with a constant and a monthly file on a
  360-day modulo axis; ``RestoringData.tendencies`` with 7 file levels
  onto 4 layers.
* ``BGCCoupler.column_physics`` built by ``build_bgc_coupler`` from the
  files of ``configs.write_bgc_inputs`` with every channel on (rivers,
  dust, ndep, the sediment iron, restoring, the sinking POC, the ice
  fraction) and a ``gas_fields`` override on the fluxes: once with the
  shortwave's light, once through the implicit vertical diffusion.
* NPZD through the coupler and through its own ``column_physics``; the
  ValueError of a tracer two packages declare.
* ``step_offline`` on seeded transports, both sweep orders.
* The offline round trip of tests/test_offline_driver.py's case (with
  the dye in a box, so that it moves) through the port's driver: the
  online run's offline files and final dye equal the JAX driver's, the
  offline dye equals the online dye to roundoff and its content is
  conserved.

Tolerance 1e-12, relative to each field's largest value.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core.forcing import Fluxes as JFluxes
from mom6_tpu.core.state import State as JState
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.tracer import bgc_interface as jbgc
from mom6_tpu.tracer import cfc as jcfc
from mom6_tpu.tracer import marbl_driver as jmd
from mom6_tpu.tracer import offline as joff
from mom6_tpu.tracer.registry import TracerRegistry as JRegistry

from mom6_torch import configs
from mom6_torch.core.forcing import Fluxes
from mom6_torch.core.state import State
from mom6_torch.framework.config import ParamFile
from mom6_torch.framework.io import write_fields
from mom6_torch.model import build_model
from mom6_torch.tracer import bgc_interface as tbgc
from mom6_torch.tracer import cfc as tcfc
from mom6_torch.tracer import marbl_driver as tmd
from mom6_torch.tracer import offline as toff
from mom6_torch.tracer.registry import TracerRegistry

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, NK = 12, 10, 4
TOL = 1e-12

BASE = f"""NIGLOBAL = {NI}
NJGLOBAL = {NJ}
NK = {NK}
DT = 600.0
DT_THERM = 1200.0
GRID_CONFIG = cartesian
AXIS_UNITS = k
LENLON = 120.0
LENLAT = 100.0
REENTRANT_X = True
TOPO_CONFIG = flat
MAXIMUM_DEPTH = 800.0
F_0 = 1.0e-4
TS_CONFIG = linear
T_RANGE = 12.0
"""
IDEAL = """USE_IDEAL_AGE_TRACER = True
USE_PSEUDO_SALT_TRACER = True
USE_REGIONAL_DYES = True
DYE_SOURCE_MINLON = 30.0
DYE_SOURCE_MAXLON = 70.0
DYE_SOURCE_MINLAT = 20.0
DYE_SOURCE_MAXLAT = 60.0
USE_DOME_TRACER = True
USE_BOUNDARY_IMPULSE_TRACER = True
IMPULSE_SOURCE_TIME = 5000.0
USE_OIL_TRACER = True
OIL_SOURCE_LONGITUDE = 55.0
OIL_SOURCE_LATITUDE = 45.0
OIL_SOURCE_LAYER = 1
OIL_SOURCE_RATE = 2.0
OIL_DECAY_DAYS = 3.0
USE_ADVECTION_TEST_TRACER = True
ADVECTION_TEST_X_ORIGIN = 60.0
ADVECTION_TEST_Y_ORIGIN = 50.0
ADVECTION_TEST_X_WIDTH = 30.0
ADVECTION_TEST_Y_WIDTH = 25.0
USE_OCMIP2_CFC = True
CFC_EXCHANGE_WIND = 9.0
"""


def _np(a):
    return a.detach().double().numpy() if torch.is_tensor(a) \
        else np.asarray(a, np.float64)


def _check(ref, out, name, tol=TOL):
    a, b = _np(ref), _np(out)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


def _jitted(fn, *args):
    """``fn(*args)`` under one jax.jit with most XLA optimizations off:
    eagerly, the remap inside compiles each of its operations."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return jax.jit(fn)(*args)
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


def _build(tmp, extra=""):
    """(JAX model, port model) of BASE + extra, with INPUTDIR ``tmp``."""
    path = os.path.join(tmp, "MOM_input")
    with open(path, "w") as f:
        f.write(BASE + extra + f"INPUTDIR = {tmp}\n")
    return (j_build_model(JParamFile(path)),
            build_model(ParamFile(path), device="cpu", dtype=F64))


@pytest.fixture(scope="module")
def ideal(tmp_path_factory):
    return _build(str(tmp_path_factory.mktemp("ideal")), IDEAL)


@pytest.fixture(scope="module")
def bgc_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bgc"))
    configs.write_bgc_inputs(d, NI, NJ, seed=3)
    return d


@pytest.fixture(scope="module")
def column():
    """A seeded state on the fixtures' shape: h, T, S, a shortwave and
    interface diffusivities."""
    rng = np.random.default_rng(17)
    shape = (NK, NJ + 8, NI + 8)
    return dict(h=rng.uniform(20.0, 300.0, shape),
                T=rng.uniform(0.0, 28.0, shape),
                S=rng.uniform(32.0, 37.0, shape),
                sw=rng.uniform(0.0, 300.0, shape[1:]),
                kd=rng.uniform(1e-5, 1e-2, (NK + 1,) + shape[1:]),
                salt=rng.uniform(-1e-6, 1e-6, shape[1:]))


def test_ideal_packages_match_jax(ideal, column):
    jm, pm = ideal
    assert list(pm.tracers) == list(jm.tracers) == [
        "age", "pseudo_salt", "dye1", "dome_dye1", "dome_dye2",
        "boundary_impulse", "oil1", "tr_cyl", "tr_bell", "cfc11", "cfc12"]
    for k, v in jm.tracers.items():
        _check(v, pm.tracers[k], f"initial {k}", tol=0.0)
    assert float(pm.tracers["dye1"].sum()) > 0.0
    assert float(pm.tracers["tr_bell"].max()) > 0.5
    rng = np.random.default_rng(5)
    trs = {k: rng.uniform(0.0, 1.0, v.shape) for k, v in jm.tracers.items()}
    c = column
    js = JState(u=jnp.zeros(c["h"].shape), v=jnp.zeros(c["h"].shape),
                h=jnp.asarray(c["h"]), T=jnp.asarray(c["T"]),
                S=jnp.asarray(c["S"]))
    ps = State(u=_t(np.zeros(c["h"].shape)), v=_t(np.zeros(c["h"].shape)),
               h=_t(c["h"]), T=_t(c["T"]), S=_t(c["S"]))
    for t in (1800.0, 9000.0, None):
        jout = jm.tracer_registry.apply_column_fns(
            {k: jnp.asarray(v) for k, v in trs.items()}, js.h, 1200.0,
            state=js, t=None if t is None else jnp.asarray(t))
        pout = pm.registry.apply_column_fns(
            {k: _t(v) for k, v in trs.items()}, ps.h, 1200.0, state=ps, t=t)
        for k in trs:
            _check(jout[k], pout[k], f"{k} after its column function, t={t}")
    # the impulse's window and the oil source
    assert float(pout["boundary_impulse"][0].min()) == 1.0
    decayed = _t(trs["oil1"]) * np.exp(-1200.0 / (3.0 * 86400.0))
    assert int(((pout["oil1"] - decayed).abs() > 1e-12).sum()) == 1


def test_gas_fluxes_match_jax(column):
    rng = np.random.default_rng(8)
    shape = column["sw"].shape
    T, S = column["T"][0], column["S"][0]
    c = rng.uniform(0.0, 300.0, shape)
    u10 = rng.uniform(0.0, 15.0, shape)
    patm = rng.uniform(1e-10, 0.3, shape)
    open_frac = rng.uniform(0.0, 1.0, shape)
    for gas in ("CFC11", "CFC12"):
        jc, pc = jcfc.CFCCfg(gas=gas), tcfc.CFCCfg(gas=gas)
        _check(jcfc.cfc_surface_flux(jc, c * 1e-9, T, S, 7.5, 270e-12),
               tcfc.cfc_surface_flux(pc, _t(c * 1e-9), _t(T), _t(S), 7.5,
                                     270e-12), f"cfc_surface_flux {gas}")
        _check(jcfc.cfc_solubility(gas, T, S),
               tcfc.cfc_solubility(gas, _t(T), _t(S)), f"solubility {gas}")
    jspecs = list(jmd.MARBLBaseBioPackage().specs()) \
        + list(jmd.CFCPackage().specs())
    pspecs = list(tmd.MARBLBaseBioPackage().specs()) \
        + list(tmd.CFCPackage().specs())
    gases = [(j, p) for j, p in zip(jspecs, pspecs) if j.gas is not None]
    assert [p.name for _, p in gases] == ["dic", "o2", "cfc11", "cfc12"]
    for j, p in gases:
        assert p.gas.schmidt == j.gas.schmidt
        assert p.gas.atm_field == j.gas.atm_field
        _check(j.gas.flux(c, T, S, u10, patm, open_frac),
               p.gas.flux(_t(c), _t(T), _t(S), _t(u10), _t(patm),
                          _t(open_frac)), f"GasSpec.flux {p.name}")


def test_forcing_sources_match_jax(ideal, tmp_path):
    jm, pm = ideal
    rng = np.random.default_rng(2)
    rec = rng.uniform(0.0, 1e-4, (12, NJ, NI))
    path = str(tmp_path / "monthly.nc")
    write_fields(path, {"time": 30.0 * np.arange(12) + 15.0, "flux": rec},
                 dims={"time": ("time",), "flux": ("time", "ny", "nx")},
                 attrs={"time": {"units": "days since 0001-01-01",
                                 "modulo": "360"}})
    js = jmd.BGCForcingSources(u10=6.5, ice_frac=0.25)
    ps = tmd.BGCForcingSources(u10=6.5, ice_frac=0.25)
    js.add("const", 3.0e-7)
    ps.add("const", 3.0e-7)
    js.add_file("monthly", path, "flux", jm.grid, scale=2.0)
    ps.add_file("monthly", path, "flux", pm.grid, scale=2.0)
    like = np.zeros((NJ + 8, NI + 8))
    for t in (0.0, 3.3e6, 2.0e7, 3.2e7):
        jf = js.at(jnp.asarray(t), jnp.asarray(like))
        pf = ps.at(t, _t(like))
        _check(jf.u10, pf.u10, "u10")
        _check(jf.open_frac, pf.open_frac, "open_frac")
        for k in ("const", "monthly"):
            _check(jf.fields[k], pf.fields[k], f"{k} at t={t}")


def test_restoring_matches_jax(column):
    rng = np.random.default_rng(4)
    nz = 7
    shape = (nz,) + column["sw"].shape
    dz = rng.uniform(50.0, 200.0, nz)
    clim = {k: rng.uniform(0.0, 30.0, shape) for k in ("no3", "po4")}
    i_tau = rng.uniform(-1e-7, 1e-6, shape)
    jr = jmd.RestoringData(clim={k: jnp.asarray(v) for k, v in clim.items()},
                           dz=jnp.asarray(dz), i_tau=jnp.asarray(i_tau))
    pr = tmd.RestoringData(clim={k: _t(v) for k, v in clim.items()},
                           dz=_t(dz), i_tau=_t(i_tau))
    trs = {k: rng.uniform(0.0, 30.0, column["h"].shape)
           for k in ("no3", "po4", "fe")}
    jt = _jitted(jr.tendencies, {k: jnp.asarray(v) for k, v in trs.items()},
                 jnp.asarray(column["h"]))
    pt = pr.tendencies({k: _t(v) for k, v in trs.items()}, _t(column["h"]))
    assert list(pt) == list(jt) == ["no3", "po4"]
    for k in jt:
        _check(jt[k], pt[k], f"restoring {k}")


COUPLER = """USE_MARBL_TRACERS = True
USE_OCMIP2_CFC = True
ATM_CO2_CONST = 4.1e-4
BGC_ICE_FRACTION = 0.2
BGC_EXCHANGE_WIND = 7.0
BOT_FLUX_MIX_THICKNESS = 250.0
MARBL_TRACER_RESTORING_SOURCE = file
MARBL_TRACER_RESTORING_FILE = bgc_restoring.nc
READ_RIV_FLUXES = True
RIV_FLUX_FILE = bgc_riv.nc
MARBL_DUST_FLUX_FILE = bgc_dust.nc
FE_BIOAVAIL_FRAC_OFFSET = 0.02
MARBL_NDEP_FILE = bgc_ndep.nc
MARBL_FESEDFLUX_FILE = bgc_fesed.nc
MARBL_FESEDFLUX_SCALE_FACTOR = 3.0
"""


def _couplers(models, bgc_dir, lines, use_marbl, use_npzd, use_cfc):
    """(JAX coupler, tracers), (port coupler, tracers) from
    build_bgc_coupler on BASE + lines, on the grids of ``models``."""
    text = BASE + lines + f"INPUTDIR = {bgc_dir}\n"
    jm, pm = models
    shape = tuple(pm.state.h.shape)
    jc = jmd.build_bgc_coupler(JParamFile(text=text), jm.grid, shape,
                               JRegistry(), use_marbl, use_npzd, use_cfc)
    pc = tmd.build_bgc_coupler(ParamFile(text=text), pm.grid, shape,
                               TracerRegistry(), use_marbl, use_npzd,
                               use_cfc, device="cpu", dtype=F64)
    return jc, pc


def _run_couplers(jc, pc, column, seed, **kw):
    """Both couplers' column_physics on one seeded set of tracers, with
    a gas_fields override on the fluxes; the outputs compared."""
    rng = np.random.default_rng(seed)
    (jcp, jtr), (pcp, ptr) = jc, pc
    assert list(ptr) == list(jtr)
    for k in jtr:
        _check(jtr[k], ptr[k], f"initial {k}", tol=0.0)
    trs = {k: float(np.asarray(v).max()) * rng.uniform(
        0.5, 1.5, column["h"].shape) for k, v in jtr.items()}
    trs = {k: v if v.max() > 0 else rng.uniform(0.0, 2.0, v.shape)
           for k, v in trs.items()}
    gas = {"atm_co2": rng.uniform(3e-4, 5e-4, column["sw"].shape),
           "u10": rng.uniform(2.0, 12.0, column["sw"].shape)}
    jfl = JFluxes(salt_flux=jnp.asarray(column["salt"]),
                  sw=jnp.asarray(column["sw"]),
                  gas_fields={k: jnp.asarray(v) for k, v in gas.items()})
    pfl = Fluxes(salt_flux=_t(column["salt"]), sw=_t(column["sw"]),
                 gas_fields={k: _t(v) for k, v in gas.items()})
    c = column
    jkw = {k: jnp.asarray(c[v]) for k, v in kw.items()}
    pkw = {k: _t(c[v]) for k, v in kw.items()}
    jout = _jitted(
        lambda tr, h, T, S, fl, kw: jcp.column_physics(
            tr, h, T, S, 1200.0, t=jnp.asarray(4.1e6), fluxes=fl, **kw),
        {k: jnp.asarray(v) for k, v in trs.items()}, jnp.asarray(c["h"]),
        jnp.asarray(c["T"]), jnp.asarray(c["S"]), jfl, jkw)
    pout = pcp.column_physics(
        {k: _t(v) for k, v in trs.items()}, _t(c["h"]), _t(c["T"]),
        _t(c["S"]), 1200.0, t=4.1e6, fluxes=pfl, **pkw)
    for k in jout:
        _check(jout[k], pout[k], f"column_physics {k} ({sorted(kw)})")
        assert float(pout[k].min()) >= 0.0
    return trs, pout


@pytest.mark.parametrize("kw", [{"sw": "sw"}, {"kd_int": "kd"}],
                         ids=["sw", "kd_int"])
def test_coupler_matches_jax(ideal, bgc_dir, column, kw):
    jc, pc = _couplers(ideal, bgc_dir, COUPLER, True, False, True)
    pcp = pc[0]
    assert sorted(pcp.forcing_sources.sources) == sorted(
        [f"riv_{n}" for n in configs.BGC_RIVERS]
        + ["dust_fe", "ndep", "fesedflux", "atm_co2", "atm_o2",
           "pcfc11_atm", "pcfc12_atm"])
    assert sorted(pcp.restoring.clim) == ["no3", "po4", "sio3"]
    trs, out = _run_couplers(jc, pc, column, 11, **kw)
    # every channel moved its tracer
    for k in trs:
        assert not np.array_equal(_np(out[k]), trs[k]), k


def test_npzd_matches_jax(ideal, bgc_dir, column):
    jc, pc = _couplers(ideal, bgc_dir,
                       COUPLER.replace("USE_MARBL_TRACERS", "USE_NPZD"),
                       False, True, False)
    assert list(pc[1]) == ["no3", "phyto", "zoo", "det"]
    _run_couplers(jc, pc, column, 12, sw="sw")
    # its own column physics
    rng = np.random.default_rng(13)
    trs = {k: rng.uniform(0.0, 12.0, column["h"].shape)
           for k in ("no3", "phyto", "zoo", "det")}
    h = column["h"]
    jn, pn = jbgc.NPZDPackage(), tbgc.NPZDPackage()
    jout = jn.column_physics({k: jnp.asarray(v) for k, v in trs.items()},
                             jnp.asarray(h), None, None, 1800.0)
    pout = pn.column_physics({k: _t(v) for k, v in trs.items()}, _t(h),
                             None, None, 1800.0)
    for k in trs:
        _check(jout[k], pout[k], f"NPZD column_physics {k}")
    jreg, preg = JRegistry(), TracerRegistry()
    shape = (NK, 3, 5)
    jinit = jn.register(jreg, shape)
    pinit = pn.register(preg, shape, device="cpu", dtype=F64)
    for k, v in jinit.items():
        _check(v, pinit[k], f"NPZD initial {k}", tol=0.0)
    assert preg.names() == jreg.names()


def test_two_packages_one_tracer_raise(bgc_dir):
    text = BASE + "USE_MARBL_TRACERS = True\nUSE_NPZD = True\n"
    with pytest.raises(ValueError, match="declared by two packages"):
        j_build_model(JParamFile(text=text))
    with pytest.raises(ValueError, match="declared by two packages"):
        build_model(ParamFile(text=text), device="cpu", dtype=F64)


@pytest.mark.parametrize("x_first", [True, False])
def test_step_offline_matches_jax(ideal, column, x_first):
    jm, pm = ideal
    rng = np.random.default_rng(21 + x_first)
    h_end = column["h"]
    area = _np(pm.grid.areaT)
    # transports of at most a fifth of the cell volumes, zero at the walls
    uh = 0.2 * rng.uniform(-1.0, 1.0, h_end.shape) * h_end * area \
        * _np(pm.grid.mask2dCu)
    vh = 0.2 * rng.uniform(-1.0, 1.0, h_end.shape) * h_end * area \
        * _np(pm.grid.mask2dCv)
    trs = {k: rng.uniform(0.0, 1.0, h_end.shape) for k in ("age", "dye1")}
    jcfg, pcfg = joff.OfflineCfg(dt_offline=7200.0), \
        toff.OfflineCfg(dt_offline=7200.0)
    for kd in (None, column["kd"]):
        jt, jh = joff.step_offline(
            jm.domain, jm.grid, {k: jnp.asarray(v) for k, v in trs.items()},
            jnp.asarray(h_end), jnp.asarray(uh), jnp.asarray(vh),
            None if kd is None else jnp.asarray(kd), jcfg,
            registry=jm.tracer_registry, x_first=x_first)
        pt, ph = toff.step_offline(
            pm.domain, pm.grid, {k: _t(v) for k, v in trs.items()},
            _t(h_end), _t(uh), _t(vh), None if kd is None else _t(kd), pcfg,
            registry=pm.registry, x_first=x_first)
        H = 4
        _check(np.asarray(jh)[:, H:-H, H:-H], ph[:, H:-H, H:-H], "h_end")
        for k in trs:
            _check(np.asarray(jt[k])[:, H:-H, H:-H], pt[k][:, H:-H, H:-H],
                   f"step_offline {k} (kd {kd is not None})")


OFFLINE_CASE = """SPLIT = True
ENABLE_THERMODYNAMICS = False
ADIABATIC = True
DT = 1200.0
DT_THERM = 2400.0
DAYMAX = 0.11111111111
ENERGYSAVEDAYS = 0.055555
NIGLOBAL = 10
NJGLOBAL = 10
NK = 3
GRID_CONFIG = "cartesian"
AXIS_UNITS = "k"
LENLAT = 100.0
LENLON = 100.0
TOPO_CONFIG = "flat"
MAXIMUM_DEPTH = 300.0
F_0 = 1.0E-04
REENTRANT_X = True
THICKNESS_CONFIG = "uniform"
WIND_CONFIG = "gyres"
TAUX_MAGNITUDE = 0.2
USE_REGIONAL_DYES = True
"""
# the dye in a box, so that the transports move it
DYE_BOX = """DYE_SOURCE_MINLON = 20.0
DYE_SOURCE_MAXLON = 60.0
DYE_SOURCE_MINLAT = 30.0
DYE_SOURCE_MAXLAT = 70.0
"""


def test_offline_round_trip(tmp_path):
    """tests/test_offline_driver.py's case through the port's driver:
    online with WRITE_OFFLINE_FIELDS, then offline from its files.  With
    its uniform dye the offline dye equals the online one to roundoff.
    With the dye in a box the JAX driver runs too: the offline files,
    the online dye and the offline dye equal the JAX driver's, and the
    offline run conserves the dye's content.  (The offline dye parts
    from the online one there in both packages: the offline steps
    alternate x_first from x-first, the online thermodynamic steps,
    every second step, all run y-first.)"""
    from mom6_tpu.drivers import solo as jsolo
    from mom6_torch.drivers import solo
    from mom6_torch.framework.io import read_field
    from mom6_torch.framework.restart import restore_restart

    def case(name, extra):
        d = tmp_path / name
        d.mkdir()
        (d / "MOM_input").write_text(OFFLINE_CASE + extra)
        return str(d)

    def offline(src):
        return f"OFFLINE_TRACER_MODE = True\nOFFLINEDIR = {src}\n" \
            "DT_OFFLINE = 2400.0\n"

    def dye(d, m):
        trees, _ = restore_restart(os.path.join(d, "RESTART", "MOM.res"),
                                   {"tracers": m.tracers})
        return m.domain.interior(trees["tracers"]["dye1"])

    def content(m, dye1, h):
        d = m.domain
        return float(torch.sum(dye1 * d.interior(h) * d.interior(
            m.grid.areaT)))

    runs = {}
    for label, box in (("uniform", ""), ("box", DYE_BOX)):
        on = case(f"{label}_online", box + "WRITE_OFFLINE_FIELDS = True\n")
        runs[label] = (on, solo.main([on, "--cpu"]))
        off = case(f"{label}_offline", box + offline(on))
        run = solo.main([off, "--cpu"])
        assert run["steps"] == 4 and run["state"] is None
        m = build_model(ParamFile(os.path.join(off, "MOM_input")),
                        device="cpu", dtype=F64)
        dye_off = dye(off, m)
        dye_on = m.domain.interior(runs[label][1]["tracers"]["dye1"])
        tot0 = content(m, m.domain.interior(m.tracers["dye1"]), m.state.h)
        tot1 = content(m, dye_off, runs[label][1]["state"].h)
        np.testing.assert_allclose(tot1, tot0, rtol=1e-12)
        stats = open(os.path.join(off, "ocean.stats")).read().splitlines()
        assert stats[0] == "# offline tracer mode: step, day, total[dye1]"
        assert [ln.split(",")[0] for ln in stats[1:]] == ["4"]
        assert float(stats[1].split(",")[2]) == pytest.approx(tot1,
                                                              rel=1e-9)
        runs[label] += (off, m, dye_on, dye_off)
    _, _, _, _, dye_on, dye_off = runs["uniform"]
    np.testing.assert_allclose(_np(dye_off), _np(dye_on), atol=1e-10)

    on, _, off, m, dye_on, dye_off = runs["box"]
    assert not torch.equal(dye_on, m.domain.interior(m.tracers["dye1"]))
    jon = case("jax_online", DYE_BOX + "WRITE_OFFLINE_FIELDS = True\n")
    jsolo.main([jon, "--cpu"])
    for f, var in (("off_sum.nc", "uhtr"), ("off_sum.nc", "vhtr"),
                   ("off_snap.nc", "h_end")):
        want = read_field(os.path.join(jon, f), var)
        got = read_field(os.path.join(on, f), var)
        assert got.shape == want.shape == (4, 3, 10, 10)
        _check(want, got, f"{f} {var}")
    _check(dye(jon, m), dye_on, "online dye")
    joff_ = case("jax_offline", DYE_BOX + offline(jon))
    jsolo.main([joff_, "--cpu"])
    _check(dye(joff_, m), dye_off, "offline dye")
