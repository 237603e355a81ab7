"""mom6_torch against mom6_tpu: the coupled drivers, the ODA ensemble and
the driver's particles in float64 on the CPU.

* The solo driver with USE_PARTICLES on a copy of cases/double_gyre cut
  to 8x8x2, 3 steps, through both packages (the JAX driver with most
  XLA optimizations off): ``particles.nc`` 1e-12.
* The EnKF update on the same seeded ensemble, 1e-13 (a float32
  ensemble, whose means are float32 sums, 2.4e-7);
  ``init_ensemble_states`` of both packages' builds of bench.py's
  CONFIG at 8x8x2 (the perturbations' normals 4e-15 absolute times
  t_pert, plus one rounding of T); ``ensemble_stats``, ``propagate_ensemble`` and
  ``IncrementalUpdate``, 1e-13.
* ``_iob_to_forcing``, ``extract_surface_state`` and the cap's
  ``import_fields`` and ``export_fields`` on a state set by hand (the
  four shortwave bands and the four liquid fluxes summed in the JAX
  order, bitwise), 1e-13.
* The composed paths at 8x8x2 against the JAX package: one cap
  interval of one step and ``update_ocean_model`` (the JAX
  ``step_ocean``, which both call eagerly, jitted here with most XLA
  optimizations off), the export fields with So_bldepth and Fioo_q
  1e-9; one ODA cycle of one step of 2 members through both
  ``run_oda_cycles`` (x first on odd steps), the members and the SST
  mean and spread 1e-9.
* The port's own ``run_oda_cycles`` over 2 cycles of 1 step equal to
  the members stepped one by one through ``step_ocean`` and updated by
  ``enkf_analysis``; ``finalize`` restoring.
"""

import dataclasses
import pathlib
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import orchestrator as jorch
from mom6_tpu.drivers import nuopc_cap as jcap
from mom6_tpu.drivers import ocean_model as jom
from mom6_tpu.drivers import solo as jsolo
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.oda import driver as joda
from mom6_tpu.oda import ensemble as jens

from mom6_torch import convert
from mom6_torch.configs import BENCH_CONFIG
from mom6_torch.core.orchestrator import step_ocean
from mom6_torch.drivers import nuopc_cap as pcap
from mom6_torch.drivers import ocean_model as pom
from mom6_torch.drivers import solo
from mom6_torch.framework.io import read_field
from mom6_torch.framework.restart import restore_restart
from mom6_torch.oda import driver as poda
from mom6_torch.oda import ensemble as pens

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
H = 4
ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 8
TEXT = BENCH_CONFIG + (
    f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {N}\n"
    f"#override NJGLOBAL = {N}\n#override NK = 2\n"
    f"#override LENLON = {N * 10.0}\n#override LENLAT = {N * 10.0}\n")


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


# ---- the driver's particles ---------------------------------------------------

def _particle_case(d):
    d.mkdir()
    text = (ROOT / "cases" / "double_gyre" / "MOM_input").read_text()
    for a, b in (("NIGLOBAL = 44", "NIGLOBAL = 8"),
                 ("NJGLOBAL = 40", "NJGLOBAL = 8"),
                 ("LENLAT = 1200.0", "LENLAT = 240.0"),
                 ("LENLON = 1320.0", "LENLON = 240.0")):
        assert a in text
        text = text.replace(a, b)
    (d / "MOM_input").write_text(
        text + "USE_PARTICLES = True\nPARTICLES_NX = 3\nPARTICLES_NY = 2\n"
        "PARTICLES_LAYER = 1\n#override ENERGYSAVEDAYS = 0.0138889\n")


def test_driver_particles_match_jax(tmp_path):
    """3 steps of 1200 s, a record every step."""
    dirs = {}
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for name, main in (("jax", jsolo.main), ("port", solo.main)):
            d = dirs[name] = tmp_path / name
            _particle_case(d)
            main([str(d), "--days", "0.0416667", "--cpu"])
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    for v in ("part_x", "part_y"):
        want = read_field(str(dirs["jax"] / "particles.nc"), v)
        got = read_field(str(dirs["port"] / "particles.nc"), v)
        assert np.asarray(got).shape == (3, 6)
        _check(want, np.asarray(got), v, 1e-12)
    assert "particles" in (dirs["port"] / "clocks.txt").read_text()


# ---- the ensemble -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_enkf_matches_jax(dtype):
    rng = np.random.default_rng(1)
    field = (15.0 + rng.standard_normal((5, 3, 7, 9))).astype(dtype)
    kw = dict(ensemble_size=5, inflation=1.05, obs_error=0.2)
    want = jens.enkf_analysis(jens.EnsembleCfg(**kw), jnp.asarray(field),
                              14.3, 40)
    got = pens.enkf_analysis(pens.EnsembleCfg(**kw), torch.tensor(field),
                             14.3, 40)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    # a float32 ensemble's means are float32 sums, in each package's
    # order: 2 ulp there
    _check(want, got, "enkf", 1e-13 if dtype == np.float64 else 2.4e-7)


def test_ensemble_pieces_match_jax():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((4, 6, 5))
    for a, b in zip(jens.ensemble_stats(jnp.asarray(f)),
                    pens.ensemble_stats(torch.tensor(f))):
        _check(a, b, "stats", 1e-13)
    states = {"a": f, "b": (f[:, 0] ** 2, f[:, 1])}

    def jstep(s):
        return {"a": 2.0 * s["a"] + 1.0, "b": (s["b"][0] * s["b"][1],
                                               s["b"][1] - 1.0)}
    pstep = jstep
    want = jens.propagate_ensemble(jstep, jax.tree.map(jnp.asarray, states),
                                   n_steps=3)
    got = pens.propagate_ensemble(pstep, {"a": torch.tensor(f), "b": (
        torch.tensor(f[:, 0] ** 2), torch.tensor(f[:, 1]))}, n_steps=3)
    _check(want["a"], got["a"], "a", 1e-13)
    for x, y in zip(want["b"], got["b"]):
        _check(x, y, "b", 1e-13)
    inc = {"T": rng.standard_normal((3, 4))}
    fields = {"T": rng.standard_normal((3, 4)), "S": np.ones((3, 4))}
    ju = jens.IncrementalUpdate(increment={"T": jnp.asarray(inc["T"])},
                                n_steps=3)
    pu = pens.IncrementalUpdate(increment={"T": torch.tensor(inc["T"])},
                                n_steps=3)
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    pf = {k: torch.tensor(v) for k, v in fields.items()}
    for step in range(4):
        jf, pf = ju.apply(jf, step), pu.apply(pf, step)
    for k in fields:
        _check(jf[k], pf[k], k, 1e-13)


@pytest.fixture(scope="module")
def models():
    """bench.py's CONFIG at 8x8x2 built by both packages."""
    jm = j_build_model(JParamFile(text=TEXT))
    pm = pom.ocean_model_init(text=TEXT, device="cpu")
    return jm, pm


def test_init_ensemble_states_match_jax(models):
    jm, pm = models
    js, jsp = joda.init_ensemble_states(jm, 3, t_pert=0.4, seed=5)
    ps, psp = poda.init_ensemble_states(pm, 3, t_pert=0.4, seed=5)
    assert ps.T.shape == js.T.shape
    # the normals' 4e-15 times t_pert, and one rounding of T ~ 15
    err = np.abs(np.asarray(js.T) - ps.T.numpy()).max()
    assert err <= 0.4 * 4e-15 + np.spacing(16.0), err
    assert float((ps.T[0] - ps.T[1]).abs().max()) > 0.1
    for k in ("h", "u", "v", "S"):
        _check(getattr(js, k), getattr(ps, k), k, 0.0)
    _check(jsp.eta, psp.eta, "eta", 0.0)


def _hand_state(jm, pm, seed=3):
    """A perturbed state in both packages."""
    rng = np.random.default_rng(seed)
    arrs = {}
    for k in ("u", "v", "h", "T", "S"):
        a = np.asarray(getattr(jm.state, k))
        scale = {"u": 0.1, "v": 0.1, "h": 5.0, "T": 1.0, "S": 0.2}[k]
        arrs[k] = a + scale * rng.standard_normal(a.shape)
    js = dataclasses.replace(jm.state, **{k: jnp.asarray(v)
                                          for k, v in arrs.items()})
    ps = convert.state_from_numpy(arrs, device="cpu", dtype=F64)
    return js, ps


def _fields(jm, seed=4):
    rng = np.random.default_rng(seed)
    shp = np.asarray(jm.grid.mask2dT).shape
    out = {"Foxx_taux": 0.1 * rng.standard_normal(shp),
           "Foxx_tauy": 0.1 * rng.standard_normal(shp),
           "Foxx_sen": -20.0 + 5.0 * rng.standard_normal(shp),
           "Sa_pslv": 101325.0 + 100.0 * rng.standard_normal(shp),
           "Faxa_rain": 1e-5 * rng.random(shp),
           "Faxa_snow": 3e-6 * rng.random(shp),
           "Foxx_rofl": 7e-7 * rng.random(shp)}
    for band in ("vdr", "vdf", "idr", "idf"):
        out[f"Foxx_swnet_{band}"] = 50.0 * rng.random(shp)
    return out


def test_surface_state_and_forcing_match_jax(models):
    jm, pm = models
    js, ps = _hand_state(jm, pm)
    want = jom.extract_surface_state(jm, js)
    got = pom.extract_surface_state(pm, ps)
    for f in dataclasses.fields(got):
        _check(getattr(want, f.name), getattr(got, f.name), f.name, 1e-13)
    fields = _fields(jm)
    jiob = jom.IceOceanBoundary(u_flux=jnp.asarray(fields["Foxx_taux"]),
                                lprec=jnp.asarray(fields["Faxa_rain"]))
    piob = pom.IceOceanBoundary(u_flux=torch.tensor(fields["Foxx_taux"]),
                                lprec=torch.tensor(fields["Faxa_rain"]))
    (jf, jfl), (pf, pfl) = (jom._iob_to_forcing(jiob, jm.grid),
                            pom._iob_to_forcing(piob, pm.grid))
    _check(jf.taux, pf.taux, "taux", 0.0)
    _check(jfl.lprec, pfl.lprec, "lprec", 0.0)
    assert pf.tauy is None and pfl.sw is None


def test_cap_import_export_match_jax(models):
    jm, pm = models
    jc = jcap.MOM6Cap().realize(text=TEXT)
    pc = pcap.MOM6Cap().realize(text=TEXT, device="cpu")
    assert pc.advertise() == jc.advertise()
    assert len(pcap.IMPORT_FIELDS) == 15 and len(pcap.EXPORT_FIELDS) == 9
    js, ps = _hand_state(jm, pm, seed=8)
    jc._state, pc._state = js, ps
    # before the first advance: zeros for the frazil and the mixed layer
    got0 = pc.export_fields()
    assert float(got0["Fioo_q"].abs().max()) == 0.0
    fields = _fields(jm)
    jc.import_fields({k: jnp.asarray(v) for k, v in fields.items()})
    pc.import_fields({k: torch.tensor(v) for k, v in fields.items()})
    for f in dataclasses.fields(pc._iob):
        a, b = getattr(jc._iob, f.name), getattr(pc._iob, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            _check(a, b, f.name, 0.0)
    want, got = jc.export_fields(), pc.export_fields()
    assert sorted(got) == sorted(want) == sorted(pcap.EXPORT_FIELDS)
    for k in want:
        _check(want[k], got[k], k, 1e-13)
    assert float(got["So_dhdx"].abs().max()) > 0.0


# ---- the composed paths ----------------------------------------------------------

def _jit_jax_step(monkeypatch):
    """Route the JAX ``step_ocean`` of the cap and update_ocean_model
    through one jit for each grid and x_first, keeping the diagnostics
    the cap exports."""
    real, cache = jorch.step_ocean, {}

    def step(d, g, vg, st, sp, tr, fo, fl, dt, cfg, *, x_first, **kw):
        key = (id(g), x_first)
        if key not in cache:
            def f(st, sp, tr, fo, fl):
                st, sp, tr, dg = real(d, g, vg, st, sp, tr, fo, fl, dt,
                                      cfg, x_first=x_first, **kw)[:4]
                return st, sp, tr, dg.frazil, dg.mld
            cache[key] = jax.jit(f)
        st, sp, tr, frazil, mld = cache[key](st, sp, tr, fo, fl)
        return st, sp, tr, types.SimpleNamespace(frazil=frazil, mld=mld)
    monkeypatch.setattr(jorch, "step_ocean", step)


def test_cap_advance_matches_jax(monkeypatch, tmp_path):
    """One coupling interval of one step from the cap's start."""
    _jit_jax_step(monkeypatch)
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jc = jcap.MOM6Cap().realize(text=TEXT)
        fields = _fields(jc.model, seed=9)
        jc.import_fields({k: jnp.asarray(v) for k, v in fields.items()})
        jc.advance(jc.model.dt)
        want = jc.export_fields()
        jm = jc.model
        jsfc = jom.update_ocean_model(jm, jc._iob, jm.state, jm.split_state,
                                      jm.tracers, jm.dt)[3]
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    pc = pcap.MOM6Cap().realize(text=TEXT, device="cpu")
    pc.import_fields({k: torch.tensor(v) for k, v in fields.items()})
    pc.advance(pc.model.dt)
    got = pc.export_fields()
    assert sorted(got) == sorted(want)
    for k in want:
        _check(want[k], got[k], k, 1e-9)
    assert float(got["So_bldepth"].abs().max()) > 0.0      # KPP's depth
    pm = pc.model
    psfc = pom.update_ocean_model(pm, pc._iob, pm.state, pm.split,
                                  pm.tracers, pm.dt)[3]
    for f in dataclasses.fields(psfc):
        _check(getattr(jsfc, f.name), getattr(psfc, f.name), f.name, 1e-9)
    pc.finalize(str(tmp_path / "cap"))
    trees, _ = restore_restart(str(tmp_path / "cap"),
                               {"state": pm.state, "split": pm.split})
    assert torch.equal(trees["state"].T, pc._state.T)


def test_oda_cycle_matches_jax(models):
    """2 members, one cycle of one step (y first, as step 0 is even)."""
    jm, pm = models
    kw = dict(ensemble_size=2, obs_error=0.05)
    obs, ji = [14.0], (H + 3, H + 5)
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        want = joda.run_oda_cycles(jm, jens.EnsembleCfg(**kw), 1, 1, obs,
                                   ji, t_pert=0.3, seed=1)
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    got = poda.run_oda_cycles(pm, pens.EnsembleCfg(**kw), 1, 1, obs, ji,
                              t_pert=0.3, seed=1)
    for k in ("h", "u", "v", "T", "S"):
        _check(getattr(want.states, k), getattr(got.states, k), k, 1e-9)
    _check(want.splits.eta, got.splits.eta, "eta", 1e-9)
    _check(want.sst_mean, got.sst_mean, "sst_mean", 1e-9)
    _check(want.sst_spread, got.sst_spread, "sst_spread", 1e-9)


# ---- the port's own full paths --------------------------------------------------

def test_oda_cycles_step_members_in_turn(models):
    _, pm = models
    cfg = pens.EnsembleCfg(ensemble_size=2, obs_error=0.05)
    obs, ji = [14.0, 13.5], (H + 3, H + 5)
    run = poda.run_oda_cycles(pm, cfg, 2, 1, obs, ji, t_pert=0.3, seed=1)
    states, splits = poda.init_ensemble_states(pm, 2, 0.3, 1)
    mem = [(pens.member(states, m), pens.member(splits, m))
           for m in range(2)]
    means = []
    for cyc in range(2):
        mem = [step_ocean(pm.domain, pm.grid, pm.vgrid, st, sp, None,
                          pm.forces, None, pm.dt, pm.cfg, eos=pm.eos,
                          x_first=(cyc % 2 == 1))[:2] for st, sp in mem]
        T = torch.stack([st.T for st, _ in mem])
        t0 = pens.enkf_analysis(cfg, T[:, 0].reshape(2, -1), obs[cyc],
                                ji[0] * T.shape[-1] + ji[1])
        t0 = t0.reshape(T[:, 0].shape)
        mem = [(dataclasses.replace(st, T=torch.cat([t0[m][None], st.T[1:]])),
                sp) for m, (st, sp) in enumerate(mem)]
        means.append(float(t0[:, ji[0], ji[1]].mean()))
    for m, (st, sp) in enumerate(mem):
        for k in ("h", "u", "v", "T", "S"):
            assert torch.equal(getattr(run.states, k)[m], getattr(st, k)), k
        assert torch.equal(run.splits.eta[m], sp.eta)
    assert run.sst_mean == means and len(run.sst_spread) == 2
    assert all(np.isfinite(run.sst_spread))


def test_ocean_model_init_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pom.ocean_model_init(text=TEXT)
