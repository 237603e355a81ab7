"""mom6_torch against mom6_tpu: the rest of the first breadth item, on
the CPU in float64.

* The gridded generator (``framework/random.py``): uniform fields
  bitwise equal to ``gridded_uniform``, normal fields within 1e-14
  absolute of ``gridded_normal`` (the two erfinv evaluations differ in
  their last bits), in float64 and in float32 (JAX's 32-bit draws, the
  reference's composition with dtype float32; normal within 1e-6), for
  several seeds, one and three values a cell, and the step seed
  ``seed + round(t/dt) + 1`` of ``step_pattern`` with t at a step's
  centre (rounded half to even).
* ``init_pattern``/``step_pattern``, ``apply_sppt``, ``skeb_taper`` and
  ``apply_skeb`` with walls in y (1e-12); GME inside
  ``horizontal_viscosity`` and the STOCH_EOS pressure force (1e-12).
* GME with STOCH_EOS through ``step_dyn_split_rk2`` and
  ``step_dyn_split_rk2b``, a step (1e-9).
* ``Model.step_fn`` of ``configs.BENCH_CONFIG_STOCH`` at 16x16x4 with
  Z* ALE and layered (a thermodynamic step, then a dynamics step that
  sees the pattern it set), the pattern carry included; each
  FIRST ordering alone on bench.py's CONFIG, layered, a thermodynamic
  step (1e-9).  Under the unsplit
  stepper USE_GME and STOCH_EOS change nothing, as in the JAX package.
* A SPPT/SKEB restart written by the port's driver restores through the
  JAX package's restore, and one the JAX package writes in its
  driver's layout restores through the port's driver, which runs on
  from it.

The JAX side runs eagerly (``jax.disable_jit``) but for its barotropic
solve, which runs under ``jax.jit`` as in its own runs.  Tolerances are
relative to each field's maximum on the compute domain unless stated.
"""

import dataclasses
import json
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import dynamics_split_rk2 as jrk2
from mom6_tpu.core import dynamics_split_rk2b as jrk2b
from mom6_tpu.core import pressure_force as jpf
from mom6_tpu.core.dynamics_split_rk2 import SplitDynState as JSplitDynState
from mom6_tpu.core.state import State as JState
from mom6_tpu.framework import random as jrandom
from mom6_tpu.framework import restart as jrestart
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.param.lateral import hor_visc as jhv
from mom6_tpu.param.stochastic import stochastics as jsto
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch import configs, convert
from mom6_torch.core import dynamics_split_rk2 as trk2
from mom6_torch.core import dynamics_split_rk2b as trk2b
from mom6_torch.core import pressure_force as tpf
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.drivers import solo
from mom6_torch.framework import random as trandom
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.param.lateral import hor_visc as thv
from mom6_torch.param.stochastic import stochastics as tsto
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

F64 = torch.float64
H = 4
SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n#override LENLON = 160.0\n"
         "#override LENLAT = 160.0\n")
# the restart case through the port's driver, at 8x8x3
TINY = ("#override NIGLOBAL = 8\n#override NJGLOBAL = 8\n"
        "#override NK = 3\n#override LENLON = 80.0\n"
        "#override LENLAT = 80.0\n")
LAYERED = "#override USE_REGRIDDING = False\n"


def _jitted_btstep(fn):
    """The JAX package's btstep under jax.jit (its normal mode), also
    inside disable_jit: run op by op, its substep loop is most of an
    eager step's time."""
    jf = jax.jit(fn, static_argnums=(0, 12, 13),
                 static_argnames=("nstep", "obc"))

    def call(*args, **kw):
        with jax.disable_jit(False):
            return jf(*args, **kw)
    return call


@pytest.fixture(scope="module", autouse=True)
def _eager_jax():
    """Run the JAX references op by op, every call here being small, but
    for the barotropic solve."""
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        for mod in (jrk2, jrk2b):
            mp.setattr(mod, "btstep", _jitted_btstep(mod.btstep))
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


def _models(text, size=SMALL):
    """The JAX model and the port's of ``text`` at ``size``."""
    jm = j_build_model(JParamFile(text=text + size))
    pm = build_model(ParamFile(text=text + size), device="cpu", dtype=F64)
    return jm, pm


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
    """The JAX model's initial state plus seeded noise (h, T, u, v)."""
    rng = np.random.default_rng(seed)
    d, g = jm.domain, jm.grid

    def noisy(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    st = jm.state
    return dataclasses.replace(
        st, h=noisy(st.h, 2.0), T=noisy(st.T, 0.5),
        u=noisy(st.u, 0.05, g.mask2dCu), v=noisy(st.v, 0.05, g.mask2dCv))


# ---- the gridded generator -------------------------------------------------

def _jax_gridded32(d, seed, nk, normal):
    """The JAX package's gridded composition drawn in float32 (its
    32-bit path, what it draws without float64)."""
    gi, gj = jrandom._cell_keys(d, seed)
    base = jax.random.key(seed)
    mix = (gi * jnp.uint32(2654435761) ^ gj * jnp.uint32(40503)
           ).astype(jnp.uint32)
    keys = jax.vmap(lambda m: jax.random.fold_in(base, m))(mix.ravel())
    draw = jax.random.normal if normal else jax.random.uniform
    vals = jax.vmap(lambda k: draw(k, (nk,), dtype=jnp.float32))(keys)
    return jnp.moveaxis(vals.reshape(d.njh, d.nih, nk), -1, 0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed,nk", [(0, 1), (12345, 3), (2 ** 33 + 7919, 3)])
def test_gridded_fields_match(dtype, seed, nk):
    kw = dict(ni=16, nj=16, halo=H)
    jd, td = JDomain(**kw), Domain(**kw)
    tdt = getattr(torch, dtype)
    if dtype == "float64":
        ju = jrandom.gridded_uniform(jd, seed, nk)
        jn = jrandom.gridded_normal(jd, seed, nk)
    else:
        ju = _jax_gridded32(jd, seed, nk, False)
        jn = _jax_gridded32(jd, seed, nk, True)
    tu = trandom.gridded_uniform(td, seed, nk, dtype=tdt)
    tn = trandom.gridded_normal(td, seed, nk, dtype=tdt)
    assert tu.dtype == tn.dtype == tdt
    assert tu.shape == (nk, jd.njh, jd.nih)
    assert np.array_equal(np.asarray(ju), tu.numpy())
    tol = 1e-14 if dtype == "float64" else 1e-6
    err = np.abs(np.asarray(jn, np.float64) - tn.double().numpy()).max()
    assert err <= tol, f"normal: {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("n", [2, 3])
def test_step_seed_rounds_half_to_even(n):
    """The pattern's step index is round(t/dt) with t = (n + 1/2) dt:
    2 at n = 2 and 4 at n = 3 (half to even), as jnp.round gives."""
    dt, seed = 600.0, 12345
    step = round((n + 0.5) * dt / dt)
    assert step == int(jnp.round((n + 0.5) * dt / dt)) == 2 * ((n + 1) // 2)
    kw = dict(ni=16, nj=16, halo=H)
    jd, td = JDomain(**kw), Domain(**kw)
    cfg = dict(smooth_passes=2, decorr_steps=10)
    p0 = jsto.init_pattern(jd, jsto.StochasticsCfg(**cfg), seed)
    want = jsto.step_pattern(jd, jsto.StochasticsCfg(**cfg), p0, seed,
                             jnp.asarray(step, jnp.int32))
    got = tsto.step_pattern(td, tsto.StochasticsCfg(**cfg), _t(p0), seed,
                            step)
    err = np.abs(np.asarray(want) - got.numpy()).max()
    assert err <= 1e-14, err


# ---- SPPT, SKEB, GME and STOCH_EOS ---------------------------------------

@pytest.fixture(scope="module")
def basin():
    """The JAX and port models of the STOCH text, layered (walls in y),
    with a perturbed state as numpy."""
    jm, pm = _models(configs.BENCH_CONFIG_STOCH + LAYERED)
    return jm, pm, {k: np.asarray(v) for k, v in
                    _arrays(_perturbed(jm)).items()}


def test_patterns_and_sppt_match(basin):
    jm, pm, _ = basin
    jd, td = jm.domain, pm.domain
    kw = dict(smooth_passes=3, decorr_steps=12, sppt_amplitude=0.7)
    jc, tc = jsto.StochasticsCfg(**kw), tsto.StochasticsCfg(**kw)
    jp = jsto.init_pattern(jd, jc, 77)
    tp = tsto.init_pattern(td, tc, 77)
    _close(jp, tp, 1e-12, "init_pattern")
    for step in (0, 5):
        jp = jsto.step_pattern(jd, jc, jp, 77, step)
        tp = tsto.step_pattern(td, tc, tp, 77, step)
        _close(jp, tp, 1e-12, f"step_pattern {step}")
    tend = np.random.default_rng(2).standard_normal((4,) + jp.shape)
    _close(jsto.apply_sppt(jc, jnp.asarray(tend), 3.0 * jp),
           tsto.apply_sppt(tc, _t(tend), 3.0 * tp), 1e-12, "apply_sppt")


def test_skeb_matches(basin):
    jm, pm, a = basin
    kw = dict(skeb_npass=3, skeb_taper_width=3, skeb_amplitude=2.0)
    jc, tc = jsto.StochasticsCfg(**kw), tsto.StochasticsCfg(**kw)
    jt = jsto.skeb_taper(jm.domain, jm.grid, 3)
    tt = tsto.skeb_taper(pm.domain, pm.grid, 3)
    for name, x, y in zip(("taperCu", "taperCv"), jt, tt):
        _close(x, y, 1e-12, name, halo=0)
    # zero at the wall faces, one away from them
    assert float(pm.domain.interior(tt[1]).min()) == 0.0
    assert float(pm.domain.interior(tt[0]).max()) == 1.0
    wts = jsto.init_pattern(jm.domain, jc, 3)
    u, v = (jm.domain.fill_halos(jnp.asarray(a[k]), width=1)
            for k in ("u", "v"))
    ju, jv = jsto.apply_skeb(jm.domain, jm.grid, jc, u, v, wts, 600.0)
    tu, tv = tsto.apply_skeb(pm.domain, pm.grid, tc, _t(u), _t(v), _t(wts),
                             600.0)
    _close(ju - u, tu - _t(u), 1e-12, "SKEB du")
    _close(jv - v, tv - _t(v), 1e-12, "SKEB dv")
    assert float(torch.abs(tu - _t(u)).max()) > 0.0


@pytest.mark.parametrize("given_htot", [True, False],
                         ids=["htot", "htot_from_h"])
def test_gme_stress_matches(basin, given_htot):
    jm, pm, a = basin
    kw = dict(biharmonic=True, smag_bi_const=0.06, dt=600.0, use_gme=True,
              gme_kh=600.0, gme_h0=300.0, gme_limiter=500.0)
    rng = np.random.default_rng(4)
    u_bt = np.asarray(jm.domain.fill_halos(jnp.asarray(
        0.1 * rng.standard_normal(a["h"].shape[1:]))))
    v_bt = np.asarray(jm.domain.fill_halos(jnp.asarray(
        0.1 * rng.standard_normal(a["h"].shape[1:]))))
    htot = a["h"].sum(0) if given_htot else None
    ref = jhv.horizontal_viscosity(
        jm.grid, jnp.asarray(a["u"]), jnp.asarray(a["v"]),
        jnp.asarray(a["h"]), jhv.HorViscCfg(**kw), u_bt=jnp.asarray(u_bt),
        v_bt=jnp.asarray(v_bt),
        htot=None if htot is None else jnp.asarray(htot))
    out = thv.horizontal_viscosity(
        pm.grid, _t(a["u"]), _t(a["v"]), _t(a["h"]), thv.HorViscCfg(**kw),
        u_bt=_t(u_bt), v_bt=_t(v_bt), htot=None if htot is None else _t(htot))
    _close(ref.diffu, out.diffu, 1e-12, "diffu")
    _close(ref.diffv, out.diffv, 1e-12, "diffv")
    plain = thv.horizontal_viscosity(
        pm.grid, _t(a["u"]), _t(a["v"]), _t(a["h"]),
        thv.HorViscCfg(**dict(kw, use_gme=False)))
    assert not torch.equal(plain.diffu, out.diffu)


def test_stoch_eos_pressure_force_matches(basin):
    jm, pm, a = basin
    pat = np.asarray(jsto.init_pattern(jm.domain, jsto.StochasticsCfg(), 9))
    kw = dict(stanley_coeff=0.5, quad_points=5)
    ref = jpf.pressure_force(jm.grid, jm.vgrid, jnp.asarray(a["h"]),
                             jnp.asarray(a["T"]), jnp.asarray(a["S"]),
                             jm.eos, cfg=jpf.PressureForceCfg(**kw),
                             varT_mult=jnp.exp(0.8 * jnp.asarray(pat)))
    out = tpf.pressure_force(pm.grid, pm.vgrid, _t(a["h"]), _t(a["T"]),
                             _t(a["S"]), pm.eos,
                             cfg=tpf.PressureForceCfg(**kw),
                             varT_mult=torch.exp(0.8 * _t(pat)))
    _close(ref.PFu, out.PFu, 1e-12, "PFu")
    _close(ref.PFv, out.PFv, 1e-12, "PFv")
    _close(ref.pbce, out.pbce, 1e-12, "pbce")


@pytest.mark.parametrize("stepper", ["rk2", "rk2b"])
def test_gme_and_stoch_eos_through_the_steppers(stepper):
    """A dynamics step of the STOCH text's split configuration
    (GME on the barotropic strain, Stanley with the STOCH_EOS
    multiplier of a given pattern)."""
    text = configs.BENCH_CONFIG_STOCH + LAYERED
    if stepper == "rk2b":
        text += "SPLIT_RK2B = True\n"
    jm, pm = _models(text)
    assert pm.cfg.split_cfg.horvisc.use_gme
    assert pm.cfg.split_cfg.stoch_eos_a == 1.0
    st0 = _perturbed(jm)
    pat = jsto.init_pattern(jm.domain, jsto.StochasticsCfg(), 21)
    jfn, tfn = ((jrk2.step_dyn_split_rk2, trk2.step_dyn_split_rk2)
                if stepper == "rk2" else
                (jrk2b.step_dyn_split_rk2b, trk2b.step_dyn_split_rk2b))
    if stepper == "rk2":
        jsp = jrk2.init_split_state(jm.domain, jm.grid, jm.vgrid, st0,
                                    horvisc_cfg=jm.split_cfg.horvisc)
    else:
        jsp = jrk2b.init_split_b_state(jm.domain, jm.grid, jm.vgrid, st0)
    pm = convert.model_with_state(pm, _arrays(st0), _arrays(jsp))
    js, jsp, _ = jfn(jm.domain, jm.grid, jm.vgrid, st0, jsp, jm.forces,
                     jm.dt, jm.split_cfg, eos=jm.eos, stoch_pattern=pat)
    ts, tsp, _ = tfn(pm.domain, pm.grid, pm.vgrid, pm.state, pm.split,
                     pm.forces, pm.dt, pm.cfg.split_cfg, eos=pm.eos,
                     stoch_pattern=_t(pat))
    for name in ("h", "u", "v"):
        _close(getattr(js, name), getattr(ts, name), 1e-9, name)
    _close(jsp.eta, tsp.eta, 1e-9, "eta")


# ---- the models ------------------------------------------------------------

def _run_both(text, steps):
    """The steps ``steps`` (step indices n) of step_fn in both packages
    from the same perturbed state; returns the JAX and port (state,
    split, tracers, step)."""
    jm, pm = _models(text)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    st0, sp0 = _perturbed(jm), jm.split_state
    step_j = jm.step_fn()
    js, jsp, jtr = st0, sp0, jm.tracers
    for n in steps:
        js, jsp, jtr = step_j(js, jsp, jtr, n)
    pm = convert.model_with_state(
        pm, _arrays(st0), _arrays(sp0),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step_p = pm.step_fn()
    ts, tsp, ttr = pm.state, pm.split, pm.tracers
    for n in steps:
        ts, tsp, ttr = step_p(ts, tsp, ttr, n)
    for name in ("h", "u", "v", "T", "S"):
        _close(getattr(js, name), getattr(ts, name), 1e-9, name)
    for name in ("eta", "u_av", "v_av", "uh", "vh"):
        _close(getattr(jsp, name), getattr(tsp, name), 1e-9, name)
    _close(jtr["age"], ttr["age"], 1e-9, "age")
    return (js, jsp, jtr, step_j), (ts, tsp, ttr, step_p)


@pytest.mark.parametrize("variant,steps", [("ale", (1, 2)),
                                           ("layered", (1, 2))])
def test_stoch_text_matches_step_fn(variant, steps):
    """Steps n = 1 (thermodynamic: the patterns start, before that step's
    dynamics under DIABATIC_FIRST, so the dynamics see none yet) and 2
    (the dynamics see the pattern)."""
    text = configs.BENCH_CONFIG_STOCH + (LAYERED if variant == "layered"
                                         else "")
    (_, _, _, step_j), (_, _, _, step_p) = _run_both(text, steps)
    jc, tc = step_j.carry()["sppt"], step_p.carry()["sppt"]
    assert sorted(jc) == sorted(tc) == ["skeb", "sppt"]
    for k in jc:
        _close(jc[k], tc[k], 1e-12, f"pattern {k}")


@pytest.mark.parametrize("line", ["THICKNESSDIFFUSE_FIRST = True",
                                  "DIABATIC_FIRST = True"])
def test_first_orderings_alone_match(line):
    """One thermodynamic step (n = 1), with GM or the column physics
    ahead of the dynamics."""
    _run_both(configs.BENCH_CONFIG + LAYERED + line + "\n", (1,))


def test_gme_and_stoch_eos_are_inert_under_unsplit():
    """The unsplit stepper takes neither GME's inputs nor the pattern
    (as in the JAX package, whose orchestrator passes them only to the
    split steppers): its state after a thermodynamic step is the same
    with USE_GME and STOCH_EOS on."""
    base = (configs.BENCH_CONFIG_UNSPLIT + LAYERED + SMALL
            + "USE_STANLEY_PGF = True\nSTANLEY_COEFF = 0.5\n")
    states = []
    for extra in ("", "USE_GME = True\nSTOCH_EOS = True\n"):
        pm = build_model(ParamFile(text=base + extra), device="cpu",
                         dtype=F64)
        step = pm.step_fn()
        st, sp, tr = pm.state, pm.split, pm.tracers
        for n in range(7):
            st, sp, tr = step(st, sp, tr, n)
        states.append((st, step.carry()["sppt"]))
    (a, none), (b, pat) = states
    assert none is None and pat is not None
    pm_on = build_model(ParamFile(text=base + "USE_GME = True\n"),
                        device="cpu", dtype=F64)
    assert pm_on.cfg.unsplit_cfg.horvisc.use_gme
    for name in ("h", "u", "v", "T", "S"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_restarts_carry_the_patterns_across_packages(tmp_path):
    """The port's driver writes carry_sppt_p/carry_sppt_k, which the JAX
    package's restore reads as its driver does; a JAX-written pair
    restores through the port's driver into the {"sppt", "skeb"}
    carry."""
    d = tmp_path / "case"
    d.mkdir()
    text = (configs.BENCH_CONFIG_STOCH + TINY + "ENERGYSAVEDAYS = 0.5\n")
    (d / "MOM_input").write_text(text)
    run = solo.main([str(d), "--cpu", "--days", repr(2 * 600 / 86400)])
    assert run["steps"] == 2
    path = str(d / "RESTART" / "MOM.res")
    saved = set(json.loads((d / "RESTART" / "MOM.res.json").read_text())
                ["trees"])
    assert {"carry_sppt_p", "carry_sppt_k"} <= saved
    assert "carry_sppt" not in saved
    leaf = jnp.zeros(1)
    trees, _ = jrestart.restore_restart(
        path, {n: leaf for n in ("carry_sppt_p", "carry_sppt_k")})
    port = np.load(path + ".npz")
    man = json.loads((d / "RESTART" / "MOM.res.json").read_text())["trees"]
    for n in ("carry_sppt_p", "carry_sppt_k"):
        assert np.array_equal(np.asarray(trees[n]),
                              port[man[n]["keys"][0]])
    # the other way: the JAX driver's layout of a pattern pair, its
    # state and split trees in the JAX package's containers
    pm = build_model(ParamFile(text=text), device="cpu", dtype=F64)
    pats = {k: np.asarray(v) for k, v in run["state"].__dict__.items()
            if k in ("T", "S")}
    jpath = str(tmp_path / "jax" / "MOM.res")
    jrestart.save_restart(
        jpath, {"state": JState(**{k: jnp.asarray(v) for k, v in
                                   _arrays(pm.state).items()}),
                "split": JSplitDynState(**{k: jnp.asarray(v) for k, v in
                                           _arrays(pm.split).items()}),
                "tracers": {k: jnp.asarray(v.numpy())
                            for k, v in pm.tracers.items()},
                "carry_sppt_p": jnp.asarray(pats["T"][0]),
                "carry_sppt_k": jnp.asarray(pats["S"][1])},
        meta={"step": 2, "time_days": 2 * 600 / 86400, "truncs": 0})
    state, _, _, carry, step0, _ = solo._restore(jpath, pm)
    assert step0 == 2 and sorted(carry["sppt"]) == ["skeb", "sppt"]
    assert np.array_equal(carry["sppt"]["sppt"].numpy(), pats["T"][0])
    assert np.array_equal(carry["sppt"]["skeb"].numpy(), pats["S"][1])
    assert torch.equal(state.T, pm.state.T)
    # and the port's driver continues from it
    run2 = solo.main([str(d), "--cpu", "--days", repr(3 * 600 / 86400),
                      "--restart-from", jpath])
    assert run2["steps"] == 1
