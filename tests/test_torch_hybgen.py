"""mom6_torch against mom6_tpu: the hybrid coordinates of the sixth breadth
item, on the CPU in float64.

* ``hybgen_regrid`` on seeded 6-layer columns (thick, thin and nearly
  vanished layers, bottoms deeper and shallower than the column) under
  the deep and the terrain-following constraints, with and without a
  minimum isopycnal depth; ``hybgen_unmix`` with a tracer under the
  WRIGHT and TEOS10 forms, on columns where each of its three cases
  (entrain, swap, split) occurs (1e-11 under the polynomial form,
  whose densities differ from the JAX package's by rounding, about 1e-12
  kg m-3, and enter the split as differences of ~0.1 kg m-3); the
  ADAPTIVE coordinate under WRIGHT with and without ADAPT_DO_MIN_DEPTH,
  two ADAPT_ALPHA, on a land mask (under ROQUET_RHO in the model test);
  ``build_grid`` in HYBGEN (with the default and a given generator
  configuration); the three
  hybgen remap schemes with and without the monotonic limiter; and
  ``ale_regrid_accelerated`` under HYBGEN: 1e-12 relative to each
  field's maximum.
* ``configs.BENCH_CONFIG_HYBGEN`` and ``configs.BENCH_CONFIG_ADAPT`` at
  16x16x4 with DT_THERM = DT: the configuration and the initial state
  after REGRID_ACCELERATE_INIT equal to the JAX builder's, and 2 steps of
  ``Model.step_fn`` from a perturbed state, 1e-9 relative on h, u, v, T,
  S, age, eta, uh and vh.  Both texts run in one test, so that the JAX
  package's eager operations compile once for both; the JAX side runs
  eagerly but for its barotropic solve.  The HYBGEN text's deep profile
  is the nominal spacing: a layer stays fixed while its interfaces lie
  within a tenth of a layer of their nominal depths, and the isopycnal
  passes act where the flow moves them further (chip_smoke.py's 32x32x6
  run has such columns); they act in the module tests and in the
  accelerated regrid above (a 5 to 160 m profile).  (The HYCOM1 text
  with unmixing is in tests/test_torch_eos_forms.py.)
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.ale import ale_main as jale
from mom6_tpu.ale import hybgen_regrid as jhr
from mom6_tpu.ale import hybgen_unmix as jhu
from mom6_tpu.ale import regridding as jrg
from mom6_tpu.ale import remapping as jrm
from mom6_tpu.core import dynamics_split_rk2 as jrk2
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch import configs, convert
from mom6_torch.ale import ale_main as tale
from mom6_torch.ale import hybgen_regrid as thr
from mom6_torch.ale import hybgen_unmix as thu
from mom6_torch.ale import regridding as trg
from mom6_torch.ale import remapping as trm
from mom6_torch.convert import grid_from_numpy
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.eos import make_eos
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
# the column tests take the shape of the grid tests' halo-padded fields
# (4x4 points, halo 4): the JAX package's eager operations compile once
# for both
NK, NJ, NI = 6, 12, 12
TOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _check(ref, out, name, tol=TOL):
    a = np.asarray(ref, np.float64)
    b = out.detach().numpy()
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _regrid_columns(seed):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.0, 300.0, (NK, NJ, NI))
    h[:, :2, :2] *= 1e-3                       # nearly vanished columns
    h[2, 3] = 0.0                              # a vanished interior layer
    rcv = (np.sort(1025.0 + rng.uniform(-1.0, 5.0, (NK, NJ, NI)), axis=0)
           + rng.normal(0.0, 0.3, (NK, NJ, NI)))
    tgt = np.sort(1025.0 + rng.uniform(0.0, 4.0, NK))
    depth = h.sum(0) * rng.uniform(0.7, 1.3, (NJ, NI))
    prof = dict(dp0k=tuple(rng.uniform(5.0, 50.0, NK)),
                ds0k=tuple(rng.uniform(1.0, 5.0, NK)))
    return h, rcv, tgt, depth, prof


@pytest.mark.parametrize("nsigma,topiso", [(0, 0.0), (0, 60.0), (2, 0.0),
                                           (2, 60.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_hybgen_regrid_matches_jax(seed, nsigma, topiso):
    h, rcv, tgt, depth, prof = _regrid_columns(seed)
    kw = dict(prof, nsigma=nsigma, topiso_const=topiso, qhybrlx=0.5)
    ref = jhr.hybgen_regrid(jhr.HybgenRegridCfg(**kw),
                            *(jnp.asarray(a) for a in (h, rcv, tgt, depth)))
    out = thr.hybgen_regrid(thr.HybgenRegridCfg(**kw),
                            *(_t(a) for a in (h, rcv, tgt, depth)))
    _check(ref, out, "h_new")
    assert np.abs(np.asarray(ref) - h).max() > 10.0     # the grid moved
    tot = h.sum(0)
    assert float((out.sum(0) - _t(tot)).abs().max()) <= 1e-12 * tot.max()


def _unmix_columns(seed, eos):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.0, 200.0, (NK, NJ, NI))
    h[4:, 0] = 0.0                             # a shallower deepest layer
    T = (np.sort(rng.uniform(2.0, 20.0, (NK, NJ, NI)), axis=0)[::-1]
         + rng.normal(0.0, 1.0, (NK, NJ, NI)))
    S = 35.0 + rng.normal(0.0, 0.5, (NK, NJ, NI))
    rlay = np.sort(np.asarray(eos.density(jnp.asarray(T.mean((1, 2))),
                                          jnp.asarray(S.mean((1, 2))), 2e7)))
    age = rng.uniform(0.0, 10.0, (NK, NJ, NI))
    return h, T, S, rlay, age


def _unmix_cases(h, T, S, rlay, eos, cfg):
    """The number of columns in each of the unmixing's cases A (entrain),
    B (swap) and C (split, judged on the input)."""
    K = np.arange(NK)[:, None, None]
    R = np.asarray(eos.density(jnp.asarray(T), jnp.asarray(S),
                               cfg.ref_pressure))
    G = rlay[:, None, None] * np.ones_like(h)
    kp = np.where((h >= cfg.h_thin) & (K >= 2), K, 1).max(0)

    def at(x, k):
        return np.take_along_axis(x, np.maximum(k, 0)[None], 0)[0]

    Rk, Rm, Ra = at(R, kp), at(R, kp - 1), at(R, kp - 2)
    Gk, Gm = at(G, kp), at(G, kp - 1)
    base = (kp > cfg.fixlay) & (at(h, kp - 1) >= cfg.h_thin)
    a = base & (Gk > Rk) & (Rm > Rk) & (Ra > Rk)
    b = base & (Gk > Rk) & (Rm > Rk) & ~a
    c = (base & (Rk < Gk) & (Rk > Gm) & (np.abs(Gm - Rm) < cfg.hybiso)
         & (Rk - Rm > 0.001 * (Gk - Gm)))
    return int(a.sum()), int(b.sum()), int(c.sum())


@pytest.mark.parametrize("form", ["WRIGHT", "TEOS10"])
@pytest.mark.parametrize("seed", [0, 2])
def test_hybgen_unmix_matches_jax(seed, form):
    je, te = j_make_eos(form), make_eos(form)
    h, T, S, rlay, age = _unmix_columns(seed, je)
    kw = dict(hybiso=0.5, qhybrlx=0.25)
    assert all(_unmix_cases(h, T, S, rlay, je, jhu.HybgenUnmixCfg(**kw)))
    ref = jhu.hybgen_unmix(*(jnp.asarray(a) for a in (h, T, S)),
                           {"age": jnp.asarray(age)}, je, jnp.asarray(rlay),
                           jhu.HybgenUnmixCfg(**kw))
    out = thu.hybgen_unmix(*(_t(a) for a in (h, T, S)), {"age": _t(age)},
                           te, _t(rlay), thu.HybgenUnmixCfg(**kw))
    # the split's fraction divides density differences of ~0.1 kg m-3,
    # which carry the polynomial forms' 1e-12 kg m-3 of rounding
    # difference (eos/poly.py sums in another order)
    tol = TOL if form == "WRIGHT" else 1e-11
    for name, r, o in zip(("h", "T", "S"), ref[:3], out[:3]):
        _check(r, o, name, tol)
    _check(ref[3]["age"], out[3]["age"], "age", tol)
    assert np.abs(np.asarray(ref[0]) - h).max() > 1.0   # it acted
    assert thu.hybgen_unmix(_t(h)[:2], _t(T)[:2], _t(S)[:2], None, te,
                            _t(rlay)[:2])[3] is None    # nk < 3: unchanged


def _adapt_case(seed):
    rng = np.random.default_rng(seed)
    h = rng.uniform(1.0, 300.0, (NK, NJ, NI))
    T = np.sort(rng.uniform(2.0, 20.0, (NK, NJ, NI)), axis=0)[::-1].copy()
    S = 35.0 + rng.normal(0.0, 0.3, (NK, NJ, NI))
    mask = (rng.random((NJ, NI)) > 0.2).astype(float)
    return h, T, S, mask


@pytest.mark.parametrize("do_min", [False, True])
@pytest.mark.parametrize("alpha", [0.8, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_matches_jax(seed, alpha, do_min):
    h, T, S, mask = _adapt_case(seed)
    kw = dict(mode="ADAPTIVE", adapt_do_min=do_min, adapt_alpha=alpha,
              min_thickness=0.5)
    ref = jrg.build_grid(jrg.RegridCfg(**kw), *(jnp.asarray(a) for a in
                                                (h, h.sum(0), T, S)),
                         j_make_eos("WRIGHT"), mask2dT=jnp.asarray(mask))
    out = trg.build_grid(trg.RegridCfg(**kw), *(_t(a) for a in
                                                (h, h.sum(0), T, S)),
                         make_eos("WRIGHT"), mask2dT=_t(mask))
    _check(ref, out, "h_new")
    assert np.abs(np.asarray(ref) - h).max() > 10.0
    assert torch.equal(out[:, mask == 0.0], _t(h)[:, mask == 0.0])


@pytest.mark.parametrize("given", [False, True])
def test_build_grid_hybgen_matches_jax(given):
    h, _, _, depth, prof = _regrid_columns(3)
    rng = np.random.default_rng(8)
    T = np.sort(rng.uniform(2.0, 20.0, (NK, NJ, NI)), axis=0)[::-1].copy()
    S = 35.0 + rng.normal(0.0, 0.3, (NK, NJ, NI))
    rlay = np.linspace(1025.5, 1028.5, NK)
    kw = dict(mode="HYBGEN", min_thickness=0.5)
    jkw, tkw = dict(kw), dict(kw)
    if given:
        jkw["hybgen"] = jhr.HybgenRegridCfg(**prof, nsigma=1)
        tkw["hybgen"] = thr.HybgenRegridCfg(**prof, nsigma=1)
    ref = jrg.build_grid(jrg.RegridCfg(**jkw), *(jnp.asarray(a) for a in
                                                 (h, depth, T, S)),
                         j_make_eos("TEOS10"), rlay=jnp.asarray(rlay))
    out = trg.build_grid(trg.RegridCfg(**tkw), *(_t(a) for a in
                                                 (h, depth, T, S)),
                         make_eos("TEOS10"), rlay=_t(rlay))
    _check(ref, out, "h_new")


@pytest.mark.parametrize("monotonic", [True, False])
@pytest.mark.parametrize("scheme", ["PLM_HYBGEN", "PPM_HYBGEN",
                                    "WENO_HYBGEN"])
def test_hybgen_remap_schemes_match_jax(scheme, monotonic):
    rng = np.random.default_rng(1)
    h_src = rng.uniform(0.0, 50.0, (NK, NJ, NI))
    h_src[2, 0] = 0.0
    h_src[-1, 1] = 1e-12
    u = np.sin(np.cumsum(h_src, 0) / 30.0) + 0.3 * rng.standard_normal(
        (NK, NJ, NI))
    w = rng.uniform(0.0, 50.0, (NK, NJ, NI))
    h_dst = w / w.sum(0) * h_src.sum(0)
    ref = jrm.remap_column_means(
        *(jnp.asarray(a) for a in (h_src, u, h_dst)),
        jrm.RemapCfg(scheme=scheme, force_monotonic=monotonic))
    out = trm.remap_column_means(
        *(_t(a) for a in (h_src, u, h_dst)),
        trm.RemapCfg(scheme=scheme, force_monotonic=monotonic))
    _check(ref, out, scheme)
    # each reconstruction's pieces as well
    jr = jrm.reconstruct(jnp.asarray(h_src), jnp.asarray(u),
                         jrm.RemapCfg(scheme=scheme))
    tr = trm.reconstruct(_t(h_src), _t(u), trm.RemapCfg(scheme=scheme))
    for name in ("c0", "c1", "c2"):
        _check(getattr(jr, name), getattr(tr, name), f"{scheme} {name}")


def _grid_pair(ni=4, nj=4):
    jd = JDomain(ni=ni, nj=nj, halo=4, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=40.0, lenlat_km=40.0, f0=1e-4,
                          beta=2e-11, max_depth=1000.0)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    tg = grid_from_numpy(gnp, Domain(ni=ni, nj=nj, halo=4, reentrant_x=True),
                         device="cpu", dtype=F64)
    return jd, jg, tg


def _column_state(jd, seed):
    rng = np.random.default_rng(seed)
    shape = (NK, jd.njh, jd.nih)
    h = rng.uniform(0.5, 1.5, shape)
    h = h / h.sum(0) * 1000.0
    T = np.linspace(18.0, 4.0, NK)[:, None, None] \
        + 0.5 * rng.standard_normal(shape)
    S = np.linspace(34.5, 35.5, NK)[:, None, None] \
        + 0.1 * rng.standard_normal(shape)
    u = 0.1 * rng.standard_normal(shape)
    v = 0.1 * rng.standard_normal(shape)
    fill = jd.fill_halos
    return {k: np.asarray(fill(jnp.asarray(a)))
            for k, a in dict(h=h, T=T, S=S, u=u, v=v).items()}


def test_accelerated_hybgen_matches_jax():
    """REGRID_ACCELERATE_INIT under HYBGEN with a deep profile of 5 to
    160 m (under which the isopycnal passes act), the hybgen remap schemes
    and the ROQUET_SPV form.  (HYCOM1 with unmixing and a tracer in
    ale_regrid_remap runs in the model test of
    tests/test_torch_eos_forms.py.)"""
    jd, jg, tg = _grid_pair()
    st = _column_state(jd, 11)
    rlay = np.linspace(1025.0, 1027.6, NK)
    jvg = JVerticalGrid.from_rlay(jnp.asarray(rlay))
    tvg = VerticalGrid.from_rlay(rlay, device="cpu", dtype=F64)
    js = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = State(**{k: _t(v) for k, v in st.items()})
    prof = dict(dp0k=(5.0, 10.0, 20.0, 40.0, 80.0, 160.0),
                ds0k=(1.0,) * NK)
    kw = dict(remap=dict(scheme="PPM_HYBGEN"),
              vel_remap=dict(scheme="WENO_HYBGEN"))
    jcfg = jale.ALECfg(regrid=jrg.RegridCfg(
        mode="HYBGEN", hybgen=jhr.HybgenRegridCfg(**prof)),
        **{k: jrm.RemapCfg(**v) for k, v in kw.items()})
    tcfg = tale.ALECfg(regrid=trg.RegridCfg(
        mode="HYBGEN", hybgen=thr.HybgenRegridCfg(**prof)),
        **{k: trm.RemapCfg(**v) for k, v in kw.items()})
    # one compiled program, with most XLA optimizations off: op by op,
    # the JAX package compiles each of its hundreds of operations
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        ja = jax.jit(lambda s: jale.ale_regrid_accelerated(
            jg, jvg, s, jcfg, 2, eos=j_make_eos("ROQUET_SPV")))(js)
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    ta = tale.ale_regrid_accelerated(tg, tvg, ts, tcfg, 2,
                                     eos=make_eos("ROQUET_SPV"))
    for name in ("h", "T", "S", "u", "v"):
        _check(getattr(ja[0], name), getattr(ta[0], name), f"accel {name}")
    assert np.abs(np.asarray(ja[0].h) - st["h"]).max() > 10.0


# ---- the full-width texts at 16x16x4 ---------------------------------------

@pytest.mark.parametrize("name", ["HYBGEN", "ADAPT", "UNMIX"])
def test_text_is_bench_config_plus_its_lines(name):
    lines = getattr(configs, f"{name}_LINES")
    assert getattr(configs, f"BENCH_CONFIG_{name}") == (configs.BENCH_CONFIG
                                                        + lines)
    assert lines.startswith("#override EQN_OF_STATE = ")


SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n#override LENLON = 160.0\n"
         "#override LENLAT = 160.0\nBT_WIDE_HALO_PERIOD = 2\n"
         "#override DT_THERM = 600.0\n")
H = 4


def _jitted_btstep(fn):
    """The JAX package's btstep under jax.jit, also inside disable_jit:
    run op by op, its substep loop is most of an eager step's time."""
    jf = jax.jit(fn, static_argnums=(0, 12, 13),
                 static_argnames=("nstep", "obc"))

    def call(*args, **kw):
        with jax.disable_jit(False):
            return jf(*args, **kw)
    return call


def _defaults(obj):
    base = type(obj)()
    return {f.name: _defaults(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(base, f.name) for f in dataclasses.fields(obj)}


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _close(ref, out, name, tol):
    a = np.asarray(ref, np.float64)[..., H:-H, H:-H]
    b = out.detach().double().numpy()[..., H:-H, H:-H]
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _jax_run(body):
    """The JAX model of ``body`` and 2 steps of its step_fn from a
    perturbed state (run eagerly but for btstep)."""
    jm = j_build_model(JParamFile(text=body))
    rng = np.random.default_rng(5)
    d, g, st = jm.domain, jm.grid, jm.state

    def noisy(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    st0 = dataclasses.replace(
        st, h=noisy(st.h, 2.0), T=noisy(st.T, 0.5),
        u=noisy(st.u, 0.3, g.mask2dCu), v=noisy(st.v, 0.3, g.mask2dCv))
    step = jm.step_fn()
    js, jsp, jtr = st0, jm.split_state, jm.tracers
    for n in range(2):
        js, jsp, jtr = step(js, jsp, jtr, n)
    return jm, st0, (js, jsp, jtr)


def _port_run(body, jm, st0):
    pm = build_model(ParamFile(text=body), device="cpu", dtype=F64)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    # the initial state, after REGRID_ACCELERATE_INIT where it is set
    for name in ("h", "u", "v", "T", "S"):
        _close(getattr(jm.state, name), getattr(pm.state, name),
               f"initial {name}", 1e-12)
    # eta is the column total less the depth: roundoff around 0
    eta = np.asarray(jm.split_state.eta)[H:-H, H:-H]
    assert np.abs(eta - pm.split.eta.numpy()[H:-H, H:-H]).max() <= 1e-9
    pm = convert.model_with_state(
        pm, _arrays(st0), _arrays(jm.split_state),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step = pm.step_fn()
    ts, tsp, ttr = pm.state, pm.split, pm.tracers
    for n in range(2):
        ts, tsp, ttr = step(ts, tsp, ttr, n)
    return pm, (ts, tsp, ttr)


def test_hybgen_and_adapt_texts_match_step_fn():
    texts = {"HYBGEN": configs.BENCH_CONFIG_HYBGEN + SMALL,
             "ADAPT": configs.BENCH_CONFIG_ADAPT + SMALL}
    for label, body in texts.items():
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            mp.setattr(jrk2, "btstep", _jitted_btstep(jrk2.btstep))
            jm, st0, (js, jsp, jtr) = _jax_run(body)
        pm, (ts, tsp, ttr) = _port_run(body, jm, st0)
        for name in ("h", "u", "v", "T", "S"):
            _close(getattr(js, name), getattr(ts, name), f"{label} {name}",
                   1e-9)
        for name in ("eta", "uh", "vh"):
            _close(getattr(jsp, name), getattr(tsp, name), f"{label} {name}",
                   1e-9)
        _close(jtr["age"], ttr["age"], f"{label} age", 1e-9)
        if label.startswith("HYBGEN"):
            assert pm.cfg.ale.regrid.hybgen is not None
            assert pm.cfg.ale.remap.scheme == "PPM_HYBGEN"
            assert pm.cfg.ale.vel_remap.scheme == "WENO_HYBGEN"
            assert pm.eos.name == "TEOS10"
        else:
            assert pm.cfg.ale.regrid.mode == "ADAPTIVE"
            assert pm.eos.name == "ROQUET_RHO"
