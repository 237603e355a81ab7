"""mom6_torch against mom6_tpu: MOM6's layered mode with thermodynamics,
on the CPU in float64.

* ``Model.step_fn`` of ``configs.BENCH_CONFIG_BML`` (bench.py's layered
  variant with the bulk mixed layer, LMD94 shear mixing, diffusive
  entrainment, the regularization of the surface layers and frazil) at
  16x16x4 in a weakly stratified 400 m column for 3 steps from a
  perturbed state, with the shear-viscosity and frazil carries (1e-9);
  the builder's configuration equals the JAX builder's.
* BULKMIXEDLAYER with USE_REGRIDDING raises ValueError in both builders.
* ``cases/layer_mode`` (spherical grid, bowl topography, WRIGHT_FULL,
  the bulk mixed layer with regularization) through both solo drivers
  for 4 steps of 900 s, ocean.stats written every step: the tolerances
  of tests/test_torch_solo.py (energy and CFL 1e-9, SL and the mass
  error 1e-12 absolute, the rest as printed).
* Each MOM_parameter_doc.all line the port writes for
  ``cases/layer_mode`` and ``cases/benchmark`` equals the JAX driver's
  line for that parameter.  (The JAX file holds 33 more, the MEKE and
  VarMix parameters of the fourth breadth item.)

The JAX side of the model test runs eagerly but for its barotropic
solve; its driver compiles with most XLA optimizations off.
"""

import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import dynamics_split_rk2 as jrk2
from mom6_tpu.drivers import solo as jsolo
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model

from mom6_torch import configs, convert
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.drivers import solo
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
H = 4
SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n#override LENLON = 160.0\n"
         "#override LENLAT = 160.0\n"
         "#override MAXIMUM_DEPTH = 400.0\n#override T_RANGE = 0.2\n")
DAYS = "0.0417"                  # 4 steps of 900 s
EVERY_STEP = "#override ENERGYSAVEDAYS = 0.010416666666666666\n"


def _close(ref, out, tol, name):
    a = np.asarray(ref, np.float64)[..., H:-H, H:-H]
    b = out.detach().double().numpy()[..., H:-H, H:-H]
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _defaults(obj):
    base = type(obj)()
    return {f.name: _defaults(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(base, f.name) for f in dataclasses.fields(obj)}


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def test_bml_text_matches_step_fn(monkeypatch):
    """Steps 0-2, the second a thermodynamic step: the bulk mixed layer,
    entrainment and regularization move the interfaces."""
    jf = jax.jit(jrk2.btstep, static_argnums=(0, 12, 13),
                 static_argnames=("nstep", "obc"))

    def btstep(*args, **kw):
        with jax.disable_jit(False):
            return jf(*args, **kw)
    monkeypatch.setattr(jrk2, "btstep", btstep)
    body = configs.BENCH_CONFIG_BML + SMALL
    jm = j_build_model(JParamFile(text=body))
    pm = build_model(ParamFile(text=body), device="cpu", dtype=F64)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg and cfg.diabatic.use_bml and cfg.ale is None
    rng = np.random.default_rng(5)
    d, g, st = jm.domain, jm.grid, jm.state

    def noisy(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    st0 = dataclasses.replace(
        st, h=noisy(st.h, 2.0), T=noisy(st.T, 0.5),
        u=noisy(st.u, 0.3, g.mask2dCu), v=noisy(st.v, 0.3, g.mask2dCv))
    sp0 = jm.split_state
    with jax.disable_jit():
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
    for name in ("h", "u", "v", "T", "S", "frazil"):
        _close(getattr(js, name), getattr(ts, name), 1e-9, name)
    for name in ("eta", "u_av", "v_av", "uh", "vh"):
        _close(getattr(jsp, name), getattr(tsp, name), 1e-9, name)
    _close(jtr["age"], ttr["age"], 1e-9, "age")
    jc, tc = step_j.carry(), step_p.carry()
    _close(jc["kv"], tc["kv"], 1e-9, "kv")
    assert jc["mld"] is None and tc["mld"] is None
    h0 = np.asarray(st0.h)[0, H:-H, H:-H]
    assert float(ts.h[0, H:-H, H:-H].max()) > float(h0.max())


def test_bml_with_regridding_raises_as_jax():
    text = configs.BENCH_CONFIG + SMALL + "#override BULKMIXEDLAYER = True\n"
    with pytest.raises(ValueError, match="BULKMIXEDLAYER"):
        j_build_model(JParamFile(text=text))
    with pytest.raises(ValueError, match="BULKMIXEDLAYER"):
        build_model(ParamFile(text=text), device="cpu", dtype=F64)


# ---- the cases through the drivers -----------------------------------------

def _case_copy(tmp_path_factory, case, name, extra=""):
    d = tmp_path_factory.mktemp(name)
    text = (ROOT / "cases" / case / "MOM_input").read_text()
    (d / "MOM_input").write_text(text + extra)
    return d


@pytest.fixture(scope="module")
def layer_mode_runs(tmp_path_factory):
    jd = _case_copy(tmp_path_factory, "layer_mode", "jax_lm", EVERY_STEP)
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jsolo.main([str(jd), "--days", DAYS, "--cpu"])
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    pd = _case_copy(tmp_path_factory, "layer_mode", "port_lm", EVERY_STEP)
    solo.main([str(pd), "--days", DAYS, "--cpu"])
    return jd, pd


def _stats(path):
    out = {}
    for line in path.read_text().splitlines()[2:]:
        step, day, truncs, *rest = [c.strip() for c in line.split(",")]
        row = {"day": day, "truncs": truncs}
        row.update(c.split(None, 1) for c in rest)
        out[int(step)] = row
    return out


def test_layer_mode_stats_match_jax(layer_mode_runs):
    jd, pd = layer_mode_runs
    want, got = _stats(jd / "ocean.stats"), _stats(pd / "ocean.stats")
    assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4]
    for n, w in want.items():
        g = got[n]
        for k in ("day", "truncs", "M", "S", "T"):
            assert g[k] == w[k], (n, k)
        en_w, en_g = float(w["En"]), float(g["En"])
        assert abs(en_g - en_w) <= 1e-9 * abs(en_w), (n, en_g, en_w)
        assert abs(float(g["CFL"]) - float(w["CFL"])) <= 1e-9, n
        assert abs(float(g["SL"]) - float(w["SL"])) <= 1e-12, n
        assert abs(float(g["Me"]) - float(w["Me"])) <= 1e-12, n
    assert float(want[4]["En"]) > 0.0


def _doc_lines(path):
    return {line.split(" = ", 1)[0]: line
            for line in path.read_text().splitlines()
            if " = " in line and not line.lstrip().startswith("!")}


@pytest.mark.parametrize("case", ["layer_mode", "benchmark"])
def test_parameter_doc_matches_jax(case, tmp_path_factory, layer_mode_runs):
    if case == "layer_mode":
        jd, pd = layer_mode_runs
    else:
        # the drivers write the docs before stepping: no step is needed
        jd = _case_copy(tmp_path_factory, case, "jax_bm")
        jsolo.main([str(jd), "--days", "0", "--cpu"])
        pd = _case_copy(tmp_path_factory, case, "port_bm")
        solo.main([str(pd), "--days", "0", "--cpu"])
    want = _doc_lines(jd / "MOM_parameter_doc.all")
    got = _doc_lines(pd / "MOM_parameter_doc.all")
    assert len(got) > 250
    for name, line in got.items():
        assert line == want.get(name), name
    for name in ("BULKMIXEDLAYER", "NKML", "NKBL", "GRID_CONFIG", "MSTAR"):
        assert name in got, name
