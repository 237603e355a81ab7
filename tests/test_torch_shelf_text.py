"""mom6_torch against mom6_tpu: the ice shelf coupled to the ocean, in
float64 on the CPU, built by both packages from one MOM_input and
stepped by both ``Model.step_fn`` (the JAX step compiled once a kind
of step with most XLA optimizations off):

* tests/test_shelf_coupling.py's BASE (a layered channel, linear EOS,
  under a 400 m channel shelf, every step thermodynamic), with
  SHELF_STRESS_FRACTION 0.25: the shelf configuration and state, the
  depressed initial thicknesses, then 4 steps to 1e-9;
* ``configs.BENCH_CONFIG_SHELF`` (bench.py's CONFIG under a 500 m shelf
  over the ISOMIP profile) at 16x16x4: the build, then 3 steps (a
  dynamics, a thermodynamic and a dynamics step) to 1e-9.
"""

import dataclasses

import numpy as np
import jax
import torch

from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.ice_shelf import shelf_main as jsm
from mom6_tpu.model import build_model as j_build_model

from mom6_torch import configs, convert
from mom6_torch.framework.config import ParamFile
from mom6_torch.ice_shelf import shelf_main as psm
from mom6_torch.model import build_model

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
H = 4


def _check(ref, out, name, tol):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _both(text, nsteps):
    """Both models of ``text`` and their states after ``nsteps`` steps:
    (JAX model, port model, JAX (state, split, tracers), port's)."""
    jm = j_build_model(JParamFile(text=text))
    pm = build_model(ParamFile(text=text), device="cpu", dtype=F64)
    assert pm.shelf_cfg == convert.config_from_values(
        psm.ShelfCfg, dataclasses.asdict(jm.shelf_cfg),
        dataclasses.asdict(jsm.ShelfCfg()))
    for name in ("h_shelf", "area_frac", "bed_elev"):
        _check(getattr(jm.ice_shelf, name), getattr(pm.ice_shelf, name),
               name, 0.0)
    for name in ("h", "T", "S"):
        _check(getattr(jm.state, name), getattr(pm.state, name),
               f"initial {name}", 1e-15)
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        step = jm.step_fn()
        jcur = (jm.state, jm.split_state, jm.tracers)
        for k in range(nsteps):
            jcur = step(*jcur, k)
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    pstep = pm.step_fn()
    pcur = (pm.state, pm.split, pm.tracers)
    for k in range(nsteps):
        pcur = pstep(*pcur, k)
    (js, jsp, jtr), (ts, tsp, ttr) = jcur, pcur
    for name in ("h", "u", "v", "T", "S"):
        _check(np.asarray(getattr(js, name))[..., H:-H, H:-H],
               getattr(ts, name)[..., H:-H, H:-H], name, 1e-9)
    for name in ("eta", "uh", "vh"):
        _check(np.asarray(getattr(jsp, name))[..., H:-H, H:-H],
               getattr(tsp, name)[..., H:-H, H:-H], name, 1e-9)
    for name in jtr or {}:
        _check(np.asarray(jtr[name])[..., H:-H, H:-H],
               ttr[name][..., H:-H, H:-H], name, 1e-9)
    return jm, pm, jcur, pcur


BASE = """
NIGLOBAL = 16
NJGLOBAL = 10
NK = 3
DT = 600.0
DT_THERM = 600.0
DAYMAX = 0.01
GRID_CONFIG = cartesian
AXIS_UNITS = k
LENLON = 160.0
LENLAT = 100.0
TOPO_CONFIG = flat
MAXIMUM_DEPTH = 800.0
F_0 = 1.0e-4
TS_CONFIG = linear
T_REF = 2.0
T_RANGE = 1.0
S_REF = 34.5
EQN_OF_STATE = LINEAR
BULKMIXEDLAYER = False
ICE_SHELF = True
ICE_PROFILE_CONFIG = channel
SHELF_MAX_THICKNESS = 400.0
SHELF_LENGTH_LON = 60.0
WIND_CONFIG = constant
TAUX_MAGNITUDE = 0.1
"""


def test_shelf_coupling_base_matches_jax():
    """BASE with SHELF_STRESS_FRACTION 0.25, so that the shielding's
    fraction is taken too."""
    _, pm, _, (ts, _, _) = _both(BASE + "SHELF_STRESS_FRACTION = 0.25\n", 4)
    # the melt cooled the water under the shelf
    under = pm.ice_shelf.h_shelf[H:-H, H:-H] > 1.0
    dT = (ts.T[0] - pm.state.T[0])[H:-H, H:-H]
    assert float(dT[under].mean()) < float(dT[~under].mean())


def test_shelf_text_matches_jax():
    n = 16
    assert configs.BENCH_CONFIG_SHELF == configs.BENCH_CONFIG \
        + configs.SHELF_LINES
    text = configs.BENCH_CONFIG_SHELF + (
        f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {n}\n"
        f"#override NJGLOBAL = {n}\n#override NK = 4\n"
        f"#override LENLON = {n * 10.0}\n#override LENLAT = {n * 10.0}\n")
    _, pm, _, (ts, _, _) = _both(text, 3)
    assert not pm.domain.reentrant_x
    # the shelf covers the western quarter, 500 m at the wall
    hs = pm.ice_shelf.h_shelf[H:-H, H:-H]
    assert abs(float(hs[:, 0].max()) - 500.0 * (1.0 - 0.5 / 4.0)) < 1e-9
    assert float(hs[:, n // 4:].abs().max()) == 0.0
    # the columns under it are depressed by the ice's draft
    htot = ts.h.sum(0)[H:-H, H:-H]
    assert float(htot[:, 0].max()) < 4000.0 - 350.0
