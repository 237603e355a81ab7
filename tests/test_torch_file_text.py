"""mom6_torch against mom6_tpu: configs.BENCH_CONFIG_FILE, bench.py's
CONFIG set up and forced from files (the ninth breadth item), at
16x16x4 from the files of configs.write_file_inputs (seed 0), built by
both packages from one case directory: the configuration, the initial
state and the sponge equal, then 3 steps of Model.step_fn (a dynamics,
a thermodynamic and a dynamics step; the JAX step compiled once a kind
of step with most XLA optimizations off) to 1e-9.
"""

import dataclasses

import numpy as np
import jax
import torch

from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model

from mom6_torch import configs, convert
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
H = 4


def _check(ref, out, name, tol=1e-12):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _defaults(obj):
    base = type(obj)()
    return {f.name: _defaults(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(base, f.name) for f in dataclasses.fields(obj)}


def test_file_text_matches_jax(tmp_path):
    n = 16
    configs.write_file_inputs(str(tmp_path), n, n, seed=0)
    text = configs.BENCH_CONFIG_FILE + (
        f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {n}\n"
        f"#override NJGLOBAL = {n}\n#override NK = 4\n"
        f"#override LENLON = {n * 10.0}\n#override LENLAT = {n * 10.0}\n"
        f"INPUTDIR = {tmp_path}\n")
    (tmp_path / "MOM_input").write_text(text)
    path = str(tmp_path / "MOM_input")
    jm = j_build_model(JParamFile(path))
    pm = build_model(ParamFile(path), device="cpu", dtype=F64)
    assert jm.data_override is not None and pm.data_override is not None
    assert pm.forces_fn is not None and pm.fluxes_fn is not None
    jsd, psd = jm.ocean_cfg.sponge_data, pm.cfg.sponge
    assert psd["ref_h"].shape[0] == len(configs.WOA_DEPTHS)
    for k in ("idamp", "T", "S", "ref_h"):
        _check(jsd[k], psd[k], f"sponge {k}", tol=0.0)
    for k in ("h", "T", "S"):
        _check(getattr(jm.state, k), getattr(pm.state, k), f"initial {k}")
    cfg = convert.config_from_values(
        OceanCfg, {k: v for k, v in dataclasses.asdict(jm.ocean_cfg).items()
                   if k != "sponge_data"}, _defaults(jm.ocean_cfg))
    assert cfg == dataclasses.replace(pm.cfg, sponge=None)
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        step = jm.step_fn()
        js, jsp_, jtr = jm.state, jm.split_state, jm.tracers
        for k in range(3):
            js, jsp_, jtr = step(js, jsp_, jtr, k)
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    pstep = pm.step_fn()
    ts, tsp_, ttr = pm.state, pm.split, pm.tracers
    for k in range(3):
        ts, tsp_, ttr = pstep(ts, tsp_, ttr, k)
    for name in ("h", "u", "v", "T", "S"):
        _check(np.asarray(getattr(js, name))[..., H:-H, H:-H],
               getattr(ts, name)[..., H:-H, H:-H], name, tol=1e-9)
    for name in ("eta", "uh", "vh"):
        _check(np.asarray(getattr(jsp_, name))[..., H:-H, H:-H],
               getattr(tsp_, name)[..., H:-H, H:-H], name, tol=1e-9)
    _check(np.asarray(jtr["age"])[..., H:-H, H:-H],
           ttr["age"][..., H:-H, H:-H], "age", tol=1e-9)
    assert float(ts.u.abs().max()) > 1e-4
