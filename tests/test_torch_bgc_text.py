"""mom6_torch against mom6_tpu: configs.BENCH_CONFIG_BGC, bench.py's
CONFIG with the MARBL-shaped coupler, the coupled CFCs and pseudo-salt
(the seventh breadth item), at 16x16x4 from the files of
configs.write_bgc_inputs (seed 0), built by both packages from one case
directory: the configuration, the tracers' initial fields and the
coupler's restoring data and forcing sources equal, then 3 steps of
Model.step_fn (a dynamics, a thermodynamic and a dynamics step; the JAX
step compiled once a kind of step with most XLA optimizations off) to
1e-9, every tracer among them.
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
BGC = ("no3", "po4", "sio3", "fe", "dic", "alk", "o2", "doc", "poc",
       "cfc11", "cfc12")


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


def test_bgc_text_matches_jax(tmp_path):
    n = 16
    configs.write_bgc_inputs(str(tmp_path), n, n, seed=0)
    text = configs.BENCH_CONFIG_BGC + (
        f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {n}\n"
        f"#override NJGLOBAL = {n}\n#override NK = 4\n"
        f"#override LENLON = {n * 10.0}\n#override LENLAT = {n * 10.0}\n"
        f"INPUTDIR = {tmp_path}\n")
    assert configs.BENCH_CONFIG_BGC == configs.BENCH_CONFIG \
        + configs.BGC_LINES
    path = tmp_path / "MOM_input"
    path.write_text(text)
    jm = j_build_model(JParamFile(str(path)))
    pm = build_model(ParamFile(str(path)), device="cpu", dtype=F64)
    assert list(pm.tracers) == list(jm.tracers)
    assert len(pm.tracers) == 13 and set(BGC) <= set(pm.tracers)
    for k, v in jm.tracers.items():
        _check(v, pm.tracers[k], f"initial {k}", tol=0.0)
    jb, pb = jm.ocean_cfg.bgc, pm.cfg.bgc
    assert list(pb._specs) == list(jb._specs)
    assert sorted(pb.forcing_sources.sources) \
        == sorted(jb.forcing_sources.sources)
    for k in ("riv_no3", "riv_doc", "dust_fe", "ndep", "fesedflux"):
        _check(jb.forcing_sources.sources[k].data,
               pb.forcing_sources.sources[k].data, f"source {k}")
    _check(jb.restoring.dz, pb.restoring.dz, "restoring dz", tol=0.0)
    _check(jb.restoring.i_tau, pb.restoring.i_tau, "i_tau", tol=0.0)
    for k in ("no3", "po4", "sio3"):
        _check(jb.restoring.clim[k], pb.restoring.clim[k], f"clim {k}",
               tol=0.0)
    jcfg = {f.name: getattr(jm.ocean_cfg, f.name)
            for f in dataclasses.fields(jm.ocean_cfg)
            if f.name not in ("sponge_data", "bgc")}
    cfg = convert.config_from_values(
        OceanCfg, {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                   else v for k, v in jcfg.items()},
        _defaults(dataclasses.replace(jm.ocean_cfg, bgc=None)))
    assert cfg == dataclasses.replace(pm.cfg, sponge=None, bgc=None)

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
    for name in jtr:
        _check(np.asarray(jtr[name])[..., H:-H, H:-H],
               ttr[name][..., H:-H, H:-H], name, tol=1e-9)
    for name in BGC:
        assert float(ttr[name].min()) >= 0.0, name
    # the coupler moved every tracer it owns
    for name in BGC:
        assert not torch.equal(ttr[name], pm.tracers[name]), name
