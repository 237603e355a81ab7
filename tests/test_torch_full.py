"""mom6_torch against mom6_tpu: the full ocean step of bench.py's CONFIG
with USE_REGRIDDING = False and BT_WIDE_HALO_PERIOD = 2, at 16x16x4.

The JAX model comes from ``build_model(ParamFile(text=...))`` of that
text, built once per module; the port's from ``entry.build_full``.
The first test holds every configuration value and every initial field
of the two builds equal (1e-13 relative for the fields).  The second
adds a seeded perturbation to the JAX model's initial h, T, u and v
(the configuration starts at rest and horizontally uniform, where the
first step's v and eta are roundoff-sized and no comparison would mean
anything), carries the state, tracers and configuration into the port
with ``mom6_torch.convert`` and runs two steps on device="cpu" in
float64 (step 0 dynamics only, step 1 a thermodynamic step, as
DT_THERM = 2 DT), against two steps of ``Model.step_fn``: h, u, v, T,
S, age and eta agree to 1e-9 relative to each field's maximum on the
compute domain.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.framework.config import ParamFile
from mom6_tpu.model import build_model

from mom6_torch import convert, entry
from mom6_torch.core.orchestrator import OceanCfg

F64 = torch.float64
NI, NJ, NK = 16, 16, 4
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _bench_config():
    spec = importlib.util.spec_from_file_location("_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CONFIG


TEXT_OVERRIDES = (
    "#override USE_REGRIDDING = False\nBT_WIDE_HALO_PERIOD = 2\n"
    f"#override NIGLOBAL = {NI}\n#override NJGLOBAL = {NJ}\n"
    f"#override NK = {NK}\n#override LENLON = {NI * 10.0}\n"
    f"#override LENLAT = {NJ * 10.0}\n")


@pytest.fixture(scope="module", autouse=True)
def _quick_xla_compile():
    """Compile the JAX references with most XLA optimizations off: at
    this size their compile time is most of the test's time."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def jax_model():
    return build_model(ParamFile(text=_bench_config() + TEXT_OVERRIDES))


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


def _port_cfg(jm):
    return convert.config_from_values(
        OceanCfg, dataclasses.asdict(jm.ocean_cfg), _defaults(jm.ocean_cfg))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _close(ref, out, tol, name, H=None):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    if H is not None:
        a, b = a[..., H:-H, H:-H], b[..., H:-H, H:-H]
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def test_build_full_matches_build_model(jax_model):
    jm = jax_model
    pm = entry.build_full(NI, NJ, NK, device="cpu", dtype=F64)
    # configuration: the JAX values carried over equal the port's own
    assert _port_cfg(jm) == pm.cfg
    assert (jm.dt, jm.dt_therm) == (pm.dt, pm.dt_therm)
    assert jm.eos.name == pm.eos.name and jm.eos.variant == pm.eos.variant
    assert dataclasses.asdict(jm.domain)["halo"] == pm.domain.halo
    assert (jm.domain.ni, jm.domain.nj, jm.domain.reentrant_x,
            jm.domain.reentrant_y) == (pm.domain.ni, pm.domain.nj,
                                       pm.domain.reentrant_x,
                                       pm.domain.reentrant_y)
    fcfg, _, south, lenlat = jm.fluxes_fn.__defaults__
    assert dataclasses.asdict(fcfg) == dataclasses.asdict(pm.forcing_cfg)
    assert (south, lenlat) == (pm.south, pm.lenlat)
    assert jm.tracer_registry.names() == pm.registry.names()
    for k in ("nk", "g_Earth", "Rho0", "boussinesq", "angstrom"):
        assert getattr(jm.vgrid, k) == getattr(pm.vgrid, k), k
    # fields: grid, vertical grid, forcing, state, split state, tracers
    for name, v in _fields(pm.grid).items():
        if torch.is_tensor(v):
            _close(getattr(jm.grid, name), v, 1e-13, f"grid.{name}")
    _close(jm.vgrid.Rlay, pm.vgrid.Rlay, 1e-13, "Rlay")
    _close(jm.vgrid.g_prime, pm.vgrid.g_prime, 1e-13, "g_prime")
    assert jm.forces.tauy is None and pm.forces.tauy is None
    _close(jm.forces.taux, pm.forces.taux, 1e-13, "taux")
    for name in ("u", "v", "h", "T", "S"):
        _close(getattr(jm.state, name), getattr(pm.state, name), 1e-13,
               f"state.{name}")
    for name, v in _fields(pm.split).items():
        _close(getattr(jm.split_state, name), v, 1e-13, f"split.{name}")
    _close(jm.tracers["age"], pm.tracers["age"], 1e-13, "age")
    fl_j = jm.fluxes_fn(jm.state, 0.0)
    fl_p = pm.fluxes(pm.state)
    _close(fl_j.sensible, fl_p.sensible, 1e-13, "fluxes.sensible")
    assert fl_j.salt_flux is None and fl_p.salt_flux is None


def test_two_steps_match_step_fn(jax_model):
    jm = jax_model
    rng = np.random.default_rng(7)
    d, g = jm.domain, jm.grid

    def perturbed(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    st0 = dataclasses.replace(
        jm.state, h=perturbed(jm.state.h, 2.0), T=perturbed(jm.state.T, 0.5),
        u=perturbed(jm.state.u, 0.05, g.mask2dCu),
        v=perturbed(jm.state.v, 0.05, g.mask2dCv))
    step_j = jm.step_fn()
    st, sp, tr = st0, jm.split_state, jm.tracers
    for n in range(2):
        st, sp, tr = step_j(st, sp, tr, n)

    pm = entry.build_full(NI, NJ, NK, device="cpu", dtype=F64)
    pm.cfg = _port_cfg(jm)

    def arrays(obj):
        return {k: np.asarray(v) for k, v in _fields(obj).items()
                if v is not None}

    pm.state = convert.state_from_numpy(arrays(st0), device="cpu",
                                        dtype=F64)
    pm.split = convert.split_state_from_numpy(arrays(jm.split_state),
                                              device="cpu", dtype=F64)
    pm.tracers = convert.tracers_from_numpy(
        {k: np.asarray(v) for k, v in jm.tracers.items()}, device="cpu",
        dtype=F64)
    step_p = pm.step_fn()
    pst, psp, ptr = pm.state, pm.split, pm.tracers
    for n in range(2):
        pst, psp, ptr = step_p(pst, psp, ptr, n)
    for name in ("h", "u", "v", "T", "S"):
        _close(getattr(st, name), getattr(pst, name), 1e-9, name, H=4)
    _close(tr["age"], ptr["age"], 1e-9, "age", H=4)
    _close(sp.eta, psp.eta, 1e-9, "eta", H=4)
    # the step really moved the state
    assert float(np.abs(np.asarray(st.u)).max()) > 0.0
