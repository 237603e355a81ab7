"""mom6_torch against mom6_tpu: every equation of state, and a model on the
Roquet specific-volume fit, on the CPU in float64.

* Each of the nine EQN_OF_STATE forms and each EOS method on seeded
  T in [-2, 30] degC, S in [30, 38] and p in [0, 6e7] Pa, through the JAX
  package eagerly and the port: density (rho_ref 0 and 1035), spec_vol
  (spv_ref 0 and 1/1035), density_derivs, compressibility and the five
  second derivatives; 1e-12 relative to each field's maximum.  The one
  exception is d2rho/dS2 of the three polynomial forms (ROQUET_RHO,
  ROQUET_SPV, TEOS10), held at 5e-12: the port sums the polynomial in
  another order (``eos/poly.py``), and against the derivative taken in
  40-digit arithmetic the JAX package's value is itself off by up to
  2.3e-12 of the field's maximum there, the port's by 1.1e-12.
* UNESCO and JACKETT_06 give drho/dS = NaN at S = 0 in both packages (0
  times the infinite slope of sqrt in forward-mode autodiff); the other
  forms stay finite there.
* temperature_convert's three functions, 1e-13.
* A polynomial form's density is a few tens of kernels (aten ops), not
  seven a term.
* ``configs.BENCH_CONFIG_UNMIX`` (HYCOM1 with hybgen unmixing on the
  ROQUET_SPV fit) at 16x16x4 with DT_THERM = DT: the configuration equal
  to the JAX builder's, and 2 steps of ``Model.step_fn`` from a perturbed
  state, 1e-9 relative on h, u, v, T, S, age, eta, uh and vh.  The JAX
  side runs eagerly but for its barotropic solve.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mom6_tpu import eos as jeos
from mom6_tpu.core import dynamics_split_rk2 as jrk2
from mom6_tpu.eos import temperature_convert as jtc
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model

from mom6_torch import configs, convert
from mom6_torch import eos as teos
from mom6_torch.core.orchestrator import OceanCfg
from mom6_torch.eos import temperature_convert as ttc
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
FORMS = ["LINEAR", "WRIGHT", "WRIGHT_FULL", "WRIGHT_RED", "UNESCO",
         "JACKETT_06", "ROQUET_RHO", "ROQUET_SPV", "TEOS10"]
POLY = ("ROQUET_RHO", "ROQUET_SPV", "TEOS10")
RHO_REF = 1035.0
METHODS = {
    "density": lambda e, *x: [e.density(*x)],
    "density_rho_ref": lambda e, *x: [e.density(*x, rho_ref=RHO_REF)],
    "spec_vol": lambda e, *x: [e.spec_vol(*x)],
    "spec_vol_spv_ref": lambda e, *x: [e.spec_vol(*x,
                                                  spv_ref=1.0 / RHO_REF)],
    "density_derivs": lambda e, *x: list(e.density_derivs(*x)),
    "compressibility": lambda e, *x: [e.compressibility(*x)],
    "density_second_derivs": lambda e, *x: list(
        e.density_second_derivs(*x)),
}


def _err(ref, out):
    a = np.asarray(ref)
    b = out.numpy()
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-300)


def _tsp(seed=0, shape=(4, 6, 7)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2.0, 30.0, shape), rng.uniform(30.0, 38.0, shape),
            rng.uniform(0.0, 6e7, shape))


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("form", FORMS)
def test_eos_method_matches_jax(form, method):
    x = _tsp()
    refs = METHODS[method](jeos.make_eos(form),
                           *(jnp.asarray(a) for a in x))
    outs = METHODS[method](teos.make_eos(form),
                           *(torch.tensor(a, dtype=F64) for a in x))
    assert len(refs) == len(outs)
    for i, (r, o) in enumerate(zip(refs, outs)):
        tol = 5e-12 if (method == "density_second_derivs" and i == 0
                        and form in POLY) else 1e-12
        if not np.abs(np.asarray(r)).max():
            assert not o.abs().max(), f"{form} {method}[{i}] not zero"
            continue
        assert _err(r, o) <= tol, \
            f"{form} {method}[{i}]: {_err(r, o):.3e} > {tol:.0e}"


@pytest.mark.parametrize("form", FORMS)
def test_derivatives_at_zero_salinity(form):
    """drho/dS at S = 0: NaN for UNESCO and JACKETT_06 in both packages,
    a fault of the JAX package that the port follows; finite for every
    other form.  drho/dT is finite for all."""
    T, _, p = _tsp(1, (3, 4))
    S = np.zeros_like(T)
    jd = jeos.make_eos(form).density_derivs(
        *(jnp.asarray(a) for a in (T, S, p)))
    td = teos.make_eos(form).density_derivs(
        *(torch.tensor(a, dtype=F64) for a in (T, S, p)))
    nan = form in ("UNESCO", "JACKETT_06")
    assert np.isnan(np.asarray(jd[1])).all() == nan
    assert bool(torch.isnan(td[1]).all()) == nan
    if not nan:
        assert torch.isfinite(td[1]).all() and _err(jd[1], td[1]) <= 1e-12
    assert torch.isfinite(td[0]).all() and _err(jd[0], td[0]) <= 1e-12


@pytest.mark.parametrize("fn", ["poTemp_to_consTemp", "dTc_dTp",
                                "consTemp_to_poTemp"])
def test_temperature_convert_matches_jax(fn):
    rng = np.random.default_rng(2)
    T = rng.uniform(-2.0, 32.0, (5, 7))
    Sa = rng.uniform(0.0, 42.0, (5, 7))
    ref = getattr(jtc, fn)(jnp.asarray(T), jnp.asarray(Sa))
    out = getattr(ttc, fn)(torch.tensor(T), torch.tensor(Sa))
    assert _err(ref, out) <= 1e-13, f"{fn}: {_err(ref, out):.3e}"


def test_temperature_convert_round_trip():
    rng = np.random.default_rng(4)
    T = torch.tensor(rng.uniform(-2.0, 32.0, (6, 5)))
    Sa = torch.tensor(rng.uniform(0.0, 42.0, (6, 5)))
    back = ttc.consTemp_to_poTemp(ttc.poTemp_to_consTemp(T, Sa), Sa)
    assert float((back - T).abs().max()) <= 1e-10


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view     # a view launches nothing
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("form", POLY)
def test_polynomial_density_is_a_few_kernels(form):
    """55 or 75 terms in about thirty aten ops that are not views (each
    a kernel on the card) once the coefficients are on the device, where
    the term-by-term form takes about seven a term."""
    T, S, p = (torch.tensor(a, dtype=F64) for a in _tsp(3))
    e = teos.make_eos(form)
    e.density(T, S, p)
    with _CountOps() as c:
        e.density(T, S, p)
    assert c.n <= 40, f"{form}: {c.n} aten ops"


# ---- the HYCOM1 text with unmixing on ROQUET_SPV ---------------------------

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


def _step_close(ref, out, name):
    a = np.asarray(ref, np.float64)[..., H:-H, H:-H]
    b = out.detach().double().numpy()[..., H:-H, H:-H]
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= 1e-9, f"{name}: relative error {err:.3e} > 1e-9"


def test_unmix_text_matches_step_fn():
    body = configs.BENCH_CONFIG_UNMIX + SMALL
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jrk2, "btstep", _jitted_btstep(jrk2.btstep))
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

    pm = build_model(ParamFile(text=body), device="cpu", dtype=F64)
    cfg = convert.config_from_values(OceanCfg,
                                     dataclasses.asdict(jm.ocean_cfg),
                                     _defaults(jm.ocean_cfg))
    assert cfg == pm.cfg
    assert cfg.ale.hybgen_unmix is not None
    assert cfg.ale.regrid.mode == "HYCOM1"
    assert pm.eos.name == "ROQUET_SPV"
    pm = convert.model_with_state(
        pm, _arrays(st0), _arrays(jm.split_state),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step = pm.step_fn()
    ts, tsp, ttr = pm.state, pm.split, pm.tracers
    for n in range(2):
        ts, tsp, ttr = step(ts, tsp, ttr, n)
    for name in ("h", "u", "v", "T", "S"):
        _step_close(getattr(js, name), getattr(ts, name), name)
    for name in ("eta", "uh", "vh"):
        _step_close(getattr(jsp, name), getattr(tsp, name), name)
    _step_close(jtr["age"], ttr["age"], "age")
