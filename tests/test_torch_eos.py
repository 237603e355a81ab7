"""mom6_torch against mom6_tpu: the equations of state and the pressure
force with an equation of state.

Seeded numpy T/S/p (ocean ranges) go through each JAX EOS method,
under jax.jit in float64, and the port's on device="cpu" in float64:
density, density_derivs, compressibility and the five second
derivatives (nested forward-mode autodiff on both sides), for the
Wright forms and the linear form; tolerance 1e-13 relative to each
field's maximum.  The pressure force and pbce with the Wright EOS,
midpoint and 5-point quadrature (with and without the PLM
reconstruction), at 12x10x5: tolerance 1e-11 relative on the compute
domain (PFu/PFv are differences of pressures ~1e7 larger).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu import eos as jeos
from mom6_tpu.core import pressure_force as jpf
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch import eos as teos
from mom6_torch.convert import grid_from_numpy
from mom6_torch.core import pressure_force as tpf
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
FORMS = ["WRIGHT", "WRIGHT_FULL", "WRIGHT_RED", "LINEAR"]


def _err(ref, out):
    a = np.asarray(ref)
    b = out.numpy()
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-300)


def _tsp(seed=0, shape=(4, 6, 7)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2.0, 30.0, shape), rng.uniform(30.0, 38.0, shape),
            rng.uniform(0.0, 5e7, shape))


@pytest.mark.parametrize("form", FORMS)
def test_eos_matches_jax(form):
    T, S, p = _tsp()
    j = jeos.make_eos(form)
    t = teos.make_eos(form)
    def quantities(e, *x):
        return [e.density(*x), e.density(*x, rho_ref=1000.0), e.spec_vol(*x),
                e.compressibility(*x), *e.density_derivs(*x),
                *e.density_second_derivs(*x)]

    refs = jax.jit(lambda *x: quantities(j, *x))(
        *(jnp.asarray(a) for a in (T, S, p)))
    outs = quantities(t, *(torch.tensor(a, dtype=F64) for a in (T, S, p)))
    pairs = list(zip(refs, outs))
    assert len(pairs) == 11
    for i, (r, o) in enumerate(pairs):
        assert _err(r, o) <= 1e-13 or np.abs(np.asarray(r)).max() == 0.0 \
            and not o.abs().max(), f"{form} quantity {i}: {_err(r, o):.3e}"


def test_base_autodiff_derivs_match_written_out_ones():
    """The base class's forward-mode derivatives against Wright's
    written-out ones (the port's torch.func path)."""
    T, S, p = (torch.tensor(a, dtype=F64) for a in _tsp(1))
    w = teos.make_eos("WRIGHT")
    for got, want in zip(teos.EOS.density_derivs(w, T, S, p),
                         w.density_derivs(T, S, p)):
        assert torch.allclose(got, want, rtol=1e-12, atol=0.0)
    assert torch.allclose(teos.EOS.compressibility(w, T, S, p),
                          w.compressibility(T, S, p), rtol=1e-12, atol=0.0)


def test_unported_forms_raise():
    """Every EQN_OF_STATE form is ported (tests/test_torch_eos_forms.py):
    what still raises is a form no package knows."""
    assert teos.make_eos("TEOS10").name == "TEOS10"
    with pytest.raises(ValueError, match="TEOS11"):
        teos.make_eos("TEOS11")


@pytest.mark.parametrize("quad,recon", [(1, False), (5, False), (5, True)])
def test_pressure_force_with_eos_matches_jax(quad, recon):
    ni, nj, nk = 12, 10, 5
    jd = JDomain(ni=ni, nj=nj, halo=4, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=120.0, lenlat_km=100.0, f0=1e-4,
                          beta=2e-11, max_depth=4000.0)
    jvg = JVerticalGrid.uniform(nk=nk)
    rng = np.random.default_rng(3)
    shape = (nk, jd.njh, jd.nih)

    def field(a):
        return np.asarray(jd.fill_halos(jnp.asarray(a)))

    h = field(800.0 + 20.0 * rng.standard_normal(shape))
    T = field(np.linspace(20.0, 2.0, nk)[:, None, None]
              + 0.5 * rng.standard_normal(shape))
    S = field(35.0 + 0.2 * rng.standard_normal(shape))
    p_atm = field(100.0 * rng.standard_normal(shape[1:]))
    jcfg = jpf.PressureForceCfg(quad_points=quad, reconstruct=recon)
    ref = jax.jit(lambda *x: jpf.pressure_force(
        jg, jvg, *x[:3], jeos.make_eos("WRIGHT"), p_atm=x[3], cfg=jcfg))(
        *(jnp.asarray(a) for a in (h, T, S, p_atm)))

    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    tg = grid_from_numpy(gnp, Domain(ni=ni, nj=nj, reentrant_x=True),
                         device="cpu", dtype=F64)
    tvg = VerticalGrid.uniform(nk=nk, device="cpu", dtype=F64)
    out = tpf.pressure_force(tg, tvg, torch.tensor(h), torch.tensor(T),
                             torch.tensor(S), teos.make_eos("WRIGHT"),
                             p_atm=torch.tensor(p_atm),
                             cfg=tpf.PressureForceCfg(quad_points=quad,
                                                      reconstruct=recon))
    for name in ("PFu", "PFv", "pbce", "eta_pf"):
        r = np.asarray(getattr(ref, name))[..., 4:-4, 4:-4]
        o = getattr(out, name).numpy()[..., 4:-4, 4:-4]
        err = np.abs(r - o).max() / (np.abs(r).max() + 1e-300)
        assert err <= 1e-11, f"{name}: {err:.3e}"
