"""mom6_torch against mom6_tpu: btstep on the wide-halo march
(BT_WIDE_HALO_PERIOD > 1), the path of kernel K3m.

The same seeded numpy inputs go through the JAX btstep (its jnp march,
under jax.jit) and the port's btstep on device="cpu", which runs K3m's
plain version, in float64 at 16x16x2: periods 2 and 4, walled and
reentrant y, linear and BT_cont curve transports.  Tolerance 1e-12
relative to each field's maximum on the compute domain.  One case holds
the port against the JAX package's Pallas march in interpret mode, run
as tests/test_pallas_barotropic.py runs it (float32, tolerance 5e-5).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.core import barotropic as jbt
from mom6_tpu.core.continuity_ppm import ContinuityCfg, set_up_bt_cont

from mom6_torch.convert import bt_cont_from_numpy, grid_from_numpy
from mom6_torch.core import barotropic as tbt
from mom6_torch.core import barotropic_cuda
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

NI, NJ, NK = 16, 16, 2
FIELDS = ("eta", "uhbtav", "vhbtav", "ubt_av", "vbt_av", "accel_layer_u",
          "accel_layer_v")


@pytest.fixture(scope="module", autouse=True)
def _quick_xla_compile():
    """Compile the JAX references with most XLA optimizations off: at
    this size their compile time is most of the test's time."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@functools.lru_cache(maxsize=None)
def _case(reentrant_y, curve, dtype):
    d = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=True,
                reentrant_y=reentrant_y)
    g = j_cartesian_grid(d, lenlon_km=160.0, lenlat_km=160.0, f0=1e-4,
                         beta=2e-11, max_depth=900.0)
    vg = JVerticalGrid.uniform(nk=NK)
    rng = np.random.default_rng(11)

    def pad(a):
        return np.asarray(d.fill_halos(d.pad(jnp.asarray(a))))

    a = dict(h=pad(rng.uniform(250.0, 350.0, (NK, NJ, NI))),
             u=pad(0.05 * rng.standard_normal((NK, NJ, NI))),
             v=pad(0.05 * rng.standard_normal((NK, NJ, NI))),
             eta=pad(0.05 * rng.standard_normal((NJ, NI))),
             acc=pad(1e-6 * rng.standard_normal((NK, NJ, NI))),
             vr_u=pad(rng.uniform(0.5, 1.0, (NK, NJ, NI))),
             vr_v=pad(rng.uniform(0.5, 1.0, (NK, NJ, NI))),
             ecor=pad(0.01 * rng.standard_normal((NJ, NI))))
    a["pbce"] = np.full(a["h"].shape, 9.8 / NK)
    bc = None
    if curve:
        bc = set_up_bt_cont(g, vg, *(jnp.asarray(a[k])
                                     for k in ("u", "v", "h")), 600.0,
                            ContinuityCfg())
        bc = {k: np.asarray(v) for k, v in bc._asdict().items()}
        a["uh0"] = np.sum(a["h"] * 0.01, 0)
        a["vh0"] = np.sum(a["h"] * 0.005, 0)
    if dtype == np.float32:
        a = {k: v.astype(np.float32) for k, v in a.items()}
        g = jax.tree.map(lambda x: x.astype(jnp.float32)
                         if hasattr(x, "astype")
                         and x.dtype == jnp.float64 else x, g)
        vg = jax.tree.map(lambda x: x.astype(jnp.float32)
                          if hasattr(x, "astype")
                          and x.dtype == jnp.float64 else x, vg)
    nstep = jbt.set_dtbt(d, g, vg, jbt.BarotropicCfg(), 600.0)
    return d, g, vg, a, bc, nstep


def _jax_btstep(d, g, vg, a, bc, cfg):
    x = {k: jnp.asarray(v) for k, v in a.items()}
    jbc = None if bc is None else _jax_bt_cont(bc, x["h"].dtype)
    return jbt.btstep(d, g, vg, x["u"], x["v"], x["eta"], x["h"],
                      x["acc"], x["acc"], x["pbce"], x["u"], x["v"], 600.0,
                      cfg, x["vr_u"], x["vr_v"], taux=0.1 * g.mask2dCu,
                      bt_cont=jbc, eta_cor=x["ecor"],
                      uhbt_in=x.get("uh0"), vhbt_in=x.get("vh0"))


def _jax_bt_cont(bc, dtype):
    from mom6_tpu.core.continuity_ppm import BTContFaces
    return BTContFaces(**{k: jnp.asarray(v, dtype) for k, v in bc.items()})


def _port_btstep(d, g, vg, a, bc, cfg, dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    gnp = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g)
           if f.name != "domain" and getattr(g, f.name) is not None}
    td = Domain(ni=NI, nj=NJ, halo=4, reentrant_x=True,
                reentrant_y=d.reentrant_y)
    tg = grid_from_numpy(gnp, td, device="cpu", dtype=tdt)
    tvg = VerticalGrid.uniform(nk=NK, device="cpu", dtype=tdt)
    t = {k: torch.tensor(v, dtype=tdt) for k, v in a.items()}
    tbc = None if bc is None else bt_cont_from_numpy(bc, device="cpu",
                                                     dtype=tdt)
    return tbt.btstep(td, tg, tvg, t["u"], t["v"], t["eta"], t["h"],
                      t["acc"], t["acc"], t["pbce"], t["u"], t["v"], 600.0,
                      cfg, t["vr_u"], t["vr_v"], taux=0.1 * tg.mask2dCu,
                      bt_cont=tbc, eta_cor=t["ecor"], uhbt_in=t.get("uh0"),
                      vhbt_in=t.get("vh0"))


def _assert_close(ref, out, tol):
    for name in FIELDS:
        r = np.asarray(getattr(ref, name), np.float64)[..., 4:-4, 4:-4]
        o = getattr(out, name).double().numpy()[..., 4:-4, 4:-4]
        err = np.abs(r - o).max() / (np.abs(r).max() + 1e-300)
        assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("curve", [False, True], ids=["linear", "curve"])
@pytest.mark.parametrize("reentrant_y", [False, True],
                         ids=["walled_y", "reentrant_y"])
@pytest.mark.parametrize("period", [2, 4])
def test_march_btstep_matches_jax(period, reentrant_y, curve):
    d, g, vg, a, bc, nstep = _case(reentrant_y, curve, np.float64)
    jcfg = jbt.BarotropicCfg(nstep=nstep, use_bt_cont=curve,
                             wide_halo_period=period)
    ref = jax.jit(lambda: _jax_btstep(d, g, vg, a, bc, jcfg))()
    before = barotropic_cuda.subcycle_march_cuda.launches
    out = _port_btstep(d, g, vg, a, bc, tbt.BarotropicCfg(
        nstep=nstep, use_bt_cont=curve, wide_halo_period=period),
        np.float64)
    # a CPU tensor takes the plain version: no kernel launch counted
    assert barotropic_cuda.subcycle_march_cuda.launches == before
    _assert_close(ref, out, 1e-12)


def test_march_btstep_matches_pallas_march(monkeypatch):
    monkeypatch.setenv("MOM6_PALLAS_INTERPRET", "1")
    d, g, vg, a, bc, nstep = _case(True, False, np.float32)
    jcfg = jbt.BarotropicCfg(nstep=nstep, use_bt_cont=False,
                             use_pallas=True, wide_halo_period=2)
    ref = _jax_btstep(d, g, vg, a, None, jcfg)
    out = _port_btstep(d, g, vg, a, None, tbt.BarotropicCfg(
        nstep=nstep, use_bt_cont=False, wide_halo_period=2), np.float32)
    _assert_close(ref, out, 5e-5)


def test_march_inputs_round_the_period_and_pad_the_chunks():
    """The period rounding and chunk padding of the JAX package
    (barotropic.py:505-532): odd periods round up, the substep count is
    padded to whole chunks with zero filter weights."""
    assert [tbt.march_period(tbt.BarotropicCfg(wide_halo_period=p))
            for p in (1, 2, 3, 4, 5)] == [1, 2, 4, 4, 6]
    d, g, vg, a, bc, nstep = _case(False, False, np.float64)
    for period, chunk in ((1, 2), (2, 2), (4, 4), (6, 6)):
        cfg = tbt.BarotropicCfg(nstep=nstep, wide_halo_period=period)
        td = Domain(ni=NI, nj=NJ, halo=4, reentrant_x=True)
        t = {k: torch.tensor(v) for k, v in a.items()}
        gnp = {f.name: np.asarray(getattr(g, f.name))
               for f in dataclasses.fields(g)
               if f.name != "domain" and getattr(g, f.name) is not None}
        tg = grid_from_numpy(gnp, td, device="cpu", dtype=torch.float64)
        tvg = VerticalGrid.uniform(nk=NK, device="cpu", dtype=torch.float64)
        inp = tbt.subcycle_inputs(td, tg, tvg, t["u"], t["v"], t["eta"],
                                  t["h"], t["acc"], t["acc"], t["pbce"],
                                  t["u"], t["v"], 600.0, cfg)
        nfilt = int(np.ceil(75.0 / (600.0 / nstep) - 1e-9))
        assert inp.wts.shape[1] == -(-(nstep + nfilt) // chunk) * chunk
        assert not inp.wts[:, nstep + nfilt:].any()
        assert inp.period == max(1, period)
        halo = 3 * period if period > 1 else 4
        assert inp.domain.halo == halo
        assert inp.eta.shape == (NJ + 2 * halo, NI + 2 * halo)
        assert all(c.shape == inp.eta.shape for c in inp.consts.values())
