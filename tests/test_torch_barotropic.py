"""mom6_torch against mom6_tpu: btstep, linear (Datu*ubt) and BT_cont
curve transports, with the eta_cor mass source and the layered
transport anchors uhbt_in/vhbt_in (the inputs of
test_pallas_barotropic.py, in float64 at 32x24x3).  On the CPU the
port runs the plain version of kernel K3.  The JAX side is the jnp
fori_loop path under jax.jit.  Tolerance 1e-11 relative to each
field's maximum on the compute domain.  One case runs 120 substeps
(128 with the filter): the wrapper takes any substep count.
"""

import dataclasses

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
from mom6_torch.core import barotropic_cuda as bcu
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, NK = 32, 24, 3


@pytest.mark.parametrize("curve", [False, True])
def test_btstep_matches_jax(curve):
    _btstep_matches(curve)


def test_btstep_many_substeps_matches_jax():
    _btstep_matches(True, nstep=120)


def _btstep_matches(curve, nstep=None):
    d = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=True, reentrant_y=False)
    g = j_cartesian_grid(d, lenlon_km=320.0, lenlat_km=240.0, f0=1e-4,
                         max_depth=900.0)
    vg = JVerticalGrid.uniform(nk=NK)
    rng = np.random.default_rng(5)

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
    nstep = nstep or jbt.set_dtbt(d, g, vg, jbt.BarotropicCfg(), 600.0)
    bc = uh0 = vh0 = None
    if curve:
        bc = set_up_bt_cont(g, vg, *(jnp.asarray(a[k])
                                     for k in ("u", "v", "h")), 600.0,
                            ContinuityCfg())
        uh0 = np.sum(a["h"] * 0.01, 0)
        vh0 = np.sum(a["h"] * 0.005, 0)
    jcfg = jbt.BarotropicCfg(nstep=nstep, use_bt_cont=curve)

    @jax.jit
    def ref_fn(x):
        return jbt.btstep(d, g, vg, x["u"], x["v"], x["eta"], x["h"],
                          x["acc"], x["acc"], x["pbce"], x["u"], x["v"],
                          600.0, jcfg, x["vr_u"], x["vr_v"],
                          taux=0.1 * g.mask2dCu, bt_cont=bc,
                          eta_cor=x["ecor"], uhbt_in=uh0, vhbt_in=vh0)

    ref = ref_fn({k: jnp.asarray(v) for k, v in a.items()})

    gnp = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g)
           if f.name != "domain" and getattr(g, f.name) is not None}
    td = Domain(ni=NI, nj=NJ, halo=4, reentrant_x=True, reentrant_y=False)
    tg = grid_from_numpy(gnp, td, device="cpu", dtype=F64)
    tvg = VerticalGrid.uniform(nk=NK, device="cpu", dtype=F64)
    t = {k: torch.tensor(v, dtype=F64) for k, v in a.items()}
    tbc = None
    if curve:
        tbc = bt_cont_from_numpy(
            {k: np.asarray(v) for k, v in bc._asdict().items()},
            device="cpu", dtype=F64)
    out = tbt.btstep(td, tg, tvg, t["u"], t["v"], t["eta"], t["h"],
                     t["acc"], t["acc"], t["pbce"], t["u"], t["v"], 600.0,
                     tbt.BarotropicCfg(nstep=nstep, use_bt_cont=curve),
                     t["vr_u"], t["vr_v"], taux=0.1 * tg.mask2dCu,
                     bt_cont=tbc, eta_cor=t["ecor"],
                     uhbt_in=None if uh0 is None else torch.as_tensor(uh0),
                     vhbt_in=None if vh0 is None else torch.as_tensor(vh0))
    for name in ("eta", "uhbtav", "vhbtav", "ubt_av", "vbt_av",
                 "accel_layer_u", "accel_layer_v"):
        r = np.asarray(getattr(ref, name))[..., 4:-4, 4:-4]
        o = getattr(out, name).numpy()[..., 4:-4, 4:-4]
        err = np.abs(r - o).max() / (np.abs(r).max() + 1e-300)
        assert err <= 1e-11, f"{name}: {err:.3e}"


@pytest.mark.parametrize("scheme", ["ARITHMETIC", "HARMONIC", "HYBRID",
                                    "FROM_BT_CONT"])
def test_btcalc_matches_jax(scheme):
    d = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=True, reentrant_y=False)
    rng = np.random.default_rng(3)
    depth = np.asarray(d.fill_halos(d.pad(jnp.asarray(
        rng.uniform(500.0, 1000.0, (NJ, NI))))))
    g = j_cartesian_grid(d, lenlon_km=320.0, lenlat_km=240.0,
                         depth_fn=lambda lon, lat: depth)
    h = np.asarray(d.fill_halos(d.pad(jnp.asarray(
        rng.uniform(0.0, 400.0, (NK, NJ, NI))))))
    gnp = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g)
           if f.name != "domain" and getattr(g, f.name) is not None}
    tg = grid_from_numpy(gnp, Domain(ni=NI, nj=NJ, reentrant_x=True),
                         device="cpu", dtype=F64)
    ref = jbt.btcalc(g, jnp.asarray(h), scheme)
    out = tbt.btcalc(tg, torch.tensor(h), scheme)
    for r, o in zip(ref, out):
        r = np.asarray(r)[..., 4:-4, 4:-4]
        o = o.numpy()[..., 4:-4, 4:-4]
        assert np.abs(r - o).max() <= 1e-12 * np.abs(r).max()


def test_filter_weights_match_jax():
    for nstep, nfilt, dt_filt, dtbt in ((27, 4, 75.0, 600.0 / 27),
                                       (13, 2, 75.0, 600.0 / 13)):
        total = -(-(nstep + nfilt) // 2) * 2
        ref = np.stack(jbt._filter_weights(nstep, nfilt, total, dt_filt,
                                           dtbt, dtype=jnp.float64))
        out = tbt._filter_weights(nstep, nfilt, total, dt_filt, dtbt,
                                  torch.float64)
        assert np.array_equal(ref, out)


def test_btstep_rejects_unported_options():
    with pytest.raises(NotImplementedError, match="OBC"):
        tbt.btstep(None, None, None, None, None, None, None, None, None,
                   None, None, None, 600.0, tbt.BarotropicCfg(),
                   obc=object())


@pytest.mark.parametrize("nj,ni,sms", [(520, 520, 132), (524, 524, 132),
                                       (536, 536, 132), (520, 520, 114),
                                       (1096, 1448, 132)])
def test_subcycle_band_plan(nj, ni, sms):
    """The persistent K3/K3m launch's band plan on a card of ``sms`` SMs
    and 227 KB of shared memory a block (H100 SXM: 132, PCIe: 114):
    every point owned once, in as many tiles as a band needs; the
    transport planes of a band in shared memory while they fit (curve
    planes in fp32 at the main path's shapes), from global memory
    otherwise (fp64 curve mode, the OM4-class width); arrays past the
    kernel's 32-bit indices raise; the filter weights of any substep
    count are laid out as the kernel reads them."""
    smem_limit = 232448
    tile = bcu.THREADS * bcu.POINTS_PER_THREAD
    points = nj * ni
    for itemsize in (4, 8):
        for curve in (False, True):
            plan = bcu.band_plan(nj, ni, itemsize, curve, sms, smem_limit)
            npb = plan.points_per_block
            assert (plan.tiles - 1) * tile < npb <= plan.tiles * tile
            assert plan.blocks <= sms
            owned = np.zeros(points, np.int64)
            for b in range(plan.blocks):
                band = owned[b * npb:(b + 1) * npb]
                assert band.size > 0
                band += 1
            assert (owned == 1).all()
            want = (22 if curve else 2) * npb * itemsize
            assert plan.smem_bytes == (want if want <= smem_limit else 0)
            assert plan.placement == ("shared" if plan.smem_bytes
                                      else "global")
            if nj * ni <= 536 * 536 and curve:
                assert plan.placement == ("shared" if itemsize == 4
                                          else "global")
    # one tile a band at the main path's shapes on 132 SMs; more on a
    # card with fewer SMs or at the OM4-class width
    assert (plan.tiles == 1) == (sms == 132 and points <= 536 * 536)
    with pytest.raises(ValueError, match="32-bit"):
        bcu.band_plan(50000, 50000, 4, True, sms, smem_limit)
    for total in (32, 128, 200):
        w = np.random.default_rng(total).standard_normal((4, total))
        rows = bcu.weight_rows(w, torch.float32, "cpu")
        assert rows.shape == (4, total) and rows.is_contiguous()
        assert torch.equal(rows, torch.from_numpy(w).float())
