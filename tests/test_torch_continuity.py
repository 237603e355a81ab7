"""mom6_torch against mom6_tpu: transport-matched PPM continuity and the
BT_cont curve fit (the plain versions of kernels K1 and K2).

Inputs are the random reentrant setup of test_continuity_pallas.py at
32x24x3 in float64; the JAX side is the jnp path, run eagerly: after
the first case its primitives are compiled, and each further case
costs ~40 ms where a jax.jit compile per configuration costs ~1 s.
Tolerances are relative to each field's maximum on the compute domain:
1e-12 on thicknesses, transports, corrected velocities and face areas.
The turn velocities u_turn/v_turn divide by the near-cancelling
FA_far - FA_0, which magnifies summation-order roundoff (torch.sum
and XLA reduce the layers in different orders), so they get 1e-8.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.core import continuity_ppm as jc

from mom6_torch.convert import grid_from_numpy
from mom6_torch.core import continuity_ppm as tc
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.domain import Domain

F64 = torch.float64


def _setup(seed, land=False):
    dn = JDomain(ni=32, nj=24, halo=4, reentrant_x=True, reentrant_y=True)
    g = j_cartesian_grid(dn, lenlon_km=320.0, lenlat_km=240.0, f0=1e-4,
                         max_depth=1000.0)
    if land:
        from mom6_tpu.parallel.stencil import ip1, jp1
        maskT = jnp.ones((dn.njh, dn.nih)).at[:, 14:18].set(0.0)
        g = dataclasses.replace(g, mask2dT=maskT,
                                mask2dCu=maskT * ip1(maskT),
                                mask2dCv=maskT * jp1(maskT))
    rng = np.random.default_rng(seed)
    shape = (3, dn.njh, dn.nih)

    def f(a):
        return np.asarray(dn.fill_halos(jnp.asarray(a)))

    arrays = dict(
        h=f(300.0 + 30.0 * rng.standard_normal(shape)),
        u=f(0.3 * rng.standard_normal(shape)) * np.asarray(g.mask2dCu),
        v=f(0.3 * rng.standard_normal(shape)) * np.asarray(g.mask2dCv),
        vr_u=f(rng.uniform(0.5, 1.0, shape)),
        vr_v=f(rng.uniform(0.5, 1.0, shape)),
        uhbt=f(50.0 * rng.standard_normal(shape[1:])),
        vhbt=f(50.0 * rng.standard_normal(shape[1:])))
    gnp = {x.name: np.asarray(getattr(g, x.name))
           for x in dataclasses.fields(g)
           if x.name != "domain" and getattr(g, x.name) is not None}
    tg = grid_from_numpy(gnp, Domain(ni=32, nj=24, reentrant_x=True,
                                     reentrant_y=True),
                         device="cpu", dtype=F64)
    return (g, JVerticalGrid.uniform(nk=3, gint=0.01), tg,
            VerticalGrid.uniform(nk=3, gint=0.01, device="cpu", dtype=F64),
            arrays)


def _err(ref, out):
    a = np.asarray(ref)[..., 4:-4, 4:-4]
    b = out.numpy()[..., 4:-4, 4:-4]
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-300)


@pytest.mark.parametrize("x_first,land,option", [
    (True, False, None), (False, False, None), (True, True, None),
    (False, True, None), (True, False, "upwind_1st"),
    (True, False, "simple_2nd"), (False, False, "monotonic"),
    (True, True, "vol_cfl"), (True, False, "unmatched")])
def test_continuity_ppm_matches_jax(x_first, land, option):
    """Both sweep orders, with and without land; the plain version also
    carries the scheme options that the CUDA kernel refuses, and the
    sweep without transport matching."""
    jg, jvg, tg, tvg, a = _setup(0 if not land else 3, land)
    kw = {option: True} if option not in (None, "unmatched") else {}
    if option == "unmatched":
        a = dict(a, uhbt=None, vhbt=None)
    names = ("u", "v", "h", "vr_u", "vr_v", "uhbt", "vhbt")
    j = {k: None if a[k] is None else jnp.asarray(a[k]) for k in names}
    ref = jc.continuity_ppm(jg, jvg, j["u"], j["v"], j["h"], 600.0,
                            jc.ContinuityCfg(**kw), uhbt=j["uhbt"],
                            vhbt=j["vhbt"], visc_rem_u=j["vr_u"],
                            visc_rem_v=j["vr_v"], x_first=x_first)
    t = {k: None if a[k] is None else torch.tensor(a[k], dtype=F64)
         for k in names}
    out = tc.continuity_ppm(tg, tvg, t["u"], t["v"], t["h"], 600.0,
                            tc.ContinuityCfg(**kw), uhbt=t["uhbt"],
                            vhbt=t["vhbt"], visc_rem_u=t["vr_u"],
                            visc_rem_v=t["vr_v"], x_first=x_first)
    for name in ("h", "uh", "vh") + (("u_cor", "v_cor") if t["uhbt"]
                                     is not None else ()):
        err = _err(getattr(ref, name), getattr(out, name))
        assert err <= 1e-12, f"{name}: {err:.3e}"


@pytest.mark.parametrize("seed", [7, 11])
def test_set_up_bt_cont_matches_jax(seed):
    jg, jvg, tg, tvg, a = _setup(seed)
    names = ("u", "v", "h", "vr_u", "vr_v")
    ju, jv, jh, jr_u, jr_v = (jnp.asarray(a[k]) for k in names)
    ref = jc.set_up_bt_cont(jg, jvg, ju, jv, jh, 600.0, jc.ContinuityCfg(),
                            jr_u, jr_v)
    u, v, h, vr_u, vr_v = (torch.tensor(a[k], dtype=F64) for k in names)
    out = tc.set_up_bt_cont(tg, tvg, u, v, h, 600.0, tc.ContinuityCfg(),
                            vr_u, vr_v)
    for name in ref._fields:
        tol = 1e-8 if name.startswith(("uBT", "vBT")) else 1e-12
        err = _err(getattr(ref, name), getattr(out, name))
        assert err <= tol, f"{name}: {err:.3e}"


def _partition(n, step, width):
    """Times each of n positions is owned by tiles starting every
    ``step`` positions and owning ``width`` of them."""
    owned = np.zeros(n, np.int64)
    for start in range(0, n, step):
        owned[start:start + width] += 1
    return owned


@pytest.mark.parametrize("nj,ni", [(520, 520), (1096, 1448)])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nk", [1, 3, 25, 75, 200])
def test_continuity_tile_plan(nk, itemsize, sms, nj, ni):
    """K1's and K2's tiles on a card of ``sms`` SMs and 227 KB of shared
    memory a block (H100 SXM: 132, PCIe: 114), at the main path's width
    and the OM4-class width with their halos: every plan fits the
    shared memory it states, its tiles own every face once, K2's two
    directions share one block size, and the whole column stays on chip
    up to MOM6's 75 layers (deeper ones may be cut into layer chunks)."""
    from mom6_torch.core import continuity_cuda as cc
    smem_limit = 232448
    for axes in ((0,), (1,), (0, 1)):
        plans = cc.tile_plan(nk, nj, ni, itemsize, axes, sms, smem_limit)
        assert tuple(p.axis for p in plans) == axes
        assert len({p.threads for p in plans}) == 1
        for p in plans:
            n, m = (ni, nj) if p.axis == 0 else (nj, ni)
            assert 2 <= p.faces and 1 <= p.across
            assert p.threads <= cc.MAX_THREADS and p.threads % 32 == 0
            assert p.smem_bytes == cc.stage_bytes(p.faces, p.across,
                                                  p.layers, itemsize)
            assert p.smem_bytes <= smem_limit
            assert (p.chunks - 1) * p.layers < nk <= p.chunks * p.layers
            assert p.chunks == 1 or nk > 75
            along = _partition(n, p.faces - 1, p.faces - 1)
            across = _partition(m, p.across, p.across)
            assert (along == 1).all() and (across == 1).all()
            assert p.blocks == -(-n // (p.faces - 1)) * -(-m // p.across)
            if p.axis == 0:
                assert p.faces >= 32     # lanes run along i
            else:
                assert p.across >= 8
    with pytest.raises(ValueError, match="not one layer"):
        cc.tile_plan(nk, nj, ni, itemsize, (0,), sms, 600)
