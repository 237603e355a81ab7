"""mom6_torch against mom6_tpu: halo fills, the cartesian grid and the
numpy carriers of convert.py.

Halo fills copy values, so they must agree bit for bit; the grid's
metrics are computed in float64 numpy on both sides (within 2 ulp).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.continuity_ppm import BTContFaces as JBTContFaces

from mom6_torch.convert import (bt_cont_from_numpy, grid_from_numpy,
                                split_state_from_numpy, state_from_numpy,
                                to_numpy)
from mom6_torch.core.grid import cartesian_grid
from mom6_torch.core.dynamics_split_rk2 import SplitDynState
from mom6_torch.parallel.domain import Domain

NI, NJ = 12, 10


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("rx,ry", [(True, False), (False, True),
                                   (True, True), (False, False)])
def test_fill_halos_bitwise(rx, ry, width):
    rng = np.random.default_rng(width + 2 * rx + 4 * ry)
    a = rng.standard_normal((2, NJ + 8, NI + 8))
    jd = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=rx, reentrant_y=ry)
    td = Domain(ni=NI, nj=NJ, halo=4, reentrant_x=rx, reentrant_y=ry)
    ref = np.asarray(jd.fill_halos(jnp.asarray(a), width=width))
    out = td.fill_halos(torch.as_tensor(a), width=width)
    assert np.array_equal(ref, out.numpy())
    # a nest of fields fills leaf by leaf, 2D leaves included
    pair = td.fill_halos_group((torch.as_tensor(a), torch.as_tensor(a[0])),
                               width=width)
    assert np.array_equal(ref, pair[0].numpy())
    assert np.array_equal(ref[0], pair[1].numpy())


@pytest.mark.parametrize("rx,ry", [(True, False), (False, True)])
def test_vector_halos_and_shifts_bitwise(rx, ry):
    from mom6_tpu.parallel import stencil as js
    from mom6_torch.parallel import stencil as ts
    rng = np.random.default_rng(7)
    u, v = rng.standard_normal((2, 3, NJ + 8, NI + 8))
    jd = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=rx, reentrant_y=ry)
    td = Domain(ni=NI, nj=NJ, halo=4, reentrant_x=rx, reentrant_y=ry)
    ref = jd.fill_vector_halos(jnp.asarray(u), jnp.asarray(v), width=3)
    out = td.fill_vector_halos(torch.as_tensor(u), torch.as_tensor(v), 3)
    for r, o in zip(ref, out):
        assert np.array_equal(np.asarray(r), o.numpy())
    for f in ("ip1", "im1", "jp1", "jm1"):
        assert np.array_equal(np.asarray(getattr(js, f)(jnp.asarray(u))),
                              getattr(ts, f)(torch.as_tensor(u)).numpy())
    for f in ("ishift", "jshift"):
        assert np.array_equal(np.asarray(getattr(js, f)(jnp.asarray(u), 2)),
                              getattr(ts, f)(torch.as_tensor(u), 2).numpy())


def test_domain_rejects_unported_layouts():
    with pytest.raises(NotImplementedError, match="layout"):
        Domain(ni=8, nj=8, layout=(2, 1))
    with pytest.raises(NotImplementedError, match="tripolar"):
        Domain(ni=8, nj=8, tripolar_n=True)


@pytest.mark.parametrize("rx,ry", [(True, False), (False, False)])
def test_cartesian_grid(rx, ry):
    kw = dict(lenlon_km=NI * 10.0, lenlat_km=NJ * 10.0, f0=1e-4,
              beta=2e-11, max_depth=4000.0)
    jg = j_cartesian_grid(JDomain(ni=NI, nj=NJ, reentrant_x=rx,
                                  reentrant_y=ry), **kw)
    tg = cartesian_grid(Domain(ni=NI, nj=NJ, reentrant_x=rx,
                               reentrant_y=ry), device="cpu",
                        dtype=torch.float64, **kw)
    for f in dataclasses.fields(jg):
        a = getattr(jg, f.name)
        if f.name == "domain" or a is None:
            continue
        b = getattr(tg, f.name).numpy()
        np.testing.assert_array_max_ulp(np.asarray(a), b, maxulp=2)


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    td = Domain(ni=NI, nj=NJ)
    jg = j_cartesian_grid(JDomain(ni=NI, nj=NJ), lenlon_km=120.0,
                          lenlat_km=100.0, f0=1e-4)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    shape3 = (3, NJ + 8, NI + 8)
    snp = {k: rng.standard_normal(shape3) for k in ("u", "v", "h")}
    spnp = {f.name: rng.standard_normal(shape3 if f.name != "eta"
                                        else shape3[1:])
            for f in dataclasses.fields(SplitDynState)}
    bnp = {k: rng.standard_normal(shape3[1:]) for k in JBTContFaces._fields}
    cases = [(grid_from_numpy(gnp, td, device="cpu", dtype=torch.float64),
              gnp),
             (state_from_numpy(snp, device="cpu", dtype=torch.float64), snp),
             (split_state_from_numpy(spnp, device="cpu",
                                     dtype=torch.float64), spnp),
             (bt_cont_from_numpy(bnp, device="cpu", dtype=torch.float64),
              bnp)]
    for obj, src in cases:
        back = to_numpy(obj)
        assert back.keys() == src.keys()
        for k in src:
            assert np.array_equal(back[k], src[k]), k
    assert state_from_numpy(snp, device="cpu", dtype=torch.float64).T is None
    with pytest.raises(KeyError, match="h"):
        state_from_numpy({"u": snp["u"], "v": snp["v"]}, device="cpu",
                         dtype=torch.float64)
