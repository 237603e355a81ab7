"""mom6_torch against mom6_tpu: the ALE regrid/remap (mom6_torch.ale).

Seeded numpy columns go through the JAX functions, called eagerly in
float64, and their ports on device="cpu" in float64:

* remap_column_means for the 7 ported schemes, with and without
  force_monotonic, on 7-layer columns with vanished source and target
  layers and on 3-layer columns (the h2 / ih3 short-column paths):
  1e-12 relative to the result's maximum (the implicit schemes with
  vanished source layers at the bottom only, see IMPLICIT);
* the tc2 column (two thick layers over six of 1e-10 m), where the
  JAX package's boundary cubic divides 0 by 0: the port's remap stays
  finite and conserves (PPM_H4, PPM_IH4);
* the banded remap (ALE_REMAP_BAND) equals the full remap, when the band
  holds every interface and when it misses one;
* build_grid in the LAYER, Z*, SIGMA, RHO and HYCOM1 modes (1e-13, with
  the column totals kept); the hybgen remap schemes conserve (the JAX
  comparisons of them, of ADAPTIVE and of HYBGEN are in
  tests/test_torch_hybgen.py), and an unknown scheme or mode raises;
* the grid-motion filter (REGRID_TIME_SCALE) with and without a blend
  depth range;
* ale_regrid_remap with a tracer and face auxiliaries, batched,
  sequential and banded, and ale_regrid_accelerated (1e-12).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.ale import ale_main as jale
from mom6_tpu.ale import regridding as jrg
from mom6_tpu.ale import remapping as jrm
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch.ale import ale_main as tale
from mom6_torch.ale.hybgen_unmix import HybgenUnmixCfg
from mom6_torch.ale import regridding as trg
from mom6_torch.ale import remapping as trm
from mom6_torch.convert import grid_from_numpy
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.eos import make_eos
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
SCHEMES = ("PCM", "PLM", "PPM_H4", "PPM_IH4", "PPM_CW", "PQM_IH4IH3",
           "PQM_IH6IH5")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _check(ref, out, tol, name):
    a = np.asarray(ref)
    b = out.detach().numpy()
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


# The implicit edge schemes solve a tridiagonal over the interfaces whose
# pivot vanishes at an exactly vanished interior source layer: the JAX
# package returns NaN there (PPM_IH4, PQM_IH4IH3) or a value that rounding
# moves by 1e-3 (PPM_IH4) to 1e-9 (PQM_IH6IH5).  Their cases vanish
# source layers at the column bottom only.
IMPLICIT = ("PPM_IH4", "PQM_IH4IH3", "PQM_IH6IH5")


def _columns(nk, seed=3, nj=5, ni=6, interior_vanished=True):
    """Source and target thicknesses with equal column totals, vanished
    layers in both, and a smooth field with noise."""
    rng = np.random.default_rng(seed)
    h_src = rng.uniform(1.0, 60.0, (nk, nj, ni))
    if interior_vanished:                       # vanished source layers
        h_src[min(1, nk - 1), 0] = 0.0
    h_src[nk - 1, 1, :3] = 0.0
    w = rng.uniform(0.2, 1.0, (nk, nj, ni))
    w[nk // 2, 2] = 0.0                          # vanished target layers
    h_dst = w / w.sum(0) * h_src.sum(0)
    z = np.cumsum(h_src, 0) - 0.5 * h_src
    u = np.sin(z / 40.0) + 0.1 * rng.standard_normal((nk, nj, ni))
    return h_src, u, h_dst


@pytest.mark.parametrize("nk", [7, 3])
@pytest.mark.parametrize("monotonic", [True, False])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_remap_column_means_matches_jax(scheme, monotonic, nk):
    h_src, u, h_dst = _columns(nk, interior_vanished=scheme not in IMPLICIT)
    ref = jrm.remap_column_means(
        *(jnp.asarray(a) for a in (h_src, u, h_dst)),
        jrm.RemapCfg(scheme=scheme, force_monotonic=monotonic))
    out = trm.remap_column_means(
        *(_t(a) for a in (h_src, u, h_dst)),
        trm.RemapCfg(scheme=scheme, force_monotonic=monotonic))
    _check(ref, out, 1e-12, f"{scheme} nk={nk}")


@pytest.mark.parametrize("motion", ["in_band", "out_of_band"])
def test_banded_remap_equals_full(motion):
    h_src, u, _ = _columns(7, seed=5)
    rng = np.random.default_rng(6)
    if motion == "in_band":       # interfaces move a fraction of a layer
        w = 1.0 + 0.3 * rng.uniform(-1.0, 1.0, h_src.shape)
        h_dst = h_src * w
    else:                         # the top layer swallows most of the column
        h_dst = np.full(h_src.shape, 1.0)
        h_dst[0] = 50.0
    h_dst = h_dst / h_dst.sum(0) * h_src.sum(0)
    cfg = trm.RemapCfg()
    args = [_t(a) for a in (h_src, u, h_dst)]
    full = trm.remap_column_means(*args, cfg)
    banded = trm.remap_column_means_banded(*args, 1, cfg)
    assert torch.equal(banded, full) if motion == "out_of_band" else \
        float((banded - full).abs().max()) <= 1e-12 * float(full.abs().max())
    ref = jrm.remap_column_means_banded(
        *(jnp.asarray(a) for a in (h_src, u, h_dst)), 1, jrm.RemapCfg())
    _check(ref, banded, 1e-12, f"banded {motion}")


def _tc2_column():
    """cases/tc2's first wet row at its first remap: two thick layers over
    six of 1e-10 m (the top boundary cubic's 4 cells hold two of them),
    beside a column of 8 thick layers; a Z* target of equal totals."""
    h_src = np.array([[300.0, 325.0] + [1e-10] * 6,
                      [60.0, 70.0, 80.0, 90.0, 85.0, 75.0, 65.0, 55.0]]).T
    u = np.array([[12.0, 9.0, 8.5, 8.1, 7.9, 7.2, 6.8, 6.1],
                  [14.0, 12.5, 11.0, 9.0, 7.5, 6.0, 5.0, 4.5]]).T
    h_dst = np.ones_like(h_src) / 8.0 * h_src.sum(0)
    return (a.reshape(8, 1, 2) for a in (h_src, u, h_dst))


@pytest.mark.parametrize("scheme", ["PPM_H4", "PPM_IH4"])
def test_tc2_column_remaps_finite(scheme):
    """The boundary cubic's pivot vanishes on the tc2 column: the JAX
    package, called eagerly, returns NaN in the whole column; the port
    takes the h2 boundary estimates there and remaps it finite,
    conserving its content to 1e-12, and the thick column as the JAX
    package does (1e-12)."""
    h_src, u, h_dst = _tc2_column()
    ref = np.asarray(jrm.remap_column_means(
        *(jnp.asarray(a) for a in (h_src, u, h_dst)),
        jrm.RemapCfg(scheme=scheme)))
    assert np.isnan(ref[:, :, 0]).all()
    out = trm.remap_column_means(*(_t(a) for a in (h_src, u, h_dst)),
                                 trm.RemapCfg(scheme=scheme))
    assert bool(torch.isfinite(out).all())
    content = (out * _t(h_dst)).sum(0)
    want = (_t(u) * _t(h_src)).sum(0)
    assert float(((content - want) / want).abs().max()) <= 1e-12
    _check(ref[:, :, 1:], out[:, :, 1:], 1e-12, f"{scheme} thick column")
    lo, hi = u[:, :, 0].min(), u[:, :, 0].max()
    assert float(out[:, :, 0].min()) >= lo and float(out[:, :, 0].max()) <= hi


def test_hybgen_schemes_raise():
    """The hybgen schemes are ported (tests/test_torch_hybgen.py holds
    them to the JAX package): they remap, conserving each column's
    integral, and what still raises is a scheme no package knows."""
    h_src, u, h_dst = _columns(4)
    args = [_t(a) for a in (h_src, u, h_dst)]
    for scheme in ("PLM_HYBGEN", "PPM_HYBGEN", "WENO_HYBGEN"):
        out = trm.remap_column_means(*args, trm.RemapCfg(scheme=scheme))
        assert torch.allclose((out * args[2]).sum(0),
                              (args[1] * args[0]).sum(0), rtol=1e-12)
    with pytest.raises(ValueError, match="PPM_H8"):
        trm.remap_column_means(*args, trm.RemapCfg(scheme="PPM_H8"))


NK = 6


def _grid_case():
    """A 10x8 grid with a sloping bottom, and a stratified column state
    whose totals follow it."""
    jd = JDomain(ni=10, nj=8, halo=4, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=100.0, lenlat_km=80.0, f0=1e-4,
                          beta=2e-11, max_depth=1000.0)
    rng = np.random.default_rng(17)
    shape = (NK, jd.njh, jd.nih)
    bathy = np.asarray(jg.bathyT) * rng.uniform(0.6, 1.0, shape[1:])
    jg = dataclasses.replace(jg, bathyT=jnp.asarray(bathy))
    h = rng.uniform(0.5, 1.5, shape)
    h = h / h.sum(0) * bathy
    h[1, 2] = 0.0
    T = np.linspace(20.0, 4.0, NK)[:, None, None] \
        + 0.5 * rng.standard_normal(shape)
    S = 35.0 + 0.1 * rng.standard_normal(shape)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    tg = grid_from_numpy(gnp, Domain(ni=10, nj=8, halo=4, reentrant_x=True),
                         device="cpu", dtype=F64)
    return jg, tg, dict(h=h, T=T, S=S, bathy=bathy, rng=rng)


_RLAY = 1022.0 + 1.2 * np.arange(NK)


@pytest.mark.parametrize("mode", ["LAYER", "Z*", "SIGMA", "RHO", "HYCOM1"])
def test_build_grid_matches_jax(mode):
    _, _, c = _grid_case()
    res = (0.1, 0.1, 0.15, 0.2, 0.2, 0.25) if mode == "SIGMA" else ()
    kw = dict(min_thickness=0.5, resolution=res)
    ref = jrg.build_grid(jrg.RegridCfg(mode=mode, **kw),
                         jnp.asarray(c["h"]), jnp.asarray(c["bathy"]),
                         jnp.asarray(c["T"]), jnp.asarray(c["S"]),
                         j_make_eos("WRIGHT"), rlay=jnp.asarray(_RLAY))
    out = trg.build_grid(trg.RegridCfg(mode=mode, **kw), _t(c["h"]),
                         _t(c["bathy"]), _t(c["T"]), _t(c["S"]),
                         make_eos("WRIGHT"), rlay=_t(_RLAY))
    _check(ref, out, 1e-13, mode)
    tot = c["h"].sum(0)
    assert np.abs(out.sum(0).numpy() - tot).max() <= 1e-12 * tot.max()
    assert float(out.min()) >= 0.0


def test_unported_regrid_modes_raise():
    """ADAPTIVE, HYBGEN and hybgen unmixing are ported
    (tests/test_torch_hybgen.py); what still raises is ADAPTIVE without
    T, S and an EOS, and a mode no package knows."""
    h = torch.ones(3, 2, 2, dtype=F64)
    with pytest.raises(ValueError, match="ADAPTIVE"):
        trg.build_grid(trg.RegridCfg(mode="ADAPTIVE"), h, h[0])
    with pytest.raises(ValueError, match="ISOPYCNAL"):
        trg.build_grid(trg.RegridCfg(mode="ISOPYCNAL"), h, h[0])
    assert tale.ALECfg(hybgen_unmix=HybgenUnmixCfg()).hybgen_unmix.fixlay \
        == 2


@pytest.mark.parametrize("depths", [(0.0, 0.0), (50.0, 400.0)])
def test_filter_grid_motion_matches_jax(depths):
    rng = np.random.default_rng(9)
    h_old = rng.uniform(10.0, 200.0, (NK, 4, 5))
    h_new = rng.uniform(10.0, 200.0, (NK, 4, 5))
    h_new = h_new / h_new.sum(0) * h_old.sum(0)
    kw = dict(regrid_time_scale=3600.0, filter_shallow_depth=depths[0],
              filter_deep_depth=depths[1])
    ref = jale._filter_grid_motion(jale.ALECfg(**kw), jnp.asarray(h_old),
                                   jnp.asarray(h_new), 1200.0)
    out = tale._filter_grid_motion(tale.ALECfg(**kw), _t(h_old),
                                   _t(h_new), 1200.0)
    _check(ref, out, 1e-13, "filtered h")


def _ale_inputs():
    jg, tg, c = _grid_case()
    rng = c["rng"]
    shape = c["h"].shape
    u = 0.1 * rng.standard_normal(shape) * np.asarray(jg.mask2dCu)
    v = 0.1 * rng.standard_normal(shape) * np.asarray(jg.mask2dCv)
    f = dict(h=c["h"], u=u, v=v, T=c["T"], S=c["S"],
             age=rng.uniform(0.0, 2.0, shape),
             u_av=0.9 * u, v_av=1.1 * v,
             diffu=1e-6 * rng.standard_normal(shape),
             diffv=1e-6 * rng.standard_normal(shape))
    # layer densities 1023 ... 1026 kg m-3, across the column's range
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.006, light=1023.0)
    tvg = VerticalGrid.uniform(nk=NK, gint=0.006, light=1023.0,
                               device="cpu", dtype=F64)
    return jg, tg, jvg, tvg, f


@pytest.mark.parametrize("variant", ["batched", "sequential", "banded",
                                     "filtered"])
def test_ale_regrid_remap_matches_jax(variant):
    jg, tg, jvg, tvg, f = _ale_inputs()
    kw = dict(regrid=dict(mode="Z*", min_thickness=1e-3),
              sequential_remap=variant == "sequential",
              remap_band=2 if variant == "banded" else 0,
              regrid_time_scale=3600.0 if variant == "filtered" else 0.0)
    jcfg = jale.ALECfg(**{**kw, "regrid": jrg.RegridCfg(**kw["regrid"])})
    tcfg = tale.ALECfg(**{**kw, "regrid": trg.RegridCfg(**kw["regrid"])})
    J = {k: jnp.asarray(v) for k, v in f.items()}
    ref = jale.ale_regrid_remap(
        jg, jvg, JState(u=J["u"], v=J["v"], h=J["h"], T=J["T"], S=J["S"]),
        jcfg, eos=j_make_eos("WRIGHT"), tracers={"age": J["age"]},
        aux_u={"u_av": J["u_av"], "diffu": J["diffu"]},
        aux_v={"v_av": J["v_av"], "diffv": J["diffv"]}, dt=1200.0)
    P = {k: _t(v) for k, v in f.items()}
    out = tale.ale_regrid_remap(
        tg, tvg, State(u=P["u"], v=P["v"], h=P["h"], T=P["T"], S=P["S"]),
        tcfg, eos=make_eos("WRIGHT"), tracers={"age": P["age"]},
        aux_u={"u_av": P["u_av"], "diffu": P["diffu"]},
        aux_v={"v_av": P["v_av"], "diffv": P["diffv"]}, dt=1200.0)
    for name in ("h", "u", "v", "T", "S"):
        _check(getattr(ref[0], name), getattr(out[0], name), 1e-12, name)
    _check(ref[1]["age"], out[1]["age"], 1e-12, "age")
    _check(ref[2], out[2], 1e-12, "h_new")
    for i, names in ((3, ("u_av", "diffu")), (4, ("v_av", "diffv"))):
        for name in names:
            _check(ref[i][name], out[i][name], 1e-12, name)


def test_ale_regrid_accelerated_matches_jax():
    jg, tg, jvg, tvg, f = _ale_inputs()
    J = {k: jnp.asarray(v) for k, v in f.items()}
    P = {k: _t(v) for k, v in f.items()}
    ref = jale.ale_regrid_accelerated(
        jg, jvg, JState(u=J["u"], v=J["v"], h=J["h"], T=J["T"], S=J["S"]),
        jale.ALECfg(regrid=jrg.RegridCfg(mode="HYCOM1")), 3,
        eos=j_make_eos("WRIGHT"), tracers={"age": J["age"]})
    out = tale.ale_regrid_accelerated(
        tg, tvg, State(u=P["u"], v=P["v"], h=P["h"], T=P["T"], S=P["S"]),
        tale.ALECfg(regrid=trg.RegridCfg(mode="HYCOM1")), 3,
        eos=make_eos("WRIGHT"), tracers={"age": P["age"]})
    for name in ("h", "u", "v", "T", "S"):
        _check(getattr(ref[0], name), getattr(out[0], name), 1e-12, name)
    _check(ref[1]["age"], out[1]["age"], 1e-12, "age")
