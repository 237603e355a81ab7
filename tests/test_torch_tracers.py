"""mom6_torch against mom6_tpu: tracer transport and the lateral
parameterizations of the full step.

One seeded layered state at 12x10x3 (reentrant x, walls in y, halo 4)
goes through the JAX functions, called eagerly in float64, and their
ports on device="cpu" in float64: advect_tracers (both sweep orders),
tracer_hordiff on the plain KHTR path, the ideal age tracer's column
function through the registry, thickness_diffuse (constant KHTH) and
mixed_layer_restrat (Wright EOS, a given mixed-layer depth).  Tolerance
1e-12 relative to each field's maximum on the compute domain.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.param.lateral import mixed_layer_restrat as jmle
from mom6_tpu.param.lateral import thickness_diffuse as jtd
from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.tracer import advect as jadv
from mom6_tpu.tracer import hor_diff as jhd
from mom6_tpu.tracer.ideal import register_ideal_age as j_register_age
from mom6_tpu.tracer.registry import TracerRegistry as JRegistry

from mom6_torch.convert import grid_from_numpy
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.eos import make_eos
from mom6_torch.param.lateral import mixed_layer_restrat as tmle
from mom6_torch.param.lateral import thickness_diffuse as ttd
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer import advect as tadv
from mom6_torch.tracer import hor_diff as thd
from mom6_torch.tracer.ideal import register_ideal_age as t_register_age
from mom6_torch.tracer.registry import TracerRegistry

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, NK = 12, 10, 3
TOL = 1e-12


def _setup():
    jd = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=120.0, lenlat_km=100.0, f0=1e-4,
                          beta=2e-11, max_depth=1500.0)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    td = Domain(ni=NI, nj=NJ, halo=4, reentrant_x=True)
    tg = grid_from_numpy(gnp, td, device="cpu", dtype=F64)
    rng = np.random.default_rng(31)
    shape = (NK, jd.njh, jd.nih)

    def field(a):
        return np.asarray(jd.fill_halos(jnp.asarray(a)))

    h = field(rng.uniform(300.0, 700.0, shape))
    a = dict(
        h=h,
        T=field(np.linspace(20.0, 4.0, NK)[:, None, None]
                + rng.standard_normal(shape)),
        S=field(35.0 + 0.2 * rng.standard_normal(shape)),
        age=field(rng.uniform(0.0, 3.0, shape)),
        # accumulated transports up to 0.3 of the cell volume [m3]
        uhtr=field(0.3 * h * gnp["areaT"] * rng.uniform(-1.0, 1.0, shape)
                   * gnp["mask2dCu"]),
        vhtr=field(0.3 * h * gnp["areaT"] * rng.uniform(-1.0, 1.0, shape)
                   * gnp["mask2dCv"]),
        hml=field(rng.uniform(20.0, 400.0, shape[1:])))
    return jd, jg, td, tg, a


JD, JG, TD, TG, A = _setup()


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _check(ref, out, name, H=4):
    a = np.asarray(ref, np.float64)
    b = out.numpy()
    if H and a.ndim >= 2:
        a, b = a[..., H:-H, H:-H], b[..., H:-H, H:-H]
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= TOL, f"{name}: relative error {err:.3e} > {TOL:.0e}"


@pytest.mark.parametrize("x_first", [True, False])
def test_advect_tracers_matches_jax(x_first):
    names = ("T", "S", "age")
    ref = jadv.advect_tracers(JD, JG, {k: jnp.asarray(A[k]) for k in names},
                              *(jnp.asarray(A[k]) for k in
                                ("h", "uhtr", "vhtr")),
                              jadv.TracerAdvectCfg(), x_first=x_first)
    out = tadv.advect_tracers(TD, TG, {k: _t(A[k]) for k in names},
                              *(_t(A[k]) for k in ("h", "uhtr", "vhtr")),
                              tadv.TracerAdvectCfg(), x_first=x_first)
    for k in names:
        _check(ref[0][k], out[0][k], k)
    _check(ref[1], out[1], "h_out")
    _check(ref[2], out[2], "resid", H=0)
    with pytest.raises(NotImplementedError, match="PPM"):
        tadv.advect_tracers(TD, TG, {}, *(_t(A[k]) for k in
                                          ("h", "uhtr", "vhtr")),
                            tadv.TracerAdvectCfg(scheme="PPM:H3"))


def test_tracer_hordiff_matches_jax():
    names = ("T", "age")
    kw = dict(khtr=600.0, khtr_min=50.0)
    ref = jhd.tracer_hordiff(JD, JG, {k: jnp.asarray(A[k]) for k in names},
                             jnp.asarray(A["h"]), 1200.0,
                             jhd.TracerHorDiffCfg(**kw))
    out = thd.tracer_hordiff(TD, TG, {k: _t(A[k]) for k in names},
                             _t(A["h"]), 1200.0, thd.TracerHorDiffCfg(**kw))
    for k in names:
        _check(ref[k], out[k], k)
    with pytest.raises(NotImplementedError, match="KHTR_SLOPE_CFF"):
        thd.tracer_hordiff(TD, TG, {}, _t(A["h"]), 1200.0,
                           thd.TracerHorDiffCfg(khtr=1.0,
                                                khtr_slope_cff=0.1))


def test_ideal_age_column_matches_jax():
    jreg, treg = JRegistry(), TracerRegistry()
    j0 = j_register_age(jreg, A["h"].shape)
    t0 = t_register_age(treg, A["h"].shape, device="cpu", dtype=F64)
    assert jreg.names() == treg.names() == ["age"]
    _check(j0, t0, "age init", H=0)
    ref = jreg.apply_column_fns({"age": jnp.asarray(A["age"])},
                                jnp.asarray(A["h"]), 1200.0)
    out = treg.apply_column_fns({"age": _t(A["age"])}, _t(A["h"]), 1200.0)
    _check(ref["age"], out["age"], "age", H=0)


def test_thickness_diffuse_matches_jax():
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.01)
    tvg = VerticalGrid.uniform(nk=NK, gint=0.01, device="cpu", dtype=F64)
    ref = jtd.thickness_diffuse(JG, jvg, jnp.asarray(A["h"]), 600.0,
                                jtd.ThicknessDiffuseCfg(khth=600.0))
    out = ttd.thickness_diffuse(TG, tvg, _t(A["h"]), 600.0,
                                ttd.ThicknessDiffuseCfg(khth=600.0))
    for name in ("h", "uhD", "vhD", "gm_work"):
        _check(getattr(ref, name), getattr(out, name), name)
    with pytest.raises(NotImplementedError, match="khth_2d"):
        ttd.thickness_diffuse(TG, tvg, _t(A["h"]), 600.0,
                              ttd.ThicknessDiffuseCfg(khth=600.0),
                              khth_2d=_t(A["hml"]))


@pytest.mark.parametrize("with_hml", [False, True])
def test_mixed_layer_restrat_matches_jax(with_hml):
    jvg = JVerticalGrid.uniform(nk=NK)
    tvg = VerticalGrid.uniform(nk=NK, device="cpu", dtype=F64)
    ref = jmle.mixed_layer_restrat(
        jmle.MLRestratCfg(), JG, jvg, jnp.asarray(A["h"]), 600.0,
        T=jnp.asarray(A["T"]), S=jnp.asarray(A["S"]),
        eos=j_make_eos("WRIGHT"),
        hml=jnp.asarray(A["hml"]) if with_hml else None)
    out = tmle.mixed_layer_restrat(
        tmle.MLRestratCfg(), TG, tvg, _t(A["h"]), 600.0, T=_t(A["T"]),
        S=_t(A["S"]), eos=make_eos("WRIGHT"),
        hml=_t(A["hml"]) if with_hml else None)
    for name in ("h", "uhml", "vhml"):
        _check(getattr(ref, name), getattr(out, name), name)
