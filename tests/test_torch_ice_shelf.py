"""mom6_torch against mom6_tpu: the ice shelf (the eighth breadth item) in
float64 on the CPU, each module fed the same numpy inputs from a seed.

* ``three_equation_melt``, masked and unmasked; ``basal_traction``
  (Weertman and Coulomb) and ``glen_a_arrhenius``: 1e-12.
* The SSA operator the port writes out (``ssa_apply``) against
  ``torch.autograd.grad`` of the port's energy (1e-13) and against
  ``jax.grad`` of the JAX package's energy (1e-12), and the exact
  diagonal (``ssa_diagonal``) against the operator on unit vectors.
* ``ssa_velocity_solve`` on the ISOMIP cavity of
  tests/test_isomip_shelf.py: one Picard refresh of 5 CG iterations
  (1e-12), and the default 24 refreshes of 200 iterations against the
  JAX package's jitted solve at 7.5e-14, ten times the JAX package's own
  spread on this case (its jitted against its eager solve, 7.6e-15 in the
  viscosity, 1.26e-14 in u, 2.52e-14 in v; tools/ssa_spread.py).
* ``step_shelf`` on that cavity for two steps, with grounding on the
  ISOMIP bed, Coulomb friction, the melt of the ISOMIP profile, the
  front advancing and the ice temperature evolving: 1e-12.
* The shelf-only driver against the JAX driver on
  tests/test_shelf_coupling.py's case (two steps): ``shelf.stats`` (the
  volume to 1e-12, the speed as printed) and ``shelf_final.nc`` (1e-12:
  the second solve starts from the first's velocities).

The JAX calls run jitted.  The coupled models are in
tests/test_torch_shelf_text.py.
"""

import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.drivers import shelf_solo as j_shelf_solo
from mom6_tpu.framework.io import read_field
from mom6_tpu.ice_shelf import dynamics as jdyn
from mom6_tpu.ice_shelf import shelf_main as jsm
from mom6_tpu.ice_shelf import thermo as jth
from mom6_tpu.parallel import stencil as jst
from mom6_tpu.parallel.domain import Domain as JDomain
from mom6_tpu.user.configs import topo_isomip

from mom6_torch import convert
from mom6_torch.drivers import shelf_solo
from mom6_torch.ice_shelf import dynamics as pdyn
from mom6_torch.ice_shelf import shelf_main as psm
from mom6_torch.ice_shelf import thermo as pth
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, H = 48, 8, 4
LENLON, LENLAT, MAX_DEPTH = 480.0, 80.0, 900.0
TOL = 1e-12
# ten times the JAX package's own spread on the default solve
SOLVE_TOL = 7.5e-14


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _check(ref, out, name, tol=TOL):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.fixture(scope="module")
def isomip():
    """The ISOMIP cavity of tests/test_isomip_shelf.py in both packages:
    (JAX domain, JAX grid, port domain, port grid, h, mask) with the
    ice 800 m at the west wall thinning to 200 m at 55 % of the
    channel."""
    jd = JDomain(ni=NI, nj=NJ, halo=H)
    ctx = {"max_depth": MAX_DEPTH, "west": 0.0, "lenlon": LENLON}
    jg = j_cartesian_grid(
        jd, lenlon_km=LENLON, lenlat_km=LENLAT, f0=-1.4e-4, beta=0.0,
        depth_fn=lambda lo, la: topo_isomip(np.asarray(lo), np.asarray(la),
                                            ctx),
        max_depth=MAX_DEPTH)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    td = Domain(ni=NI, nj=NJ, halo=H)
    tg = convert.grid_from_numpy(gnp, td, device="cpu", dtype=F64)
    lon = gnp["geoLonT"]
    xn = np.clip((lon - lon.min()) / LENLON, 0.0, 1.0)
    h = np.where(xn < 0.55, 800.0 + (200.0 - 800.0) * xn / 0.55, 0.0) \
        * gnp["mask2dT"]
    h = np.asarray(jd.fill_halos(jnp.asarray(h)))
    return jd, jg, td, tg, h, (h > 1e-3).astype(np.float64)


def _isomip_melt(h, mask, thermo, pkg):
    """The three-equation melt of the ISOMIP Ocean0 profile at the ice
    base (tests/test_isomip_shelf.py) in the package ``pkg``."""
    draft, p_b = pkg.shelf_draft(thermo, h)
    if pkg is jth:
        frac = jnp.clip(draft / MAX_DEPTH, 0.0, 1.0)
    else:
        frac = torch.clamp(draft / MAX_DEPTH, 0.0, 1.0)
    t_w = -1.9 + (1.0 - -1.9) * frac
    s_w = 33.8 + (34.55 - 33.8) * frac
    return pkg.three_equation_melt(thermo, t_w, s_w, p_b,
                                   shelf_mask=mask).melt


@pytest.mark.parametrize("masked", [False, True])
def test_three_equation_melt_matches_jax(masked):
    rng = np.random.default_rng(3)
    shape = (9, 11)
    t_w = rng.uniform(-2.5, 2.0, shape)
    s_w = rng.uniform(30.0, 35.0, shape)
    s_w[0, :3] = [0.5, 0.0, 80.0]          # the clip of S_b on both sides
    p_b = rng.uniform(0.0, 9e6, shape)
    mask = (rng.random(shape) < 0.6).astype(np.float64) if masked else None
    cfg = dict(gamma_t=2e-4, rho0=1030.0)
    want = jth.three_equation_melt(
        jth.IceShelfCfg(**cfg), jnp.asarray(t_w), jnp.asarray(s_w),
        jnp.asarray(p_b), None if mask is None else jnp.asarray(mask))
    got = pth.three_equation_melt(
        pth.IceShelfCfg(**cfg), _t(t_w), _t(s_w), _t(p_b),
        None if mask is None else _t(mask))
    for name, a, b in zip(want._fields, want, got):
        _check(a, b, name)
    jd, jp = jth.shelf_draft(jth.IceShelfCfg(), jnp.asarray(p_b / 1e4))
    pd, pp = pth.shelf_draft(pth.IceShelfCfg(), _t(p_b / 1e4))
    _check(jd, pd, "draft")
    _check(jp, pp, "p_base")


@pytest.mark.parametrize("coulomb", [False, True])
def test_basal_traction_and_glen_a_match_jax(isomip, coulomb):
    jd, jg, td, tg, h, _ = isomip
    rng = np.random.default_rng(5)
    u, v = (rng.standard_normal(h.shape) * 3e-6 for _ in range(2))
    gf = (rng.random(h.shape) < 0.5).astype(np.float64)
    kw = dict(c_basal=1e10, n_basal=3.0, coulomb=coulomb, cf_post_peak=2.0,
              cf_min_n=10.0)
    bed = np.asarray(jg.bathyT)
    want = jdyn.basal_traction(jdyn.SSACfg(**kw), jg, jnp.asarray(u),
                               jnp.asarray(v), jnp.asarray(h),
                               jnp.asarray(gf), jnp.asarray(bed))
    got = pdyn.basal_traction(pdyn.SSACfg(**kw), tg, _t(u), _t(v), _t(h),
                              _t(gf), _t(bed))
    _check(want, got, "basal_traction")
    t_shelf = rng.uniform(-40.0, -1.0, h.shape)
    for t_ref in (-20.0, -10.0, -5.0):
        _check(jdyn.glen_a_arrhenius(jnp.asarray(t_shelf), 3e-24, t_ref),
               pdyn.glen_a_arrhenius(_t(t_shelf), 3e-24, t_ref),
               f"glen_a t_ref {t_ref}")


def _j_energy(jg, uv, w_q, beta_a):
    """The JAX package's SSA energy (ssa_velocity_solve's ``energy``)
    with the corner weights w_q = nu h area given."""
    ip1, jp1 = jst.ip1, jst.jp1
    uu, vv = uv
    dx_u, dx_v = ip1(uu) - uu, ip1(vv) - vv
    ux = 0.5 * (dx_u + jp1(dx_u)) * jg.IdxBu
    vx = 0.5 * (dx_v + jp1(dx_v)) * jg.IdxBu
    dy_u, dy_v = jp1(uu) - uu, jp1(vv) - vv
    uy = 0.5 * (dy_u + ip1(dy_u)) * jg.IdyBu
    vy = 0.5 * (dy_v + ip1(dy_v)) * jg.IdyBu
    ev = jnp.sum(w_q * (2.0 * ux * ux + 2.0 * vy * vy + 2.0 * ux * vy
                        + 0.5 * (uy + vx) ** 2))
    return ev + 0.5 * jnp.sum(beta_a * (uu * uu + vv * vv))


def test_ssa_operator_matches_autograd_and_jax(isomip):
    jd, jg, td, tg, h, mask = isomip
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2,) + h.shape) * 1e-5
    w_q = rng.uniform(0.5, 2.0, h.shape) * 1e14 * np.asarray(jg.areaBu)
    beta = rng.uniform(0.0, 1.0, h.shape) * 1e18 * (rng.random(h.shape)
                                                     < 0.3)
    got = pdyn.ssa_apply(tg, _t(x), _t(w_q), _t(beta), _t(mask))
    # the gradient of the port's own energy, by autograd
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(pdyn.ssa_energy(tg, xt, _t(w_q), _t(beta)),
                               xt)
    _check(g.detach() * _t(mask), got, "autograd", tol=1e-13)
    # the gradient of the JAX package's energy, by jax.grad
    gu, gv = jax.grad(lambda uv: _j_energy(jg, uv, jnp.asarray(w_q),
                                           jnp.asarray(beta)))(
        (jnp.asarray(x[0]), jnp.asarray(x[1])))
    _check(np.stack([np.asarray(gu), np.asarray(gv)]) * mask, got,
           "jax.grad")
    # the exact diagonal: the operator on unit vectors
    du, dv = pdyn.ssa_diagonal(tg, _t(w_q), _t(beta))
    for j, i in ((H, H + 3), (H + 4, H + 20), (H + 7, H + 30)):
        for c, diag in ((0, du), (1, dv)):
            e = torch.zeros((2,) + h.shape, dtype=F64)
            e[c, j, i] = 1.0
            col = pdyn.ssa_apply(tg, e, _t(w_q), _t(beta),
                                 torch.ones_like(e[0]))
            assert abs(float(col[c, j, i] - diag[j, i])) \
                <= 1e-13 * abs(float(diag[j, i])), (c, j, i)


def _solve_inputs(jg, h, mask):
    st = jsm.ShelfState(h_shelf=jnp.asarray(h), bed_elev=jg.bathyT)
    _, gf = jsm.update_grounding(jsm.ShelfCfg(), st)
    return np.asarray(gf)


@pytest.mark.parametrize("kw,temp", [
    (dict(n_outer=1, n_inner=5, c_basal=1e10), False),
    (dict(n_outer=1, n_inner=5, c_basal=1e10, coulomb=True, n_basal=3.0,
          picard_damping=0.5), True),
    (dict(n_outer=24, n_inner=200, c_basal=1e10), False)],
    ids=["picard1_cg5", "picard1_cg5_coulomb_temp", "default"])
def test_ssa_solve_matches_jax(isomip, kw, temp):
    jd, jg, td, tg, h, mask = isomip
    gf = _solve_inputs(jg, h, mask)
    bed = np.asarray(jg.bathyT)
    rng = np.random.default_rng(11)
    # the default solve starts from rest, as tools/ssa_spread.py's
    u0 = rng.standard_normal(h.shape) * 1e-6 if kw["n_outer"] == 1 \
        else None
    a2d = None
    if temp:
        a2d = np.asarray(jdyn.glen_a_arrhenius(
            jnp.asarray(rng.uniform(-30.0, -2.0, h.shape))))
    jc, pc = jdyn.SSACfg(**kw), pdyn.SSACfg(**kw)

    def jsolve(hh, mm, g, b, u, a):
        return jdyn.ssa_velocity_solve(jc, jg, hh, mm, u0=u, ground_frac=g,
                                       bed_elev=b, a_glen_2d=a)

    want = jax.jit(jsolve)(*(None if a is None else jnp.asarray(a)
                             for a in (h, mask, gf, bed, u0, a2d)))
    got = pdyn.ssa_velocity_solve(pc, tg, _t(h), _t(mask),
                                  u0=None if u0 is None else _t(u0),
                                  ground_frac=_t(gf), bed_elev=_t(bed),
                                  a_glen_2d=None if a2d is None
                                  else _t(a2d))
    tol = SOLVE_TOL if kw["n_outer"] == 24 else TOL
    for name, a, b in zip(want._fields, want, got):
        _check(a, b, name, tol)
    assert float(got.u.abs().max()) > 0.0


def test_step_shelf_matches_jax(isomip):
    """Two steps with grounding on the bed, Coulomb friction, the melt,
    the front advancing and the ice temperature evolving."""
    jd, jg, td, tg, h, mask = isomip
    kw = dict(n_outer=3, n_inner=20, c_basal=1e10, coulomb=True)
    extra = dict(advance_front=True, evolve_temp=True)
    jc = jsm.ShelfCfg(ssa=jdyn.SSACfg(**kw), **extra)
    pc = psm.ShelfCfg(ssa=pdyn.SSACfg(**kw), **extra)
    rng = np.random.default_rng(13)
    t_sh = np.where(mask > 0, rng.uniform(-25.0, -5.0, h.shape), -10.0)
    bed = np.asarray(jg.bathyT)
    js = jsm.ShelfState(h_shelf=jnp.asarray(h), area_frac=jnp.asarray(mask),
                        bed_elev=jnp.asarray(bed), t_shelf=jnp.asarray(t_sh))
    ps = convert.shelf_state_from_numpy(
        dict(h_shelf=h, area_frac=mask, bed_elev=bed, t_shelf=t_sh),
        device="cpu", dtype=F64)
    dt = 10.0 * 86400.0
    jstep = jax.jit(lambda s, m, u, v: jsm.step_shelf(jd, jg, s, jc, dt,
                                                      melt=m, u0=u, v0=v))
    ju = jv = pu = pv = None
    for _ in range(2):
        jm = _isomip_melt(js.h_shelf, js.mask(jc.min_thickness),
                          jc.thermo, jth)
        pm = _isomip_melt(ps.h_shelf, ps.mask(pc.min_thickness),
                          pc.thermo, pth)
        _check(jm, pm, "melt")
        jr = jstep(js, jm, ju, jv)
        pr = psm.step_shelf(td, tg, ps, pc, dt, melt=pm, u0=pu, v0=pv)
        js, ju, jv = jr
        ps, pu, pv = pr
    for name in ("h_shelf", "area_frac", "t_shelf"):
        _check(getattr(js, name), getattr(ps, name), name)
    _check(ju, pu, "u")
    _check(jv, pv, "v")
    an = ps.area_frac.numpy()[H:-H, H:-H]
    assert ((an > 0) & (an < 1)).any(), "no partial front cell"
    gf = psm.update_grounding(pc, ps)[1].numpy()[H:-H, H:-H]
    assert 0 < gf.sum() < (an > 0).sum()


SOLO_CASE = """
NIGLOBAL = 12
NJGLOBAL = 8
LENLON = 120.0
LENLAT = 80.0
DT_ICE_DYNAMICS = 43200.0
DAYMAX = 1.0
ICE_PROFILE_CONFIG = channel
SHELF_MAX_THICKNESS = 400.0
SHELF_LENGTH_LON = 60.0
"""


def _shelf_stats(path):
    rows = pathlib.Path(path).read_text().splitlines()
    assert rows[0].startswith("# step, day, ice volume")
    return [[float(c) for c in r.split(",")] for r in rows[1:]]


def test_shelf_solo_driver_matches_jax(tmp_path):
    dirs = {}
    for name, main in (("jax", j_shelf_solo.main), ("port", shelf_solo.main)):
        d = tmp_path / name
        d.mkdir()
        (d / "MOM_input").write_text(SOLO_CASE)
        main([str(d), "--cpu"])
        dirs[name] = d
    want = _shelf_stats(dirs["jax"] / "shelf.stats")
    got = _shelf_stats(dirs["port"] / "shelf.stats")
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert g[:2] == w[:2]
        assert abs(g[2] - w[2]) <= 1e-12 * abs(w[2]), (g, w)
        # the speed is printed to 1e-4 m/a
        assert abs(g[3] - w[3]) <= 1.5e-4, (g, w)
    # two default solves, the second from the first's velocities: 1e-12
    # (the first alone is held to SOLVE_TOL above)
    for var in ("thick", "u", "v"):
        _check(read_field(str(dirs["jax"] / "shelf_final.nc"), var),
               read_field(str(dirs["port"] / "shelf_final.nc"), var), var)
