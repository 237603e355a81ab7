"""mom6_torch against mom6_tpu: the dynamics modules and the slice.

The same seeded numpy inputs go through the JAX function (float64 on
the CPU, the slice step under jax.jit) and its port on device="cpu" in
float64; fields compare on the compute domain, relative to the
field's maximum.  The last test runs three split RK2 steps of the
slice's configuration at 32x24x3.
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
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.forcing import MechForcing as JMechForcing
from mom6_tpu.core import pressure_force as jpf
from mom6_tpu.core import coriolis_adv as jca
from mom6_tpu.core import vert_friction as jvf
from mom6_tpu.param.lateral import hor_visc as jhv
from mom6_tpu.core import dynamics_split_rk2 as jdyn
from mom6_tpu.core.barotropic import BarotropicCfg as JBarotropicCfg

from mom6_torch import entry
from mom6_torch.convert import grid_from_numpy, to_numpy
from mom6_torch.core import pressure_force as tpf
from mom6_torch.core import coriolis_adv as tca
from mom6_torch.core import vert_friction as tvf
from mom6_torch.core.forcing import MechForcing as TMechForcing
from mom6_torch.core.dynamics_split_rk2 import step_dyn_split_rk2
from mom6_torch.core.vertical_grid import VerticalGrid as TVerticalGrid
from mom6_torch.param.lateral import hor_visc as thv
from mom6_torch.parallel.domain import Domain as TDomain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, NK = 32, 24, 3


def _jgrid_numpy(g):
    return {f.name: np.asarray(getattr(g, f.name))
            for f in dataclasses.fields(g)
            if f.name != "domain" and getattr(g, f.name) is not None}


def _setup(seed=0):
    jd = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=True, reentrant_y=False)
    jg = j_cartesian_grid(jd, lenlon_km=320.0, lenlat_km=240.0, f0=1e-4,
                          beta=2e-11, max_depth=4000.0)
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.005)
    td = TDomain(ni=NI, nj=NJ, halo=4, reentrant_x=True, reentrant_y=False)
    tg = grid_from_numpy(_jgrid_numpy(jg), td, device="cpu", dtype=F64)
    tvg = TVerticalGrid.uniform(nk=NK, gint=0.005, device="cpu", dtype=F64)
    rng = np.random.default_rng(seed)
    shape = (NK, jd.njh, jd.nih)

    def field(scale, offset=0.0, s=shape):
        a = offset + scale * rng.standard_normal(s)
        return np.asarray(jd.fill_halos(jnp.asarray(a)))

    return jd, jg, jvg, td, tg, tvg, field


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _assert_close(ref, out, tol, name, H=4):
    a = np.asarray(ref)[..., H:-H, H:-H]
    b = out.detach().numpy()[..., H:-H, H:-H] if torch.is_tensor(out) \
        else np.asarray(out)[..., H:-H, H:-H]
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("p_atm", [False, True])
@pytest.mark.parametrize("montgomery", [False, True])
def test_pressure_force(montgomery, p_atm):
    jd, jg, jvg, td, tg, tvg, field = _setup(1)
    h = field(20.0, 1000.0)
    pa = field(100.0, 1e5, s=h.shape[1:]) if p_atm else None
    jcfg = jpf.PressureForceCfg(montgomery=montgomery)
    tcfg = tpf.PressureForceCfg(montgomery=montgomery)
    ref = jpf.pressure_force(jg, jvg, jnp.asarray(h), cfg=jcfg,
                             p_atm=None if pa is None else jnp.asarray(pa))
    out = tpf.pressure_force(tg, tvg, _t(h), cfg=tcfg,
                             p_atm=None if pa is None else _t(pa))
    for name in ("PFu", "PFv", "pbce", "eta_pf"):
        _assert_close(getattr(ref, name), getattr(out, name), 1e-12, name)


def test_coriolis_adv():
    jd, jg, jvg, td, tg, tvg, field = _setup(2)
    h, u, v = field(20.0, 1000.0), field(0.2), field(0.2)
    uh, vh = field(1e4), field(1e4)
    ref = jca.coriolis_adv(jg, *map(jnp.asarray, (u, v, h, uh, vh)))
    out = tca.coriolis_adv(tg, *map(_t, (u, v, h, uh, vh)))
    for name in ("CAu", "CAv", "rel_vort", "pv"):
        _assert_close(getattr(ref, name), getattr(out, name), 1e-12, name)


def test_vertvisc():
    jd, jg, jvg, td, tg, tvg, field = _setup(3)
    h, u, v = field(20.0, 1000.0), field(0.2), field(0.2)
    tau = np.asarray(jg.mask2dCu) * 0.1
    jcfg, tcfg = jvf.VertViscCfg(kv=1e-4), tvf.VertViscCfg(kv=1e-4)

    # one jit for the JAX chain: its lax.scan solves would each compile
    # separately when run eagerly
    @jax.jit
    def ref_fn(u, v, h, tau):
        b = jvf.set_viscous_bbl(jg, u, v, h, jcfg, jvg)
        c = jvf.vertvisc_coef(jg, u, v, h, cfg=jcfg, bbl=b)
        uv = jvf.vertvisc(jg, u, v, h, c, 360.0, tau)
        ust = jvf.surface_ustar(jg, 1035.0, JMechForcing(taux=tau, tauy=tau))
        return b, c, uv, ust, jvf.vertvisc_remnant(jg, c, 360.0)

    jb, jc, (ju, jv), just, jr = ref_fn(*map(jnp.asarray, (u, v, h, tau)))
    tb = tvf.set_viscous_bbl(tg, *map(_t, (u, v, h)), tcfg, tvg)
    for name in jb._fields:
        _assert_close(getattr(jb, name), getattr(tb, name), 1e-12, name)
    tc = tvf.vertvisc_coef(tg, *map(_t, (u, v, h)), cfg=tcfg, bbl=tb)
    for name in tc._fields:
        _assert_close(getattr(jc, name), getattr(tc, name), 1e-12, name)
    tu, tv = tvf.vertvisc(tg, _t(u), _t(v), _t(h), tc, 360.0, _t(tau))
    _assert_close(ju, tu, 1e-12, "u")
    _assert_close(jv, tv, 1e-12, "v")
    tforces = TMechForcing(taux=_t(tau), tauy=_t(tau))
    _assert_close(just, tvf.surface_ustar(tg, 1035.0, tforces), 1e-12,
                  "ustar")
    tr = tvf.vertvisc_remnant(tg, tc, 360.0)
    _assert_close(jr[0], tr[0], 1e-12, "visc_rem_u")
    _assert_close(jr[1], tr[1], 1e-12, "visc_rem_v")


def test_horizontal_viscosity():
    jd, jg, jvg, td, tg, tvg, field = _setup(4)
    h, u, v = field(20.0, 1000.0), field(0.2), field(0.2)
    kw = dict(biharmonic=True, smag_bi_const=0.06, laplacian=True,
              kh=50.0, smag_lap_const=0.1, dt=600.0)
    ref = jhv.horizontal_viscosity(jg, *map(jnp.asarray, (u, v, h)),
                                   jhv.HorViscCfg(**kw))
    out = thv.horizontal_viscosity(tg, *map(_t, (u, v, h)),
                                   thv.HorViscCfg(**kw))
    _assert_close(ref.diffu, out.diffu, 1e-12, "diffu")
    _assert_close(ref.diffv, out.diffv, 1e-12, "diffv")


def test_slice_three_steps_match_jax():
    """The slice: three split RK2 steps, port (plain versions on the CPU)
    against the JAX step under jax.jit, both float64."""
    s = entry.build(NI, NJ, NK, device="cpu", dtype=F64)
    jd = JDomain(ni=NI, nj=NJ, halo=4, reentrant_x=True, reentrant_y=False)
    jg = j_cartesian_grid(jd, lenlon_km=NI * 10.0, lenlat_km=NJ * 10.0,
                          f0=1e-4, beta=2e-11, max_depth=4000.0)
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.005)
    jcfg = jdyn.SplitCfg(
        vertvisc=jvf.VertViscCfg(kv=1e-4),
        horvisc=jhv.HorViscCfg(biharmonic=True, smag_bi_const=0.06,
                               dt=s.dt),
        barotropic=JBarotropicCfg(nstep=s.cfg.barotropic.nstep))
    h0 = to_numpy(s.state)["h"]
    jstate = JState(u=jnp.zeros_like(h0), v=jnp.zeros_like(h0),
                    h=jnp.asarray(h0))
    jsplit = jdyn.init_split_state(jd, jg, jvg, jstate)
    jforces = JMechForcing(taux=0.1 * jg.mask2dCu)

    @jax.jit
    def jstep(st, sp):
        st2, sp2, _ = jdyn.step_dyn_split_rk2(jd, jg, jvg, st, sp,
                                              jforces, s.dt, jcfg)
        return st2, sp2

    st, sp = s.state, s.split
    for _ in range(3):
        jstate, jsplit = jstep(jstate, jsplit)
        st, sp, _ = step_dyn_split_rk2(s.domain, s.grid, s.vgrid, st, sp,
                                       s.forces, s.dt, s.cfg)
    for name in ("h", "u", "v"):
        _assert_close(getattr(jstate, name), getattr(st, name), 1e-9, name)
    _assert_close(jsplit.eta, sp.eta, 1e-9, "eta")
    # the flow really moved: wind, pressure gradients and the subcycle
    assert float(torch.abs(st.u).max()) > 1e-3
