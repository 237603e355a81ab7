"""mom6_torch against mom6_tpu: the schemes and options of the dynamics
modules that the RK2b and unsplit steppers and the reference cases
bring in.

* ``coriolis_adv``: every CORIOLIS_SCHEME, KE_SCHEME and flag (NOSLIP,
  BOUND_CORIOLIS, CORIOLIS_EN_DIS, PV_ADV_UPWIND1, the blend weights) on
  a closed basin whose thicknesses vary by orders of magnitude, so that
  the masks, the blend ratios and the robust-enstrophy clamps all act;
  1e-12 relative to each field's maximum.
* The plain continuity (through the dispatching wrapper on CPU tensors)
  in each edge scheme and with the volume-based CFL, transport-matched
  and untargeted, with the 2D Newton corrections du_cor/dv_cor, and the
  BT_cont fit in each scheme: 1e-12 (the turn velocities 1e-8, as in
  tests/test_torch_continuity.py).
* ``horizontal_viscosity`` with NOSLIP and with USE_LAND_MASK_FOR_HVISC
  off, and ``vertvisc_coef``/``vertvisc`` with BOTTOMDRAGLAW off: 1e-12.

The JAX functions run eagerly in float64, the port on device="cpu".
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.core import continuity_ppm as jcont
from mom6_tpu.core import coriolis_adv as jca
from mom6_tpu.core import vert_friction as jvf
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.param.lateral import hor_visc as jhv
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch.convert import grid_from_numpy
from mom6_torch.core import continuity_cuda as tcc
from mom6_torch.core import continuity_ppm as tcont
from mom6_torch.core import coriolis_adv as tca
from mom6_torch.core import vert_friction as tvf
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.param.lateral import hor_visc as thv
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
NI, NJ, NK = 14, 12, 3


def _setup(seed, reentrant_x=False):
    kw = dict(ni=NI, nj=NJ, halo=4, reentrant_x=reentrant_x,
              reentrant_y=False)
    jd = JDomain(**kw)
    jg = j_cartesian_grid(jd, lenlon_km=NI * 10.0, lenlat_km=NJ * 10.0,
                          f0=1e-4, beta=2e-11, max_depth=4000.0)
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.005)
    tg = grid_from_numpy({f.name: np.asarray(getattr(jg, f.name))
                          for f in dataclasses.fields(jg)
                          if f.name != "domain"
                          and getattr(jg, f.name) is not None},
                         Domain(**kw), device="cpu", dtype=F64)
    tvg = VerticalGrid.uniform(nk=NK, gint=0.005, device="cpu", dtype=F64)
    rng = np.random.default_rng(seed)
    shape = (NK, jd.njh, jd.nih)

    def field(scale, offset=0.0, mask=1.0, s=shape):
        a = offset + scale * rng.standard_normal(s)
        return np.asarray(jd.fill_halos(jnp.asarray(a) * mask))

    def thick():
        # thicknesses from near-vanished to thick: 1e-3 .. 1e3 m
        a = 10.0 ** rng.uniform(-3.0, 3.0, shape)
        return np.asarray(jd.fill_halos(jnp.asarray(a)))

    return jd, jg, jvg, tg, tvg, field, thick


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _close(ref, out, tol, name, H=4):
    a = np.asarray(ref)[..., H:-H, H:-H]
    b = out.detach().numpy()[..., H:-H, H:-H]
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


CORIOLIS = [
    dict(),
    dict(coriolis_en_dis=True),
    dict(scheme="SADOURNY75_ENSTRO"),
    dict(scheme="ARAKAWA_HSU90"),
    dict(scheme="ARAKAWA_LAMB81"),
    dict(scheme="ARAKAWA_LAMB_BLEND"),
    dict(scheme="AL_BLEND", blend_wt_lin=0.5, blend_f_eff_max=3.0),
    dict(scheme="ARAKAWA_LAMB_BLEND", blend_f_eff_max=2.0),
    dict(scheme="ROBUST_ENSTRO"),
    dict(scheme="ROBUST_ENSTRO", pv_adv_upwind=True, h_tiny=1e-6),
    dict(ke_scheme="KE_SIMPLE_GUDONOV"),
    dict(ke_scheme="KE_GUDONOV", scheme="SADOURNY75_ENSTRO"),
    dict(no_slip=True),
    dict(bound_coriolis=True),
    dict(bound_coriolis=True, scheme="ARAKAWA_LAMB81", no_slip=True),
]


@pytest.mark.parametrize("kw", CORIOLIS, ids=[
    "-".join(f"{k}={v}" for k, v in kw.items()) or "default"
    for kw in CORIOLIS])
def test_coriolis_schemes(kw):
    jd, jg, jvg, tg, tvg, field, thick = _setup(3)
    h = thick()
    u, v = field(0.3, mask=jg.mask2dCu), field(0.3, mask=jg.mask2dCv)
    # transports near, but not equal to, the centred u h dy (the
    # energy-dissipating bias picks between the two)
    uh = field(0.1, 1.0) * u * np.asarray(jg.dyCu) * h
    vh = field(0.1, 1.0) * v * np.asarray(jg.dxCv) * h
    ref = jca.coriolis_adv(jg, *map(jnp.asarray, (u, v, h, uh, vh)),
                           jca.CoriolisCfg(**kw))
    out = tca.coriolis_adv(tg, *map(_t, (u, v, h, uh, vh)),
                           tca.CoriolisCfg(**kw))
    for name in ("CAu", "CAv", "rel_vort", "pv"):
        _close(getattr(ref, name), getattr(out, name), 1e-12, name)
    assert float(torch.abs(out.CAu).max()) > 0.0


def test_coriolis_rejects_unknown_scheme():
    _, _, _, tg, _, field, thick = _setup(4)
    z = _t(field(0.0))
    with pytest.raises(ValueError, match="CORIOLIS_SCHEME"):
        tca.coriolis_adv(tg, z, z, _t(thick()), z, z,
                         tca.CoriolisCfg(scheme="NOT_A_SCHEME"))


CONTINUITY = [dict(), dict(upwind_1st=True), dict(simple_2nd=True),
              dict(monotonic=True), dict(vol_cfl=True),
              dict(monotonic=True, vol_cfl=True)]


def _continuity_inputs(seed):
    jd, jg, jvg, tg, tvg, field, _ = _setup(seed)
    x = dict(h=field(16.0, 160.0), u=field(0.3, mask=jg.mask2dCu),
             v=field(0.3, mask=jg.mask2dCv),
             vr_u=np.asarray(jd.fill_halos(jnp.asarray(
                 np.random.default_rng(seed).uniform(0.5, 1.0,
                                                     (NK, jd.njh, jd.nih))))))
    x["vr_v"] = x["vr_u"][:, ::-1].copy()
    noise = field(0.05, 1.0, s=x["h"].shape[1:])
    x["uhbt"] = (x["u"] * x["h"]).sum(0) * np.asarray(jg.dyCu) * noise
    x["vhbt"] = (x["v"] * x["h"]).sum(0) * np.asarray(jg.dxCv) * noise
    return jg, jvg, tg, tvg, x


@pytest.mark.parametrize("targeted", [True, False],
                         ids=["targeted", "untargeted"])
@pytest.mark.parametrize("kw", CONTINUITY, ids=[
    "-".join(kw) or "ppm" for kw in CONTINUITY])
def test_continuity_schemes(kw, targeted):
    jg, jvg, tg, tvg, x = _continuity_inputs(5)
    jcfg, tcfg = jcont.ContinuityCfg(**kw), tcont.ContinuityCfg(**kw)
    for x_first in (True, False):
        jkw = dict(x_first=x_first)
        tkw = dict(x_first=x_first)
        if targeted:
            jkw.update(uhbt=x["uhbt"], vhbt=x["vhbt"],
                       visc_rem_u=x["vr_u"], visc_rem_v=x["vr_v"])
            tkw.update({k: _t(v) for k, v in (
                ("uhbt", x["uhbt"]), ("vhbt", x["vhbt"]),
                ("visc_rem_u", x["vr_u"]), ("visc_rem_v", x["vr_v"]))})
        ref = jcont.continuity_ppm(jg, jvg, *(jnp.asarray(x[k])
                                              for k in ("u", "v", "h")),
                                   600.0, jcfg, **jkw)
        out = tcc.continuity_ppm_cuda(tg, tvg, *(_t(x[k])
                                                 for k in ("u", "v", "h")),
                                      600.0, tcfg, **tkw)
        names = ("h", "uh", "vh") + (("u_cor", "v_cor", "du_cor", "dv_cor")
                                     if targeted else ())
        for name in names:
            _close(getattr(ref, name), getattr(out, name), 1e-12,
                   f"{name} x_first={x_first}")
        if not targeted:
            assert out.u_cor is None and out.du_cor is None
    if kw:
        # every scheme really changes the answer
        base = tcont.continuity_ppm(tg, tvg, _t(x["u"]), _t(x["v"]),
                                    _t(x["h"]), 600.0)
        assert not torch.equal(base.uh, out.uh)


@pytest.mark.parametrize("kw", CONTINUITY[1:], ids=[
    "-".join(kw) for kw in CONTINUITY[1:]])
def test_bt_cont_schemes(kw):
    jg, jvg, tg, tvg, x = _continuity_inputs(6)
    ref = jcont.set_up_bt_cont(jg, jvg, *(jnp.asarray(x[k]) for k in (
        "u", "v", "h")), 600.0, jcont.ContinuityCfg(**kw),
        jnp.asarray(x["vr_u"]), jnp.asarray(x["vr_v"]))
    out = tcc.set_up_bt_cont_cuda(tg, tvg, *(_t(x[k]) for k in (
        "u", "v", "h")), 600.0, tcont.ContinuityCfg(**kw), _t(x["vr_u"]),
        _t(x["vr_v"]))
    for name in ref._fields:
        turn = name.startswith(("uBT", "vBT"))
        _close(getattr(ref, name), getattr(out, name),
               1e-8 if turn else 1e-12, name)


@pytest.mark.parametrize("kw", [dict(no_slip=True),
                                dict(use_land_mask=False),
                                dict(no_slip=True, use_land_mask=False)],
                         ids=["noslip", "no_land_mask", "both"])
def test_horizontal_viscosity_options(kw):
    jd, jg, jvg, tg, tvg, field, _ = _setup(7)
    # land cells beyond the walls hold thickness too: the land mask
    # removes it, USE_LAND_MASK_FOR_HVISC = False keeps it
    h = np.where(np.asarray(jg.mask2dT) > 0, field(20.0, 1000.0), 900.0)
    u, v = field(0.2, mask=jg.mask2dCu), field(0.2, mask=jg.mask2dCv)
    base = dict(biharmonic=True, smag_bi_const=0.06, laplacian=True,
                kh=50.0, smag_lap_const=0.1, dt=600.0)
    ref = jhv.horizontal_viscosity(jg, *map(jnp.asarray, (u, v, h)),
                                   jhv.HorViscCfg(**base, **kw))
    out = thv.horizontal_viscosity(tg, *map(_t, (u, v, h)),
                                   thv.HorViscCfg(**base, **kw))
    _close(ref.diffu, out.diffu, 1e-12, "diffu")
    _close(ref.diffv, out.diffv, 1e-12, "diffv")
    # under free slip the corner stress on a wall is zero, so the land
    # mask changes nothing there; with NOSLIP both options act
    plain = thv.horizontal_viscosity(tg, *map(_t, (u, v, h)),
                                     thv.HorViscCfg(**base))
    assert torch.equal(plain.diffu, out.diffu) != kw.get("no_slip", False)


def test_vertvisc_without_drag_law():
    jd, jg, jvg, tg, tvg, field, _ = _setup(8)
    h = field(20.0, 1000.0)
    u, v = field(0.2, mask=jg.mask2dCu), field(0.2, mask=jg.mask2dCv)
    tau = np.asarray(jg.mask2dCu) * 0.1
    kw = dict(kv=1e-2, hbbl=1.0, bottomdraglaw=False)
    jcfg, tcfg = jvf.VertViscCfg(**kw), tvf.VertViscCfg(**kw)

    @jax.jit
    def ref_fn(u, v, h, tau):
        c = jvf.vertvisc_coef(jg, u, v, h, cfg=jcfg)
        return c, jvf.vertvisc(jg, u, v, h, c, 600.0, tau)

    jc, (ju, jv) = ref_fn(*map(jnp.asarray, (u, v, h, tau)))
    tc = tvf.vertvisc_coef(tg, *map(_t, (u, v, h)), cfg=tcfg)
    for name in tc._fields:
        # the Rayleigh drags are None on both sides without CHANNEL_DRAG
        if getattr(tc, name) is None and getattr(jc, name) is None:
            continue
        _close(getattr(jc, name), getattr(tc, name), 1e-12, name)
    tu, tv = tvf.vertvisc(tg, _t(u), _t(v), _t(h), tc, 600.0, _t(tau))
    _close(ju, tu, 1e-12, "u")
    _close(jv, tv, 1e-12, "v")
