"""mom6_torch against mom6_tpu: open boundaries, on the CPU in float64.

* ``parse_segments`` on the tc3 and ref_tc3 segment strings and on
  partial, nudged and file-data specs (every Segment field).
* Every ``OpenBoundaries`` method (extend, Flather, Orlanski radiation
  with nudging, the tracer reservoirs, keep_boundary) and
  ``open_grid_masks`` on segments of every kind (bitwise), and
  ``build_obc_data_interp`` at several model times (1e-14).
* The five OBC_USER_CONFIG updates (1e-14; the Kelvin wave's
  exponentials 1e-13).
* ``horizontal_viscosity`` under the OBC strain, vorticity and
  biharmonic flags (1e-12), and ``btstep`` with open faces (1e-11).
* ``build_model`` + ``Model.step_fn`` of ``configs.BENCH_CONFIG_OBC``
  at 16x16x4 for 4 steps (two thermodynamic ones; the S segment's dye
  enters), and of bench.py's CONFIG with its segments (Z* ALE, T/S and
  the age tracer through the reservoirs) for 2 steps, with the tracer
  reservoirs (1e-9).
* ``cases/tc3`` through both solo drivers (ocean.stats as printed), as
  shipped (all zero) and with SSH = 0.1 m on one segment and three
  dyes; the port restores the JAX run's restart with its reservoirs,
  and its own restart is bitwise.

The JAX side runs eagerly (``jax.disable_jit``), its solo driver
excepted: at these sizes compiling costs more than running.  Tolerances are relative to each
field's maximum on the compute domain unless stated.
"""

import dataclasses
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mom6_tpu.core import barotropic as jbt
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.drivers import solo as jsolo
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.obc import boundary_update as jbu
from mom6_tpu.obc import open_boundary as job
from mom6_tpu.param.lateral import hor_visc as jhv
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch import configs, convert
from mom6_torch.core import barotropic as tbt
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.drivers import solo
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model
from mom6_torch.obc import boundary_update as tbu
from mom6_torch.obc import open_boundary as tob
from mom6_torch.param.lateral import hor_visc as thv
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

F64 = torch.float64
ROOT = pathlib.Path(__file__).resolve().parents[1]
NI, NJ, NK, H = 14, 12, 3, 4
DT = 600.0

SEGMENTS = """OBC_NUMBER_OF_SEGMENTS = 4
OBC_SEGMENT_001 = "I=0,J=0:N,FLATHER,ORLANSKI"
OBC_SEGMENT_001_DATA = "U=value:0.05,V=value:0.0,SSH=value:0.02"
OBC_SEGMENT_002 = "I=N,J=N:0,FLATHER,ORLANSKI,NUDGED"
OBC_SEGMENT_002_DATA = "U=file:obc_east.nc(u),SSH=file:obc_east.nc(ssh)"
OBC_SEGMENT_002_VELOCITY_NUDGING_TIMESCALES = 0.01, 0.1
OBC_SEGMENT_003 = "J=0,I=3:9,FLATHER,ORLANSKI"
OBC_SEGMENT_003_DATA = "V=value:0.01,SSH=value:-0.01,TEMP=value:4.0"
OBC_SEGMENT_004 = "J=N,I=N:5,FLATHER,ORLANSKI,NUDGED"
OBC_SEGMENT_004_VELOCITY_NUDGING_TIMESCALES = 0.02
"""


@pytest.fixture(scope="module", autouse=True)
def _eager_jax():
    """Run the JAX references op by op: every call here is small."""
    with jax.disable_jit():
        yield


def _close(ref, out, tol, name, halo=H):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    if halo:
        a, b = a[..., halo:-halo, halo:-halo], b[..., halo:-halo, halo:-halo]
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _same(ref, out, name):
    """Bitwise, over the whole padded array."""
    a = np.asarray(ref, np.float64)
    b = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    np.testing.assert_array_equal(b, a, err_msg=name)


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


class Setup:
    """Both packages' domain, grid and open boundaries from SEGMENTS
    (the E data file written into ``indir``), with seeded fields."""

    def __init__(self, indir, seed=3, dye=2, text=SEGMENTS):
        configs.write_obc_data(str(indir), NI, NJ, seed=seed)
        text = text + f"INPUTDIR = {indir}\n"
        kw = dict(ni=NI, nj=NJ, halo=H, reentrant_x=False,
                  reentrant_y=False)
        self.jd, self.td = JDomain(**kw), Domain(**kw)
        self.jpf, self.tpf = JParamFile(text=text), ParamFile(text=text)
        self.jobc = job.build_open_boundaries(self.jpf, self.jd, str(indir),
                                              dye_tracers=dye)
        self.tobc = tob.build_open_boundaries(self.tpf, self.td, str(indir),
                                              dye_tracers=dye, device="cpu",
                                              dtype=F64)
        jg = j_cartesian_grid(self.jd, lenlon_km=NI * 10.0,
                              lenlat_km=NJ * 10.0, f0=1e-4, beta=2e-11,
                              max_depth=1000.0,
                              depth_fn=lambda lon, lat: 800.0 + lon + lat)
        self.jg0 = jg
        self.jg = job.open_grid_masks(jg, self.jobc)
        self.tg = convert.grid_from_numpy(
            {f.name: np.asarray(getattr(self.jg, f.name))
             for f in dataclasses.fields(self.jg)
             if f.name != "domain" and getattr(self.jg, f.name) is not None},
            self.td, device="cpu", dtype=F64)
        self.rng = np.random.default_rng(seed)

    def field(self, shape, scale=1.0, offset=0.0):
        return offset + scale * self.rng.standard_normal(shape)


def _obc_fields(o):
    return {f.name: getattr(o, f.name) for f in dataclasses.fields(o)}


# ---- segments and the boundary object -----------------------------------

SPECS = {
    "tc3": ('"J=N,I=N:0,FLATHER,ORLANSKI"', "U=value:0.0,V=value:0.0,"
            "SSH=value:0.0"),
    "ref_tc3": ('"I=N,J=N:0,FLATHER,ORLANSKI"', "U=value:0.0,V=value:0.0,"
                "SSH=value:0.1"),
    "partial": ('"J=0,I=3:9,FLATHER,GRADIENT"', "V=value:-0.02,"
                "TEMP=value:12.5,SALT=value:35.0"),
    "partial_to_end": ('"J=N,I=N:5,ORLANSKI"', ""),
    "nudged": ('"I=0,J=0:N,FLATHER,ORLANSKI,NUDGED"', "U=value:0.1"),
    "file": ('"I=N,J=0:N,FLATHER,ORLANSKI"',
             "U=file:obc_east.nc(u),SSH=file:obc_east.nc(ssh)"),
}


@pytest.mark.parametrize("case", list(SPECS))
def test_parse_segments_match(case, tmp_path):
    spec, data = SPECS[case]
    configs.write_obc_data(str(tmp_path), NI, NJ, seed=1)
    text = (f"OBC_NUMBER_OF_SEGMENTS = 1\nOBC_SEGMENT_001 = {spec}\n"
            f'OBC_SEGMENT_001_DATA = "{data}"\n'
            "OBC_SEGMENT_001_VELOCITY_NUDGING_TIMESCALES = 0.5, 2.0\n")
    ref = job.parse_segments(JParamFile(text=text), str(tmp_path))
    out = tob.parse_segments(ParamFile(text=text), str(tmp_path))
    assert len(ref) == len(out) == 1
    for f in dataclasses.fields(ref[0]):
        r, o = getattr(ref[0], f.name), getattr(out[0], f.name)
        if f.name == "data_series" and r is not None:
            assert r.keys() == o.keys()
            for k in r:
                for a, b in zip(r[k], o[k]):
                    np.testing.assert_array_equal(np.asarray(b),
                                                  np.asarray(a))
        elif isinstance(r, np.ndarray):
            np.testing.assert_array_equal(o, r)
        else:
            assert o == r, f.name
    if case == "file":
        assert out[0].data_series["U"][1].tolist() == [0.0, 86400.0]


def test_open_boundaries_build_match(tmp_path):
    s = Setup(tmp_path)
    jf, tf = _obc_fields(s.jobc), _obc_fields(s.tobc)
    for k, r in jf.items():
        o = tf[k]
        if torch.is_tensor(o):
            _same(r, o, k)
        else:
            assert o == r, k
    assert s.tobc.open_w and s.tobc.open_n and s.tobc.tau_in_n > 0.0
    for k in ("mask2dT", "mask2dCu", "mask2dCv", "mask2dBu", "bathyT"):
        _same(getattr(s.jg, k), getattr(s.tg, k), k)
    assert float(s.tg.mask2dCu[6, H - 1]) == 1.0


def test_open_boundary_methods_match(tmp_path):
    s = Setup(tmp_path)
    shape = (NK, NJ + 2 * H, NI + 2 * H)
    f = {k: s.field(shape, 0.1) for k in ("u", "v", "u0", "v0", "T", "d")}
    eta, D = s.field(shape[1:], 0.1), s.field(shape[1:], 50.0, 500.0)
    jo, to = s.jobc, s.tobc
    ext_j = jo.extend({"a": jnp.asarray(f["u"]), "b": jnp.asarray(eta)})
    ext_t = to.extend({"a": _t(f["u"]), "b": _t(eta)})
    _same(ext_j["a"], ext_t["a"], "extend 3D")
    _same(ext_j["b"], ext_t["b"], "extend 2D")
    _same(jo.apply_flather_u(jnp.asarray(f["u"][0]), jnp.asarray(eta),
                             jnp.asarray(D), 9.8),
          to.apply_flather_u(_t(f["u"][0]), _t(eta), _t(D), 9.8), "flather_u")
    _same(jo.apply_flather_v(jnp.asarray(f["v"][0]), jnp.asarray(eta),
                             jnp.asarray(D), 9.8),
          to.apply_flather_v(_t(f["v"][0]), _t(eta), _t(D), 9.8), "flather_v")
    for dt in (0.0, DT):
        _same(jo.radiate_u(jnp.asarray(f["u"]), jnp.asarray(f["u0"]), dt=dt),
              to.radiate_u(_t(f["u"]), _t(f["u0"]), dt=dt), f"radiate_u {dt}")
        _same(jo.radiate_v(jnp.asarray(f["v"]), jnp.asarray(f["v0"]), dt=dt),
              to.radiate_v(_t(f["v"]), _t(f["v0"]), dt=dt), f"radiate_v {dt}")
    trj = {"T": jnp.asarray(f["T"]), "dye_01": jnp.asarray(f["d"]),
           "dye_02": jnp.asarray(f["d"] * 0.5)}
    trt = {k: _t(v) for k, v in trj.items()}
    rj, rt = jo.init_tracer_reservoirs(trj), to.init_tracer_reservoirs(trt)
    for it in range(2):
        for name in rj:
            assert rj[name].keys() == rt[name].keys()
            for e in rj[name]:
                _same(rj[name][e], rt[name][e], f"reservoir {name} {e} {it}")
        rj = jo.update_tracer_reservoirs(rj, trj, jnp.asarray(f["u"]),
                                         jnp.asarray(f["v"]), DT)
        rt = to.update_tracer_reservoirs(rt, trt, _t(f["u"]), _t(f["v"]), DT)
    aj, at = jo.apply_tracer_reservoirs(trj, rj), \
        to.apply_tracer_reservoirs(trt, rt)
    for name in aj:
        _same(aj[name], at[name], f"apply {name}")
    filled = s.field(shape, 1.0)
    _same(jo.keep_boundary((jnp.asarray(f["T"]),), (jnp.asarray(filled),))[0],
          to.keep_boundary((_t(f["T"]),), (_t(filled),))[0], "keep_boundary")


def test_obc_data_interp_matches(tmp_path):
    s = Setup(tmp_path)
    jfn = job.build_obc_data_interp(s.jpf, s.jd, s.jobc, str(tmp_path))
    tfn = tob.build_obc_data_interp(s.tpf, s.td, s.tobc, str(tmp_path))
    h = s.field((NK, NJ + 2 * H, NI + 2 * H), 1.0, 100.0)
    for t in (0.0, 3000.0, 43200.0, 86400.0, 2.0e5):
        jo = jfn(s.jobc, s.jg, jnp.asarray(h), jnp.asarray(t))
        to = tfn(s.tobc, s.tg, _t(h), t)
        for k in ("u_e", "ssh_e"):
            _close(getattr(jo, k), getattr(to, k), 1e-14, f"{k} at {t}",
                   halo=0)
    assert tob.build_obc_data_interp(
        ParamFile(text="OBC_NUMBER_OF_SEGMENTS = 0\n"), s.td, s.tobc) is None


UPDATES = {
    "kelvin": "OBC_USER_CONFIG = kelvin\nKELVIN_WAVE_SSH_AMP = 0.2\n",
    "tidal_bay": "OBC_USER_CONFIG = tidal_bay\nTIDAL_BAY_SSH_AMP = 0.1\n",
    "shelfwave": "OBC_USER_CONFIG = shelfwave\nSHELFWAVE_AMPLITUDE = 0.3\n",
    "supercritical": "OBC_USER_CONFIG = supercritical\n",
    "dyed_channel": "OBC_USER_CONFIG = dyed_channel\n"
                    "CHANNEL_TIDAL_AMP = 0.5\nCHANNEL_FLOW_FREQUENCY = 1e-4\n",
}


@pytest.mark.parametrize("name", list(UPDATES))
def test_user_updates_match(name, tmp_path):
    s = Setup(tmp_path)
    jfn = jbu.build_obc_update(JParamFile(text=UPDATES[name]), south=0.0,
                               axis_units="k")
    tfn = tbu.build_obc_update(ParamFile(text=UPDATES[name]), south=0.0,
                               axis_units="k")
    h = s.field((NK, NJ + 2 * H, NI + 2 * H), 1.0, 100.0)
    for t in (1000.0, 20000.0):
        jo = jfn(s.jobc, s.jg, jnp.asarray(h), t)
        to = tfn(s.tobc, s.tg, _t(h), t)
        for k in ("u_w", "u_e", "v_s", "v_n", "ssh_w", "ssh_e", "ssh_s",
                  "ssh_n"):
            r, o = getattr(jo, k), getattr(to, k)
            if np.ndim(r) == 2:
                _close(r, o, 1e-13, f"{name} {k}", halo=0)
            else:
                assert abs(float(o) - float(r)) <= 1e-14 * max(
                    1.0, abs(float(r))), (name, k)
    assert tbu.build_obc_update(ParamFile(text="")) is None


# ---- viscosity and the barotropic solver -----------------------------------

HV_FLAGS = {
    "zero": dict(obc_zero_vorticity=True, obc_zero_strain=True,
                 obc_zero_biharmonic=True),
    "freeslip": dict(obc_freeslip_vorticity=True, obc_freeslip_strain=True),
}


@pytest.mark.parametrize("flags", list(HV_FLAGS))
def test_hor_visc_obc_flags_match(flags, tmp_path):
    s = Setup(tmp_path)
    shape = (NK, NJ + 2 * H, NI + 2 * H)
    u, v = s.field(shape, 0.1), s.field(shape, 0.1)
    h = s.field(shape, 1.0, 200.0)
    opts = dict(laplacian=True, biharmonic=True, kh=50.0, ah=1e9,
                smag_bi_const=0.06, dt=DT, **HV_FLAGS[flags])
    ref = jhv.horizontal_viscosity(s.jg, jnp.asarray(u), jnp.asarray(v),
                                   jnp.asarray(h), jhv.HorViscCfg(**opts),
                                   obc=s.jobc)
    out = thv.horizontal_viscosity(s.tg, _t(u), _t(v), _t(h),
                                   thv.HorViscCfg(**opts), obc=s.tobc)
    _close(ref.diffu, out.diffu, 1e-12, "diffu")
    _close(ref.diffv, out.diffv, 1e-12, "diffv")
    plain = thv.horizontal_viscosity(s.tg, _t(u), _t(v), _t(h),
                                     thv.HorViscCfg(laplacian=True,
                                                    biharmonic=True, kh=50.0,
                                                    ah=1e9, smag_bi_const=0.06,
                                                    dt=DT), obc=s.tobc)
    assert not torch.equal(plain.diffu, out.diffu)


@pytest.mark.parametrize("period", [1, 2])
def test_btstep_with_open_faces_matches(period, tmp_path):
    """Whole W/E edges (file profiles on E), partial S and N strips; the
    wide-halo period falls back to 1 under OBC in both packages."""
    s = Setup(tmp_path)
    shape = (NK, NJ + 2 * H, NI + 2 * H)
    mask_u, mask_v = np.asarray(s.jg.mask2dCu), np.asarray(s.jg.mask2dCv)
    a = dict(u=s.field(shape, 0.1) * mask_u, v=s.field(shape, 0.1) * mask_v,
             h=s.field(shape, 5.0, 300.0), eta=s.field(shape[1:], 0.05),
             acc=s.field(shape, 1e-6), vr=s.rng.uniform(0.5, 1.0, shape),
             ecor=s.field(shape[1:], 0.1))
    a["pbce"] = np.full(shape, 9.8 / NK)
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.01)
    tvg = VerticalGrid.uniform(nk=NK, gint=0.01, device="cpu", dtype=F64)
    nstep = jbt.set_dtbt(s.jd, s.jg, jvg, jbt.BarotropicCfg(), DT)
    cfg = dict(nstep=nstep, wide_halo_period=period)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: _t(v) for k, v in a.items()}
    ref = jbt.btstep(s.jd, s.jg, jvg, j["u"], j["v"], j["eta"], j["h"],
                     j["acc"], j["acc"], j["pbce"], j["u"], j["v"], DT,
                     jbt.BarotropicCfg(**cfg), j["vr"], j["vr"],
                     taux=0.1 * s.jg.mask2dCu, obc=s.jobc,
                     eta_cor=j["ecor"])
    out = tbt.btstep(s.td, s.tg, tvg, t["u"], t["v"], t["eta"], t["h"],
                     t["acc"], t["acc"], t["pbce"], t["u"], t["v"], DT,
                     tbt.BarotropicCfg(**cfg), t["vr"], t["vr"],
                     taux=0.1 * s.tg.mask2dCu, obc=s.tobc,
                     eta_cor=t["ecor"])
    for name in ("eta", "uhbtav", "vhbtav", "ubt_av", "vbt_av",
                 "accel_layer_u", "accel_layer_v"):
        _close(getattr(ref, name), getattr(out, name), 1e-11, name)
    # the E and N boundary faces carry flow (the W and S faces lie in the
    # halo, which the closing refresh of the sums clears in both packages)
    assert float(out.uhbtav[H + 2, H + NI - 1].abs()) > 0.0
    assert float(out.vhbtav[H + NJ - 1, H + 7].abs()) > 0.0


# ---- the model ----------------------------------------------------------

SMALL = ("#override NIGLOBAL = 16\n#override NJGLOBAL = 16\n"
         "#override NK = 4\n#override LENLON = 160.0\n"
         "#override LENLAT = 160.0\n" + configs.obc_strip(16))
SEG_LINES = "".join(
    ln + "\n" for ln in configs.OBC_LINES.splitlines()
    if ln.startswith(("OBC_NUMBER", "OBC_SEGMENT")))


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


@pytest.mark.parametrize("text", ["BENCH_CONFIG_OBC", "CONFIG_WITH_SEGMENTS"])
def test_model_two_steps_match_step_fn(text, tmp_path):
    """The regional configuration (adiabatic, layered, 3 dyes) for 4
    steps, and bench.py's CONFIG with the same segments (Z* ALE; T, S
    and the age tracer ride the reservoirs) for 2."""
    base = configs.BENCH_CONFIG_OBC if text == "BENCH_CONFIG_OBC" else (
        configs.BENCH_CONFIG + "#override REENTRANT_X = False\n" + SEG_LINES)
    configs.write_obc_data(str(tmp_path), 16, 16, seed=7)
    full = base + SMALL + f"INPUTDIR = {tmp_path}\n"
    jm = j_build_model(JParamFile(text=full))
    pm = build_model(ParamFile(text=full), device="cpu", dtype=F64)
    assert pm.obc is not None and pm.obc_update_fn is not None
    assert (pm.cfg.ale is None) == (text == "BENCH_CONFIG_OBC")
    assert sorted(pm.tracers) == sorted(jm.tracers)
    rng = np.random.default_rng(5)
    d, g = jm.domain, jm.grid

    def perturbed(a, scale, mask=1.0):
        a = np.asarray(a) + scale * rng.standard_normal(a.shape)
        return d.fill_halos(jnp.asarray(a) * mask)

    kw = {} if jm.state.T is None else {"T": perturbed(jm.state.T, 0.5)}
    st0 = dataclasses.replace(
        jm.state, h=perturbed(jm.state.h, 2.0),
        u=perturbed(jm.state.u, 0.05, g.mask2dCu),
        v=perturbed(jm.state.v, 0.05, g.mask2dCv), **kw)
    steps = range(4 if text == "BENCH_CONFIG_OBC" else 2)
    st, sp, tr = st0, jm.split_state, jm.tracers
    step_j = jm.step_fn()
    for n in steps:
        st, sp, tr = step_j(st, sp, tr, n)
    pm = convert.model_with_state(
        pm, _arrays(st0), _arrays(jm.split_state),
        {k: np.asarray(v) for k, v in jm.tracers.items()})
    step_p = pm.step_fn()
    pst, psp, ptr = pm.state, pm.split, pm.tracers
    for n in steps:
        pst, psp, ptr = step_p(pst, psp, ptr, n)
    for name in ("h", "u", "v", "T", "S"):
        if getattr(st, name) is not None:
            _close(getattr(st, name), getattr(pst, name), 1e-9, name)
    for name in ("eta", "u_av", "v_av", "uh", "vh"):
        _close(getattr(sp, name), getattr(psp, name), 1e-9, name)
    for name in tr:
        _close(tr[name], ptr[name], 1e-9, name)
    rj, rt = step_j.obc_reservoirs(), step_p.obc_reservoirs()
    assert rj.keys() == rt.keys()
    for name in rj:
        for e in rj[name]:
            _close(rj[name][e], rt[name][e], 1e-9, f"res {name} {e}",
                   halo=0)
    assert float(np.abs(np.asarray(st.u)).max()) > 0.0
    if text == "BENCH_CONFIG_OBC":
        dye = ptr["dye_03"][:, H:-H, H:-H]
        assert 0.0 < float(dye.max()) <= 1.0 and float(dye.min()) >= 0.0


def test_config_text_is_bench_config_plus_its_lines():
    assert configs.BENCH_CONFIG_OBC == configs.BENCH_CONFIG + configs.OBC_LINES
    names = [ln.split("=")[0].replace("#override", "").strip()
             for ln in configs.OBC_LINES.splitlines()]
    assert len(names) == len(set(names))
    assert configs.obc_strip(512).count("I=128:384") == 1


# ---- cases/tc3 through the drivers -----------------------------------------

TC3_VARIANTS = {
    "as_shipped": lambda text: text,
    "ssh_dyes": lambda text: text.replace(
        'OBC_SEGMENT_003_DATA = "U=value:0.0,V=value:0.0,SSH=value:0.0"',
        'OBC_SEGMENT_003_DATA = "U=value:0.0,V=value:0.0,SSH=value:0.1"')
    + "NUM_DYE_TRACERS = 3\n",
}


def _stats(path):
    return [line.split(",") for line in path.read_text().splitlines()[2:]]


@pytest.fixture(scope="module", params=list(TC3_VARIANTS))
def tc3_runs(request, tmp_path_factory):
    text = TC3_VARIANTS[request.param](
        (ROOT / "cases" / "tc3" / "MOM_input").read_text())
    dirs = {}
    for pkg in ("jax", "torch"):
        dirs[pkg] = tmp_path_factory.mktemp(f"tc3_{request.param}_{pkg}")
        (dirs[pkg] / "MOM_input").write_text(text)
    # the JAX driver compiles its steps (a one-layer column has no scan
    # to run eagerly), with most XLA optimizations off
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with jax.disable_jit(False):
            jsolo.main([str(dirs["jax"]), "--cpu"])
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    run = solo.main([str(dirs["torch"]), "--cpu"])
    return request.param, dirs, run


def test_tc3_drivers_agree(tc3_runs):
    variant, dirs, run = tc3_runs
    want, got = (_stats(dirs[p] / "ocean.stats") for p in ("jax", "torch"))
    assert got == want and len(got) == 4
    energy = {float(r[3].split()[1]) for r in got}
    assert (energy == {0.0}) == (variant == "as_shipped")
    if variant == "ssh_dyes":
        assert sorted(run["tracers"]) == ["dye_01", "dye_02", "dye_03"]


def test_tc3_restart_with_reservoirs(tc3_runs, tmp_path):
    """The port restores the JAX run's restart (state, tracers and the
    reservoirs); a port run restarted half-way ends bitwise where the
    straight run ends."""
    variant, dirs, run = tc3_runs
    model = build_model(ParamFile(str(dirs["torch"] / "MOM_input")),
                        device="cpu", dtype=F64)
    state, _, tracers, carry, step0, _ = solo._restore(
        str(dirs["jax"] / "RESTART" / "MOM.res"), model)
    assert step0 == 14
    for k in ("u", "v", "h"):
        _close(getattr(state, k).numpy(), getattr(run["state"], k), 1e-9, k)
    assert (carry["res"] is None) == (variant == "as_shipped")
    if carry["res"] is not None:
        for name, edges in carry["res"].items():
            assert sorted(edges) == ["E", "N", "S", "W"]
            _close(tracers[name].numpy(), run["tracers"][name], 1e-9, name)
    half = tmp_path / "half"
    half.mkdir()
    shutil.copy(dirs["torch"] / "MOM_input", half / "MOM_input")
    solo.main([str(half), "--cpu", "--days", "0.025"])
    res = half / "RESTART" / "MOM.res"
    second = solo.main([str(half), "--cpu", "--restart-from", str(res)])
    for k in ("u", "v", "h"):
        assert torch.equal(getattr(second["state"], k),
                           getattr(run["state"], k)), k
    for k in run["tracers"] or {}:
        assert torch.equal(second["tracers"][k], run["tracers"][k]), k
