"""mom6_torch against mom6_tpu: the debug layer, on the CPU in float64.

* ``chksum``: bit count, minimum and maximum bitwise equal to the JAX
  package's on the same arrays, in float64 and float32; the mean within
  the JAX package's own summation rounding (it sums in the field's dtype
  in XLA's order; the port divides the exact sum), and ``is_nan``;
  ``state_chksum`` and ``check_halo_consistency``.
* ``parse_diag_table`` and ``DiagMediator`` in checksum mode and in
  NetCDF mode (time means and snapshots, masks, area weights and a
  downsampled field) against the JAX package's on the same posts: the
  same ``chksum_diag`` text and the same NetCDF variables.
* ``build_z_thickness``, ``remap_to_z``, ``reintegrate_to_z``,
  ``interpolate_to_z`` and ``build_rho_thickness`` (1e-12), and
  ``PrognosticDiags.post_state`` in checksum mode (names in order,
  statistics within 1e-12 relative, bits equal for the fields posted
  as they are).
* ``cases/ref_tc0`` through ``python -m mom6_torch.drivers.solo --cpu``
  and through the JAX package's driver: ocean.stats against
  ``tests/goldens_ref_cases.json`` at ``tests/test_ref_cases.py``'s
  tolerances, and the two drivers' ``chksum_debug`` and ``chksum_diag``
  with the same lines and names, statistics within 1e-12 relative.  The
  case stays at rest (u = v = 0, h = 100 m), so the two packages' fields
  are bitwise equal and their bit counts are held equal too.
"""

import json
import math
import pathlib
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.io import netcdf_file

from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.state import State as JState
from mom6_tpu.core.vertical_grid import VerticalGrid as JVerticalGrid
from mom6_tpu.diagnostics import debugging as jdbg
from mom6_tpu.diagnostics import prognostic_diags as jpd
from mom6_tpu.drivers import solo as jsolo
from mom6_tpu.eos import make_eos as j_make_eos
from mom6_tpu.framework import checksums as jck
from mom6_tpu.framework import diag as jdiag
from mom6_tpu.framework import diag_remap as jdr
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch import convert
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.diagnostics import debugging as tdbg
from mom6_torch.diagnostics import prognostic_diags as tpd
from mom6_torch.diagnostics.sum_output import collect_stats
from mom6_torch.drivers import solo
from mom6_torch.eos import make_eos
from mom6_torch.framework import checksums as tck
from mom6_torch.framework import diag as tdiag
from mom6_torch.framework import diag_remap as tdr
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
NI, NJ, NK, H = 12, 10, 4, 4


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _port_domain(**kw):
    return Domain(ni=NI, nj=NJ, halo=H, **kw)


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-300) if a != b else 0.0


# ---- checksums ---------------------------------------------------------

def _field(dtype, seed=1, shape=(NK, NJ + 2 * H, NI + 2 * H)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)
    x[0, H + 1, H + 2] = -0.0
    x[-1, H, H] = 1e-300 if dtype == np.float64 else 1e-30
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_chksum_matches(dtype):
    jd, td = JDomain(ni=NI, nj=NJ, halo=H), _port_domain()
    x = _field(dtype)
    a = jck.chksum(jd, jnp.asarray(x))
    b = tck.chksum(td, torch.from_numpy(x))
    assert (b.bitcount, b.vmin, b.vmax) == (a.bitcount, a.vmin, a.vmax)
    # the mean: the JAX package's sum rounds in the field's dtype
    inner = x[:, H:H + NJ, H:H + NI].astype(np.float64)
    eps = np.finfo(dtype).eps
    assert abs(b.mean - a.mean) <= inner.size * eps * np.abs(inner).mean()
    assert b.mean == math.fsum(inner.ravel()) / inner.size
    assert tck.hchksum_str(td, torch.from_numpy(x), "T").startswith(
        f"T: bits={a.bitcount} min={a.vmin:.17g} max={a.vmax:.17g} mean=")
    y = x.copy()
    assert not tck.is_nan(td, torch.from_numpy(y))
    y[1, H + 2, H + 3] = np.nan
    assert tck.is_nan(td, torch.from_numpy(y)) == jck.is_nan(
        jd, jnp.asarray(y)) is True


def test_state_chksum_matches(capsys):
    fields = {k: _field(np.float64, seed=i + 3)
              for i, k in enumerate(("u", "v", "h", "T", "S"))}
    a = jdbg.state_chksum(JDomain(ni=NI, nj=NJ, halo=H), JState(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    b = tdbg.state_chksum(_port_domain(), State(
        **{k: _t(v) for k, v in fields.items()}), label="after")
    assert list(a) == list(b) == ["u", "v", "h", "T", "S"]
    for k in a:
        assert (a[k].bitcount, a[k].vmin, a[k].vmax) == \
            (b[k].bitcount, b[k].vmin, b[k].vmax)
        assert _rel(a[k].mean, b[k].mean) <= 1e-12
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"after u: bits={a['u'].bitcount} ")
    assert len(out) == 5


@pytest.mark.parametrize("reentrant", [True, False],
                         ids=["reentrant", "walls"])
def test_check_halo_consistency_matches(reentrant):
    jd = JDomain(ni=NI, nj=NJ, halo=H, reentrant_x=True, reentrant_y=True)
    x = np.asarray(jd.fill_halos(jnp.asarray(_field(np.float64))))
    bad = x.copy()
    bad[2, 1, 6] += 1.0           # a halo point
    bad[0, H + 3, 1] -= 2.0       # another
    td = _port_domain(reentrant_x=True, reentrant_y=True)
    for arr, want in ((x, 0), (bad, 2 if reentrant else 0)):
        a = jdbg.check_halo_consistency(jd, arr, reentrant_wrap=reentrant)
        b = tdbg.check_halo_consistency(td, _t(arr),
                                        reentrant_wrap=reentrant)
        assert a == b == want


# ---- the diag mediator ---------------------------------------------------

DIAG_TABLE = '''"test run"
1 1 1 0 0 0
"ocean_month", 1, "days", 1, "days", "time"
"ocean_model", "temp", "temp", "ocean_month", "all", "mean", "none", 2
"ocean_model", "SSH", "SSH", "ocean_month", "all", "none", "none", 2
"ocean_model", "h", "h", "ocean_month", "all", "mean", "none", 2
# a comment line
"ocean_model", "sst2", "sst2", "ocean_month", "all", "mean", "none", 2
'''


def test_parse_diag_table_matches():
    assert tdiag.parse_diag_table(DIAG_TABLE) == \
        jdiag.parse_diag_table(DIAG_TABLE)


def _posts(rng):
    """Three rounds of posts: (name, padded field, weight)."""
    out = []
    for r in range(3):
        out.append([
            ("temp", 10.0 + rng.standard_normal((NK, NJ + 8, NI + 8)), 0.5),
            ("SSH", 0.1 * rng.standard_normal((NJ + 8, NI + 8)), 1.0),
            ("h", 100.0 + rng.standard_normal((NK, NJ + 8, NI + 8)), 2.0),
            ("sst2", rng.standard_normal((NJ + 8, NI + 8)), 1.0)])
    return out


@pytest.mark.parametrize("as_chksum", [True, False],
                         ids=["chksum", "netcdf"])
def test_diag_mediator_matches(tmp_path, as_chksum):
    rng = np.random.default_rng(8)
    area = 1e8 * (1.0 + rng.random((NJ + 8, NI + 8)))
    mask = (rng.random((NJ, NI)) > 0.2).astype(np.float64)
    posts = _posts(rng)
    files = {}
    for pkg, mod in (("jax", jdiag), ("port", tdiag)):
        d = tmp_path / pkg
        d.mkdir()
        dom = JDomain(ni=NI, nj=NJ, halo=H) if pkg == "jax" \
            else _port_domain()
        med = mod.DiagMediator(dom, str(d), diag_table_text=DIAG_TABLE,
                               as_chksum=as_chksum)
        conv = jnp.asarray if pkg == "jax" else _t
        ids = {"temp": med.register("ocean_model", "temp", "degC",
                                    mask=mask),
               "SSH": med.register("ocean_model", "SSH", "m",
                                   area=conv(area), mask=mask),
               "h": med.register("ocean_model", "h", "m"),
               "sst2": med.register("ocean_model", "sst2", "degC",
                                    area=conv(area), downsample=2),
               "nope": med.register("ocean_model", "absent", "")}
        assert ids["nope"] == -1
        means = []
        for rnd in posts:
            for name, f, w in rnd:
                med.post(ids[name], conv(f), weight=w)
            means.append(med.area_mean(ids["SSH"], conv(rnd[1][1])))
        files[pkg] = (med.flush("diags.nc", time_value=3.0), means)
    (pj, mj), (pp, mp) = files["jax"], files["port"]
    assert mj == mp
    if as_chksum:
        text = pathlib.Path(pp).read_text()
        assert text == pathlib.Path(pj).read_text()
        assert len(text.splitlines()) == 12
        return
    with netcdf_file(pj, "r", mmap=False) as a, \
            netcdf_file(pp, "r", mmap=False) as b:
        assert sorted(a.variables) == sorted(b.variables)
        for k in a.variables:
            x, y = np.array(a.variables[k][:]), np.array(b.variables[k][:])
            assert x.shape == y.shape and np.array_equal(x, y, equal_nan=True)


# ---- the diagnostic remap --------------------------------------------------

def _column_setup(seed=4):
    rng = np.random.default_rng(seed)
    shape = (NK, NJ + 8, NI + 8)
    bathy = 400.0 + 300.0 * rng.random(shape[1:])
    frac = rng.uniform(0.5, 1.5, shape)
    h = bathy[None] * frac / frac.sum(0)[None]
    T = 15.0 - 10.0 * np.cumsum(frac, 0) / frac.sum(0)[None] \
        + 0.3 * rng.standard_normal(shape)
    S = 35.0 + 0.2 * rng.standard_normal(shape)
    return bathy, h, T, S


def _close(a, b, tol, name):
    a = np.asarray(a, np.float64)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, name
    assert np.array_equal(np.isnan(a), np.isnan(b)), name
    ok = ~np.isnan(a)
    err = np.abs(a[ok] - b[ok]).max() / (np.abs(a[ok]).max() + 1e-300)
    assert err <= tol, f"{name}: {err:.3e}"


def test_diag_remap_matches():
    bathy, h, T, S = _column_setup()
    jcfg = jdr.DiagRemapCfg.uniform(6, 700.0)
    tcfg = tdr.DiagRemapCfg.uniform(6, 700.0)
    jhz = jdr.build_z_thickness(jcfg, jnp.asarray(bathy))
    thz = tdr.build_z_thickness(tcfg, _t(bathy))
    _close(jhz, thz, 0.0, "h_z")
    _close(jdr.remap_to_z(jnp.asarray(T), jnp.asarray(h), jhz, jcfg),
           tdr.remap_to_z(_t(T), _t(h), thz, tcfg), 1e-12, "remap_to_z")
    flux = T * h
    _close(jdr.reintegrate_to_z(jnp.asarray(flux), jnp.asarray(h), jhz),
           tdr.reintegrate_to_z(_t(flux), _t(h), thz), 1e-12,
           "reintegrate_to_z")
    e = np.concatenate([np.zeros_like(h[:1]), np.cumsum(T, 0)], 0)
    zo = [0.0, 50.0, 333.3, 650.0, 900.0]
    _close(jdr.interpolate_to_z(jnp.asarray(e), jnp.asarray(h), zo),
           tdr.interpolate_to_z(_t(e), _t(h), zo), 1e-12,
           "interpolate_to_z")
    rl = np.linspace(1025.5, 1028.0, NK)
    jeos, teos = j_make_eos("WRIGHT"), make_eos("WRIGHT")
    _close(jdr.build_rho_thickness(rl, jnp.asarray(h), jnp.asarray(bathy),
                                   jnp.asarray(T), jnp.asarray(S), jeos),
           tdr.build_rho_thickness(_t(rl), _t(h), _t(bathy), _t(T), _t(S),
                                   teos), 1e-12, "h_rho")


def _lines(text):
    """[(name, {stat: value})] of chksum_diag text."""
    out = []
    for ln in text.splitlines():
        name, rest = ln.split(": ", 1)
        out.append((name, {k: float(v) for k, v in
                           (c.split("=") for c in rest.split())}))
    return out


def test_prognostic_diags_match(tmp_path):
    bathy, h, T, S = _column_setup(seed=6)
    rng = np.random.default_rng(6)
    u, v = (0.1 * rng.standard_normal(h.shape) for _ in range(2))
    jd = JDomain(ni=NI, nj=NJ, halo=H, reentrant_x=True)
    jg = j_cartesian_grid(jd, lenlon_km=NI * 10.0, lenlat_km=NJ * 10.0,
                          f0=1e-4, max_depth=700.0,
                          depth_fn=lambda lon, lat: np.full_like(lat, 700.0))
    tg = convert.grid_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in jg.__dataclass_fields__
         if k != "domain" and getattr(jg, k) is not None},
        _port_domain(reentrant_x=True), device="cpu", dtype=F64)
    jvg = JVerticalGrid.uniform(nk=NK, gint=0.005)
    tvg = VerticalGrid.uniform(nk=NK, gint=0.005, device="cpu", dtype=F64)
    texts = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        if pkg == "jax":
            med = jdiag.DiagMediator(jd, str(d), as_chksum=True)
            pd = jpd.PrognosticDiags.create(med, jg, jvg, 700.0, 5)
            st = JState(**{k: jnp.asarray(x) for k, x in
                           dict(u=u, v=v, h=h, T=T, S=S).items()})
            pd.post_state(jg, jvg, st, eos=j_make_eos("WRIGHT"))
        else:
            med = tdiag.DiagMediator(_port_domain(reentrant_x=True), str(d),
                                     as_chksum=True)
            pd = tpd.PrognosticDiags.create(med, tg, tvg, 700.0, 5)
            st = State(**{k: _t(x) for k, x in
                          dict(u=u, v=v, h=h, T=T, S=S).items()})
            pd.post_state(tg, tvg, st, eos=make_eos("WRIGHT"))
        texts[pkg] = pathlib.Path(med.flush()).read_text()
    a, b = _lines(texts["jax"]), _lines(texts["port"])
    assert [n for n, _ in a] == [n for n, _ in b]
    assert len(a) == 14
    for (name, x), (_, y) in zip(a, b):
        for k in ("mean", "min", "max"):
            assert _rel(x[k], y[k]) <= 1e-12, (name, k)
        if name.split(".")[1] in ("u", "v", "h", "temp", "salt"):
            assert x["bits"] == y["bits"], name


# ---- cases/ref_tc0 through both drivers ------------------------------------

@pytest.fixture(scope="module")
def ref_tc0_runs(tmp_path_factory):
    """ref_tc0 through the JAX driver (fewer XLA optimizations: its
    compile is most of its run) and the port's, on copies of the case."""
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path_factory.mktemp(f"ref_tc0_{pkg}")
        for name in ("MOM_input", "MOM_override"):
            shutil.copy(ROOT / "cases" / "ref_tc0" / name, d / name)
        if pkg == "jax":
            old = jax.config.read("jax_disable_most_optimizations")
            jax.config.update("jax_disable_most_optimizations", True)
            try:
                jsolo.main([str(d), "--cpu"])
            finally:
                jax.config.update("jax_disable_most_optimizations", old)
        else:
            out["summary"] = solo.main([str(d), "--cpu"])
        out[pkg] = d
    return out


def _stats_rows(path):
    rows = []
    for line in path.read_text().splitlines()[2:]:
        step, day, truncs, *rest = [c.strip() for c in line.split(",")]
        rows.append((int(step), {k: float(v) for k, v in
                                 (c.split(None, 1) for c in rest)}))
    return rows


def test_ref_tc0_driver_matches_golden(ref_tc0_runs):
    golden = json.loads((ROOT / "tests" / "goldens_ref_cases.json")
                        .read_text())["ref_tc0"]
    run = ref_tc0_runs["summary"]
    n = golden["nsteps"]
    assert run["steps"] == n
    s = run["state"]
    assert bool(torch.isfinite(s.h).all())
    from mom6_torch.diagnostics.sum_output import stat_sums
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.model import build_model
    case = ROOT / "cases" / "ref_tc0"
    m = build_model(ParamFile(str(case / "MOM_input"),
                              str(case / "MOM_override")),
                    device="cpu", dtype=F64)
    st = collect_stats(stat_sums(m.domain, m.grid, m.vgrid, s, m.dt),
                       m.vgrid, n, 0.0)
    np.testing.assert_allclose(st.energy_per_mass,
                               golden["energy_per_mass"], rtol=1e-9)
    np.testing.assert_allclose(st.total_mass, golden["mass"], rtol=1e-11)
    np.testing.assert_allclose(st.mean_salin, golden["salt"], atol=1e-9)
    np.testing.assert_allclose(st.mean_temp, golden["temp"], rtol=1e-9)
    np.testing.assert_allclose(st.max_cfl, golden["max_cfl"], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(st.mean_sea_level, golden["sea_level"],
                               rtol=1e-6, atol=1e-12)
    # the driver's ocean.stats lines agree with the JAX driver's
    want = _stats_rows(ref_tc0_runs["jax"] / "ocean.stats")
    got = _stats_rows(ref_tc0_runs["port"] / "ocean.stats")
    assert [k for k, _ in got] == [k for k, _ in want] == [0, 1, 2]
    for (_, a), (_, b) in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            assert _rel(a[k], b[k]) <= 1e-9 or abs(a[k] - b[k]) <= 1e-12, k


@pytest.mark.parametrize("name", ["chksum_debug", "chksum_diag"])
def test_ref_tc0_checksum_files_match(ref_tc0_runs, name):
    want = (ref_tc0_runs["jax"] / name).read_text().splitlines()
    got = (ref_tc0_runs["port"] / name).read_text().splitlines()
    assert len(got) == len(want) > 6
    for a, b in zip(want, got):
        if a.startswith("= step"):
            assert a == b
            continue
        (na, xa), = _lines(a)
        (nb, xb), = _lines(b)
        assert na == nb and xa.keys() == xb.keys()
        for k in xa:
            # the fields are bitwise equal here (the case stays at rest),
            # so the bit counts are too
            tol = 0.0 if k == "bits" else 1e-12
            assert _rel(xa[k], xb[k]) <= tol, (a, b)
