"""mom6_torch against mom6_tpu: the ninth breadth item, set-up and forcing
from files, sponges and the rest of the IO.

The same numpy inputs, drawn from a seed, go through the JAX functions
(eagerly, float64) and their ports on device="cpu" in float64:

* the NetCDF reads (read_fields, read_attrs, field_names) of a file the
  port writes, and the calendar arithmetic of ``Time``/``Calendar``;
* parse_data_table and DataOverride with a constant, an on-grid and an
  off-grid (bilinear) override, at two model times;
* the file wind (WIND_CONFIG = file, a 360-day modulo axis) and the
  buoyancy fluxes (BUOY_CONFIG = file) at two model times;
* mosaic_grid on cases/ref_tc4's ocean_hgrid.nc (made by its
  gen_data.py);
* fill_missing, bilinear_regrid and the z-space initial state (1e-12);
* the layer and ALE sponges (7 reference levels onto 4) and the
  interface sponge (1e-12);
* COORD_CONFIG linear through both builders;
* the depth-list file: written by either package, read by the other;
* DEBUG_NANS: cases/tc2, whose steps make a NaN and mask it away, runs
  on; an injected NaN in a step's output raises, naming the step;
* the builder's other file branches: TOPO_CONFIG file, VELOCITY_CONFIG
  file, TRACER_Z_INIT_FILE, and SPONGE_CONFIG BFB, RGC (SPONGE_UV) and a
  file sponge with ETA targets.

configs.BENCH_CONFIG_FILE through both packages is in
tests/test_torch_file_text.py.
"""

import dataclasses
import os
import pathlib
import runpy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mom6_tpu.ale.remapping import RemapCfg as JRemapCfg
from mom6_tpu.core.grid import cartesian_grid as j_cartesian_grid
from mom6_tpu.core.grid import mosaic_grid as j_mosaic_grid
from mom6_tpu.diagnostics import depth_list as jdl
from mom6_tpu.drivers import surface_forcing as jsf
from mom6_tpu.framework import data_override as jdo
from mom6_tpu.framework import io as jio
from mom6_tpu.framework import time_manager as jtm
from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.initialization import horizontal_regrid as jhr
from mom6_tpu.initialization import z_init as jzi
from mom6_tpu.model import build_model as j_build_model
from mom6_tpu.param.vertical import sponge as jsp
from mom6_tpu.parallel.domain import Domain as JDomain

from mom6_torch.ale.remapping import RemapCfg
from mom6_torch.convert import grid_from_numpy
from mom6_torch.core.grid import mosaic_grid
from mom6_torch.diagnostics import depth_list as tdl
from mom6_torch.drivers import solo
from mom6_torch.drivers import surface_forcing as tsf
from mom6_torch.framework import data_override as tdo
from mom6_torch.framework import io as tio
from mom6_torch.framework import time_manager as ttm
from mom6_torch.framework.config import ParamFile
from mom6_torch.framework.debug_nans import NanCheck
from mom6_torch.initialization import horizontal_regrid as thr
from mom6_torch.initialization import z_init as tzi
from mom6_torch.model import build_model
from mom6_torch.param.vertical import sponge as tsp
from mom6_torch.parallel.domain import Domain

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
NI, NJ, NK, H = 12, 10, 4, 4
TOL = 1e-12


def _grids():
    """A cartesian 12x10 grid (120 x 100 km) with a bowl-like bottom and
    a land corner in both packages."""
    jd = JDomain(ni=NI, nj=NJ, halo=H, reentrant_x=True)

    def depth(lon, lat):
        d = 500.0 + 3000.0 * np.sin(np.pi * lat / 100.0) ** 2 \
            + 10.0 * lon
        return np.where((lon < 30.0) & (lat < 25.0), 0.0, d)
    jg = j_cartesian_grid(jd, lenlon_km=120.0, lenlat_km=100.0, f0=1e-4,
                          depth_fn=depth, max_depth=4000.0)
    gnp = {f.name: np.asarray(getattr(jg, f.name))
           for f in dataclasses.fields(jg)
           if f.name != "domain" and getattr(jg, f.name) is not None}
    td = Domain(ni=NI, nj=NJ, halo=H, reentrant_x=True)
    return jd, jg, td, grid_from_numpy(gnp, td, device="cpu", dtype=F64)


JD, JG, TD, TG = _grids()


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _check(ref, out, name, tol=TOL):
    a = np.asarray(ref, np.float64)
    b = out.detach().double().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float64)
    assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-300)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def test_io_reads_and_time(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "f.nc")
    tio.write_fields(path, {"a": rng.standard_normal((3, 4)),
                            "t": np.arange(3.0)},
                     dims={"a": ("t", "x"), "t": ("t",)},
                     attrs={"t": {"units": "days since 0001-01-01"}},
                     global_attrs={"depth_chksum": 1234, "title": "x"})
    assert tio.field_names(path) == jio.field_names(path) == ["a", "t"]
    got, want = tio.read_fields(path, ["a", "t"]), \
        jio.read_fields(path, ["a", "t"])
    for k in want:
        assert np.array_equal(got[k], want[k])
    assert tio.read_attrs(path) == jio.read_attrs(path)
    assert int(tio.read_attrs(path)["depth_chksum"]) == 1234
    for kind in ("NOLEAP", "JULIAN", "GREGORIAN", "360_DAY"):
        jc, tc = jtm.Calendar(kind), ttm.Calendar(kind)
        for days, secs in ((0, 0), (59, 3600), (1460, 86399),
                           (36524 + 17, 45296)):
            jt, tt = jtm.Time(days, secs), ttm.Time(days, secs)
            assert tt.to_date(tc) == jt.to_date(jc)
            date = jt.to_date(jc, epoch_year=1900)
            assert ttm.Time.from_date(tc, *date, epoch_year=1900) \
                .total_seconds() == jtm.Time.from_date(
                    jc, *date, epoch_year=1900).total_seconds()
            assert (tt + 90000).total_seconds() \
                == (jt + 90000).total_seconds()
            assert (tt - ttm.Time(0, 7)).total_days() \
                == (jt - jtm.Time(0, 7)).total_days()
        assert [tc.days_in_year(y) for y in (1900, 2000, 2023, 2024)] \
            == [jc.days_in_year(y) for y in (1900, 2000, 2023, 2024)]


def _forcing_files(d):
    """An on-grid file with two dated records (days 0 and 10) and an
    off-grid one with lon/lat axes and one record."""
    rng = np.random.default_rng(2)
    tio.write_fields(
        os.path.join(d, "ongrid.nc"),
        {"time": np.array([0.0, 10.0]),
         "u_flux": rng.uniform(-0.2, 0.2, (2, NJ, NI)),
         "tauy": rng.uniform(-0.1, 0.1, (2, NJ, NI)),
         "SW": rng.uniform(50.0, 250.0, (2, NJ, NI)),
         "evap": rng.uniform(0.0, 5e-5, (2, NJ, NI))},
        dims={"time": ("time",), "u_flux": ("time", "y", "x"),
              "tauy": ("time", "y", "x"), "SW": ("time", "y", "x"),
              "evap": ("time", "y", "x")},
        attrs={"time": {"units": "days since 0001-01-01", "modulo": "20"}})
    tio.write_fields(
        os.path.join(d, "offgrid.nc"),
        {"lon": np.linspace(-10.0, 130.0, 7),
         "lat": np.linspace(0.0, 100.0, 5),
         "lw": rng.uniform(-80.0, -40.0, (5, 7))},
        dims={"lon": ("lon",), "lat": ("lat",), "lw": ("lat", "lon")})


TABLE = """# a comment
"OCN", "u_flux", "u_flux", "ongrid.nc", .true., 1.5
"OCN", "lw", "lw", "offgrid.nc", "bilinear", 1.0
"OCN", "sensible", "", "", .false., -20.0
"ATM", "taux", "", "", .false., 3.0
"""


def test_data_table_and_override(tmp_path):
    _forcing_files(str(tmp_path))
    assert tdo.parse_data_table(TABLE) == jdo.parse_data_table(TABLE)
    (tmp_path / "data_table").write_text(TABLE)
    table = str(tmp_path / "data_table")
    jo = jdo.DataOverride.build(table, JG, indir=str(tmp_path))
    to = tdo.DataOverride.build(table, TG, indir=str(tmp_path))
    assert sorted(to.fields) == sorted(jo.fields) \
        == ["lw", "sensible", "taux"]
    rng = np.random.default_rng(3)
    sw = rng.uniform(0.0, 100.0, JG.mask2dT.shape)
    from mom6_tpu.core.forcing import Fluxes as JFluxes, \
        MechForcing as JMech
    from mom6_torch.core.forcing import Fluxes, MechForcing
    for t in (3.0 * 86400.0, 17.5 * 86400.0):
        jm = jo.mech(JMech(tauy=jnp.asarray(sw)), jnp.asarray(t), JG)
        tm = to.mech(MechForcing(tauy=_t(sw)), t, TG)
        for k in ("taux", "tauy"):
            _check(getattr(jm, k), getattr(tm, k), f"mech {k} t={t}")
        jf = jo.fluxes(JFluxes(sw=jnp.asarray(sw)), jnp.asarray(t), JG)
        tf = to.fluxes(Fluxes(sw=_t(sw)), t, TG)
        for k in ("sw", "lw", "sensible"):
            _check(getattr(jf, k), getattr(tf, k), f"fluxes {k} t={t}")
        assert tf.evap is None and to.fluxes(None, t, TG).sw is None


def test_file_wind_and_fluxes(tmp_path):
    _forcing_files(str(tmp_path))
    path = str(tmp_path / "ongrid.nc")
    jw = jsf.wind_forcing_from_file(JG, path, "u_flux", "tauy",
                                    scale=2.0)
    tw = tsf.wind_forcing_from_file(TG, path, "u_flux", "tauy", scale=2.0)
    files = {"sw": (path, "SW"), "evap": (path, "evap"),
             "lw": (str(tmp_path / "offgrid.nc"), "lw")}
    jb = jsf.buoyancy_forcing_from_files(JG, files)
    tb = tsf.buoyancy_forcing_from_files(TG, files)
    assert tw.time_varying and tb.time_varying
    for t in (4.0 * 86400.0, 23.0 * 86400.0):
        jm, tm = jw(jnp.asarray(t)), tw(t)
        _check(jm.taux, tm.taux, f"taux t={t}")
        _check(jm.tauy, tm.tauy, f"tauy t={t}")
        jf, tf = jb(None, jnp.asarray(t)), tb(None, t)
        for k in files:
            _check(getattr(jf, k), getattr(tf, k), f"{k} t={t}")


def test_mosaic_grid_matches_jax(tmp_path):
    runpy.run_path(str(ROOT / "cases" / "ref_tc4" / "gen_data.py"))["gen"](
        str(tmp_path))
    path = str(tmp_path / "ocean_hgrid.nc")
    jd = JDomain(ni=14, nj=10, halo=H)
    jg = j_mosaic_grid(jd, path, min_depth=0.0)
    tg = mosaic_grid(Domain(ni=14, nj=10, halo=H), path, device="cpu",
                     dtype=F64)
    for f in dataclasses.fields(jg):
        a = getattr(jg, f.name)
        if f.name != "domain" and a is not None:
            _check(a, getattr(tg, f.name), f.name, tol=0.0)


def _z_file(seed=4):
    """A 9x7 lon/lat, 6-level z file over the grid, missing (-1e20) over
    a land block and below 1800 m in one corner."""
    rng = np.random.default_rng(seed)
    lon = np.linspace(2.0, 118.0, 9)
    lat = np.linspace(3.0, 97.0, 7)
    z = np.array([5.0, 50.0, 200.0, 600.0, 1500.0, 3200.0])
    T = 20.0 * np.exp(-z / 800.0)[:, None, None] \
        + rng.standard_normal((6, 7, 9))
    S = 35.0 + 0.1 * rng.standard_normal((6, 7, 9))
    T[:, :2, :3] = -1e20
    S[:, :2, :3] = -1e20
    T[4:, 5:, 7:] = -1e20
    S[4:, 5:, 7:] = -1e20
    return lon, lat, z, T, S


def test_fill_regrid_and_z_init():
    lon, lat, z, T, S = _z_file()
    valid = T > -1e10
    jf = jhr.fill_missing(T, valid)
    tf = thr.fill_missing(T, valid, device="cpu")
    _check(jf, tf, "fill_missing")
    for stag in ("T", "Cu"):
        dlon, dlat = (np.asarray(getattr(JG, f"geo{c}{stag}"))
                      for c in ("Lon", "Lat"))
        _check(jhr.bilinear_regrid(jf, lon, lat, dlon, dlat),
               thr.bilinear_regrid(tf, lon, lat, dlon, dlat),
               f"bilinear_regrid {stag}")
    ze = jzi.z_edges_from_centers(z, 4000.0)
    assert np.array_equal(ze, tzi.z_edges_from_centers(z, 4000.0))
    bathy = np.asarray(JG.bathyT)
    _check(jzi.thickness_from_z_edges(ze, bathy, 1e-10),
           tzi.thickness_from_z_edges(ze, _t(bathy), 1e-10), "h from z")
    res = np.array([50.0, 300.0, 1000.0, 2650.0])
    zc = np.minimum(np.concatenate([[0.0], np.cumsum(res)])[:, None, None],
                    bathy[None])
    hz = np.maximum(zc[1:] - zc[:-1], 1e-10)
    args = (lon, lat, z, np.asarray(JG.geoLonT), np.asarray(JG.geoLatT),
            bathy)
    jT, jS = jzi.temp_salt_from_z(T, S, *args, jnp.asarray(hz), 1e-10)
    tT, tS = tzi.temp_salt_from_z(T, S, *args, _t(hz), 1e-10)
    _check(jT, tT, "z-init T")
    _check(jS, tS, "z-init S")
    jtr = jzi.tracer_from_z(S, *args, jnp.asarray(hz), 1e-10,
                            remap_cfg=JRemapCfg(scheme="PLM"))
    ttr = tzi.tracer_from_z(S, *args, _t(hz), 1e-10,
                            remap_cfg=RemapCfg(scheme="PLM"))
    _check(jtr, ttr, "tracer_from_z")


def test_sponges_match_jax():
    rng = np.random.default_rng(5)
    shape = (NK, JD.njh, JD.nih)
    h = rng.uniform(1.0, 400.0, shape)
    T = rng.uniform(2.0, 20.0, shape)
    S = rng.uniform(34.0, 36.0, shape)
    idamp = rng.uniform(0.0, 1.0 / 86400.0, shape[1:])
    idamp[:3] = 0.0
    dt = 1800.0
    # layer targets
    tgt = {"T": rng.uniform(2.0, 20.0, shape), "S": None}
    jo = jsp.apply_sponge({"T": jnp.asarray(T), "S": jnp.asarray(S)},
                          jnp.asarray(h), jnp.asarray(idamp), dt,
                          {"T": jnp.asarray(tgt["T"])})
    to = tsp.apply_sponge({"T": _t(T), "S": _t(S)}, _t(h), _t(idamp), dt,
                          {"T": _t(tgt["T"])})
    _check(jo["T"], to["T"], "layer sponge T")
    assert torch.equal(to["S"], _t(S))
    # targets on 7 levels of their own (the ALE sponge)
    w = rng.uniform(0.1, 1.0, (7,) + shape[1:])
    ref_h = w / w.sum(0) * h.sum(0)
    ref_T = rng.uniform(2.0, 20.0, ref_h.shape)
    jo = jsp.apply_sponge({"T": jnp.asarray(T)}, jnp.asarray(h),
                          jnp.asarray(idamp), dt, {"T": jnp.asarray(ref_T)},
                          ref_h=jnp.asarray(ref_h))
    to = tsp.apply_sponge({"T": _t(T)}, _t(h), _t(idamp), dt,
                          {"T": _t(ref_T)}, ref_h=_t(ref_h))
    _check(jo["T"], to["T"], "ALE sponge T")
    # interface depths
    d_ref = np.cumsum(np.concatenate([np.zeros((1,) + shape[1:]),
                                      rng.uniform(1.0, 500.0, shape)]), 0)
    d_ref[2, 5:, 5:] = d_ref[1, 5:, 5:] - 3.0       # non-monotonic target
    _check(jsp.apply_eta_sponge(jnp.asarray(h), jnp.asarray(idamp), dt,
                                jnp.asarray(d_ref), 1e-10),
           tsp.apply_eta_sponge(_t(h), _t(idamp), dt, _t(d_ref), 1e-10),
           "eta sponge h")


def test_coord_config_linear():
    text = ("NIGLOBAL = 6\nNJGLOBAL = 5\nNK = 5\nDT = 600.0\n"
            "GRID_CONFIG = cartesian\nAXIS_UNITS = k\nLENLON = 60.0\n"
            "LENLAT = 50.0\nCOORD_CONFIG = linear\n"
            "LIGHTEST_DENSITY = 1024.0\nDENSITY_RANGE = 4.0\n"
            "EQN_OF_STATE = LINEAR\n")
    jm = j_build_model(JParamFile(text=text))
    tm = build_model(ParamFile(text=text), device="cpu", dtype=F64)
    _check(jm.vgrid.Rlay, tm.vgrid.Rlay, "Rlay", tol=0.0)
    _check(jm.vgrid.g_prime, tm.vgrid.g_prime, "g_prime", tol=0.0)
    assert float(tm.vgrid.Rlay[0]) == 1024.4


def test_depth_list_files_cross(tmp_path):
    jl = jdl.depth_list_setup(JD, JG, read_file=True,
                              path=str(tmp_path / "jax.nc"))
    tl = tdl.depth_list_setup(TD, TG, read_file=True,
                              path=str(tmp_path / "port.nc"))
    for k in ("depth", "area", "vol_below"):
        _check(getattr(jl, k), getattr(tl, k), k, tol=0.0)
    # each package reads the other's file (the checksums agree)
    assert tdl._grid_chksum(TD, TG) == jdl._grid_chksum(JD, JG)
    jr = jdl.depth_list_setup(JD, JG, read_file=True,
                              path=str(tmp_path / "port.nc"))
    tr = tdl.depth_list_setup(TD, TG, read_file=True,
                              path=str(tmp_path / "jax.nc"))
    for k in ("depth", "area", "vol_below"):
        _check(getattr(jl, k), getattr(jr, k), k, tol=0.0)
        _check(getattr(jl, k), getattr(tr, k), k, tol=0.0)
    # a file of another bathymetry is computed again and rewritten
    tio.write_fields(str(tmp_path / "stale.nc"),
                     {k: np.ones(3) for k in ("depth", "area",
                                              "vol_below")},
                     global_attrs={"depth_chksum": 1})
    st = tdl.depth_list_setup(TD, TG, read_file=True,
                              path=str(tmp_path / "stale.nc"))
    _check(jl.depth, st.depth, "recomputed", tol=0.0)
    assert int(tio.read_attrs(str(tmp_path / "stale.nc"))["depth_chksum"]) \
        == tdl._grid_chksum(TD, TG)


def test_debug_nans_raises_on_injected_nan(tmp_path, monkeypatch):
    x = torch.tensor([1.0, -1.0], dtype=F64)
    with NanCheck(step=7):
        assert float(torch.sqrt(x[:1])) == 1.0
        with pytest.raises(FloatingPointError, match="sqrt.*step 7"):
            torch.sqrt(x)
    assert bool(torch.isnan(torch.sqrt(x)).any())        # off again
    # tc2's PPM_H4 boundary solve makes a 0/0 on its vanished layers and
    # masks it away: the step's outputs are finite, so nothing stops
    text = (ROOT / "cases" / "tc2" / "MOM_input").read_text()
    (tmp_path / "MOM_input").write_text(text + "DEBUG_NANS = True\n")
    run = solo.main([str(tmp_path), "--cpu", "--days",
                     repr(2 * 900.0 / 86400.0)])
    assert run["steps"] == 2
    from mom6_torch.core import orchestrator
    real = orchestrator.step_ocean

    def poisoned(*args, **kw):
        out = real(*args, **kw)
        st = out[0]
        return (st.replace(h=st.h * torch.where(st.h > 0, float("nan"),
                                                1.0)),) + tuple(out[1:])
    monkeypatch.setattr("mom6_torch.model.step_ocean", poisoned)
    with pytest.raises(FloatingPointError, match="step 0"):
        solo.main([str(tmp_path), "--cpu", "--days",
                   repr(2 * 900.0 / 86400.0)])


def test_builder_file_branches_match_jax(tmp_path):
    """The builder's other file branches at 12x10x4, both packages from
    one text: TOPO_CONFIG file, VELOCITY_CONFIG file and
    TRACER_Z_INIT_FILE (the age tracer from a z file) give the same
    initial state and tracers (1e-12), and SPONGE_CONFIG BFB, RGC with
    SPONGE_UV, and a file sponge with ETA interface targets the same
    sponge data."""
    rng = np.random.default_rng(6)
    lon, lat, z, T, S = _z_file()
    d = str(tmp_path)
    depth = np.asarray(JD.interior(JG.bathyT))
    tio.write_fields(os.path.join(d, "topog.nc"), {"depth": depth})
    tio.write_fields(os.path.join(d, "vel.nc"),
                     {"u": rng.uniform(-0.1, 0.1, (1, NK, NJ, NI)),
                      "v": rng.uniform(-0.1, 0.1, (1, NK, NJ, NI))})
    tio.write_fields(os.path.join(d, "age_z.nc"),
                     {"lon": lon, "lat": lat, "depth": z,
                      "age": np.abs(T)},
                     dims={"lon": ("lon",), "lat": ("lat",),
                           "depth": ("depth",),
                           "age": ("depth", "lat", "lon")})
    shape = (NK, NJ, NI)
    tio.write_fields(os.path.join(d, "rgc.nc"),
                     {"Temp": rng.uniform(5.0, 15.0, shape),
                      "Salt": rng.uniform(34.0, 36.0, shape),
                      "h": rng.uniform(10.0, 400.0, shape)})
    eta = -np.cumsum(np.concatenate([np.zeros((1, NJ, NI)),
                                     rng.uniform(50.0, 900.0, shape)]), 0)
    tio.write_fields(os.path.join(d, "eta_sponge.nc"),
                     {"Idamp": rng.uniform(0.0, 1e-5, (NJ, NI)),
                      "ETA": eta})
    base = (f"NIGLOBAL = {NI}\nNJGLOBAL = {NJ}\nNK = {NK}\nDT = 600.0\n"
            "GRID_CONFIG = cartesian\nAXIS_UNITS = k\nLENLON = 120.0\n"
            "LENLAT = 100.0\nREENTRANT_X = True\nMAXIMUM_DEPTH = 4000.0\n"
            f"TOPO_CONFIG = file\nINPUTDIR = {d}\nTS_CONFIG = linear\n"
            "T_RANGE = 10.0\nVELOCITY_CONFIG = file\n"
            "VELOCITY_FILE = vel.nc\nUSE_IDEAL_AGE_TRACER = True\n"
            "TRACER_Z_INIT_FILE = age_z.nc\nSPONGE = True\n")
    texts = {"BFB": "SPONGE_CONFIG = BFB\n",
             "RGC": "SPONGE_CONFIG = RGC\nRGC_TNUDG = 2.0\n"
                    "LENSPONGE = 40.0\nSPONGE_UV = True\n"
                    "RGC_SPONGE_FILE = rgc.nc\n",
             "ETA": "SPONGE_DAMPING_FILE = eta_sponge.nc\n"}
    for label, extra in texts.items():
        jm = j_build_model(JParamFile(text=base + extra))
        tm = build_model(ParamFile(text=base + extra), device="cpu",
                         dtype=F64)
        if label == "BFB":
            for k in ("h", "u", "v", "T", "S"):
                _check(getattr(jm.state, k), getattr(tm.state, k),
                       f"initial {k}")
            _check(jm.tracers["age"], tm.tracers["age"], "age from z")
            assert float(tm.tracers["age"].max()) > 1.0
            assert float(tm.state.u.abs().max()) > 0.0
        js, ts = jm.ocean_cfg.sponge_data, tm.cfg.sponge
        assert sorted(k for k, v in js.items() if v is not None) \
            == sorted(k for k, v in ts.items() if v is not None), label
        for k, v in js.items():
            if k == "uv":
                assert ts[k] is True
            elif v is not None:
                _check(v, ts[k], f"{label} sponge {k}", tol=0.0)
